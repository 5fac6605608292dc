"""The port's demo and mesh data paths against the JAX package's (mirrors
tests/test_demo_paths.py): the orbit path and the SMPL rotation, every
item of the demo datasets (multi_view_demo, multi_view_perform,
rotate_smpl, monocular_demo) and of the mesh datasets (multi_view_mesh,
monocular_mesh), an orbit frame rendered through eval_step, and the
visualizers' PNGs, on tests/fake_data.py's trees (64^2, 400 vertices, 2 cm
voxels).

Tolerances: the host code (paths, items, PNGs) bit for bit; the render
from transplanted weights at 1e-4 of each map's scale, f32
(tests/test_torch_render.py's).
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuralbody_tpu.datasets  # noqa: F401  (registers plugins)
import neuralbody_tpu.renderer  # noqa: F401
import neuralbody_tpu.visualizers  # noqa: F401
from neuralbody_tpu.config import build as j_build
from neuralbody_tpu.config import make_cfg as j_make_cfg
from neuralbody_tpu.datasets import loader as j_loader
from neuralbody_tpu.datasets import render_path as j_rp
from neuralbody_tpu.models import latent_xyzc as j_lx
from neuralbody_tpu.train import step as j_step
import neuralbody_tpu_torch.datasets  # noqa: F401
import neuralbody_tpu_torch.renderer  # noqa: F401
import neuralbody_tpu_torch.visualizers  # noqa: F401
from neuralbody_tpu_torch.config import build as t_build
from neuralbody_tpu_torch.config import make_cfg as t_make_cfg
from neuralbody_tpu_torch.datasets import loader as t_loader
from neuralbody_tpu_torch.datasets import render_path as t_rp
from neuralbody_tpu_torch.train import step as t_step
from neuralbody_tpu_torch.utils.transplant import params_from_jax

from fake_data import make_fake_snapshot, make_fake_zju
from test_torch_datasets import assert_same

torch.set_num_threads(1)

N_VERTS = 400
MAP_TOL = 1e-4
MAPS = ("rgb_map", "acc_map", "depth_map", "disp_map")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One ZJU and one People-Snapshot tree per package (same content), so
    neither package reads the other's geometry cache."""
    out = {}
    for pkg in ("jax", "torch"):
        base = tmp_path_factory.mktemp(pkg)
        out[pkg] = (make_fake_zju(str(base / "CoreView_999")),
                    make_fake_snapshot(str(base / "f9c")))
    return out


def base_cfg(make_cfg, root, ann, module):
    """tests/test_demo_paths.py's base_cfg, in either package."""
    cfg = make_cfg(opts=["task", "if_nerf", "exp_name", "demo_t"])
    cfg.H = cfg.W = 64
    cfg.ratio = 1.0
    cfg.N_rand = 64
    cfg.N_samples = 8
    cfg.num_train_frame = 2
    cfg.num_render_views = 4
    cfg.training_view = [0, 1]
    cfg.voxel_size = [0.02, 0.02, 0.02]
    cfg.nv = N_VERTS
    cfg.tpu.chunk_rays = 256
    cfg.tpu.mesh_pt_chunk = 4096
    cfg.train_dataset.data_root = root
    cfg.train_dataset.human = "CoreView_999"
    cfg.train_dataset.ann_file = ann
    cfg.test_dataset.update(cfg.train_dataset)
    cfg.test_dataset.split = "test"
    cfg.test_dataset_module = module
    return cfg


def datasets(roots, module):
    """(cfg, dataset) of the JAX package and of the port for `module`."""
    snap = module.startswith("monocular")
    out = []
    for pkg, make_cfg, loader in (("jax", j_make_cfg, j_loader),
                                  ("torch", t_make_cfg, t_loader)):
        root = roots[pkg][int(snap)]
        ann = f"{root}/params.npy" if snap else f"{root}/annots.npy"
        cfg = base_cfg(make_cfg, root, ann, module)
        out.append((cfg, loader.make_dataset(cfg, "test")))
    return out


def test_orbit_path_and_rotation_equal_jax(roots):
    ann = f"{roots['torch'][0]}/annots.npy"
    for ratio in (1.0, 0.5):
        assert_same(t_rp.load_cam(ann, ratio), j_rp.load_cam(ann, ratio))
    _, RTs = t_rp.load_cam(ann, ratio=1.0)
    for n in (8, 50):
        path = t_rp.gen_orbit_path(RTs, num_views=n)
        assert_same(path, j_rp.gen_orbit_path(RTs, num_views=n))
        assert len(path) == n
        for w2c in path:   # rigid transforms
            np.testing.assert_allclose(w2c[:3, :3] @ w2c[:3, :3].T,
                                       np.eye(3), atol=1e-5)
    center = np.array([0.1, 0.0, -0.2])
    assert_same(t_rp.gen_orbit_path(RTs, 6, center),
                j_rp.gen_orbit_path(RTs, 6, center))
    xyz = np.random.RandomState(2).randn(50, 3).astype(np.float32)
    for t, plane in ((0.3, (0, 2)), (2.1, (0, 1))):
        assert_same(t_rp.rotate_points_y(xyz, t, plane),
                    j_rp.rotate_points_y(xyz, t, plane))


@pytest.mark.parametrize("module,indices", [
    ("multi_view_demo", None), ("multi_view_perform", None),
    ("rotate_smpl", (0, 1, 36, 143)), ("monocular_demo", (0, 72)),
    ("multi_view_mesh", None), ("monocular_mesh", None)])
def test_every_item_equals_jax(roots, module, indices):
    (_, jds), (_, tds) = datasets(roots, module)
    assert type(tds).__module__.startswith("neuralbody_tpu_torch.")
    assert len(tds) == len(jds) > 0
    for i in indices or range(len(tds)):
        assert_same(tds[i], jds[i], f"{module}[{i}]")


def test_lengths_and_latents(roots):
    """tests/test_demo_paths.py's counts: the orbit's views, the playback's
    frames and their latents, the 144 rotations."""
    (cfg, ds), = datasets(roots, "multi_view_demo")[1:]
    assert len(ds) == cfg.num_render_views and ds[0]["msks"].shape[0] == 2
    (_, ds), = datasets(roots, "multi_view_perform")[1:]
    assert [int(ds[i]["latent_index"]) for i in range(len(ds))] == [0, 1]
    (_, ds), = datasets(roots, "rotate_smpl")[1:]
    s0, s36 = ds[0], ds[36]
    assert len(ds) == 144 and np.isfinite(s0["ray_o"]).all()
    assert not np.array_equal(s0["R"], s36["R"])
    (_, ds), = datasets(roots, "monocular_demo")[1:]
    assert len(ds) == 144 and "R0_snap" in ds[0]


def _render(roots, module, renderer, index):
    (jcfg, jds), (tcfg, tds) = datasets(roots, module)
    jp, js = j_lx.init(jax.random.PRNGKey(0), num_train_frame=2, nv=N_VERTS)
    jp = jax.tree.map(np.asarray, jp)
    jp["alpha_fc"]["b"] = jp["alpha_fc"]["b"] + np.float32(3.0)
    tp, _ = params_from_jax(jp, jax.tree.map(np.asarray, js))
    out = []
    for pkg, cfg, ds, build, loader, params in (
            ("jax", jcfg, jds, j_build, j_loader, jp),
            ("torch", tcfg, tds, t_build, t_loader, tp)):
        static = build("model_static", cfg.network_module, cfg, ds)
        settings = build("renderer", renderer, cfg, static)
        batch, meta = loader.collate([ds[index]], cfg.tpu.chunk_rays)
        if pkg == "jax":
            ret = jax.tree.map(np.asarray, j_step.eval_step(
                params, jax.tree.map(jnp.asarray, batch), settings))
        else:
            ret = {k: v.numpy() for k, v in t_step.eval_step(
                params, batch, settings, device="cpu").items()}
        out.append((ret, batch, meta, cfg))
    return out


@pytest.mark.parametrize("module,renderer,index", [
    ("multi_view_demo", "if_clight_renderer_mmsk", 1),
    ("multi_view_perform", "if_clight_renderer_mmsk", 1),
    ("monocular_demo", "if_clight_renderer_msk", 0)])
def test_demo_render_matches_jax(roots, module, renderer, index):
    (jret, *_), (tret, *_) = _render(roots, module, renderer, index)
    for k in MAPS:
        assert np.isfinite(tret[k]).all()
        scale = max(float(np.abs(jret[k]).max()), 1e-6)
        np.testing.assert_allclose(tret[k], jret[k], rtol=0,
                                   atol=MAP_TOL * scale, err_msg=k)
    assert float(np.abs(jret["acc_map"]).max()) > 0.1   # not an empty view


@pytest.mark.parametrize("name", ["if_nerf", "if_nerf_demo",
                                  "if_nerf_perform", "if_nerf_test"])
def test_visualizer_pngs_equal_jax(roots, tmp_path, monkeypatch, name):
    """The same render output (the JAX one) through both packages'
    visualizers, in numpy and, for the port, as tensors: the same files,
    pixel for pixel."""
    (jret, batch, meta, jcfg), (_, _, _, tcfg) = _render(
        roots, "multi_view_demo", "if_clight_renderer_mmsk", 2)
    batch = dict(batch, rgb=np.random.RandomState(0).rand(
        *batch["rgb"].shape).astype(np.float32))
    written = {}
    for pkg, cfg, build, out, b in (
            ("jax", jcfg, j_build, jret, batch),
            ("torch", tcfg, t_build, {k: torch.from_numpy(v)
                                      for k, v in jret.items()},
             {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
              for k, v in batch.items()})):
        work = tmp_path / pkg
        work.mkdir()
        monkeypatch.chdir(work)
        cfg.result_dir = str(work / "result")
        build("visualizer", name, cfg).visualize(out, b, meta)
        written[pkg] = sorted(
            os.path.relpath(os.path.join(d, f), work)
            for d, _, fs in os.walk(work) for f in fs)
    assert written["torch"] == written["jax"] and len(written["jax"]) == 1
    rel = written["jax"][0]
    a = cv2.imread(str(tmp_path / "torch" / rel), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(tmp_path / "jax" / rel), cv2.IMREAD_UNCHANGED)
    assert a is not None and a.shape[0] == meta["img_hw"][0]
    np.testing.assert_array_equal(a, b)
