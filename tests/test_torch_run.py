"""The port's tool entry point (neuralbody_tpu_torch/run.py) against the
root run.py on the same configs, on the CPU at tests/fake_data.py's size
(64^2, 400 vertices, 2 cm voxels):

  * evaluate on a checkpoint written by the JAX package: the root run.py's
    run_evaluate (its ShardedEval over the test process's devices) and
    the port's give one summary, PSNR within 1e-3 dB and SSIM within 1e-4
    (the renders agree at 1e-4 of scale in f32);
  * visualize in each vis_* mode writes the files the root run.py writes;
  * dataset iterates the training loader; network times its renders;
  * light_stage writes the npz of tools/dataset_tools.py's cmd_occupancy,
    array for array;
  * evaluate_nv scores saved renders to the JAX package's summary (the
    same host code: 1e-9);
  * main() refuses an unknown --type, and runs on the card unless
    --device cpu is given.
"""
import importlib.util
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

import neuralbody_tpu.datasets  # noqa: F401  (registers plugins)
import neuralbody_tpu.models  # noqa: F401
from neuralbody_tpu.config import build as j_build
from neuralbody_tpu.config import make_cfg as j_make_cfg
from neuralbody_tpu.train.checkpoint import save_checkpoint as j_save
from neuralbody_tpu_torch import run as t_run
from neuralbody_tpu_torch.config import make_cfg as t_make_cfg
from neuralbody_tpu_torch.utils.mesh_io import save_ply

from fake_data import make_fake_zju

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_313 = os.path.join(REPO, "configs", "zju_mocap_exp",
                          "latent_xyzc_313.yaml")
PSNR_TOL = 1e-3
SSIM_TOL = 1e-4


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def root_run():
    return _load("root_run", os.path.join(REPO, "run.py"))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One ZJU tree per package (same content), so neither package reads
    the other's geometry cache."""
    return {pkg: make_fake_zju(str(tmp_path_factory.mktemp(pkg)
                                   / "CoreView_999"))
            for pkg in ("jax", "torch")}


def opts(root, **extra):
    """The 313 YAML cut to the fixture, as `key value` opts."""
    kv = dict(exp_name="run_t", H=64, W=64, ratio=1.0, N_rand=64,
              N_samples=8, num_train_frame=2, training_view="[0, 1]",
              voxel_size="[0.02, 0.02, 0.02]", nv=400, ep_iter=4,
              num_render_views=2, **{
                  "tpu.chunk_rays": 256, "tpu.mesh_pt_chunk": 4096,
                  "test.frame_sampler_interval": 1,
                  "train_dataset.data_root": root,
                  "train_dataset.human": "CoreView_999",
                  "train_dataset.ann_file": f"{root}/annots.npy",
                  "test_dataset.data_root": root,
                  "test_dataset.human": "CoreView_999",
                  "test_dataset.ann_file": f"{root}/annots.npy"})
    kv.update(extra)
    return [str(x) for k, v in kv.items() for x in (k, v)]


def cfgs(roots, **extra):
    """The JAX package's and the port's config of the same command line:
    --type sets task "run" before the YAML (the YAML's task wins), then
    the opts, with perturb off as both run.py's _setup do."""
    out = []
    for pkg, make in (("jax", j_make_cfg), ("torch", t_make_cfg)):
        cfg = make(CONFIG_313, opts(roots[pkg], **extra))
        cfg.perturb = 0
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def trained(roots, tmp_path_factory):
    """A checkpoint written by the JAX package (its init, alpha_fc's bias
    raised so the views are not empty) under data/trained_model/<task>/
    <exp_name> of a working directory that both packages run in."""
    work = tmp_path_factory.mktemp("work")
    jcfg, _ = cfgs(roots)
    init_fn, _ = j_build("network", jcfg.network_module, jcfg)
    params, bn = jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(3)))
    params["alpha_fc"]["b"] = params["alpha_fc"]["b"] + np.float32(3.0)
    j_save(str(work / jcfg.trained_model_dir), 0, params, bn, {},
           latest=True)
    return work


def test_evaluate_on_a_jax_checkpoint(roots, trained, root_run, monkeypatch):
    monkeypatch.chdir(trained)
    jcfg, tcfg = cfgs(roots)
    want = root_run.run_evaluate(jcfg)
    got = t_run.run_evaluate(tcfg, "cpu")
    assert set(got) == set(want) == {"mse", "psnr", "ssim"}
    assert np.isfinite(got["psnr"]) and 0 <= got["ssim"] <= 1
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_TOL
    assert abs(got["ssim"] - want["ssim"]) <= SSIM_TOL
    # the loaded weights render something else than the seeded ones
    shutil.move(trained / tcfg.trained_model_dir, trained / "moved")
    try:
        seeded = t_run.run_evaluate(tcfg, "cpu")
    finally:
        shutil.move(trained / "moved", trained / tcfg.trained_model_dir)
    assert abs(seeded["psnr"] - got["psnr"]) > 0.1


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("mode,extra", [
    ("vis_novel_view", {}), ("vis_novel_pose", {}),
    ("vis_rotate_smpl", {"test.sampler": "FrameSampler",
                         "test.frame_sampler_interval": 48}),
    ("vis_mesh", {"mesh_th": 0.5})])
def test_visualize_writes_what_root_run_writes(roots, trained, root_run,
                                               monkeypatch, tmp_path, mode,
                                               extra):
    written = {}
    ckpt = cfgs(roots)[0].trained_model_dir
    for pkg, fn in (("jax", lambda c: root_run.run_visualize(c)),
                    ("torch", lambda c: t_run.run_visualize(c, "cpu"))):
        work = tmp_path / pkg
        shutil.copytree(trained / ckpt, work / ckpt)
        monkeypatch.chdir(work)
        cfg = cfgs(roots, **{mode: True}, **extra)[pkg == "torch"]
        fn(cfg)
        written[pkg] = [f for f in _files(work) if "trained_model" not in f]
    assert written["torch"] == written["jax"] and written["torch"]
    if mode == "vis_mesh":
        from neuralbody_tpu_torch.utils.mesh_io import load_ply
        assert all(f.endswith(".ply") for f in written["torch"])
        for f in written["torch"]:
            v, t = load_ply(str(tmp_path / "torch" / f))
            assert len(v) > 0 and len(t) > 0


def test_dataset_and_network(roots, trained, monkeypatch, capsys):
    monkeypatch.chdir(trained)
    _, tcfg = cfgs(roots)
    assert t_run.run_dataset(tcfg) == tcfg.ep_iter
    assert "dataset OK" in capsys.readouterr().out
    times = t_run.run_network(tcfg, "cpu")
    assert len(times) == 1 and times[0] > 0   # two test images: one timed


def test_light_stage_writes_cmd_occupancys_npz(roots, root_run, tmp_path):
    """run_light_stage over pointcloud/*.ply against the repository tool's
    cmd_occupancy on the same cloud (res 256, as run.py passes)."""
    tools = _load("root_dataset_tools",
                  os.path.join(REPO, "tools", "dataset_tools.py"))
    root = tmp_path / "stage"
    (root / "pointcloud").mkdir(parents=True)
    rng = np.random.RandomState(0)
    pts = rng.randn(300, 3)
    pts = 0.4 * pts / np.linalg.norm(pts, axis=1, keepdims=True)
    save_ply(str(root / "pointcloud" / "000.ply"), pts)
    _, tcfg = cfgs(roots)
    tcfg.train_dataset.data_root = str(root)
    out = t_run.run_light_stage(tcfg)
    assert out == [str(root / "voxel" / "000.npz")]
    tools.cmd_occupancy(types.SimpleNamespace(
        ply=str(root / "pointcloud" / "000.ply"), res=256,
        out=str(tmp_path / "want.npz")))
    got, want = np.load(out[0]), np.load(tmp_path / "want.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
    assert np.unpackbits(got["compressed_occupancies"]).sum() > 0
    # no cloud: nothing written
    tcfg.train_dataset.data_root = str(tmp_path / "empty")
    assert t_run.run_light_stage(tcfg) == []


def test_evaluate_nv_equals_jax(roots, root_run, tmp_path):
    """Saved renders (each camera's "render" is the next camera's image)
    scored by both packages."""
    summaries = []
    for pkg in ("jax", "torch"):
        root = roots[pkg]
        pred = tmp_path / pkg
        annots = np.load(f"{root}/annots.npy", allow_pickle=True).item()
        for fi, frame in enumerate(annots["ims"][:2]):
            for ci in range(len(frame["ims"])):
                (pred / f"frame_{fi}").mkdir(parents=True, exist_ok=True)
                other = frame["ims"][(ci + 1) % len(frame["ims"])]
                shutil.copy(os.path.join(root, other),
                            pred / f"frame_{fi}" / f"pred_{ci + 1}.jpg")
        cfg = cfgs(roots, pred_result_dir=str(pred))[pkg == "torch"]
        cfg.result_dir = str(tmp_path / f"result_{pkg}")
        summaries.append(root_run.run_evaluate_nv(cfg) if pkg == "jax"
                         else t_run.run_evaluate_nv(cfg))
    want, got = summaries
    for k in want:
        assert np.isfinite(got[k])
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-9)


def test_main_parses_device_and_type(roots, trained, monkeypatch):
    monkeypatch.chdir(trained)
    argv = ["--type", "dataset", "--cfg_file", CONFIG_313,
            *opts(roots["torch"])]
    assert t_run.main(["--device", "cpu", *argv]) == 4
    cfg, args, device = t_run.setup(argv)
    assert (args.type, device, cfg.perturb, cfg.task) == (
        "dataset", None, 0, "if_nerf")
    with pytest.raises(SystemExit, match="unknown --type"):
        t_run.main(["--type", "nope", "--cfg_file", CONFIG_313])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_run.main(["--type", "evaluate", *argv[2:]])
