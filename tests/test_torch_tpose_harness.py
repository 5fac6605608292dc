"""The T-pose family through the port's harness on the CPU: its dataset
(datasets/tpose_dataset.py) against the JAX package's, the fixture writer
(utils/fake_zju.add_fake_warping) against tests/fake_data's, the config
resolving every module in the port's registry, a Trainer fit + validate as
tests/test_family_dispatch.py runs the JAX one, and the family's f32 under
a bf16 config.

Tolerances: the dataset's samples, the geometry and the fixture's arrays
bit for bit (the same numpy code, the same global seed); the bf16 config's
render equal to the f32 config's (the family ignores the compute dtype).
"""
import os

import numpy as np
import pytest
import torch

from fake_data import add_fake_warping as j_add_fake_warping
from fake_data import make_fake_zju as j_make_fake_zju
from neuralbody_tpu.config import make_cfg as j_make_cfg
from neuralbody_tpu_torch.config import make_cfg as t_make_cfg
from neuralbody_tpu_torch.utils import fake_zju

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs/tpose/tpose_313.yaml")
N_VERTS = 400


@pytest.fixture(scope="module")
def zju_root(tmp_path_factory):
    """tests/fake_data's sequence with its identity warp, frame 1's warped
    grid cut short on two axes (two frames of different extents: the
    dataset pads the smaller by its edge)."""
    root = j_make_fake_zju(str(tmp_path_factory.mktemp("zju")
                               / "CoreView_999"))
    j_add_fake_warping(root, n_verts=N_VERTS)
    with np.load(f"{root}/warping/1.npz") as z:
        w = {k: z[k] for k in z.files}
    w["ptot_pts"] = w["ptot_pts"][:-2, :, :-3] + 0.01
    np.savez_compressed(f"{root}/warping/1.npz", **w)
    return root


def tpose_cfg(make_cfg, root, out=None, opts=()):
    """tests/test_family_dispatch.py's base_cfg over the T-pose YAML."""
    cfg = make_cfg(cfg_file=CONFIG, opts=["task", "if_nerf", "exp_name",
                                          "tpose", *opts])
    cfg.H = cfg.W = 64
    cfg.ratio = 1.0
    cfg.N_rand = 64
    cfg.N_samples = 8
    cfg.num_train_frame = 2
    cfg.training_view = [0, 1]
    cfg.voxel_size = [0.02, 0.02, 0.02]
    cfg.ptot_vsize = [0.04, 0.04, 0.04]
    cfg.nv = N_VERTS
    cfg.tpu.chunk_rays = 256
    cfg.tpu.steps_per_dispatch = 2
    cfg.tpu.num_devices = 1
    cfg.train.num_workers = 0
    cfg.ep_iter = 4
    cfg.train.epoch = 1
    cfg.save_ep = 10
    cfg.save_latest_ep = 10
    cfg.eval_ep = 100
    cfg.log_interval = 100
    cfg.test.frame_sampler_interval = 1
    cfg.train_dataset.data_root = root
    cfg.train_dataset.human = "CoreView_999"
    cfg.train_dataset.ann_file = f"{root}/annots.npy"
    cfg.test_dataset.update(cfg.train_dataset)
    cfg.test_dataset.split = "test"
    if out is not None:
        for k in ("trained_model_dir", "record_dir", "result_dir"):
            cfg[k] = os.path.join(str(out), k)
    return cfg


def test_fake_warping_writes_the_test_modules_arrays(tmp_path):
    for add, d in ((j_add_fake_warping, "jax"),
                   (fake_zju.add_fake_warping, "torch")):
        os.makedirs(tmp_path / d)
        add(str(tmp_path / d), n_frames=2, n_verts=N_VERTS)
    np.testing.assert_array_equal(np.load(tmp_path / "jax/tvertices.npy"),
                                  np.load(tmp_path / "torch/tvertices.npy"))
    for i in range(2):
        a, b = (np.load(tmp_path / d / f"warping/{i}.npz")
                for d in ("jax", "torch"))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("split", ["train", "test"])
def test_dataset_samples_equal_the_jax_packages(zju_root, split):
    from neuralbody_tpu.datasets.loader import make_dataset as j_make
    from neuralbody_tpu_torch.datasets.loader import make_dataset as t_make
    jds = j_make(tpose_cfg(j_make_cfg, zju_root), split)
    tds = t_make(tpose_cfg(t_make_cfg, zju_root), split)
    assert type(tds).__name__ == "TposeDataset" and tds.num_geoms == 1
    assert tds.ptot_shape == jds.ptot_shape
    assert tds.tgeo.out_sh == jds.tgeo.out_sh
    assert tds.tgeo.site_caps == jds.tgeo.site_caps
    np.testing.assert_array_equal(tds.tgeo.tbounds, jds.tgeo.tbounds)
    assert len(tds) == len(jds)
    frames = set()
    for index in range(len(tds)):
        np.random.seed(index)
        js = jds[index]
        np.random.seed(index)
        ts = tds[index]
        assert sorted(ts) == sorted(js)
        assert int(ts["geom_key"]) == -1
        frames.add(int(ts["frame_index"]))
        for k in js:
            if k == "geom":
                assert sorted(ts[k]) == sorted(js[k])
                for n in js[k]:
                    np.testing.assert_array_equal(ts[k][n], js[k][n], n)
            else:
                np.testing.assert_array_equal(ts[k], js[k], k)
                assert np.asarray(ts[k]).dtype == np.asarray(js[k]).dtype, k
    assert frames == {0, 1}
    # frame 1's grid was the smaller: padded by its edge to the largest
    w1 = tds._warp[1]["ptot_pts"]
    assert w1.shape[:3] == tds.ptot_shape
    np.testing.assert_array_equal(w1[-1], w1[-3])


def test_config_resolves_every_module_in_the_port():
    from neuralbody_tpu_torch import datasets, models, renderer  # noqa: F401
    from neuralbody_tpu_torch.config import resolve
    from neuralbody_tpu_torch.train import wrappers  # noqa: F401
    cfg = t_make_cfg(cfg_file=CONFIG)
    for kind, name in [("network", cfg.network_module),
                       ("renderer", cfg.renderer_module),
                       ("trainer", cfg.trainer_module),
                       ("dataset", cfg.train_dataset_module),
                       ("dataset", cfg.test_dataset_module),
                       ("model_static", cfg.network_module)]:
        assert resolve(kind, name) is not None


@pytest.mark.parametrize("workers", [0, 1])
def test_trainer_fits_and_validates(zju_root, tmp_path, monkeypatch,
                                    workers):
    """The family through the port's Trainer: an epoch of 4 steps (two
    dispatches of G = 2, the banked path with its one shared geometry, key
    -1, from the loader's thread or through a worker's ship-once protocol)
    and validate() with a finite PSNR."""
    from neuralbody_tpu_torch.train.trainer import Trainer
    cfg = tpose_cfg(t_make_cfg, zju_root, tmp_path)   # parent_cfg: the repo's
    cfg.train.num_workers = workers
    monkeypatch.chdir(tmp_path)
    trainer = Trainer(cfg, device="cpu")
    try:
        trainer.fit()
        assert trainer.recorder.step == 4
        assert trainer.run.bank.installs == 1
        metrics = trainer.validate()
    finally:
        trainer.close()
    assert np.isfinite(metrics["psnr"])


def test_f32_under_a_bf16_config(zju_root):
    """As in the JAX package, the family runs in f32 whatever
    cfg.tpu.compute_dtype says: the statics of a bf16 config carry no
    bf16, and its render is the f32 config's."""
    from neuralbody_tpu_torch.config import build
    from neuralbody_tpu_torch.datasets.loader import (make_data_loader,
                                                      make_dataset)
    from neuralbody_tpu_torch.train.step import eval_step
    cfgs = [tpose_cfg(t_make_cfg, zju_root, opts=["tpu.compute_dtype", m])
            for m in ("float32", "bfloat16")]
    ds = make_dataset(cfgs[0], "test")
    batch, _ = next(iter(make_data_loader(cfgs[0], "test", dataset=ds)))
    init, _ = build("network", "tpose_xyzc", cfgs[0])
    params, _ = init(torch.Generator().manual_seed(0), device="cpu")
    rets = []
    for cfg in cfgs:
        static = build("model_static", cfg.network_module, cfg, ds)
        assert static.encoder.compute_dtype == "float32"
        settings = build("renderer", cfg.renderer_module, cfg, static)
        rets.append(eval_step(params, batch, settings, device="cpu"))
    for k in rets[0]:
        assert torch.equal(rets[0][k], rets[1][k]), k
