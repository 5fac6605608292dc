"""The training harness on the CPU (train/trainer.Trainer, the port's
train_net entry point) against tests/test_harness.py's checks and against
the JAX package's Trainer on the same config, data and weights.

The config is configs/zju_mocap_exp/latent_xyzc_313.yaml at
tests/test_harness.py's size (tests/fake_data.make_fake_zju: 64^2 views,
400 vertices, 2 cm voxels, 64 rays, two training views and one test view,
two frames), G = 2 steps a dispatch, epochs of 4 steps, the loader's
thread, one device in the JAX package too (its rays are then not sharded
over the CPU's virtual devices).

Tolerances, and why: one epoch of the port's Trainer against one of the
JAX Trainer from the JAX Trainer's initial weights (utils/transplant
.params_from_jax) at tests/test_torch_fresh.py's tolerances (every loss at
rtol 1e-5; params within a mean of 0.01 * lr * steps and a maximum of
lr * steps; Adam's moments within 5e-2 and the BN stats within 1e-2 of
scale; free-running steps of the random-weight model drift apart so far,
test_torch_scan.py says why). validate() with the JAX Trainer's fitted
weights: PSNR within 1e-4 dB and SSIM within 1e-5 of the JAX Trainer's
(both render in f32 with batch-statistics BN: the renders agree to ~1e-6),
and each comparison PNG within 1/255 (a value a rounding away). A resumed
fit and an uninterrupted one are equal bit for bit: on the CPU both run
the same operations on the same numbers.
"""
import os
import signal

import jax
import numpy as np
import pytest
import torch

import neuralbody_tpu.train.trainer as j_trainer
from neuralbody_tpu.config import make_cfg as j_make_cfg
from neuralbody_tpu_torch import train_net
from neuralbody_tpu_torch.config import make_cfg as t_make_cfg
from neuralbody_tpu_torch.train import checkpoint, trainer as t_trainer
from neuralbody_tpu_torch.train.optimizer import tree_leaves
from neuralbody_tpu_torch.utils.transplant import params_from_jax
from test_torch_train import (_close_to_scale, _compare_moments, _flat,
                              _param_diffs)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs/zju_mocap_exp/latent_xyzc_313.yaml")
G, STEPS = 2, 4


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    from fake_data import make_fake_zju
    return {pkg: make_fake_zju(str(tmp_path_factory.mktemp(pkg)
                                   / "CoreView_999"))
            for pkg in ("jax", "torch")}


def harness_cfg(make_cfg, root, out, path=CONFIG, opts=()):
    """The YAML at tests/test_harness.py's size over the fake ZJU tree at
    `root`, its checkpoints, records and results under `out`."""
    cfg = make_cfg(path, opts=["task", "if_nerf", "exp_name", "t",
                               *opts])
    cfg.H = cfg.W = 64
    cfg.ratio = 1.0
    cfg.N_rand = 64
    cfg.num_train_frame = 2
    cfg.training_view = [0, 1]
    cfg.voxel_size = [0.02, 0.02, 0.02]
    cfg.nv = 400
    cfg.tpu.chunk_rays = 256
    cfg.tpu.steps_per_dispatch = G
    cfg.tpu.num_devices = 1
    cfg.train.num_workers = 0
    cfg.ep_iter = STEPS
    cfg.train.epoch = 2
    cfg.save_ep = 1
    cfg.save_latest_ep = 1
    cfg.eval_ep = 100   # off during fit
    cfg.log_interval = 1
    cfg.test.frame_sampler_interval = 1
    cfg.train_dataset.data_root = root
    cfg.train_dataset.human = "CoreView_999"
    cfg.train_dataset.ann_file = f"{root}/annots.npy"
    cfg.test_dataset.update(cfg.train_dataset)
    cfg.test_dataset.split = "test"
    for k in ("trained_model_dir", "record_dir", "result_dir"):
        cfg[k] = os.path.join(str(out), k)
    return cfg


def _state(t):
    return tree_leaves([t.params, t.bn_stats, t.opt.mu, t.opt.nu])


def _load_params(trainer, jp, jbn):
    """Copy JAX params into the port Trainer's own tensors; take its BN
    stats."""
    tp, tbn = params_from_jax(jp, jbn)
    with torch.no_grad():
        for a, b in zip(tree_leaves(trainer.params), tree_leaves(tp)):
            a.copy_(b)
        for a, b in zip(tree_leaves(trainer.bn_stats), tree_leaves(tbn)):
            a.copy_(b)


@pytest.fixture(scope="module")
def jax_run(roots, tmp_path_factory):
    """The JAX Trainer: its initial weights, one epoch (every step's loss
    recorded), its state after it, validate() and its comparison PNGs."""
    out = tmp_path_factory.mktemp("jax_out")
    cfg = harness_cfg(j_make_cfg, roots["jax"], out)
    losses = []
    make = j_trainer.make_sharded_scan_step_banked

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            res = step(*args)
            losses.extend(np.asarray(res[3]["loss"]).tolist())
            return res
        return run

    j_trainer.make_sharded_scan_step_banked = recording
    try:
        t = j_trainer.Trainer(cfg)
        p0, bn0 = jax.tree.map(np.asarray, (t.params, t.bn_stats))
        t.train_epoch(0)
    finally:
        j_trainer.make_sharded_scan_step_banked = make
    metrics = t.validate()
    return dict(cfg=cfg, p0=p0, bn0=bn0, losses=losses,
                params=jax.tree.map(np.asarray, t.params),
                bn=jax.tree.map(np.asarray, t.bn_stats),
                opt=jax.tree.map(np.asarray, t.opt_state), metrics=metrics)


@pytest.fixture()
def cfg(roots, tmp_path):
    return harness_cfg(t_make_cfg, roots["torch"], tmp_path)


def test_fit_checkpoints_and_validate(cfg, monkeypatch):
    trainer = t_trainer.Trainer(cfg, device="cpu")
    trainer.fit()
    ckpts = os.listdir(cfg.trained_model_dir)
    assert "latest.ckpt" in ckpts
    assert any(c[0].isdigit() for c in ckpts)

    metrics = trainer.validate()
    assert np.isfinite(metrics["psnr"])
    assert 0 <= metrics["ssim"] <= 1
    comp = os.path.join(cfg.result_dir, "comparison")
    assert len(os.listdir(comp)) > 0

    # the test dataset and the render settings persist: a second validate
    # builds neither again
    built = []
    make = t_trainer.make_dataset
    monkeypatch.setattr(t_trainer, "make_dataset",
                        lambda *a: built.append(a) or make(*a))
    ds, settings = trainer.test_dataset, trainer.run.settings
    trainer.validate()
    assert built == []
    assert trainer.test_dataset is ds and trainer.run.settings is settings


def test_resume_continues_epoch(cfg):
    t1 = t_trainer.Trainer(cfg, device="cpu")
    t1.fit()
    t2 = t_trainer.Trainer(cfg, device="cpu")
    before = [x.clone() for x in _state(t2)]
    addresses = [x.data_ptr() for x in _state(t2)]
    assert t2.resume() == cfg.train.epoch
    assert t2.recorder.step == t1.recorder.step == cfg.train.epoch * STEPS
    assert t2.opt.count == t1.opt.count
    for a, b in zip(_state(t1), _state(t2)):
        assert torch.equal(a, b)
    # restored in place, and not the fresh init
    assert [x.data_ptr() for x in _state(t2)] == addresses
    assert any(not torch.equal(a, b) for a, b in zip(before, _state(t2)))


def test_resume_equals_an_uninterrupted_fit(roots, tmp_path):
    whole = t_trainer.Trainer(harness_cfg(t_make_cfg, roots["torch"],
                                          tmp_path / "a"), device="cpu")
    whole.fit()
    cfg = harness_cfg(t_make_cfg, roots["torch"], tmp_path / "b")
    cfg.train.epoch = 1
    t_trainer.Trainer(cfg, device="cpu").fit()
    cfg.train.epoch = 2
    resumed = t_trainer.Trainer(cfg, device="cpu")
    resumed.fit()
    assert resumed.recorder.step == whole.recorder.step
    assert resumed.opt.count == whole.opt.count == 2 * STEPS
    for a, b in zip(_state(whole), _state(resumed)):
        assert torch.equal(a, b)


def test_sigterm_checkpoints_at_the_epoch_boundary(cfg):
    """A SIGTERM during epoch 0 ends fit after that epoch with latest.ckpt
    of epoch 0, and the handlers in place before fit are back."""
    trainer = t_trainer.Trainer(cfg, device="cpu")
    dispatch = trainer.run.dispatch_staged

    def signalled(staged):
        os.kill(os.getpid(), signal.SIGTERM)
        return dispatch(staged)

    trainer.run.dispatch_staged = signalled
    seen = []
    prev = {s: signal.signal(s, lambda *a: seen.append(a))
            for s in (signal.SIGTERM, signal.SIGINT)}
    handlers = {s: signal.getsignal(s) for s in prev}
    try:
        trainer.fit()
        assert {s: signal.getsignal(s) for s in prev} == handlers
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
    assert seen == []
    assert trainer.recorder.step == STEPS     # one epoch, then the stop
    assert sorted(os.listdir(cfg.trained_model_dir)) == ["latest.ckpt"]
    raw = checkpoint.read_checkpoint(
        os.path.join(cfg.trained_model_dir, "latest.ckpt"))
    assert raw["epoch"] == 0 and raw["recorder"]["step"] == STEPS


def test_trainer_epoch_matches_jax(roots, tmp_path, jax_run):
    cfg = harness_cfg(t_make_cfg, roots["torch"], tmp_path)
    trainer = t_trainer.Trainer(cfg, device="cpu")
    _load_params(trainer, jax_run["p0"], jax_run["bn0"])
    losses = []
    dispatch = trainer.run.dispatch_staged

    def recording(staged):
        stats = dispatch(staged)
        losses.extend(stats["loss"].tolist())
        return stats

    trainer.run.dispatch_staged = recording
    trainer.train_epoch(0)
    assert trainer.recorder.step == trainer.opt.count == STEPS
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    d = _param_diffs(jax_run["params"], trainer.params)
    lr_steps = float(cfg.train.lr) * STEPS
    assert d.mean() <= 0.01 * lr_steps
    assert d.max() <= lr_steps
    _compare_moments(jax_run["opt"][-1][0], trainer.opt, 5e-2)
    for (path, j), (_, t) in zip(_flat(jax_run["bn"]),
                                 _flat(trainer.bn_stats)):
        _close_to_scale(t, j, 1e-2, 1e-5, what=path)


def test_validate_matches_jax(roots, tmp_path, jax_run):
    import cv2
    cfg = harness_cfg(t_make_cfg, roots["torch"], tmp_path)
    trainer = t_trainer.Trainer(cfg, device="cpu")
    _load_params(trainer, jax_run["params"], jax_run["bn"])
    metrics = trainer.validate()
    want = jax_run["metrics"]
    assert abs(metrics["psnr"] - want["psnr"]) <= 1e-4
    assert abs(metrics["ssim"] - want["ssim"]) <= 1e-5
    ours = os.path.join(cfg.result_dir, "comparison")
    theirs = os.path.join(jax_run["cfg"].result_dir, "comparison")
    names = sorted(os.listdir(theirs))
    assert names and sorted(os.listdir(ours)) == names
    for name in names:
        a = cv2.imread(os.path.join(ours, name)).astype(int)
        b = cv2.imread(os.path.join(theirs, name)).astype(int)
        assert np.abs(a - b).max() <= 1, name


def test_nerf_family_trains_and_validates(roots, tmp_path):
    """The NeRF baseline's config through the Trainer (eager steps, the
    perturbation on): the loss is finite and validate() scores it."""
    cfg = harness_cfg(t_make_cfg, roots["torch"], tmp_path,
                      path=os.path.join(ROOT, "configs/nerf/nerf_313.yaml"),
                      opts=["N_samples", "8", "N_importance", "8",
                            "netwidth", "32", "netwidth_fine", "32"])
    cfg.train.epoch = 1
    trainer = t_trainer.Trainer(cfg, device="cpu")
    trainer.fit()
    assert trainer.opt.count == STEPS and trainer.bn_stats == {}
    assert np.isfinite(trainer.recorder.scalars["loss"].median)
    metrics = trainer.validate()
    assert np.isfinite(metrics["psnr"]) and 0 <= metrics["ssim"] <= 1


def test_train_net_entry_point(roots, tmp_path, monkeypatch):
    """python -m neuralbody_tpu_torch.train_net --cfg_file ... --device cpu
    [opts]: fit, then validate; --test validates the latest checkpoint
    without training."""
    monkeypatch.chdir(tmp_path)
    root = roots["torch"]
    opts = ["H", "64", "W", "64", "ratio", "1.0", "N_rand", "64",
            "num_train_frame", "2", "training_view", "[0, 1]",
            "voxel_size", "[0.02, 0.02, 0.02]", "nv", "400",
            "tpu.chunk_rays", "256", "tpu.steps_per_dispatch", "2",
            "train.num_workers", "0", "ep_iter", "2", "train.epoch", "1",
            "test.frame_sampler_interval", "1", "exp_name", "cli",
            "train_dataset.data_root", root,
            "train_dataset.human", "CoreView_999",
            "train_dataset.ann_file", f"{root}/annots.npy",
            "test_dataset.data_root", root,
            "test_dataset.human", "CoreView_999",
            "test_dataset.ann_file", f"{root}/annots.npy"]
    train_net.main(["--cfg_file", CONFIG, "--device", "cpu", *opts])
    model_dir = tmp_path / "data/trained_model/if_nerf/cli"
    result = tmp_path / "data/result/if_nerf/cli/metrics.npy"
    assert (model_dir / "latest.ckpt").exists() and result.exists()
    result.unlink()
    stamp = (model_dir / "latest.ckpt").stat().st_mtime_ns
    train_net.main(["--cfg_file", CONFIG, "--test", "--device", "cpu",
                    *opts])
    assert result.exists()
    # no epoch ran: the checkpoint it resumed from stays as it was
    assert (model_dir / "latest.ckpt").stat().st_mtime_ns == stamp
    raw = checkpoint.read_checkpoint(str(model_dir / "latest.ckpt"))
    assert raw["epoch"] == 0 and raw["recorder"]["step"] == 2
