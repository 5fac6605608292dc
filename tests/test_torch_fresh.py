"""Training from a config on the CPU (train/fresh.ConfigRun) against the
JAX package on the same config, data and weights: make_cfg of
configs/zju_mocap_exp/latent_xyzc_313.yaml and of configs/nerf/nerf_313.yaml
over tests/fake_data.py's ZJU tree at tests/test_datasets.py's size (64^2
views, 400 vertices, 2 cm voxels, 64 rays), the registered factories in
both packages, the loaders' batches (equal bit for bit:
test_torch_loader.py), two dispatches of G = 2 steps: stacked on the host
(bank=False) against the JAX package's train_step_scan, and through the
device geometry bank and the prefetcher (the default) against its
train_step_scan_banked; the two paths of the port against each other; and
the bench's fresh half on a tiny SyntheticDataset.

Tolerances, and why: the port's dispatches against the JAX package's
train_step_scan (train_step_scan_banked) on the same batches (the same
frames in both banks), from the JAX factory's weights
carried over by utils/transplant.params_from_jax, at test_torch_scan.py's
tolerances for train_step_scan (the loss of every step at rtol 1e-5; the
params within a mean of 0.01 * lr * steps and a maximum of lr * steps; the
Adam moments within 5e-2 and the BN running stats within 1e-2 of scale;
its docstring says why free-running steps drift apart that far). The NeRF
config runs with its perturbation off, so nothing is random in either
package, at the same tolerances. The banked path against the stacked one
is bit for bit: on the CPU both run train_steps' loop on the same numbers.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuralbody_tpu.datasets  # noqa: F401  (registers plugins)
from neuralbody_tpu.parallel.geom import GeomBank as JGeomBank
import neuralbody_tpu.models  # noqa: F401
import neuralbody_tpu.renderer  # noqa: F401
from neuralbody_tpu.config import build as j_build
from neuralbody_tpu.config import make_cfg as j_make_cfg
from neuralbody_tpu.datasets import loader as j_loader
from neuralbody_tpu.train import optimizer as j_opt
from neuralbody_tpu.train import step as j_step
import neuralbody_tpu_torch.datasets  # noqa: F401  (registers plugins)
import neuralbody_tpu_torch.models  # noqa: F401
import neuralbody_tpu_torch.renderer  # noqa: F401
from neuralbody_tpu_torch import bench
from neuralbody_tpu_torch.config import make_cfg as t_make_cfg
from neuralbody_tpu_torch.parallel import transfer
from neuralbody_tpu_torch.train import fresh
from neuralbody_tpu_torch.train.optimizer import tree_leaves
from neuralbody_tpu_torch.utils.synthetic import SyntheticDataset
from neuralbody_tpu_torch.utils.transplant import params_from_jax
from test_torch_datasets import small_cfg
from test_torch_train import (_close_to_scale, _compare_moments, _flat,
                              _param_diffs)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, DISPATCHES = 2, 2
CONFIGS = {
    "latent_xyzc": ("configs/zju_mocap_exp/latent_xyzc_313.yaml", []),
    # the NeRF MLPs at the YAML's width, fewer samples; perturbation off
    "nerf": ("configs/nerf/nerf_313.yaml",
             ["N_samples", "8", "N_importance", "8", "perturb", "0"]),
}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    from fake_data import make_fake_zju
    return {pkg: make_fake_zju(str(tmp_path_factory.mktemp(pkg)
                                   / "CoreView_999"))
            for pkg in ("jax", "torch")}


def _cfg(make_cfg, root, family):
    """The family's YAML at tests/test_datasets.py's size over `root`."""
    path, opts = CONFIGS[family]
    cfg = make_cfg(os.path.join(ROOT, path), opts=opts + [
        "tpu.steps_per_dispatch", str(G), "ep_iter", str(G * DISPATCHES)])
    small = small_cfg(make_cfg, root)
    for k in ("H", "W", "ratio", "N_rand", "num_train_frame",
              "training_view", "voxel_size", "nv", "train_dataset",
              "test_dataset"):
        cfg[k] = small[k]
    cfg.tpu.chunk_rays = small.tpu.chunk_rays
    return cfg


def _jax_run(cfg, banked=False):
    """The JAX package's factories, weights, loader batches and G-step
    scans (banked: the loader's attach_geom=False, a JAX GeomBank over its
    geom_cache and train_step_scan_banked): (initial params, initial BN
    stats, batches, hat_state, final params, BN stats, optimizer state,
    per-step losses)."""
    ds = j_loader.make_dataset(cfg, "train")
    static = j_build("model_static", cfg.network_module, cfg, ds)
    settings = j_build("renderer", cfg.renderer_module, cfg, static)
    init_fn, _ = j_build("network", cfg.network_module, cfg)
    params, bn = jax.tree.map(np.asarray,
                              init_fn(jax.random.PRNGKey(cfg.seed)))
    tx, _ = j_opt.make_optimizer(cfg)
    hs, cache = {}, {}
    loaded = list(j_loader.make_data_loader(
        cfg, "train", dataset=ds, hat_state=hs, attach_geom=not banked,
        geom_cache=cache))
    batches = [b for b, _ in loaded]
    bank = JGeomBank(cache, capacity=8)
    if hs:
        settings = settings._replace(hat_rows_caps=tuple(hs["rows_caps"]))
    p, s, o, losses = params, bn, tx.init(params), []
    for d in range(DISPATCHES):
        group = slice(d * G, (d + 1) * G)
        stacked = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)),
                               *batches[group])
        keys = jax.random.split(jax.random.PRNGKey(d), G)
        if banked:
            arrays, stacked["geom_rows"] = bank.rows(
                [m["geom_keys"] for _, m in loaded[group]])
            p, s, o, st = j_step.train_step_scan_banked(
                p, s, o, stacked, keys, arrays, settings, tx)
        else:
            p, s, o, st = j_step.train_step_scan(p, s, o, stacked, keys,
                                                 settings, tx)
        losses += np.asarray(st["loss"]).tolist()
    return params, bn, batches, hs, p, s, o, losses


def _run_from(cfg, jp0, jbn0, bank):
    """The port's ConfigRun with the JAX factory's weights."""
    run = fresh.ConfigRun(cfg, device="cpu", bank=bank)
    assert run.G == G
    tp, tbn = params_from_jax(jp0, jbn0)
    assert ([t.shape for t in tree_leaves(run.params)]
            == [t.shape for t in tree_leaves(tp)])
    with torch.no_grad():
        for t, s in zip(tree_leaves(run.params), tree_leaves(tp)):
            t.copy_(s)
    run.bn_stats = tbn
    return run


def _matches_jax(roots, family, banked):
    jp0, jbn0, jbatches, jhs, jp, jbn, jopt, jlosses = _jax_run(
        _cfg(j_make_cfg, roots["jax"], family), banked)

    cfg = _cfg(t_make_cfg, roots["torch"], family)
    run = _run_from(cfg, jp0, jbn0, banked)
    loader = list(run.loader(0))
    assert run.hat_state == jhs and len(loader) == G * DISPATCHES
    for (b, _), jb in zip(loader, jbatches):
        assert sorted(b) == sorted(jb)
        np.testing.assert_array_equal(b["rgb"], jb["rgb"])
    losses = [x for st in run.epoch(0, loader=loader)
              for x in st["loss"].tolist()]

    assert run.opt.count == G * DISPATCHES
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    d = _param_diffs(jp, run.params)
    lr_steps = float(cfg.train.lr) * G * DISPATCHES
    assert d.mean() <= 0.01 * lr_steps
    assert d.max() <= lr_steps
    _compare_moments(jopt[-1][0], run.opt, 5e-2)
    for (path, j), (_, t) in zip(_flat(jbn), _flat(run.bn_stats)):
        _close_to_scale(t, j, 1e-2, 1e-5, what=path)
    return run


@pytest.mark.parametrize("family", ["latent_xyzc", "nerf"])
def test_config_run_matches_jax(roots, family):
    """The stacked path (bank=False) against train_step_scan."""
    _matches_jax(roots, family, banked=False)


def test_banked_config_run_matches_jax(roots):
    """The default path (the device bank, the prefetcher) against
    train_step_scan_banked, the same frames installed in both banks."""
    run = _matches_jax(roots, "latent_xyzc", banked=True)
    assert run.bank.installs == len(run.geom_cache) > 0
    assert run.staging.copies == DISPATCHES


def test_banked_config_run_is_the_stacked_one_on_the_cpu(roots):
    cfg = _cfg(t_make_cfg, roots["torch"], "latent_xyzc")
    runs = []
    for bank in (True, False):
        run = fresh.ConfigRun(cfg, device="cpu", bank=bank)
        losses = torch.cat([st["loss"] for st in run.epoch(0)])
        runs.append((run, losses))
    (a, la), (b, lb) = runs
    assert a.bank is not None and b.bank is None and len(la) == G * DISPATCHES
    assert torch.equal(la, lb)
    for x, y in zip(tree_leaves([a.params, a.bn_stats, a.opt.mu, a.opt.nu]),
                    tree_leaves([b.params, b.bn_stats, b.opt.mu, b.opt.nu])):
        assert torch.equal(x, y)


def test_bench_fresh_half_on_the_cpu():
    """measure_fresh on a tiny SyntheticDataset (the loader's thread, one
    timed dispatch) fills the bench line's fresh keys."""
    ds = SyntheticDataset(n_frames=2, n_cams=2, hw=(32, 32), n_verts=300,
                          voxel_size=0.03, n_rand=16)
    out = bench.measure_fresh(device="cpu", num_workers=0, n_disp=1,
                              dataset=ds, n_samples=4)
    assert out["fresh_rays_per_s"] > 0
    assert out["fresh_h2d_bytes_per_dispatch"] > 0
    assert out["fresh_device_busy_share"] is None      # no card, no trace
    line = bench.summary({"broadcast_rays_per_s": 4 * out[
        "fresh_rays_per_s"]}, {"broadcast_rays_per_s": 1.0}, fresh=out)
    assert line["value"] == out["fresh_rays_per_s"]
    assert line["vs_baseline"] == pytest.approx(line["value"] / 2400)
    assert line["fresh_over_broadcast"] == pytest.approx(0.25)
    assert (line["fresh_h2d_bytes_per_dispatch"]
            == out["fresh_h2d_bytes_per_dispatch"])


def test_config_run_raises_without_a_card():
    """Its entry point runs on the card unless given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fresh.ConfigRun(t_make_cfg(os.path.join(
            ROOT, CONFIGS["latent_xyzc"][0])))


def test_tail_group_is_dropped_unless_the_epoch_is_shorter():
    """G batches a dispatch; a tail shorter than G is dropped after a full
    group, and dispatched when the epoch is shorter than G (the JAX
    Trainer's rule)."""
    run = fresh.ConfigRun.__new__(fresh.ConfigRun)
    run.G, run.bank = 3, None
    run.dispatch = lambda batches: len(batches)
    for n, want in ((7, [3, 3]), (6, [3, 3]), (2, [2]), (0, [])):
        assert list(run.epoch(0, loader=[({}, {})] * n)) == want, n


def test_banked_tail_group_is_dropped_unless_the_epoch_is_shorter():
    """The same rule on the banked path, through the prefetcher: the groups
    come out in order with their frames' keys."""
    run = fresh.ConfigRun.__new__(fresh.ConfigRun)
    run.G, run.bank = 3, object()
    run.staging = transfer.StagingRing("cpu")
    run.stage = lambda item: (len(item[0]), item[1])
    run.dispatch_staged = lambda staged: staged
    for n, want in ((7, [3, 3]), (6, [3, 3]), (2, [2]), (0, [])):
        loader = [({}, {"geom_keys": [i]}) for i in range(n)]
        got = list(run.epoch(0, loader=loader))
        assert [g for g, _ in got] == want, n
        assert [k for _, keys in got for k in keys] == [
            [i] for i in range(sum(want))], n


def test_stack_batches():
    """numpy leaves stack as numpy (their dtype kept: StepGraph's to_device
    widens uint16), tensors as tensors."""
    a = {"x": np.zeros((1, 4), np.uint16), "geom": {"y": np.ones(3)},
         "t": torch.zeros(2)}
    b = {"x": np.ones((1, 4), np.uint16), "geom": {"y": np.zeros(3)},
         "t": torch.ones(2)}
    s = fresh.stack_batches([a, b])
    assert s["x"].shape == (2, 1, 4) and s["x"].dtype == np.uint16
    np.testing.assert_array_equal(s["geom"]["y"], [np.ones(3), np.zeros(3)])
    assert torch.equal(s["t"], torch.tensor([[0.0, 0.0], [1.0, 1.0]]))

