"""Training from a config on the card (train/fresh.ConfigRun): the 313
config over a small SyntheticDataset (tools/graph_noise.config_case
"small": 2 frames x 2 cameras at 64^2, 64 rays x 16 samples, 500 vertices,
2 cm voxels), its loader's batches G = 2 a dispatch through
train_step_scan's StepGraph, against eager train_steps on the same batches.
Skips where no NVIDIA GPU is present; run on the card with
`python -m pytest --noconftest tests/test_torch_fresh_cuda.py -q`.

Tolerances: a graphed run against one eager run of the same four steps
from the same state, per leaf by the relative L2 distance (tools/graph_noise
check), at most TOL of its group: 4x the farthest pair of eager runs of
these steps in two calls of 32 runs (the "fresh" scene of
tools/graph_noise.py on an H100 80GB HBM3 at 700 W), the larger of bf16's
and f32's. A run whose second dispatch
replays the first's batches (a stale copy) must be over TOL by STALE_MIN in
its worst group. The pool's batches equal the thread loader's bit for bit.
"""
import numpy as np
import pytest
import torch

from neuralbody_tpu_torch.datasets.loader import WorkerPool, make_data_loader
from neuralbody_tpu_torch.ops import conv_kernel, hat_kernel
from neuralbody_tpu_torch.tools.graph_noise import (check, config_case,
                                                    config_run, run_state)
from neuralbody_tpu_torch.train.step import train_steps

pytestmark = pytest.mark.cuda

G = 2
TOL = {"params": 0.2, "mu": 0.6, "nu": 0.45, "bn": 0.019, "loss": 8e-6}
STALE_MIN = 10


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    hat_kernel.build()
    conv_kernel.build()
    return torch.device("cuda")


def _case(dtype):
    """The config, the dataset and epoch 0's four batches (thread loader),
    with the plan sizes they derive."""
    cfg, ds = config_case("small", dtype, G, 2 * G)
    hs = {}
    batches = list(make_data_loader(cfg, "train", dataset=ds, hat_state=hs))
    return cfg, ds, batches, hs


def _graphed(cfg, ds, dev, hat_state, dispatches):
    """A ConfigRun from the seeded state over the given dispatches."""
    run = config_run(cfg, ds, dev)
    run.hat_state.update(hat_state)
    losses = [run.dispatch(group)["loss"] for group in dispatches]
    assert run.opt.step_graph.captures == 1
    return run_state(run.params, run.bn_stats, run.opt, torch.cat(losses))


def _eager(cfg, ds, dev, hat_state, steps):
    run = config_run(cfg, ds, dev)
    settings = run.settings._replace(
        hat_rows_caps=tuple(hat_state["rows_caps"]))
    bn, st = train_steps(run.params, run.bn_stats, run.opt, steps, settings,
                         device=dev)
    return run_state(run.params, bn, run.opt, st["loss"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loader_batches_through_the_graph_match_eager_steps(dev, dtype):
    cfg, ds, batches, hs = _case(dtype)
    steps = [b for b, _ in batches]
    assert len({b["rgb"].tobytes() for b in steps}) == 2 * G   # distinct
    groups, over = check(
        _graphed(cfg, ds, dev, hs, [steps[:G], steps[G:]]),
        _eager(cfg, ds, dev, hs, steps), TOL)
    assert not over, (over[:5], groups)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_stale_copy_is_over_the_tolerance(dev, dtype):
    """The second dispatch fed the first's batches, as a copy that did not
    happen would leave them: over TOL by STALE_MIN in the worst group."""
    cfg, ds, batches, hs = _case(dtype)
    steps = [b for b, _ in batches]
    groups, over = check(
        _graphed(cfg, ds, dev, hs, [steps[:G], steps[:G]]),
        _eager(cfg, ds, dev, hs, steps), TOL)
    assert max(g["ratio"] for g in groups.values()) >= STALE_MIN, groups


def test_pool_beside_the_card(dev):
    """Two spawned workers while this process holds a CUDA context: the
    thread loader's batches bit for bit, trained through one capture."""
    cfg, ds, batches, hs = _case("bfloat16")
    pool = WorkerPool(ds, 2)
    try:
        run = config_run(cfg, ds, dev, pool)
        got = list(run.loader(0))
        stats = list(run.epoch(0, loader=got))
    finally:
        pool.shutdown()
    assert run.hat_state == hs and len(got) == len(batches) == 2 * G
    for (a, _), (b, _) in zip(batches, got):
        assert sorted(a) == sorted(b)
        assert sorted(a["geom"]) == sorted(b["geom"])
        for k in a:
            for x, y in (zip(a[k].values(), b[k].values()) if k == "geom"
                         else [(a[k], b[k])]):
                np.testing.assert_array_equal(x, y, err_msg=k)
    assert run.opt.step_graph.captures == 1 and len(stats) == 2
    assert all(torch.isfinite(s["loss"]).all() for s in stats)
