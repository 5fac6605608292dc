"""Training from a config on the card (train/fresh.ConfigRun): the 313
config over a small SyntheticDataset (tools/graph_noise.config_case
"small": 2 frames x 2 cameras at 64^2, 64 rays x 16 samples, 500 vertices,
2 cm voxels), its loader's batches G = 2 a dispatch through
train_step_scan's StepGraph, against eager train_steps on the same batches;
and the banked path (parallel/geom.GeomBank, parallel/transfer's
prefetcher and staging ring, train_step_scan_banked): the graph's batch
buffers after each copy-in against the dispatch's host batch with a ring
smaller than the dispatch count, banked graphs against eager steps, and a
frame installed between replays. Skips where no NVIDIA GPU is present; run
on the card with
`python -m pytest --noconftest tests/test_torch_fresh_cuda.py -q`.

Tolerances: a graphed run against one eager run of the same four steps
from the same state, per leaf by the relative L2 distance (tools/graph_noise
check), at most TOL of its group: 4x the farthest pair of eager runs of
these steps in two calls of 32 runs (the "fresh" scene of
tools/graph_noise.py on an H100 80GB HBM3 at 700 W), the larger of bf16's
and f32's. A run whose second dispatch
replays the first's batches (a stale copy) must be over TOL by STALE_MIN in
its worst group. The pool's batches equal the thread loader's bit for bit,
and so do the staged batches the graph copies in.
"""
import numpy as np
import pytest
import torch

from neuralbody_tpu_torch.datasets.loader import WorkerPool, make_data_loader
from neuralbody_tpu_torch.ops import conv_kernel, hat_kernel
from neuralbody_tpu_torch.parallel import geom, transfer
from neuralbody_tpu_torch.tools.graph_noise import (check, config_case,
                                                    config_run, run_state)
from neuralbody_tpu_torch.train.fresh import (ConfigRun, stack_batches,
                                              with_geom)
from neuralbody_tpu_torch.train.step import (train_step_scan_banked,
                                             train_steps)

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
    thread loader's batches bit for bit (the pool's with their frames'
    geometry from its geom_cache), trained through one capture."""
    cfg, ds, batches, hs = _case("bfloat16")
    pool = WorkerPool(ds, 2)
    try:
        run = config_run(cfg, ds, dev, pool)
        got = list(run.loader(0))
        stats = list(run.epoch(0, loader=got))
    finally:
        pool.shutdown()
    assert run.hat_state == hs and len(got) == len(batches) == 2 * G
    for (a, _), (b, m) in zip(batches, got):
        b = with_geom(b, m, run.geom_cache)    # the banked loader's frames
        assert sorted(a) == sorted(b)
        assert sorted(a["geom"]) == sorted(b["geom"])
        for k in a:
            for x, y in (zip(a[k].values(), b[k].values()) if k == "geom"
                         else [(a[k], b[k])]):
                np.testing.assert_array_equal(x, y, err_msg=k)
    assert run.opt.step_graph.captures == 1 and len(stats) == 2
    assert all(torch.isfinite(s["loss"]).all() for s in stats)


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree[k]
    return out


def test_staging_sets_are_reused_without_a_stale_byte(dev):
    """A ring of 2 staging sets over 6 dispatches, the side stream in use:
    after each dispatch, the graph's batch buffers hold that dispatch's
    host batch (uint16 -> int32, float64 -> float32, its frames' bank rows)
    bit for bit. A spin on the card's main stream before each dispatch
    holds its copy-in back while the prefetcher refills the other set."""
    n_disp = 6
    cfg, ds = config_case("small", "bfloat16", G, n_disp * G)
    ring = transfer.StagingRing(dev, size=2)
    run = ConfigRun(cfg, dataset=ds, device=dev, staging=ring)
    loaded = list(run.loader(0))
    seen = []
    for _ in run.epoch(0, loader=loaded):
        torch.cuda.synchronize()
        seen.append({k: v.cpu().clone() for k, v in _leaves(
            run.opt.step_graph._batches).items()})
        torch.cuda._sleep(20_000_000)
    torch.cuda.synchronize()
    assert len(seen) == n_disp and ring.copies == n_disp
    assert run.opt.step_graph.captures == 1 and ring.size < n_disp
    for d, got in enumerate(seen):
        group = loaded[d * G:(d + 1) * G]
        want = _leaves(stack_batches([b for b, _ in group]))
        want["geom_rows"] = run.bank.rows([m["geom_keys"] for _, m in group])
        assert sorted(got) == sorted(want), d
        for k, v in want.items():
            v = np.asarray(v)
            v = v.astype({np.uint16: np.int32, np.float64: np.float32}.get(
                v.dtype.type, v.dtype))
            np.testing.assert_array_equal(got[k].numpy(), v,
                                          err_msg=f"dispatch {d}: {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_banked_graph_matches_eager_steps(dev, dtype):
    """ConfigRun's default path (bank, prefetcher, banked graph) over two
    dispatches against eager steps on the same batches with their
    geometry attached, at TOL."""
    cfg, ds = config_case("small", dtype, G, 2 * G)
    run = config_run(cfg, ds, dev)
    loaded = list(run.loader(0))
    losses = [st["loss"] for st in run.epoch(0, loader=loaded)]
    assert run.opt.step_graph.captures == 1 and len(losses) == 2
    assert run.bank.installs == len({k for _, m in loaded
                                     for k in m["geom_keys"]})
    graph = run_state(run.params, run.bn_stats, run.opt, torch.cat(losses))
    steps = [with_geom(b, m, run.geom_cache) for b, m in loaded]
    groups, over = check(graph, _eager(cfg, ds, dev, run.hat_state, steps),
                         TOL)
    assert not over, (over[:5], groups)


def test_a_frame_installed_between_replays(dev):
    """The first dispatch sees one frame, the second a frame installed into
    the bank after the first replay: no second capture, the new row equals
    the host's tables, and the four steps match eager ones at TOL."""
    cfg, ds = config_case("small", "float32", G, 2 * G)
    hs, cache = {}, {}
    loaded = list(make_data_loader(cfg, "train", dataset=ds, hat_state=hs,
                                   attach_geom=False, geom_cache=cache))
    by_frame = sorted(loaded, key=lambda bm: bm[1]["geom_keys"][0])
    first, second = by_frame[:G], by_frame[G:]
    assert ({m["geom_keys"][0] for _, m in first}
            != {m["geom_keys"][0] for _, m in second})
    run = config_run(cfg, ds, dev)
    settings = run.settings._replace(hat_rows_caps=tuple(hs["rows_caps"]))
    bank = geom.GeomBank(cache, capacity=4, device=dev)
    losses = []
    for group in (first, second):
        batches = stack_batches([b for b, _ in group])
        batches["geom_rows"] = bank.rows([m["geom_keys"] for _, m in group])
        run.bn_stats, st = train_step_scan_banked(
            run.params, run.bn_stats, run.opt, batches, bank, settings,
            device=dev)
        losses.append(st["loss"])
        assert run.opt.step_graph.captures == 1
    assert bank.installs == 2
    key = second[0][1]["geom_keys"][0]
    row = bank.rows([[key]])[0]
    for n, v in geom.take(bank, torch.as_tensor(row, device=dev)).items():
        np.testing.assert_array_equal(v[0].cpu().numpy(), cache[key][n],
                                      err_msg=n)
    graph = run_state(run.params, run.bn_stats, run.opt, torch.cat(losses))
    steps = [with_geom(b, m, cache) for b, m in first + second]
    groups, over = check(graph, _eager(cfg, ds, dev, hs, steps), TOL)
    assert not over, (over[:5], groups)
