"""Benchmark of the port: training throughput (rays/s, forward and
backward) at the reference working point, 1024 rays x 64 samples, a
6890-vertex body in 5 mm voxels, printed as the JAX package's bench.py at
the repository root prints it.

Fresh half (the headline `value`, bench.py's measure_fresh): the production
pipeline. Loader workers decode synthetic 512^2 JPEG views
(utils/synthetic.SyntheticDataset: 4 frames x 4 cameras), sample the
training rays and plan each batch with the C++ hat planner; G = 8 new
batches a dispatch, perturbed, bf16. It runs the config path's own epoch
loop (train/fresh.ConfigRun over the 313 config sized to the dataset): the
frames' geometry in a device bank, each group staged by the prefetcher
through pinned buffers on a side stream, the banked dispatch replayed as a
CUDA graph. A warm epoch of 2 dispatches, then a timed epoch of n_disp and
one scalar read at its end. Where it differs from bench.py's: the weights
and Adam's schedule are the config's (bench.py: a constant 5e-4 and
num_train_frame = 4), and each group is copied leaf by leaf, not packed
into one buffer (ROADMAP.md section 1, item 12).

Broadcast half: one host-planned batch, expanded on the device once
(precompute_hat_device), repeated G = 8 times and trained on in one
dispatch of train_step_scan (on the card, a CUDA graph of eight steps): one
warm-up dispatch, then n_iters dispatches and one scalar read at the end.

    python -m neuralbody_tpu_torch.bench

prints ONE JSON line with bench.py's keys (`value`: fresh rays/s,
`vs_baseline` = value / 2400, `fresh_over_broadcast`) and these of its
own: `card` (nvidia-smi's name and power limit), `steps_per_dispatch`,
`eager_broadcast_rays_per_s` (train_steps' eager loop on the same batches,
continuing from the same state), `hat_render_graph_rays_per_s` and
`hat_render_eager_rays_per_s` (the batch rendered by a RenderGraph replay
and by eval_step, medians), `device_busy_share` and
`fresh_device_busy_share` (busy_share below, of a broadcast and of a fresh
dispatch) and `fresh_h2d_bytes_per_dispatch` (one staging set: what a
fresh dispatch copies to the card). It needs the card;
measure_broadcast(device="cpu") and measure_fresh(device="cpu") run the
same steps through the plain versions, for tests, and then report no
device number.

A busy share is one function (tools/trace_loss.busy_share): the union of
the card's busy intervals (kernels, copies and fills, every stream) over
the span from the first record to the last, in one profiled dispatch
(tools/trace_loss.device_events: the second of two dispatches in one
profile). It is at most 1.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import torch

from .datasets.loader import WorkerPool
from .models import latent_xyzc
from .models.latent_xyzc import ModelStatic
from .models.sparse_conv_net import EncoderStatic
from .renderer.renderer import RenderSettings, precompute_hat_device
from .train.fresh import ConfigRun, synthetic_cfg
from .train.graphs import RenderGraph
from .train.optimizer import build_optimizer, tree_map
from .train.step import eval_step, scan_slice, train_step_scan, train_steps
from .utils.platform import resolve_device, to_device
from .utils.synthetic import SyntheticDataset, make_batch

BASELINE_RAYS_PER_S = 2400.0   # bench.py's yardstick (its docstring)
N_RAYS, N_SAMPLES, G = 1024, 64, 8
RENDERS = 10        # renders per way of rendering, for the medians
FRESH_WARM = 2      # dispatches of the fresh half's warm epoch
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "broadcast_rays_per_s",
              "fresh_over_broadcast", "broadcast_4096_rays_per_s")


def _setup(out_sh, site_caps, num_train_frame, dtype="bfloat16",
           hat_rows_caps=(), n_rays=N_RAYS, nv=6890, voxel=0.005,
           device=None):
    """bench.py's recipe: a bf16 encoder (f32 sums and BatchNorm), random
    weights from seed 0, value-clip 40 + Adam at 5e-4."""
    settings = RenderSettings(
        model=ModelStatic(encoder=EncoderStatic(
            out_sh=out_sh, site_caps=tuple(site_caps), compute_dtype=dtype)),
        voxel_size=(voxel,) * 3, n_samples=N_SAMPLES, chunk_rays=n_rays,
        hat_rows_caps=tuple(hat_rows_caps))
    params, bn_stats = latent_xyzc.init(
        torch.Generator().manual_seed(0), num_train_frame=num_train_frame,
        nv=nv, device=device)
    opt = build_optimizer(params, lambda step: 5e-4, clip=40.0)
    return settings, params, bn_stats, opt


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_s(fn, device, runs):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def busy_share(fn, name):
    """The card's busy share in one fn() (see the module's docstring); the
    trace is written to the build directory as `name`.json."""
    from .tools import trace_loss
    from .utils import cuda_build
    return trace_loss.busy_share(trace_loss.device_events(
        fn, os.path.join(cuda_build.BUILD_DIR, f"{name}.json")))[2]


def card_name():
    """The card as `nvidia-smi --query-gpu=name,power.limit` reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def measure_broadcast(n_rays=N_RAYS, n_iters=20, pre_expand=True,
                      n_verts=6890, voxel=0.005, device=None, extras=True):
    """One batch trained on G times per dispatch: the device's ceiling.

    n_verts / voxel are overridable only for CPU smoke tests; the headline
    number uses the reference working point (6890 vertices at 5 mm).
    Returns {"broadcast_rays_per_s": ...}, with extras=True also the eager
    loop's rate, the two render rates and the device's busy share (None
    for the device numbers on the CPU)."""
    device = resolve_device(device)
    batch_np, static = make_batch(
        n_rays=n_rays, n_verts=n_verts, voxel_size=voxel, seed=0, hat=True,
        n_samples=N_SAMPLES)
    batch = to_device(batch_np, device)
    rows_caps = static["hat"]["rows_caps"]
    settings, params, bn_stats, opt = _setup(
        static["out_sh"], static["site_caps"], num_train_frame=60,
        hat_rows_caps=rows_caps, n_rays=n_rays, nv=n_verts, voxel=voxel,
        device=device)
    if pre_expand:
        # a batch resident on the device: expand the compact row segments
        # and rebuild the sorted points and directions once
        batch = precompute_hat_device(batch, rows_caps, static["site_caps"],
                                      N_SAMPLES)
    batches = tree_map(lambda x: x[None].expand(G, *x.shape), batch)

    def dispatch():
        nonlocal bn_stats
        bn_stats, stats = train_step_scan(params, bn_stats, opt, batches,
                                          settings, device=device)
        return stats

    float(dispatch()["loss"][-1])    # warm-up: captures the graph
    t0 = time.perf_counter()
    for _ in range(n_iters):
        stats = dispatch()
    # the last loss depends on every earlier step: one read waits for all
    float(stats["loss"][-1])
    dt = time.perf_counter() - t0
    out = {"broadcast_rays_per_s": n_rays * n_iters * G / dt}
    if not extras:
        return out

    on_card = device.type == "cuda"
    steps = [scan_slice(batches, i) for i in range(G)]
    n_eager = max(1, n_iters // 10)
    t0 = time.perf_counter()
    for _ in range(n_eager):
        bn_stats, stats = train_steps(params, bn_stats, opt, steps, settings,
                                      device=device)
    float(stats["loss"][-1])
    out["eager_broadcast_rays_per_s"] = (n_rays * n_eager * G
                                         / (time.perf_counter() - t0))
    eager_s = _median_s(lambda: eval_step(params, batch, settings, device),
                        device, RENDERS)
    out["hat_render_eager_rays_per_s"] = n_rays / eager_s
    out["hat_render_graph_rays_per_s"] = out["device_busy_share"] = None
    if on_card:
        render = RenderGraph(device)
        render(params, batch, settings)
        out["hat_render_graph_rays_per_s"] = n_rays / _median_s(
            lambda: render(params, batch, settings), device, RENDERS)
        out["device_busy_share"] = busy_share(dispatch, "bench_broadcast")
    return out


def measure_fresh(num_workers=2, n_disp=12, n_rays=N_RAYS, device=None,
                  pool=None, dataset=None, n_samples=N_SAMPLES,
                  plan_device=False):
    """The production pipeline (see the module's docstring): rays/s over a
    timed epoch of n_disp dispatches of G fresh batches. plan_device=True
    ships rays only and builds the hat plan on the card
    (cfg.tpu.hat_plan_device, ops/device_plan.py), as bench.py's
    plan_device does.

    pool: a started datasets/loader.WorkerPool to use (its dataset is the
    bench's; it is left running), else num_workers workers are started and
    stopped here (0: the loader's thread). dataset / n_samples are
    overridable only for CPU tests; the headline number uses
    SyntheticDataset(4 frames, 4 cameras, 512^2, 6890 vertices, 5 mm) with
    n_rays rays. Returns fresh_rays_per_s, fresh_h2d_bytes_per_dispatch and
    fresh_device_busy_share (None on the CPU)."""
    device = resolve_device(device)
    if pool is not None:
        dataset = pool.dataset
    elif dataset is None:
        dataset = SyntheticDataset(n_frames=4, n_cams=4, hw=(512, 512),
                                   n_verts=6890, voxel_size=0.005,
                                   n_rand=n_rays)
    own = pool is None and num_workers > 0
    if own:
        pool = WorkerPool(dataset, num_workers)
    try:
        cfg = synthetic_cfg(dataset, "bfloat16", G, FRESH_WARM * G,
                            n_samples)
        cfg.tpu.hat_plan_device = bool(plan_device)
        run = ConfigRun(cfg, dataset=dataset, pool=pool, device=device)
        for stats in run.epoch(0):
            pass
        float(stats["loss"][-1])
        cfg.ep_iter = n_disp * G
        t0 = time.perf_counter()
        for stats in run.epoch(1):
            pass
        # the last loss depends on every earlier step: one read waits
        float(stats["loss"][-1])
        dt = time.perf_counter() - t0
        out = {"fresh_rays_per_s": dataset.n_rand * n_disp * G / dt,
               "fresh_h2d_bytes_per_dispatch": run.staging.set_bytes,
               "fresh_device_busy_share": None}
        if device.type == "cuda":
            # an epoch of two dispatches, the second profiled
            cfg.ep_iter = 2 * G
            epoch = run.epoch(2)
            out["fresh_device_busy_share"] = busy_share(
                lambda: next(epoch), "bench_fresh")
            for _ in epoch:
                pass
    finally:
        if own:
            pool.shutdown()
    return out


def summary(broadcast, broadcast_4096, card=None, fresh=None):
    """bench.py's JSON line from two measure_broadcast results (1024 and
    4096 rays) and a measure_fresh result (without one, the fresh keys are
    null)."""
    value = None if fresh is None else fresh["fresh_rays_per_s"]
    bcast = broadcast["broadcast_rays_per_s"]
    line = {
        "metric": "train_rays_per_s_per_chip",
        "value": value,
        "unit": "rays/s (fwd+bwd, 1024x64 @ 5mm, fresh host-planned "
                "batches)",
        "vs_baseline": (None if value is None
                        else value / BASELINE_RAYS_PER_S),
        "broadcast_rays_per_s": bcast,
        "fresh_over_broadcast": None if value is None else value / bcast,
        "broadcast_4096_rays_per_s": broadcast_4096["broadcast_rays_per_s"],
        "card": card,
        "steps_per_dispatch": G,
    }
    line.update({k: v for k, v in broadcast.items()
                 if k != "broadcast_rays_per_s"})
    for k in ("fresh_device_busy_share", "fresh_h2d_bytes_per_dispatch"):
        line[k] = None if fresh is None else fresh[k]
    return line


def main():
    fresh = measure_fresh()
    broadcast = measure_broadcast()
    # batch-size scaling headroom (same recipe, 4x rays a step)
    broadcast_4096 = measure_broadcast(n_rays=4096, n_iters=6, extras=False)
    print(json.dumps(summary(broadcast, broadcast_4096, card_name(), fresh)),
          flush=True)


if __name__ == "__main__":
    main()
