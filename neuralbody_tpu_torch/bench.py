"""Benchmark of the port: training throughput (rays/s, forward and
backward) at the reference working point, 1024 rays x 64 samples, a
6890-vertex body in 5 mm voxels, printed as the JAX package's bench.py at
the repository root prints it.

Broadcast half: one host-planned batch, expanded on the device once
(precompute_hat_device), repeated G = 8 times and trained on in one
dispatch of train_step_scan (on the card, a CUDA graph of eight steps): one
warm-up dispatch, then n_iters dispatches and one scalar read at the end.
The fresh half (loader workers building new batches, which fills `value`,
`vs_baseline` and `fresh_over_broadcast`) comes with the device geometry
bank and the prefetcher (ROADMAP.md section 1, item 5); until then those
keys are null.

    python -m neuralbody_tpu_torch.bench

prints ONE JSON line with bench.py's keys and these of its own: `card`
(nvidia-smi's name and power limit), `steps_per_dispatch`,
`eager_broadcast_rays_per_s` (train_steps' eager loop on the same batches,
continuing from the same state), `hat_render_graph_rays_per_s` and
`hat_render_eager_rays_per_s` (the batch rendered by a RenderGraph replay
and by eval_step, medians) and `device_busy_share` (the kernels' time in
one profiled dispatch over the median dispatch). It needs the card;
measure_broadcast(device="cpu") runs the same steps through the plain
versions, for tests, and then reports no device number.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import torch

from .models import latent_xyzc
from .models.latent_xyzc import ModelStatic
from .models.sparse_conv_net import EncoderStatic
from .renderer.renderer import RenderSettings, precompute_hat_device
from .train.graphs import RenderGraph
from .train.optimizer import make_optimizer, tree_map
from .train.step import eval_step, scan_slice, train_step_scan, train_steps
from .utils.platform import resolve_device, to_device
from .utils.synthetic import make_batch

N_RAYS, N_SAMPLES, G = 1024, 64, 8
RENDERS = 10        # renders per way of rendering, for the medians
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
    opt = make_optimizer(params, lambda step: 5e-4, clip=40.0)
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


def _busy_s(fn):
    """Device time of one fn()'s kernels, copies and fills (torch.profiler,
    tools/trace_loss.device_events: the second of two calls in one
    profile)."""
    from .tools.trace_loss import device_events
    from .utils import cuda_build
    return sum(e.get("dur", 0) for e in device_events(
        fn, os.path.join(cuda_build.BUILD_DIR, "bench_busy.json"))) / 1e6


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
        out["device_busy_share"] = _busy_s(dispatch) / (dt / n_iters)
    return out


def summary(broadcast, broadcast_4096, card=None):
    """bench.py's JSON line from two measure_broadcast results (1024 and
    4096 rays); the fresh half's keys are null."""
    line = {
        "metric": "train_rays_per_s_per_chip",
        "value": None,
        "unit": "rays/s (fwd+bwd, 1024x64 @ 5mm, fresh host-planned "
                "batches)",
        "vs_baseline": None,
        "broadcast_rays_per_s": broadcast["broadcast_rays_per_s"],
        "fresh_over_broadcast": None,
        "broadcast_4096_rays_per_s": broadcast_4096["broadcast_rays_per_s"],
        "card": card,
        "steps_per_dispatch": G,
    }
    line.update({k: v for k, v in broadcast.items()
                 if k != "broadcast_rays_per_s"})
    return line


def main():
    broadcast = measure_broadcast()
    # batch-size scaling headroom (same recipe, 4x rays a step)
    broadcast_4096 = measure_broadcast(n_rays=4096, n_iters=6, extras=False)
    print(json.dumps(summary(broadcast, broadcast_4096, card_name())),
          flush=True)


if __name__ == "__main__":
    main()
