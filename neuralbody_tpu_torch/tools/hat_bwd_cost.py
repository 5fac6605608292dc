"""What the hat backward costs a training step, in the checkout at TREE
(this one, or an earlier commit's archive to compare with), on an NVIDIA
GPU:

    python -m neuralbody_tpu_torch.tools.hat_bwd_cost [TREE] [--replays 30]

At the reference working point (chip_smoke.py's training batch: 1024 rays
x 64 samples, 6890 vertices, 5 mm voxels, seeded weights with alpha_fc's
bias raised), bf16 and f32: the graphed step's device ms (a StepGraph of 8
steps, replays timed with CUDA events); the four levels' backward on one
step's own inputs, each level sorting its own row ids and, where the tree
has ops/hat_kernel.sort_rows, as a step runs it (one sort for the four
levels), with the sort and the kernels apart; whether two calls of the
backward, and two eager runs of the first step's gradients, agree bit for
bit. One JSON line, with the card's name and power limit. Run trees in
turn (the earlier commit's, this one's, this one's, the earlier's) in one
machine to compare them.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def _ev_ms(torch, fn, runs):
    """Median ms of fn() between CUDA events, after two warm calls; a
    device spin before each covers the host's enqueue."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def measure(replays=30):
    """The JSON line's dict for the tree whose package is imported."""
    import torch

    from neuralbody_tpu_torch.models import latent_xyzc as lx
    from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic
    from neuralbody_tpu_torch.ops import conv_kernel, hat_interp, hat_kernel
    from neuralbody_tpu_torch.renderer.renderer import RenderSettings
    from neuralbody_tpu_torch.tools import graph_noise
    from neuralbody_tpu_torch.train import optimizer
    from neuralbody_tpu_torch.train.fresh import stack_batches
    from neuralbody_tpu_torch.train.graphs import StepGraph
    from neuralbody_tpu_torch.train.step import loss_and_grads
    from neuralbody_tpu_torch.utils.platform import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    hat_kernel.build()
    conv_kernel.build()
    dev = torch.device("cuda")
    (a, _), st = graph_noise.batch_pair(1024, 6890, 0.005, 64, 0)
    a = to_device(a, dev)

    def fresh():
        p, bn = lx.init(torch.Generator().manual_seed(0), num_train_frame=1,
                        device=dev)
        with torch.no_grad():
            p["alpha_fc"]["b"] += 1.0
        return p, bn

    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    for mode in ("bfloat16", "float32"):
        s = RenderSettings(model=lx.ModelStatic(encoder=EncoderStatic(
            out_sh=st["out_sh"], site_caps=st["site_caps"],
            compute_dtype=mode)), voxel_size=(0.005,) * 3,
            hat_rows_caps=st["hat"]["rows_caps"])
        params, bn = fresh()
        opt = optimizer.build_optimizer(params, lambda t: 5e-4)
        graph, batches = StepGraph(dev), stack_batches([a] * 8)
        state = {"bn": bn}

        def replay():
            state["bn"], _ = graph(params, state["bn"], opt, batches, s)
        res = {"graphed_step_ms": _ev_ms(torch, replay, replays) / 8}
        del graph
        calls, launch = [], hat_interp.hat_interp_level_bwd

        def rec(*args):
            calls.append(args[:5])
            return launch(*args)
        hat_interp.hat_interp_level_bwd = rec
        try:
            runs = [loss_and_grads(fresh()[0], a, s) for _ in range(2)]
        finally:
            hat_interp.hat_interp_level_bwd = launch
        four = calls[:4]
        res["hat_bwd_each_sorted_ms"] = _ev_ms(
            torch, lambda: [launch(*c) for c in four], 25)
        res["hat_bwd_bit_equal"] = all(torch.equal(launch(*c), launch(*c))
                                       for c in four)
        if hasattr(hat_kernel, "sort_rows"):
            levels = [(c[2], c[1].shape[0]) for c in four]
            srt = hat_kernel.sort_rows(levels)
            res["sort_ms"] = _ev_ms(torch, lambda: hat_kernel.sort_rows(
                levels), 25)
            res["kernels_ms"] = _ev_ms(torch, lambda: [
                launch(*c, r) for c, r in zip(four, srt)], 25)
            res["hat_bwd_step_ms"] = _ev_ms(torch, lambda: [
                launch(*c, r) for c, r in zip(
                    four, hat_kernel.sort_rows(levels))], 25)
        (l1, _, g1), (l2, _, g2) = runs
        flat = [[x for _, x in graph_noise._named(g, "g")] for g in (g1, g2)]
        res["eager_grads_bit_equal"] = bool(torch.equal(l1, l2) and all(
            torch.equal(x, y) for x, y in zip(*flat)))
        out[mode] = res
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=None,
                    help="the checkout to measure (default: this one)")
    ap.add_argument("--replays", type=int, default=30)
    args = ap.parse_args(argv)
    if args.tree is not None:
        tree = os.path.abspath(args.tree)
        # the tree's package, not this one's
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "neuralbody_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, tree)
        os.chdir(tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("hat_bwd_cost needs an NVIDIA GPU")
    out = measure(args.replays)
    out["tree"] = os.getcwd()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
