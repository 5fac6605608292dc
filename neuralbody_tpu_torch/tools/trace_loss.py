"""How often a torch.profiler trace of one training step misses kernels the
card ran, and where in the step the missing ones lie; and device_events,
the trace of one call that chip_smoke.py's traced_kernels and the card
tests count kernels by name in; and busy_share, the device's busy share of
such a trace (an interval union). The tool needs an NVIDIA GPU.

    python -m neuralbody_tpu_torch.tools.trace_loss [--seconds 240]
        [--modes bfloat16,float32]

The scene is chip_smoke.py's graph_vs_eager one (tools/graph_noise "full":
1024 rays x 64 samples, 6890 vertices, 5 mm voxels). Each round traces, in
chip_smoke.py's order, one replay of a two-step StepGraph and then one
eager train_step, each in a profile of its own ("once"); then an eager
step traced after a warm-up call inside the same profile, the kernels
counted from a marker kernel launched between the two calls on
("after_warm", device_events). A trace's kernels are compared by name, in order, with the
longest trace of its kind: a short trace's missing kernels are located by
the lengths of the prefix and the suffix the two share (a trace of the
longest one's length that differs holds the same kernels in another
order: kernels on two streams). One JSON line per mode, with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time

import torch

MARKER = "spin_kernel"   # torch.cuda._sleep's kernel
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace(fn, path, warm):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if warm:
            fn()
            torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_events(fn, path):
    """The card's events (kernels, copies, fills) of one call of fn() from
    a torch.profiler trace written to path, in start order. fn() runs
    twice in one profile with a marker kernel between the calls, and only
    the events that start after the marker are kept: a profile's first
    records are sometimes lost (this tool's measurement), a warm call takes
    that loss. fn's state advances by two calls."""
    events = _trace(fn, path, warm=True)
    marks = [e["ts"] for e in events
             if e.get("cat") == "kernel" and MARKER in e["name"]]
    if not marks:
        raise RuntimeError(f"{path}: the trace lost its marker kernel")
    return sorted((e for e in events if e.get("cat") in DEVICE_CATS
                   and e["ts"] > max(marks)), key=lambda e: e["ts"])


def busy_share(events):
    """(busy us, span us, busy / span) of the card's events (device_events'
    kernels, copies and fills, on every stream): the union of their
    intervals, over the span from the first one's start to the last one's
    end. Events that overlap (a copy on a side stream beside a kernel) count
    once, so the share is at most 1."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events)
    if not spans:
        raise ValueError("no device events to take a busy share of")
    busy, start, end = 0.0, spans[0][0], spans[0][0]
    for a, b in spans:
        if a > end:
            busy += end - start
            start = a
        end = max(end, b)
    busy += end - start
    span = max(b for _, b in spans) - spans[0][0]
    return busy, span, busy / span if span > 0 else 1.0


def trace_names(fn, path, warm=False):
    """Kernel names of one call of fn() in start order: device_events' with
    warm, else from a profile of that call alone. Also the categories and
    counts of the events kept."""
    events = (device_events(fn, path) if warm else
              sorted(_trace(fn, path, warm=False),
                     key=lambda e: e.get("ts", 0)))
    cats = collections.Counter(e.get("cat") for e in events)
    return [e["name"] for e in events if e.get("cat") == "kernel"], dict(cats)


def where_lost(names, ref):
    """(shared prefix, shared suffix, missing) of names against ref."""
    pre = 0
    while pre < min(len(names), len(ref)) and names[pre] == ref[pre]:
        pre += 1
    suf = 0
    while (suf < min(len(names), len(ref)) - pre
           and names[-1 - suf] == ref[-1 - suf]):
        suf += 1
    return pre, suf, len(ref) - len(names)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=240)
    ap.add_argument("--modes", default="bfloat16,float32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_loss needs an NVIDIA GPU")
    from ..ops import conv_kernel, hat_kernel
    from ..train import optimizer
    from ..train.fresh import stack_batches
    from ..train.graphs import StepGraph
    from ..train.step import train_step
    from ..utils import cuda_build
    from . import graph_noise
    torch.backends.cuda.matmul.allow_tf32 = False
    hat_kernel.build()
    conv_kernel.build()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    path = os.path.join(cuda_build.BUILD_DIR, "trace_loss.json")
    modes = args.modes.split(",")
    for mode in modes:
        def schedule():
            return optimizer.make_lr_schedule(5e-4, "exponential",
                                              ep_iter=500, gamma=0.1,
                                              decay_epochs=1000)
        (a, _), settings, init = graph_noise._hat_scene(
            dev, mode, 1024, 6890, 0.005, 64, 0, schedule)
        params, bn, opt = init()
        state = {"bn": bn}
        gparams, gbn, gopt = init()
        gstate = {"bn": gbn}
        graph, batches = StepGraph(dev), stack_batches([a, a])

        def replay():
            gstate["bn"], _ = graph(gparams, gstate["bn"], gopt, batches,
                                    settings)

        def step():
            state["bn"], _ = train_step(params, state["bn"], opt, a,
                                        settings, device=dev)
        replay()
        step()
        torch.cuda.synchronize()
        seqs = {"replay": [], "once": [], "after_warm": []}
        cats = {k: collections.Counter() for k in seqs}
        t_end = time.perf_counter() + args.seconds / len(modes)
        while time.perf_counter() < t_end:
            for kind, fn, warm in (("replay", replay, False),
                                   ("once", step, False),
                                   ("after_warm", step, True)):
                names, c = trace_names(fn, path, warm)
                seqs[kind].append(names)
                cats[kind].update(c)
        out = {}
        for kind, runs in seqs.items():
            ref = max(runs, key=len)
            lengths = collections.Counter(len(r) for r in runs)
            short = [where_lost(r, ref) for r in runs if len(r) < len(ref)]
            out[kind] = dict(traces=len(runs), kernels=dict(lengths),
                             short=len(short), lost=short,
                             reordered=sum(len(r) == len(ref) and r != ref
                                           for r in runs),
                             categories=dict(cats[kind]))
        print(json.dumps(dict(mode=mode, card=card, **out)), flush=True)
        del graph


if __name__ == "__main__":
    main()
