"""The traced stretch of a run: a torch.profiler trace of a few steps or
images inside the measured window, and what is read from it.

busy_union is a copy of neuralbody_tpu_torch/tools/trace_loss.busy_share's
arithmetic: the union of the card's busy intervals (kernels, copies and
fills on every stream; overlapping ones count once), here clipped to the
traced window, which a `bench.traced_window` span marks in the trace's own
clock.
"""
from __future__ import annotations

import collections
import json
import os

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
WINDOW = "bench.traced_window"


class Tracer:
    """start() / stop() a profile of the card and the host; stop() returns a
    Trace. The trace file goes to `path` and is deleted once read."""

    def __init__(self, path):
        self.path = path
        self.prof = None
        self.span = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        _sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = torch.profiler.record_function(WINDOW)
        self.span.__enter__()

    def stop(self):
        _sync()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        return Trace(events)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def busy_union(spans):
    """Total length of the union of (start, end) intervals."""
    busy, start, end = 0.0, None, None
    for a, b in sorted(spans):
        if start is None or a > end:
            if start is not None:
                busy += end - start
            start, end = a, b
        else:
            end = max(end, b)
    return busy + (end - start if start is not None else 0.0)


class Trace:
    """The device's events and the host's spans of one traced window (times
    in microseconds of the trace's clock)."""

    def __init__(self, events):
        marks = [e for e in events if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise RuntimeError("the trace lost its window span")
        w = marks[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = []
        for e in events:
            if e.get("cat") in DEVICE_CATS and "dur" in e:
                a = max(float(e["ts"]), self.t0)
                b = min(float(e["ts"]) + float(e["dur"]), self.t1)
                if b > a:
                    self.device.append((a, b, e["name"]))
        # the host spans of the thread that opened the window
        self.host = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("cat") in HOST_CATS and "dur" in e
             and e.get("tid") == w.get("tid") and e.get("name") != WINDOW),
            key=lambda h: (h[0], -h[1]))     # an outer span before its inner

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self):
        return busy_union([(a, b) for a, b, _ in self.device]) * 1e-6

    def kernel_s(self, patterns):
        """Device seconds of the kernels whose names hold one of
        `patterns`, and how many ran."""
        hits = [b - a for a, b, n in self.device
                if any(p in n for p in patterns)]
        return sum(hits) * 1e-6, len(hits)

    def top_ops(self, n=10):
        """The device operations that took most time: [[name, seconds]]."""
        by = collections.Counter()
        for a, b, name in self.device:
            by[name] += (b - a) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n=10):
        """The card's idle time inside the window by what the host was
        doing in the middle of each gap (the innermost host span there):
        [[label, seconds]], longest first."""
        spans = sorted((a, b) for a, b, _ in self.device)
        gaps, cur = [], self.t0
        for a, b in spans:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        by = collections.Counter()
        # one sweep: the thread's spans nest, so the innermost span around
        # a point is the top of the stack of those opened before it
        stack, i = [], 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while i < len(self.host) and self.host[i][0] <= mid:
                while stack and stack[-1][1] < self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            label = stack[-1][2] if stack else "(no host span)"
            by[label] += (b - a) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]
