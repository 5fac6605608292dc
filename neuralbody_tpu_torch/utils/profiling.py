"""Tracing, profiling and numerics debugging (counterpart of
neuralbody_tpu/utils/profiling.py, over torch.profiler and autograd).

  * `trace(logdir)`: a torch.profiler trace of the block (host activity,
    and the card's kernels and copies when a card is present), written to
    logdir as a Chrome trace (chrome://tracing, Perfetto) on exit.
  * `span(name, **ids)`: the program's span recorder. While a torch
    profiler records this thread (`trace()`, or any torch.profiler.profile),
    a span is a record_function in the profiler's trace and a `Span` in this
    process's ring; otherwise it costs one flag check. The program opens
    its spans at its layer boundaries (train/fresh, train/trainer,
    train/graphs, train/step, the renderers); PERF.md lists them.
  * `Span`, `record(spans)`: spans made where no profiler runs, from clock
    reads alone (the loader's workers stamp every batch; datasets/loader
    adds them to the ring when it takes the batch).
  * `spans()`, `clear()`: the ring (the newest CAPACITY spans of the
    process's life).
  * `clock_offset(ring, events)`: what puts ring spans on a trace's clock.
  * `enable_nan_checks()`: autograd's anomaly mode: a backward that makes a
    NaN raises, naming the forward operation that produced it.

Every span's start and end are time.time_ns() readings, in every process:
one clock for the main thread, the prefetcher and the loader's workers.
"""
from __future__ import annotations

import collections
import contextlib
import os
import statistics
import threading
import time
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

CAPACITY = 65536

# whether a profiler records the calling thread (a per-thread flag)
_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    start: int            # time.time_ns()
    end: int
    parent: str | None    # the enclosing span's name on the same thread
    pid: int
    tid: int              # threading.get_ident()
    ids: dict             # epoch / bi / dispatch / worker / chunk


_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_open = threading.local()     # .names: the thread's open spans
_pid = os.getpid()    # a syscall, tens of us where the card is


class _Recorded:
    __slots__ = ("name", "ids", "rf", "parent", "start")

    def __init__(self, name, ids):
        self.name, self.ids = name, ids

    def __enter__(self):
        names = _open.__dict__.setdefault("names", [])
        self.parent = names[-1] if names else None
        names.append(self.name)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.rf.__exit__(*exc)
        _open.names.pop()
        _ring.append(Span(self.name, self.start, end, self.parent, _pid,
                          threading.get_ident(), self.ids))
        return False


_NULL = contextlib.nullcontext()


def span(name: str, **ids):
    """A span of the block named `name`, with `ids` (the batch's epoch and
    bi, the dispatch's epoch and index, a chunk's index). No span goes
    inside a function that a CUDA graph captures: it would run only at
    capture."""
    if not _profiling():
        return _NULL
    return _Recorded(name, ids)


def record(spans):
    """Add finished spans (made without a profiler) to the ring."""
    _ring.extend(spans)


def spans():
    return list(_ring)


def clear():
    _ring.clear()


def clock_offset(ring, events, limit_us=200.0):
    """The offset in microseconds that puts ring spans on a profiler
    trace's clock (trace_us = ns / 1e3 + offset), from the spans of this
    process's main thread that are both in `ring` and in `events`, the
    trace's spans of that thread as (start_us, end_us, name).

    A span is in the ring when its record_function is in the trace, but
    for one open when the profiler stopped. So for each name the trace's
    events, in order, are paired with a run of as many ring spans of the
    name, in order: the run whose start offsets spread least. The offset
    is the median over all pairs; None where no span pairs or the offsets
    spread (first to third quartile) over limit_us. A span is stamped
    inside its record_function, so on the trace's clock it lies inside
    its event. torch's Kineto traces read ts = (ns - baseTimeNanoseconds)
    / 1e3."""
    main = threading.main_thread().ident
    offsets = []
    for name in {n for _, _, n in events}:
        ev = sorted(a for a, _, n in events if n == name)
        rs = sorted(s.start / 1e3 for s in ring if s.name == name
                    and s.pid == _pid and s.tid == main)
        if not rs:
            continue
        short, runs, sign = ((ev, rs, 1) if len(ev) <= len(rs)
                             else (rs, ev, -1))
        best = min(([sign * (x - y) for x, y in zip(short, runs[k:])]
                    for k in range(len(runs) - len(short) + 1)),
                   key=lambda o: max(o) - min(o))
        offsets += best
    if not offsets:
        return None
    if len(offsets) > 1:
        q1, _, q3 = statistics.quantiles(offsets, n=4)
        if q3 - q1 > limit_us:
            return None
    return statistics.median(offsets)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write logdir/trace_<ns>.json when it ends."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def enable_nan_checks(enable: bool = True):
    torch.autograd.set_detect_anomaly(enable)
