"""Tracing, profiling and numerics debugging (counterpart of
neuralbody_tpu/utils/profiling.py, over torch.profiler and autograd).

  * `trace(logdir)`: a torch.profiler trace of the block (host activity,
    and the card's kernels and copies when a card is present), written to
    logdir as a Chrome trace (chrome://tracing, Perfetto) on exit.
  * `annotate(name)`: a named span of host work in such a trace
    (torch.profiler.record_function).
  * `enable_nan_checks()`: autograd's anomaly mode: a backward that makes a
    NaN raises, naming the forward operation that produced it.
  * `device_memory_stats()`: the card's allocator numbers per device, {}
    on a machine without a card.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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


def annotate(name: str):
    return record_function(name)


def enable_nan_checks(enable: bool = True):
    torch.autograd.set_detect_anomaly(enable)


def device_memory_stats():
    """Per card {bytes_in_use, peak_bytes_in_use} from
    torch.cuda.memory_stats; {} without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        }
    return out
