"""tools/trace_loss.py without a card: device_events keeps the second call's
device events (those after the marker kernel), and where_lost locates the
kernels a short trace misses."""
import pytest

from neuralbody_tpu_torch.tools import trace_loss


def _ev(cat, name, ts):
    return {"cat": cat, "name": name, "ts": ts, "dur": 1.0}


def test_device_events_keeps_the_call_after_the_marker(monkeypatch):
    marker = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [_ev("kernel", "k0", 1.0), _ev("gpu_memcpy", "copy", 2.0),
              _ev("cuda_runtime", "cudaLaunchKernel", 2.5),
              _ev("kernel", marker, 3.0), _ev("kernel", "k1", 6.0),
              _ev("gpu_memset", "fill", 5.0), _ev("kernel", "k0", 4.0),
              _ev("cuda_runtime", "cudaLaunchKernel", 4.5)]
    seen = {}

    def fake_trace(fn, path, warm):
        seen["warm"] = warm
        return events
    monkeypatch.setattr(trace_loss, "_trace", fake_trace)
    got = trace_loss.device_events(lambda: None, "unused.json")
    assert seen["warm"] is True
    assert [(e["cat"], e["name"]) for e in got] == [
        ("kernel", "k0"), ("gpu_memset", "fill"), ("kernel", "k1")]


def test_device_events_raises_without_its_marker(monkeypatch):
    monkeypatch.setattr(trace_loss, "_trace", lambda fn, path, warm: [
        _ev("kernel", "k0", 1.0)])
    with pytest.raises(RuntimeError, match="marker"):
        trace_loss.device_events(lambda: None, "unused.json")


@pytest.mark.parametrize("names, want", [
    (list("abcdxyz"), (7, 0, 0)),
    (list("cdxyz"), (0, 5, 2)),
    (list("abcdx"), (5, 0, 2)),
    (list("abxyz"), (2, 3, 2)),
])
def test_where_lost(names, want):
    assert trace_loss.where_lost(names, list("abcdxyz")) == want
