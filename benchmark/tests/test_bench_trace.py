"""The busy-union arithmetic and what a trace's window reads."""
import pytest

from benchmark.trace import WINDOW, Trace, busy_union


def test_busy_union():
    assert busy_union([]) == 0.0
    assert busy_union([(0, 2), (1, 3), (5, 6)]) == 4.0
    assert busy_union([(0, 10), (2, 3)]) == 10.0
    assert busy_union([(4, 5), (0, 1)]) == 2.0


def _trace():
    ev = [{"name": WINDOW, "cat": "user_annotation", "ts": 100, "dur": 100,
           "tid": 1},
          {"name": "k_a", "cat": "kernel", "ts": 90, "dur": 30},
          {"name": "k_b", "cat": "kernel", "ts": 110, "dur": 20},
          {"name": "memcpy", "cat": "gpu_memcpy", "ts": 150, "dur": 10},
          {"name": "k_a", "cat": "kernel", "ts": 190, "dur": 50},
          {"name": "host_wait", "cat": "user_annotation", "ts": 125,
           "dur": 30, "tid": 1},
          {"name": "outer", "cat": "cpu_op", "ts": 100, "dur": 100, "tid": 1},
          {"name": "other_thread", "cat": "cpu_op", "ts": 100, "dur": 100,
           "tid": 2}]
    return Trace(ev)


def test_trace_window_busy_and_gaps():
    t = _trace()
    assert t.window_s == pytest.approx(100e-6)
    # clipped: [100,120] u [110,130] u [150,160] u [190,200] = 30 + 10 + 10
    assert t.busy_s == pytest.approx(50e-6)
    assert t.kernel_s(("k_a",)) == (pytest.approx(30e-6), 2)
    gaps = dict(t.idle_gaps())
    # gap 130-150 (mid 140: inside host_wait), gap 160-190 (mid 175: outer)
    assert gaps["host_wait"] == pytest.approx(20e-6)
    assert gaps["outer"] == pytest.approx(30e-6)
    assert t.top_ops()[0][0] == "k_a"


def test_trace_without_window_refused():
    with pytest.raises(RuntimeError):
        Trace([{"name": "k", "cat": "kernel", "ts": 0, "dur": 1}])
