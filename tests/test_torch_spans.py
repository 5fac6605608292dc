"""The port's span recorder (neuralbody_tpu_torch/utils/profiling.span) and
where the program opens its spans, on the CPU: a span without a profiler is
a flag check; under one it is a record_function and a ring entry with its
parent and ids; ring spans land on the trace's clock; the loader's workers
stamp every batch; a Trainer epoch spans its data waits and dispatches, and
its recorder's data_time is those waits. Last, the benchmark's readers of
these spans (benchmark/metrics/) on a hand-built timeline, and None where
the spans are missing.
"""
import json
import os
import statistics
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.trace import WINDOW, Trace
from neuralbody_tpu_torch.config import make_cfg as t_make_cfg
from neuralbody_tpu_torch.datasets import loader as t_loader
from neuralbody_tpu_torch.train import trainer as t_trainer
from neuralbody_tpu_torch.utils import profiling
from neuralbody_tpu_torch.utils.synthetic import SyntheticDataset

torch.set_num_threads(1)

READERS = ("loader_wait_idle_share.train", "worker_batch_ms.train",
           "worker_busy_share.train", "dispatch_idle_share.train",
           "render_host_idle_share.render")


@pytest.fixture(autouse=True)
def empty_ring():
    profiling.clear()
    yield
    profiling.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class _NoRing:
    def append(self, _):
        raise AssertionError("the ring was touched")

    extend = append


def test_a_span_without_a_profiler_is_a_flag_check(monkeypatch):
    def no_record_function(name):
        raise AssertionError("record_function was called")

    monkeypatch.setattr(profiling, "record_function", no_record_function)
    monkeypatch.setattr(profiling, "_ring", _NoRing())
    assert not torch._C._autograd._profiler_enabled()
    with profiling.span("train.data_wait", epoch=0, bi=1) as s:
        pass
    assert s is None


def test_nested_spans_carry_their_parent_and_ids():
    with _cpu_profile():
        with profiling.span("outer", epoch=1, dispatch=2):
            with profiling.span("inner", chunk=3):
                pass
    inner, outer = profiling.spans()
    assert (outer.name, outer.parent, outer.ids) == (
        "outer", None, {"epoch": 1, "dispatch": 2})
    assert (inner.name, inner.parent, inner.ids) == (
        "inner", "outer", {"chunk": 3})
    assert outer.start <= inner.start <= inner.end <= outer.end
    for s in (inner, outer):
        assert (s.pid, s.tid) == (os.getpid(), threading.get_ident())


def _trace_spans(logdir):
    """The exported trace's user spans: [(start_us, end_us, name)] and its
    baseTimeNanoseconds (None where the trace has none)."""
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        trace = json.load(f)
    events = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
              for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"]
    return events, trace.get("baseTimeNanoseconds")


def test_ring_spans_land_on_their_trace_events(tmp_path):
    """50 ring spans, put on the exported trace's clock by the offset that
    clock_offset finds, lie inside their own events (a span is stamped
    inside its record_function; 20 us for the trace's clock conversion),
    their starts and ends within 100 us of the events' in the median; the
    offset is the documented one where the trace states its base time."""
    logdir = str(tmp_path / "trace")
    x = torch.ones(32, 32)
    with profiling.trace(logdir):
        for i in range(50):
            with profiling.span("test.span", i=i):
                x = x @ x / 32.0
    events, base = _trace_spans(logdir)
    ring = profiling.spans()
    offset = profiling.clock_offset(ring, events)
    assert offset is not None and len(ring) == 50
    mine = sorted(e for e in events if e[2] == "test.span")
    assert len(mine) == 50
    gaps = []
    for s, (a, b, _) in zip(sorted(ring, key=lambda s: s.start), mine):
        start, end = s.start / 1e3 + offset, s.end / 1e3 + offset
        assert a - 20 <= start <= end <= b + 20
        gaps.append((start - a, b - end))
    assert max(statistics.median(g) for g in zip(*gaps)) < 100
    if base is not None:
        assert abs(offset + base / 1e3) < 100


@pytest.mark.parametrize("case", ["no pairs", "spread"])
def test_clock_offset_refuses(case):
    """No span in both the ring and the trace, or pairs whose offsets spread
    over 200 us: None."""
    me, main = os.getpid(), threading.main_thread().ident
    ring = [profiling.Span("a", i * 10**6, i * 10**6 + 5000, None, me, main,
                           {}) for i in range(6)]
    if case == "no pairs":
        events = [(i * 1e3, i * 1e3 + 5, "b") for i in range(6)]
    else:
        events = [(i * 1e3 + (300.0 if i % 2 else 0.0),
                   i * 1e3 + 5 + (300.0 if i % 2 else 0.0), "a")
                  for i in range(6)]
    assert profiling.clock_offset(ring, events) is None


def test_pool_batches_carry_their_worker_spans():
    """Every batch taken from a 2-worker pool has its loader.batch span
    (worker, epoch, bi) and its children, stamped in that worker between
    the task's send and the batch's take."""
    ds = SyntheticDataset(n_frames=3, n_cams=2, hw=(32, 32), n_verts=300,
                          voxel_size=0.03, n_rand=16)
    pool = t_loader.WorkerPool(ds, num_workers=2)
    try:
        taken = []
        dl = t_loader.DataLoader(ds, range(6), chunk_rays=16, pool=pool,
                                 epoch=3)
        sent = time.time_ns()
        for _ in dl:
            taken.append(time.time_ns())
        pids = [p.pid for p in pool._procs]
    finally:
        pool.shutdown()
    spans = profiling.spans()
    batches = {s.ids["bi"]: s for s in spans if s.name == "loader.batch"}
    assert sorted(batches) == list(range(6))
    for bi, s in batches.items():
        assert s.ids == {"epoch": 3, "bi": bi, "worker": bi % 2}
        assert s.pid == pids[bi % 2] and s.parent is None
        assert sent <= s.start <= s.end <= taken[bi]
        kids = {k.name: k for k in spans if k.parent == "loader.batch"
                and k.ids == s.ids}
        assert set(kids) == {"loader.samples", "loader.collate"}
        for k in kids.values():
            assert s.start <= k.start <= k.end <= s.end


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    from fake_data import make_fake_zju
    return make_fake_zju(str(tmp_path_factory.mktemp("spans")
                             / "CoreView_999"))


def test_trainer_epoch_spans_its_waits_and_dispatches(fake_root, tmp_path):
    """A CPU Trainer epoch (2 dispatches of G = 2 steps, the banked path's
    prefetcher, the loader's thread) under a profiler: one train.data_wait
    per batch and one for the epoch's end, one train.dispatch per dispatch,
    each inside the train.iteration that pulled it;
    the recorder's data_time holds the waits that those spans time, and its
    batch_time each dispatch's whole wall time (waits included)."""
    from test_torch_harness import G, STEPS, harness_cfg
    cfg = harness_cfg(t_make_cfg, fake_root, tmp_path)
    trainer = t_trainer.Trainer(cfg, device="cpu")
    try:
        with _cpu_profile():
            trainer.train_epoch(0)
    finally:
        trainer.close()
    spans = profiling.spans()
    named = {}
    for s in spans:
        named.setdefault(s.name, []).append(s)
    waits = sorted(named["train.data_wait"], key=lambda s: s.ids["bi"])
    assert [s.ids for s in waits] == [{"epoch": 0, "bi": i}
                                      for i in range(STEPS + 1)]
    assert [s.ids for s in named["train.dispatch"]] == [
        {"epoch": 0, "dispatch": d} for d in range(STEPS // G)]
    assert len(named["train.readback"]) == STEPS // G
    # the pulls from the epoch's generator, the last one ending it
    assert [s.ids["dispatch"] for s in named["train.iteration"]] == list(
        range(STEPS // G + 1))
    assert {s.parent for s in waits + named["train.dispatch"]} == {
        "train.iteration"}
    # the loader's own span of the consumer's wait, inside each data wait
    assert [s.ids for s in named["loader.wait"]] == [
        {"epoch": 0, "bi": i} for i in range(STEPS + 1)]
    assert {s.parent for s in named["loader.wait"]} == {"train.data_wait"}
    # the groups handed over, then the waits for them at the end (the
    # last: for the prefetcher's end)
    assert {s.ids["dispatch"] for s in named["train.submit"]} == set(
        range(STEPS // G + 1))
    # batch 0 of a run's first epoch is made by the hat plan's probe
    assert sorted(s.ids["bi"] for s in named["loader.batch"]) == list(
        range(1, STEPS))
    rec = trainer.recorder
    assert rec.data_time.count == len(waits)
    for got, s in zip(rec.data_time.deque, waits):
        assert 0 <= (s.end - s.start) * 1e-9 - got < 1e-3
    assert rec.batch_time.count == STEPS // G
    assert rec.batch_time.total * G >= sum(list(rec.data_time.deque)[:STEPS])


# -- the benchmark's readers of these spans ----------------------------------

OFFSET_US = -5e6     # trace_us = ns / 1e3 + OFFSET_US


class _Run:
    def __init__(self, traced):
        self.traced = traced
        self.config = {"num_workers": 2}


def _timeline(program_spans=True, batches=((0, 900, 1300), (1, 1300, 1500),
                                            (0, 2100, 2300), (1, 500, 700))):
    """A traced window 1000-2000 us; the card busy 1000-1200, 1500-1600 and
    1900-2000; the main thread's spans, its data wait taking batch 3; with
    program_spans the ring holds those spans and the workers' `batches`
    (worker, start, end on the trace's clock; batch i the i-th)."""
    ev = [{"name": WINDOW, "cat": "user_annotation", "ts": 1000,
           "dur": 1000, "tid": 1}]
    ev += [{"name": "k", "cat": "kernel", "ts": a, "dur": b - a}
           for a, b in ((1000, 1200), (1500, 1600), (1900, 2000))]
    host = [("train.data_wait", 1100, 1400), ("train.dispatch", 1550, 1700),
            ("render.image", 1150, 1950), ("render.chunk", 1300, 1350)]
    if not program_spans:
        host = [("bench.train_epoch", 1000, 2000)]
    ev += [{"name": n, "cat": "user_annotation", "ts": a, "dur": b - a,
            "tid": 1} for n, a, b in host]
    me, main = os.getpid(), threading.main_thread().ident
    if program_spans:
        ns = lambda us: int((us - OFFSET_US) * 1e3)  # noqa: E731
        profiling.record([profiling.Span(
            n, ns(a), ns(b), None, me, main,
            {"epoch": 0, "bi": 3} if n == "train.data_wait" else {})
            for n, a, b in host])
        profiling.record([
            profiling.Span("loader.batch", ns(a), ns(b), None, me + 1 + w,
                           0, {"epoch": 0, "bi": i, "worker": w})
            for i, (w, a, b) in enumerate(batches)])
    return _Run(Trace(ev))


# idle 1200-1500 and 1600-1900 of a 1000 us window; the workers' two
# batches that overlap it, 400 and 200 us long, 300 + 200 us inside it,
# and batch 3, 200 us, made before it and taken in it
WANT = {"loader_wait_idle_share.train": 20.0,     # 1200-1400
        "dispatch_idle_share.train": 10.0,        # 1600-1700
        "render_host_idle_share.render": 60.0,    # 1200-1500, 1600-1900
        "worker_batch_ms.train": 0.2,
        "worker_busy_share.train": 25.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_built_timeline(name):
    got = harness.load_reader(name)(_timeline())
    assert got == pytest.approx(WANT[name], abs=1e-6)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_its_spans_is_none(name):
    read = harness.load_reader(name)
    assert read(_timeline(program_spans=False)) is None
    assert read(_Run(None)) is None


def test_an_idle_pool_reads_no_busy_time():
    """A window in which the pool made no batch and from which it took none
    (an epoch's tail, the pool done ahead): the pool is 0% busy, and there
    is no batch time to read."""
    run = _timeline(batches=((0, 100, 300), (1, 2100, 2300)))
    assert harness.load_reader("worker_busy_share.train")(run) == 0.0
    assert harness.load_reader("worker_batch_ms.train")(run) is None
