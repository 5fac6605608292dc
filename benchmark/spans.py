"""What the program's own spans (neuralbody_tpu_torch/utils/profiling.span)
say about a traced stretch. The main thread's spans are in the trace
(run.traced.host, on its clock); the loader workers' are in the program's
ring, put on the trace's clock by profiling.clock_offset from the main
thread's spans, which are in both. Each function returns None where the
spans it reads are missing (a program that records none)."""
from __future__ import annotations


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _idle(traced):
    """The card's idle intervals inside the traced window."""
    gaps, cur = [], traced.t0
    for a, b, _ in sorted(traced.device):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if traced.t1 > cur:
        gaps.append((cur, traced.t1))
    return gaps


def _overlap(xs, ys):
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_share(run, accept):
    """% of the traced window in which the card is idle and the main thread
    is inside a span whose name `accept` takes (by containment: a span
    inside it counts too)."""
    t = run.traced
    if t is None or t.t1 <= t.t0:
        return None
    inside = _union((max(a, t.t0), min(b, t.t1)) for a, b, n in t.host
                    if accept(n) and min(b, t.t1) > max(a, t.t0))
    if not inside:
        return None
    return 100.0 * _overlap(_idle(t), inside) / (t.t1 - t.t0)


def worker_batches(run):
    """The pool workers' loader.batch spans on the trace's clock, as
    (start, end, inside, taken): microseconds; whether the span overlaps
    the traced window (the pool at work under its contention); whether it
    does or its batch is one that the window's train.data_wait took (made
    just before it: a window at an epoch's tail, which the pool has
    finished ahead, overlaps none)."""
    t = run.traced
    if t is None:
        return None
    try:
        from neuralbody_tpu_torch.utils import profiling
        ring = profiling.spans()
        offset = profiling.clock_offset(ring, t.host)
    except (ImportError, AttributeError):
        return None
    pool = [s for s in ring if s.name == "loader.batch"
            and isinstance(s.ids.get("worker"), int)]
    if offset is None or not pool:
        return None
    pulled = {(s.ids["epoch"], s.ids["bi"]) for s in ring
              if s.name == "train.data_wait"
              and t.t0 <= s.start / 1e3 + offset <= t.t1}
    out = []
    for s in pool:
        a, b = s.start / 1e3 + offset, s.end / 1e3 + offset
        inside = b > t.t0 and a < t.t1
        out.append((a, b, inside,
                    inside or (s.ids["epoch"], s.ids["bi"]) in pulled))
    return out
