"""How busy the loader's pool is (%): the workers' loader.batch time inside
the traced window, over the number of workers times the window (0 where
the pool made no batch in it)."""
from benchmark import spans
from benchmark.loops.common import num_workers


def read(run):
    got = spans.worker_batches(run)
    workers = num_workers(run)
    if got is None or workers < 1:
        return None
    t = run.traced
    busy = sum(min(b, t.t1) - max(a, t.t0) for a, b, inside, _ in got
               if inside)
    return 100.0 * busy / (workers * (t.t1 - t.t0))
