"""Host ms of one training batch in the loader's pool, under the traced
window's contention: the median loader.batch span (a worker's
produce_batch: the dataset's items, collate, the hat plan) over the
batches whose span overlaps the traced window or that the window's data
waits took."""
import statistics

from benchmark import spans


def read(run):
    got = spans.worker_batches(run)
    used = [b - a for a, b, _, taken in got or () if taken]
    return 1e-3 * statistics.median(used) if used else None
