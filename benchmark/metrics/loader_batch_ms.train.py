"""Host ms of one training batch on one thread: the dataset's __getitem__,
collate and the hat plan, timed after the window over the traffic's
loader_batches batches of a fresh epoch (the port's make_data_loader
without its pool, which makes them on its own thread)."""


def read(run):
    s = run.traced_info.get("loader_batch_s")
    return None if s is None else 1e3 * s
