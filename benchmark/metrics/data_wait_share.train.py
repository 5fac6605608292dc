"""The Trainer's wait for its loader: the time its loop spent blocked in
the loader's next() over the traced stretch, as a share of the stretch's
wall time (%)."""


def read(run):
    info = run.traced_info
    if not info.get("steps") or not info.get("wall_s"):
        return None
    return 100.0 * info["data_wait_s"] / info["wall_s"]
