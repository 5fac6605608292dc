"""The card's idle share of the traced window (%): 1 - the union of its
busy intervals over the window."""


def read(run):
    if run.traced is None or run.traced.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.traced.busy_s / run.traced.window_s)
