"""The hat kernels' (forward and backward) share of their roofline over the
traced training steps (%): the least time the steps' interpolation needs,
over the kernels' device time by name."""
from benchmark import work


def read(run):
    if run.traced is None:
        return None
    return work.share(run, work.train(run)["hat"], "hat")
