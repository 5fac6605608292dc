"""The dense kernel's share of its roofline over the traced training steps
(%): the coarse and fine MLPs' layers forward, their weight gradients and
their input gradients over the steps' rays."""
from benchmark import work


def read(run):
    if run.traced is None:
        return None
    return work.share(run, work.train(run)["dense"], "dense")
