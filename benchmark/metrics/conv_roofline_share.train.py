"""The sparse-conv kernel's share of its roofline over the traced training
steps (%): the least time of every convolution's forward and input
gradient over the active voxel pairs, over the kernel's device time."""
from benchmark import work


def read(run):
    if run.traced is None:
        return None
    return work.share(run, work.train(run)["conv"], "conv")
