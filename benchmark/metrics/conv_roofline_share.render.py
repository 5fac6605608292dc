"""The sparse-conv kernel's share of its roofline over the traced images
(%): one encode's forward convolutions an image."""
from benchmark import work


def read(run):
    if run.traced is None:
        return None
    return work.share(run, work.render(run)["conv"], "conv")
