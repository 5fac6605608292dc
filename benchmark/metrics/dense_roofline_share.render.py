"""The dense kernel's share of its roofline over the traced images (%): the
coarse and fine MLPs' layers over the samples of the images' real rays."""
from benchmark import work


def read(run):
    if run.traced is None:
        return None
    return work.share(run, work.render(run)["dense"], "dense")
