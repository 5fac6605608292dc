"""The card idle while the host renders an image (%): the share of the
traced window in which the card is idle and the main thread is inside one
of the program's render.* spans (eval_step's render.image and what it
holds: render.upload, render.encode, render.chunk)."""
from benchmark import spans


def read(run):
    return spans.idle_inside_share(run, lambda n: n.startswith("render."))
