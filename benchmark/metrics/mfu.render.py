"""The whole render's share of the card's f32 peak (%): the model's
operations of the traced images over the traced window and the TF32
peak."""
from benchmark import work


def read(run):
    if run.traced is None:
        return None
    return work.mfu(run, work.render(run)["model_flops"])
