"""The whole training step's share of the card's f32 peak (%): the model's
operations in the traced steps, forward and backward, over the traced
window and the TF32 peak."""
from benchmark import work


def read(run):
    if run.traced is None:
        return None
    return work.mfu(run, work.train(run)["model_flops"])
