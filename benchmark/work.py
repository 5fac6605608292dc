"""The work of a run's traced stretch, counted from the cell's inputs with
the yardstick in roofline.py: per kernel family the operations, bytes and
least time, and the model's operations (forward and backward where the
stretch trains; recomputation and padding left out). What a model runs is
its family's to count (benchmark/families/<reference>.py); the shares of
a roofline and of the peak are worked out here for every family."""
from __future__ import annotations

from . import families
from . import roofline as rl


def train(run):
    """{"conv", "hat", "dense", "model_flops"} of the traced training
    steps, as the configuration's family counts them."""
    return families.find(run.config["reference"]).train_work(run)


def render(run):
    """{"conv", "dense", "model_flops"} of the traced images, as the
    configuration's family counts them."""
    return families.find(run.config["reference"]).render_work(run)


def share(run, work, family):
    """100 x the least time of a kernel family's work over its kernels'
    device time in the trace; None where none of them ran."""
    secs, n = run.traced.kernel_s(rl.KERNELS[family])
    if n == 0 or work.bound == 0:
        return None
    return 100.0 * work.bound / secs


def mfu(run, flops):
    """100 x the model's operations over the traced window at the peak;
    None where the window traced no step or image."""
    if flops <= 0 or run.traced.window_s <= 0:
        return None
    return 100.0 * flops / (run.traced.window_s * rl.PEAK_FLOPS["float32"])
