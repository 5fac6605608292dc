"""The card idle while the host dispatches a group of steps (%): the share
of the traced window in which the card is idle and the main thread is
inside the program's train.dispatch span (ConfigRun's dispatch of G steps:
the eager steps' launches, a graph's copy-in and replay, a capture)."""
from benchmark import spans


def read(run):
    return spans.idle_inside_share(run, lambda n: n == "train.dispatch")
