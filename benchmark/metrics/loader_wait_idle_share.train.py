"""The card idle while the Trainer waits for its loader (%): the share of
the traced window in which the card is idle and the main thread is inside
the program's train.data_wait span (ConfigRun's next() on the loader)."""
from benchmark import spans


def read(run):
    return spans.idle_inside_share(run, lambda n: n == "train.data_wait")
