"""Steps (the training step, its graphed dispatch, the forward-render step
and fresh.py's config-driven run), the trainer wrappers and the optimizer
with its learning-rate schedules."""
from . import wrappers  # noqa: F401  (registers trainer plugins)
