"""Steps (the training step, its graphed dispatch, the forward-render step
and fresh.py's config-driven run), the trainer wrappers, the optimizers
with their learning-rate schedules, and the harness around them: the
Trainer (trainer.py), checkpoints (checkpoint.py) and the recorder
(recorder.py)."""
from . import wrappers  # noqa: F401  (registers trainer plugins)
