"""One module per model family, found by the configuration's `reference`
name: benchmark/families/<name>.py, beside the plain reference
benchmark/reference/<name>.py. A family module holds what the harness does
differently for its model, so that a new family comes as new files:

    write_extra(root, seed, n_frames, config, device)
        the files its dataset reads beyond the shared sequence
        (benchmark/sequence.py), written after it and before any dataset
        or Trainer exists;
    geometry(root, frames, config)
        {frame: geometry} that the check and the work count read, with at
        least reference.common.sequence_geometry's keys ("box": the world
        box where a frame's rays start and end);
    train_work(run), render_work(run)
        the traced stretch's work, counted with roofline.py:
        {"conv", "hat", "dense", "model_flops"} of the training steps and
        {"conv", "dense", "model_flops"} of the images.
"""
from __future__ import annotations

import importlib

from ..harness import CellError

API = ("write_extra", "geometry", "train_work", "render_work")


def find(name):
    """The family module `name`. CellError 2 where there is none or it lacks
    part of the API: a run never counts with another family's code."""
    if not (isinstance(name, str) and name.isidentifier()):
        raise CellError(2, f"no model family {name!r}: not a module name")
    module = f"{__name__}.{name}"
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise CellError(2, f"no model family {name!r}: benchmark/families/"
                        f"{name}.py is missing") from None
    missing = [f for f in API if not callable(getattr(mod, f, None))]
    if missing:
        raise CellError(2, f"model family {name!r} lacks {missing}")
    return mod
