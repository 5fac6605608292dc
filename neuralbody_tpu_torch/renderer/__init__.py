"""Renderers: latent_xyzc's volume render (hat path and plan-free), the
NeRF baseline's coarse + fine render and the T-pose variant's render."""
from . import renderer, volume_renderer, tpose_renderer  # noqa: F401
