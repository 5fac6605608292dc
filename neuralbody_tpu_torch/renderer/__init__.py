"""Renderers: latent_xyzc's volume render (hat path and plan-free) and the
NeRF baseline's coarse + fine render."""
from . import renderer, volume_renderer  # noqa: F401  (registers plugins)
