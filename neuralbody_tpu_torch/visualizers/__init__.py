"""Visualization sinks (counterpart of neuralbody_tpu/visualizers/): the
registered "if_nerf", "if_nerf_demo", "if_nerf_perform", "if_nerf_test"
and "if_nerf_mesh" visualizers."""
from . import visualizers  # noqa: F401  (registers plugins)
