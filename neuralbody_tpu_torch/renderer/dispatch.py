"""Render-function dispatch keyed on the settings type (counterpart of
neuralbody_tpu/renderer/dispatch.py), so that the training and evaluation
steps stay family-generic. The T-pose family is not ported yet: its
settings type does not exist here, and an unknown type raises.
"""
from __future__ import annotations

from .renderer import RenderSettings, render_density_grid, render_rays
from .volume_renderer import (NerfRenderSettings, render_nerf_density_grid,
                              render_nerf_rays)


def get_render_fn(settings):
    """Map a Settings value to its render function.

    All render functions share the signature
    ``render(params, batch, settings, train=False, generator=None) ->
    (ret, new_bn_stats)``.
    """
    if isinstance(settings, NerfRenderSettings):
        return render_nerf_rays
    if isinstance(settings, RenderSettings):
        return render_rays
    raise TypeError(
        f"no render function for settings type {type(settings).__name__}")


def get_density_grid_fn(settings):
    """Map Settings to the dense-grid density evaluator used by mesh
    extraction: latent_xyzc's multi-scale-volume decode or the NeRF
    baseline's density-only trunk."""
    if isinstance(settings, NerfRenderSettings):
        return render_nerf_density_grid
    if isinstance(settings, RenderSettings):
        return render_density_grid
    raise TypeError(
        f"no density-grid function for {type(settings).__name__}")
