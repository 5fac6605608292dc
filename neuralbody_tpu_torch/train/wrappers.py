"""Trainer wrappers: the loss per network family (counterpart of
neuralbody_tpu/train/wrappers.py).

Each registered trainer returns the loss function with the port's harness
signature ``loss_fn(params, batch, settings, generator=None) -> (loss,
(ret, new_bn, stats))``. The render function is recovered from the
settings' type (renderer/dispatch.py), so the families share the generic
loss in train/step.py, which adds the NeRF baseline's rgb0 term when the
render returns it. "tpose" is registered as in the JAX package.
"""
from __future__ import annotations

from ..config import register
from .step import loss_fn, masked_mse  # noqa: F401  (re-export)


@register("trainer", "if_nerf_clight")
def make_clight_trainer(cfg):
    return loss_fn


@register("trainer", "nerf")
def make_nerf_trainer(cfg):
    return loss_fn


@register("trainer", "tpose")
def make_tpose_trainer(cfg):
    return loss_fn
