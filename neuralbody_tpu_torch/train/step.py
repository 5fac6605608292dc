"""Training and evaluation steps (counterpart of
neuralbody_tpu/train/step.py).

A training step is: encode, hat interpolation, decode, composite, masked
MSE on the valid rays, backward, value-clip 40 + Adam (train/optimizer.py)
and the BatchNorm running-stat EMA. JAX returns new parameters; here the
step updates the parameter tensors in place, PyTorch's idiom.
"""
from __future__ import annotations

import torch

from ..models.sparse_conv_net import update_running_stats
from ..renderer.renderer import RenderSettings, render_rays
from ..utils.platform import resolve_device, to_device
from .optimizer import tree_leaves, tree_map


def masked_mse(pred, target, mask):
    """Mean squared error over valid rays (mask [B, R])."""
    m = mask[..., None]
    se = ((pred - target) ** 2) * m
    return se.sum() / torch.clamp(m.sum() * pred.shape[-1], min=1.0)


def merge_bn_stats(bn_stats, new_bn):
    """EMA-merge fresh batch statistics into the running BN state (an empty
    new_bn passes the running state through)."""
    if not new_bn:
        return bn_stats
    return {"xyzc_net": update_running_stats(bn_stats["xyzc_net"], new_bn)}


def loss_fn(params, batch, settings: RenderSettings, generator=None):
    """Training render + masked MSE. Returns (loss, (ret, new_bn, stats))
    with stats img_loss and psnr."""
    ret, new_bn = render_rays(params, batch, settings, train=True,
                              generator=generator)
    img_loss = masked_mse(ret["rgb_map"], batch["rgb"], batch["ray_mask"])
    stats = {"img_loss": img_loss.detach(),
             "psnr": -10.0 * torch.log10(img_loss.detach())}
    return img_loss, (ret, new_bn, stats)


def loss_and_grads(params, batch, settings: RenderSettings, generator=None):
    """The loss, loss_fn's aux and the gradient of every parameter (a tree
    of params' structure; a parameter the loss does not reach gets zeros,
    as JAX gives every leaf a gradient). params and batch are tensors on
    one device."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = loss_fn(params, batch, settings, generator)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    grads = tree_map(lambda p: _or_zeros(next(grads), p), params)
    return loss.detach(), aux, grads


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def train_step(params, bn_stats, opt, batch, settings: RenderSettings,
               device=None, generator=None):
    """One optimization step.

    params: the parameter dict, on `device`, updated in place; bn_stats: the
    running BN state; opt: train/optimizer.Adam over params; batch: numpy or
    tensor batch (prepare_hat_batch fields, moved to `device`); generator:
    the torch.Generator of the raw-noise term (needed when
    settings.raw_noise_std > 0). `device` defaults to the card; with no card
    present that raises.

    Returns (new bn_stats, stats): stats holds img_loss, psnr and loss as
    0-d tensors on the device (reading them waits for the step).
    """
    device = resolve_device(device)
    for p in tree_leaves(params):
        if p.device != device:
            raise ValueError(f"params must be on {device}, found one on "
                             f"{p.device}; move them with to_device before "
                             "building the optimizer")
    batch = to_device(batch, device)
    loss, (_, new_bn, stats), grads = loss_and_grads(params, batch, settings,
                                                     generator)
    opt.step(params, grads)
    stats["loss"] = loss
    return merge_bn_stats(bn_stats, new_bn), stats


def train_steps(params, bn_stats, opt, batches, settings: RenderSettings,
                device=None, generator=None):
    """G steps over a sequence of batches (counterpart of
    train_step_scan, as a plain loop). Returns (bn_stats, stats stacked
    over the G steps)."""
    stats = []
    for batch in batches:
        bn_stats, s = train_step(params, bn_stats, opt, batch, settings,
                                 device=device, generator=generator)
        stats.append(s)
    return bn_stats, {k: torch.stack([s[k] for s in stats])
                      for k in stats[0]}


def eval_step(params, batch, settings: RenderSettings, device=None):
    """Deterministic forward render (perturb off, batch-statistics BN, as
    the reference evaluates).

    params: dict of tensors (models/latent_xyzc.init or
    utils/transplant.params_from_jax); batch: numpy or tensor batch
    (ops/hat_interp.prepare_hat_batch fields). Both move to `device`,
    which defaults to the card; with no card present that raises.

    Returns dict rgb_map [B,R,3], disp_map/acc_map/depth_map [B,R].
    """
    device = resolve_device(device)
    params = to_device(params, device)
    batch = to_device(batch, device)
    with torch.no_grad():
        ret, _ = render_rays(params, batch, settings)
    return ret
