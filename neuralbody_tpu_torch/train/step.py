"""Training and evaluation steps (counterpart of
neuralbody_tpu/train/step.py).

A training step is: render (latent_xyzc: encode, interpolation, decode,
composite; the NeRF baseline: coarse pass, importance resampling, fine
pass), masked MSE on the valid rays, backward, value-clip 40 + Adam (the
optimizer module beside this one) and the BatchNorm running-stat EMA. The
steps are family-generic: the render function is recovered from the
settings' type (renderer/dispatch.py). JAX returns new parameters; here the
step updates the parameter tensors in place, PyTorch's idiom.
train_step_scan runs G steps in one dispatch: on the card as one CUDA
graph (train/graphs.py); train_step_scan_banked is the same dispatch with
each step's frame geometry taken from a device bank (parallel/geom.py).
"""
from __future__ import annotations

import torch

from ..models.sparse_conv_net import update_running_stats
from ..parallel.geom import take
from ..parallel.transfer import Staged
from ..renderer.dispatch import get_render_fn
from ..utils.platform import resolve_device, to_device
from .optimizer import Adam, tree_leaves, tree_map


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


def loss_fn(params, batch, settings, generator=None):
    """Training render + masked MSE, plus the NeRF baseline's auxiliary
    coarse term when the render returns rgb0. Returns (loss, (ret, new_bn,
    stats)) with stats img_loss, psnr and, with rgb0, img_loss0."""
    ret, new_bn = get_render_fn(settings)(params, batch, settings,
                                          train=True, generator=generator)
    img_loss = masked_mse(ret["rgb_map"], batch["rgb"], batch["ray_mask"])
    loss = img_loss
    stats = {"img_loss": img_loss.detach()}
    if "rgb0" in ret:
        img_loss0 = masked_mse(ret["rgb0"], batch["rgb"], batch["ray_mask"])
        loss = loss + img_loss0
        stats["img_loss0"] = img_loss0.detach()
    stats["psnr"] = -10.0 * torch.log10(img_loss.detach())
    return loss, (ret, new_bn, stats)


def loss_and_grads(params, batch, settings, generator=None):
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


def train_step(params, bn_stats, opt, batch, settings, device=None,
               generator=None):
    """One optimization step.

    params: the parameter dict, on `device`, updated in place; bn_stats: the
    running BN state; opt: train/optimizer.Adam over params; batch: numpy or
    tensor batch (moved to `device`); settings: a RenderSettings or
    NerfRenderSettings; generator: the torch.Generator, on `device`, of the
    render's random draws (the raw-noise term when settings.raw_noise_std
    > 0; a rays-only or NeRF render's perturbation). `device` defaults to
    the card; with no card present that raises.

    Returns (new bn_stats, stats): stats holds img_loss, psnr and loss (and
    img_loss0 for a render with a coarse pass) as 0-d tensors on the device
    (reading them waits for the step).
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


def train_steps(params, bn_stats, opt, batches, settings, device=None,
                generator=None):
    """G eager train_steps over a sequence of batches, as a plain loop.
    Returns (bn_stats, stats stacked over the G steps)."""
    stats = []
    for batch in batches:
        bn_stats, s = train_step(params, bn_stats, opt, batch, settings,
                                 device=device, generator=generator)
        stats.append(s)
    return bn_stats, {k: torch.stack([s[k] for s in stats])
                      for k in stats[0]}


def scan_slice(batches, i):
    """Step i of a batch tree whose every leaf has a leading step axis."""
    return {k: scan_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in batches.items()}


def scan_length(batches):
    """G, the leading step axis that every leaf of a batch tree shares."""
    steps = {len(t) for t in tree_leaves(batches)}
    if len(steps) != 1:
        raise ValueError(f"the batch's leaves have leading axes {steps}, not "
                         "one step count G")
    return steps.pop()


def graphed(device, batches, opt):
    """Whether a dispatch of `batches` under `opt` replays a CUDA graph:
    on the card, for latent_xyzc's hat batches (they carry hat_sort) under
    Adam, whose moments and per-step scalars the graph reads. Every other
    dispatch (the CPU, the NeRF baseline's batches, the T-pose variant's
    batches, which carry no hat plan, RAdam and SGD) runs train_steps'
    eager loop: those paths have no graph yet (ROADMAP.md section 1, item
    13)."""
    return (device.type == "cuda" and "hat_sort" in batches
            and isinstance(opt, Adam))


def train_step_scan(params, bn_stats, opt, batches, settings, device=None,
                    generator=None):
    """G optimization steps in one dispatch (counterpart of the JAX
    package's train_step_scan).

    batches: one batch tree (numpy or tensors) whose every leaf has a
    leading axis of G steps. On the card (the default) latent_xyzc's hat
    batches under Adam replay as one CUDA graph of its train_step, held in
    opt.step_graph (train/graphs.StepGraph), captured at the first call and
    again when the shapes, dtypes, settings or the parameters' or moments'
    tensors change; a failed capture or replay raises. Any other dispatch
    (graphed() says which) and every dispatch with device="cpu" runs
    train_steps' loop over the G batches.

    Returns (bn_stats, stats stacked over the G steps). On the card the
    returned bn_stats are the graph's own buffers, which its next replay
    overwrites: pass them back in.
    """
    device = resolve_device(device)
    if not graphed(device, batches, opt):
        return _plain_scan(params, bn_stats, opt, batches, settings, device,
                           generator)
    from .graphs import StepGraph   # graphs.py builds on this module
    if opt.step_graph is None or opt.step_graph.device != device:
        opt.step_graph = StepGraph(device)
    return opt.step_graph(params, bn_stats, opt, batches, settings,
                          generator)


def train_step_scan_banked(params, bn_stats, opt, batches, bank, settings,
                           device=None, generator=None):
    """train_step_scan with each step's geometry selected from a device
    bank (counterpart of the JAX package's train_step_scan_banked).

    batches: a batch tree with a leading axis of G steps that carries
    geom_rows, int64 [G, B] rows of `bank` (parallel/geom.GeomBank), in
    place of geom: numpy, tensors, or a staging set of
    parallel/transfer.StagingRing. On the card it is train_step_scan's
    StepGraph with the selection inside the graph (where graphed() says
    so); otherwise it is train_steps' loop, step i given take(bank,
    geom_rows[i]). Returns
    (bn_stats, stats stacked over the G steps), as train_step_scan.
    """
    device = resolve_device(device)
    if not graphed(device, batches, opt):
        return _plain_scan(params, bn_stats, opt, batches, settings, device,
                           generator, bank)
    from .graphs import StepGraph
    if opt.step_graph is None or opt.step_graph.device != device:
        opt.step_graph = StepGraph(device)
    return opt.step_graph(params, bn_stats, opt, batches, settings,
                          generator, bank=bank)


def _plain_scan(params, bn_stats, opt, batches, settings, device, generator,
                bank=None):
    """train_steps' loop over the G steps of a batch tree, each step's
    geometry taken from `bank` when one is given. A staging set
    (parallel/transfer.Staged) is waited for before the steps read it and
    released once they have."""
    if isinstance(batches, Staged):
        batches.wait()
    steps = []
    for i in range(scan_length(batches)):
        step = scan_slice(batches, i)
        if bank is not None:
            step["geom"] = take(bank, to_device(step.pop("geom_rows"),
                                                device))
        steps.append(step)
    out = train_steps(params, bn_stats, opt, steps, settings, device=device,
                      generator=generator)
    if isinstance(batches, Staged):
        batches.consumed()
    return out


def eval_step(params, batch, settings, device=None):
    """Deterministic forward render (perturb off, batch-statistics BN, as
    the reference evaluates), family-generic.

    params: dict of tensors (a model's init or
    utils/transplant.params_from_jax); batch: numpy or tensor batch (for
    latent_xyzc with or without ops/hat_interp.prepare_hat_batch's fields;
    for the NeRF baseline ray_o/ray_d/near/far). Both move to `device`,
    which defaults to the card; with no card present that raises.

    Returns dict rgb_map [B,R,3], disp_map/acc_map/depth_map [B,R]; a
    NeRF render with a fine pass adds rgb0, disp0, acc0 and z_std.
    """
    device = resolve_device(device)
    params = to_device(params, device)
    batch = to_device(batch, device)
    with torch.no_grad():
        ret, _ = get_render_fn(settings)(params, batch, settings)
    return ret


# -- the NeRF-baseline steps: the same code under the JAX package's names ----

def nerf_loss_fn(params, batch, settings, generator=None):
    """loss_fn without the (empty) BN statistics: (loss, (ret, stats))."""
    loss, (ret, _, stats) = loss_fn(params, batch, settings, generator)
    return loss, (ret, stats)


def nerf_train_step(params, opt, batch, settings, device=None,
                    generator=None):
    """One optimization step of the NeRF baseline (see train_step); the
    family has no BN state. Returns stats."""
    _, stats = train_step(params, {}, opt, batch, settings, device=device,
                          generator=generator)
    return stats


def nerf_eval_step(params, batch, settings, device=None):
    """Deterministic coarse + fine render (see eval_step)."""
    return eval_step(params, batch, settings, device=device)
