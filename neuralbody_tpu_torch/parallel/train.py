"""Sharded training and evaluation steps (counterpart of
neuralbody_tpu/parallel/train.py).

The JAX package jits the step over a device mesh and GSPMD inserts the
collectives: every reduction is global, state is replicated. Here one
process drives one card, the state is replicated (parallel/mesh.py
replicate_state), and the step makes GSPMD's collectives explicit
(parallel/collectives.py: all_reduce and broadcast only):

  * mode="rays", a batch on the hat path (a host plan, or rays only under
    settings.hat_plan): every rank holds the same global batch, encodes
    the whole volume, decodes its share of the hat groups and gathers the
    ranks' raw fields (RenderSettings.group_shard = GroupShard), so every
    rank composites every ray and takes the global loss; its own groups'
    part of the gradient is local.
  * mode="rays", any other batch (the plan-free render, NeRF, T-pose):
    each rank renders its share of the rays (parallel/mesh.shard_batch),
    and the loss divides by the valid rays of every rank (an all_reduce of
    the count), as masked_mse's global sum does under GSPMD.
  * mode="batch": each rank steps on its own frames (the loader's host
    shard), the loss divides by every rank's valid rays, and the encoder's
    BatchNorm is synced over the ranks (EncoderStatic.bn_sum = all_sum,
    which ops/sparse_conv.masked_batch_norm sums each pass through).

Then every rank sums every gradient leaf over the ranks (one all_reduce a
dtype, every leaf in one order, the zero gradients of unreached leaves
included) before the value clip and Adam, so the ranks end the step with
bit-equal parameters; in rays mode rank 0's BatchNorm batch statistics go
to every rank (the encoder is replicated, and on the card the vertex
codes' float atomics may move its last bits from rank to rank).

With one rank the steps are the plain ones, CUDA graphs included. With
more they run eagerly (the JAX package jits the sharded scan; graphing
these steps is ROADMAP.md section 1, item 13). The banked scan step is
single-process, as in the JAX package: with more than one rank the
Trainer attaches the geometry to each batch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..renderer.dispatch import get_render_fn
from ..train import step as _step
from ..train.optimizer import tree_leaves
from ..train.step import (hat_path, loss_and_grads, merge_bn_stats,
                          scan_length, scan_slice, train_step,
                          train_step_scan, train_step_scan_banked)
from ..utils.platform import resolve_device, to_device
from . import bootstrap
from .collectives import (all_reduce_tensors, all_sum, broadcast_tensors,
                          gather_parts, gather_rows, split)
from .mesh import RAY_KEYS, shard_batch

MODES = ("rays", "batch")


class GroupShard(NamedTuple):
    """RenderSettings.group_shard: this rank's share of the hat groups,
    and the gather of every rank's raw field."""
    rank: int
    world: int

    def share(self, n_groups):
        return split(n_groups, self.rank, self.world)

    def gather(self, x, first, total):
        return gather_rows(x, first, total)


def _bn_synced(settings):
    """settings with the encoder's BatchNorm summed over the ranks."""
    model = settings.model
    return settings._replace(model=model._replace(
        encoder=model.encoder._replace(bn_sum=all_sum)))


def _ranks(rank, world):
    return (bootstrap.rank() if rank is None else rank,
            bootstrap.world() if world is None else world)


def sharded_step(params, bn_stats, opt, batch, settings, mode="rays",
                 rank=None, world=None, device=None, generator=None):
    """One optimization step of this rank in a group of `world` (see the
    module's docstring for the three layouts). batch: the global batch in
    rays mode, this rank's frames in batch mode. Returns (bn_stats,
    stats), as train_step; the stats are global and equal on every
    rank."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    rank, world = _ranks(rank, world)
    device = resolve_device(device)
    group_split = mode == "rays" and hat_path(batch, settings)
    if group_split:
        settings = settings._replace(group_shard=GroupShard(rank, world))
    elif mode == "rays":
        batch = shard_batch(batch, rank, world)
    batch = to_device(batch, device)
    count = None
    if not group_split:
        count = batch["ray_mask"].sum().float().reshape(1)
        all_reduce_tensors([count])
        count = count[0]
    if mode == "batch" and hasattr(settings.model, "encoder"):
        settings = _bn_synced(settings)
    loss, (_, new_bn, stats), grads = loss_and_grads(
        params, batch, settings, generator, count)
    all_reduce_tensors(tree_leaves(grads))
    opt.step(params, grads)
    stats["loss"] = loss
    if not group_split:
        _global_stats(stats)
    if mode == "rays" and new_bn:
        broadcast_tensors(tree_leaves(new_bn))
    return merge_bn_stats(bn_stats, new_bn), stats


def _global_stats(stats):
    """Each rank's losses are its part of the global mean: sum them (and
    the plan overflow flags), then the PSNR of the global image loss."""
    keys = [k for k in ("loss", "img_loss", "img_loss0", "plan_overflow")
            if k in stats]
    vals = torch.stack([stats[k].float() for k in keys])
    all_reduce_tensors([vals])
    for k, v in zip(keys, vals):
        stats[k] = v
    if "plan_overflow" in stats:
        stats["plan_overflow"] = (stats["plan_overflow"] > 0).float()
    stats["psnr"] = -10.0 * torch.log10(stats["img_loss"])


def make_sharded_train_step(mode="rays", rank=None, world=None):
    """A step with train_step's signature, (params, bn_stats, opt, batch,
    settings, device=None, generator=None) -> (bn_stats, stats), over the
    process group (rank and world default to bootstrap's): train_step
    itself with one rank, sharded_step with more."""
    rank, world = _ranks(rank, world)
    if world == 1:
        return train_step

    def step(params, bn_stats, opt, batch, settings, device=None,
             generator=None):
        return sharded_step(params, bn_stats, opt, batch, settings, mode,
                            rank, world, device, generator)
    return step


def make_sharded_scan_step(mode="rays", rank=None, world=None):
    """G steps a dispatch with train_step_scan's signature (batches carry
    a leading step axis): train_step_scan itself with one rank (the CUDA
    graph on the card), G eager sharded steps with more."""
    rank, world = _ranks(rank, world)
    if world == 1:
        return train_step_scan

    def scan(params, bn_stats, opt, batches, settings, device=None,
             generator=None):
        stats = []
        for i in range(scan_length(batches)):
            bn_stats, s = sharded_step(
                params, bn_stats, opt, scan_slice(batches, i), settings,
                mode, rank, world, device, generator)
            stats.append(s)
        return bn_stats, {k: torch.stack([s[k] for s in stats])
                          for k in stats[0]}
    return scan


def make_sharded_scan_step_banked(world=None):
    """train_step_scan_banked: single-process, as in the JAX package
    (with more than one rank the geometry rides with each batch)."""
    if _ranks(None, world)[1] != 1:
        raise ValueError("the banked scan step is single-process; with "
                         "more than one rank attach the geometry to the "
                         "batches (ConfigRun(bank=False))")
    return train_step_scan_banked


def _ray_share(R, chunk, rank, world):
    """[first, last) of the rays this rank renders: whole chunks when
    there are at least as many as ranks, else an equal split of R."""
    n = R // chunk
    if n >= world and R % chunk == 0:
        c0, c1 = split(n, rank, world)
        return c0 * chunk, c1 * chunk
    if R % world:
        raise ValueError(f"{R} eval rays in {n} chunks of {chunk} do not "
                         f"split over {world} ranks")
    return R * rank // world, R * (rank + 1) // world


class ShardedEval:
    """The deterministic eval render over the process group (the JAX
    package's make_sharded_eval_step and ShardedEval): (params, batch) ->
    eval_step's maps, whole on every rank (the JAX step's replicated
    out_shardings). With one rank it is eval_step.

    A hat batch renders through the group-sharded hat path; a rays-only
    batch splits its rays over the ranks (whole chunks where it can), each
    rank renders its share through eval_step, and an all_reduce of the
    zero-filled maps gives every rank all of them."""

    def __init__(self, settings, device=None, rank=None, world=None):
        get_render_fn(settings)   # refuses a settings type no family has
        self.settings = settings
        self.device = device
        self.rank, self.world = _ranks(rank, world)

    def __call__(self, params, batch):
        # train/step.eval_step looked up at the call (an instrumented one
        # is seen)
        eval_step, s, dev = _step.eval_step, self.settings, self.device
        if self.world == 1:
            return eval_step(params, batch, s, device=dev)
        if "hat_sort" in batch:
            return eval_step(params, batch, s._replace(
                group_shard=GroupShard(self.rank, self.world)), device=dev)
        R = batch["ray_o"].shape[1]
        r0, r1 = _ray_share(R, min(s.chunk_rays, R), self.rank, self.world)
        local = {k: v[:, r0:r1] if k in RAY_KEYS else v
                 for k, v in batch.items()}
        ret = eval_step(params, local, s, device=dev)
        for k, v in ret.items():
            if v.dim() < 2 or v.shape[1] != r1 - r0:
                raise ValueError(f"eval map {k} {tuple(v.shape)} has no ray "
                                 "axis 1 to gather")
        return {k: gather_parts(v, r0, R, 1) for k, v in ret.items()}
