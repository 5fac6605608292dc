"""The shard layout of a batch over the ranks (counterpart of
neuralbody_tpu/parallel/mesh.py).

The JAX package places a batch on a 1-D device mesh with named shardings
and lets GSPMD partition the step. torch has no mesh: one process drives
one card, and what carries over is the layout, as pure functions of a host
batch. batch_layout says, key by key, which axis a key splits on
(JAX's batch_shardings specs); shard_batch returns one rank's part.

  * mode="rays": the ray keys split on the ray axis; the hat plan's tables
    (hat_seg_a*, hat_seg_cum*, hat_rows*, hat_wpts, hat_vdir, and the flat
    hat_sort) on the group axis when the group count divides the world
    (the loader pads n_groups to a multiple of 8), else they stay whole;
    everything else is replicated. Every rank builds the same global batch
    (datasets/loader.py _batch_seed).
  * mode="batch" (cfg.train.data_sharding "host" with more than one rank):
    every per-frame leaf splits on the batch axis; each rank loads its own
    frames.

`stacked` batches carry a leading step axis G in front of every leaf.
"""
from __future__ import annotations

from .collectives import broadcast_tensors

RAY_KEYS = frozenset({"ray_o", "ray_d", "near", "far", "rgb", "ray_mask",
                      "pts", "z_vals", "z_frac"})
GROUP_KEYS = frozenset(
    {f"hat_seg_a{l}" for l in (1, 2, 3, 4)}
    | {f"hat_seg_cum{l}" for l in (1, 2, 3, 4)}
    | {f"hat_rows{l}" for l in (1, 2, 3, 4)}
    # ADVICE.md on neuralbody_tpu/parallel/mesh.py:93: the pre-expanded
    # group points and dirs belong to the group-sharded set
    | {"hat_wpts", "hat_vdir"})
FLAT_GROUP_KEYS = frozenset({"hat_sort"})


def n_groups(batch, stacked=False):
    """The hat plan's group count, or None for a batch without one."""
    proto = batch.get("hat_seg_a1", batch.get("hat_rows1"))
    return None if proto is None else proto.shape[2 if stacked else 1]


def batch_layout(batch, world, stacked=False, mode="rays"):
    """{key: (what, axis)} for every top-level key: what is "rays",
    "groups", "groups_flat", "batch" or None (replicated), axis the axis it
    splits on (None when replicated). A dict leaf (geom) takes one entry
    for all its arrays."""
    lead = 1 if stacked else 0
    if mode == "batch":
        return {k: ("batch", lead) for k in batch}
    if mode != "rays":
        raise ValueError(f"mode {mode!r}: 'rays' or 'batch'")
    ng = n_groups(batch, stacked)
    groups_ok = ng is not None and ng % world == 0

    def spec(k, v):
        if isinstance(v, dict):
            return (None, None)
        if k in RAY_KEYS:
            return ("rays", lead + 1)
        if groups_ok and k in GROUP_KEYS:
            return ("groups", lead + 1)
        if groups_ok and k in FLAT_GROUP_KEYS:
            return ("groups_flat", lead + 1)
        return (None, None)

    return {k: spec(k, v) for k, v in batch.items()}


def _part(x, axis, rank, world):
    n = x.shape[axis]
    if n % world:
        raise ValueError(f"an axis of {n} does not split over {world} "
                         "ranks")
    step = n // world
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(rank * step, (rank + 1) * step)
    return x[tuple(idx)]


def shard_batch(batch, rank, world, stacked=False, mode="rays"):
    """Rank `rank`'s part of a host (numpy or tensor) batch under
    batch_layout: split keys keep their rank-th equal share of the axis
    (which must divide), the rest is returned whole (not copied)."""
    layout = batch_layout(batch, world, stacked, mode)
    out = {}
    for k, v in batch.items():
        what, axis = layout[k]
        if what is None:
            out[k] = v
        elif isinstance(v, dict):
            out[k] = {n: _part(a, axis, rank, world) for n, a in v.items()}
        else:
            out[k] = _part(v, axis, rank, world)
    return out


def replicate_state(*trees):
    """Rank 0's values of every tensor in the trees (params, BN stats, the
    optimizer's state_dict), broadcast in place to every rank; other
    leaves (a step count) are left alone."""
    import torch
    from ..train.optimizer import tree_leaves
    broadcast_tensors([t for tree in trees for t in tree_leaves(tree)
                       if isinstance(t, torch.Tensor)])
