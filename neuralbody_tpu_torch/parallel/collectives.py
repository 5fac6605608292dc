"""The collectives the sharded steps use, over the default process group.

Only all_reduce and broadcast: gloo supports no other collective on CUDA
tensors, and the same code must run under NCCL and under gloo on the card
and on the CPU. A gather is an all_reduce of a zero-filled buffer in which
each rank writes its own part (x + 0 is x exactly, so the result is the
parts themselves, on every rank).

Each call passes explicit tensors in a fixed order, so every rank issues
the same collectives in the same order; a rank that skipped one would
hang the others until the group's timeout (parallel/bootstrap.py).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _AllSum(torch.autograd.Function):
    """y = sum over ranks of x, on every rank. Each rank's y feeds its own
    loss, and the loss the step minimizes is the sum of the ranks' losses,
    so the gradient at x is the sum of the ranks' gradients at y: the
    backward reduces too (a synced BatchNorm's statistics)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_sum(x):
    """Differentiable sum over the ranks (see _AllSum)."""
    return _AllSum.apply(x)


class _GatherRows(torch.autograd.Function):
    """[total, ...] on every rank from each rank's rows [first, first + n).
    Every rank computes the same loss from the whole result, and each
    rank's own rows reach only its own part: the gradient at x is the
    result's gradient at those rows, with no collective."""

    @staticmethod
    def forward(ctx, x, first, total):
        buf = x.new_zeros((total,) + tuple(x.shape[1:]))
        buf[first:first + x.shape[0]] = x
        dist.all_reduce(buf)
        ctx.rows = (first, x.shape[0])
        return buf

    @staticmethod
    def backward(ctx, g):
        first, n = ctx.rows
        return g[first:first + n], None, None


def gather_rows(x, first, total):
    """The rows of every rank, [total, ...] (see _GatherRows)."""
    return _GatherRows.apply(x, first, total)


def gather_parts(x, first, total, dim):
    """Like gather_rows on axis `dim`, without a gradient (an eval render's
    maps)."""
    shape = list(x.shape)
    shape[dim] = total
    buf = x.new_zeros(shape)
    buf.narrow(dim, first, x.shape[dim]).copy_(x)
    dist.all_reduce(buf)
    return buf


def _by_dtype(tensors):
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups.values()


def _flat(tensors, collective):
    """collective(flat) on one flat buffer a dtype of `tensors`, in the
    order given, and the result copied back into each tensor."""
    for idx in _by_dtype(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[off:off + n].view_as(tensors[i]))
            off += n


def all_reduce_tensors(tensors):
    """Sum each tensor over the ranks, in place: one all_reduce of a flat
    buffer per dtype."""
    _flat(tensors, lambda t: dist.all_reduce(t))


def broadcast_tensors(tensors, src=0):
    """Rank src's values of each tensor on every rank, in place: one
    broadcast of a flat buffer per dtype."""
    _flat(tensors, lambda t: dist.broadcast(t, src))


def split(n, rank, world):
    """[first, last) of rank's share of n items: a balanced split in rank
    order."""
    return n * rank // world, n * (rank + 1) // world
