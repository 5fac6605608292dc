"""One level of hat interpolation, forward and backward: the Hopper
kernels, their plain versions and the wrappers that pick between them by
the tensors' device.

The forward kernel (csrc/hat_interp.cu: hat_interp_level_cuda) replaces
neuralbody_tpu/ops/pallas_hat.py:_fwd_kernel and computes the whole of
neuralbody_tpu/ops/hat_interp.py:hat_interp_level, the row gathers
feats[rows] and sites[rows] included, so neither the gathered rows nor the
[ngrp, P, capR] weights reach device memory. What bounds it on an H100:
writing the f32 output, 118.4 MB per render over the four levels at the
reference working point (10.8 / 21.5 / 43.1 / 43.1 MB for C = 32 / 64 /
128 / 128 at 658 groups x 128 points), ~35 us at 3.35 TB/s. Its design: a
block stages its group's rows (coordinates and features in their storage
type) in shared memory once, a warp owns a point, finds the at most 8 rows
that weigh on it (through a table from integer cell to staged row when
LOOKUP is set, else by scanning the staged coordinates), accumulates them
with C / 32 channels a lane and writes the point's channels as one run.

The backward kernel (hat_interp_level_bwd_cuda) replaces
neuralbody_tpu/ops/pallas_hat.py:_bwd_kernel and computes the whole
gradient of hat_interp_level with respect to the features, the scatter of
d_rf through the row lists included (atomics: rows repeat across groups).
What bounds it: reading the f32 cotangent (the same 118.4 MB per step),
plus pos, rows and the used sites, and writing the [capS, C] f32 output,
~132 MB, ~39 us at 3.35 TB/s. The source notes of both kernels say more.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches its kernel or raises. The wrappers carry no autograd graph on the
card: training differentiates through ops/hat_interp.hat_interpolate,
whose autograd Function launches both.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..utils import cuda_build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "hat_interp.cu"

LAUNCHES = 0      # forward kernel launches since the last reset
LOOKUP = True     # the forward finds a point's rows through the cell table
# (a block falls back to the scan where its group lists a cell twice); False
# scans always: the same function, kept to time the two against each other
BWD_LAUNCHES = 0  # backward kernel launches (the plain paths count none)


def hat_interp_level_plain(feats, sites, rows, pos):
    """The XLA branch of hat_interp_level, in torch.

    feats [capS, C] bf16 or f32; sites [capS, 3] int; rows [ngrp, capR]
    int (capS = sentinel: zero feature row at coordinate 1e9); pos
    [ngrp, P, 3] f32. Returns [ngrp, P, C] f32: bf16-rounded weights times
    bf16 features summed in f32 (products exact), or an f32 contraction.
    """
    C = feats.shape[-1]
    fpad = torch.cat([feats, feats.new_zeros((1, C))], dim=0)
    spad = torch.cat([sites.float(),
                      torch.full((1, 3), 1e9, device=sites.device)], dim=0)
    idx = rows.long()
    rf = fpad[idx]                                   # [ngrp, capR, C]
    rc = spad[idx]                                   # [ngrp, capR, 3]
    tent = torch.clamp(
        1.0 - (pos[:, :, None, :] - rc[:, None, :, :]).abs(), min=0.0)
    hat = tent[..., 0] * tent[..., 1] * tent[..., 2]  # [ngrp, P, capR]
    if feats.dtype == torch.bfloat16:
        return torch.bmm(hat.bfloat16().float(), rf.float())
    return torch.bmm(hat, rf.float())


def hat_interp_level_bwd_plain(grad, sites, rows, pos, dtype):
    """The gradient of hat_interp_level with respect to feats, in torch.

    grad [ngrp, P, C] f32 (the output's cotangent); sites, rows, pos as in
    hat_interp_level_plain; dtype: the features' dtype, bf16 selects the
    bf16-rounded weights. Returns d_feats [capS, C] f32: d_rf = hat^T @ grad
    per group with f32 accumulation, summed into the rows through
    index_add_ (the sentinel lands in a pad row that is dropped).
    """
    capS = sites.shape[0]
    spad = torch.cat([sites.float(),
                      torch.full((1, 3), 1e9, device=sites.device)], dim=0)
    idx = rows.long()
    rc = spad[idx]                                   # [ngrp, capR, 3]
    tent = torch.clamp(
        1.0 - (pos[:, :, None, :] - rc[:, None, :, :]).abs(), min=0.0)
    hat = tent[..., 0] * tent[..., 1] * tent[..., 2]  # [ngrp, P, capR]
    if dtype == torch.bfloat16:
        hat = hat.bfloat16().float()
    d_rf = torch.bmm(hat.transpose(1, 2), grad.float())  # [ngrp, capR, C]
    out = torch.zeros((capS + 1, grad.shape[-1]), dtype=torch.float32,
                      device=grad.device)
    out.index_add_(0, idx.reshape(-1), d_rf.reshape(-1, grad.shape[-1]))
    return out[:capS]


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = cuda_build.load("hat_interp", [SOURCE])
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd = lib.hat_interp_level_cuda
    fwd.argtypes = [p, i, p, p, p, p, i, i, i, i, i, ll, i, p]
    fwd.restype = ctypes.c_int
    bwd = lib.hat_interp_level_bwd_cuda
    bwd.argtypes = [p, ll, i, p, p, p, p, i, i, i, i, i, p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


def build():
    """Build (or load) the kernels' library now rather than at first use."""
    _kernels()


def _check(feats, sites, rows, pos, out):
    dev = feats.device
    for name, t in (("sites", sites), ("rows", rows), ("pos", pos),
                    ("out", out)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")
    if feats.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"feats must be bf16 or f32, got {feats.dtype}")
    if (sites.dtype, rows.dtype, pos.dtype, out.dtype) != (
            torch.int32, torch.int32, torch.float32, torch.float32):
        raise TypeError("sites and rows must be int32, pos and out f32")
    capS, C = feats.shape
    ngrp, P, _ = pos.shape
    if (sites.shape != (capS, 3) or rows.dim() != 2 or rows.shape[0] != ngrp
            or pos.shape[2] != 3 or out.shape != (ngrp, P, C)):
        raise ValueError(
            f"shapes: feats {tuple(feats.shape)}, sites {tuple(sites.shape)}, "
            f"rows {tuple(rows.shape)}, pos {tuple(pos.shape)}, "
            f"out {tuple(out.shape)}")
    if not all(t.is_contiguous() for t in (feats, sites, rows, pos)):
        raise ValueError("feats, sites, rows and pos must be contiguous")
    s = out.stride(1)
    if out.stride(2) != 1 or out.stride(0) != P * s:
        raise ValueError(f"out must be rows of one stride, got {out.stride()}")
    if C not in (32, 64, 128) or P > 4096:
        raise ValueError(f"kernel takes C % 32 == 0 up to 128 and P <= 4096, "
                         f"got C={C}, P={P}")
    if feats.data_ptr() % 16 or out.data_ptr() % 16 or s % 4:
        raise ValueError(
            f"feats and out must be 16-byte aligned and out's row stride a "
            f"multiple of 4 floats, got offsets {feats.data_ptr() % 16}, "
            f"{out.data_ptr() % 16} and stride {s}")


def hat_interp_level(feats, sites, rows, pos, out=None):
    """One level's interpolation for all groups.

    Args:
      feats: [capS, C] site features (padded rows zero); bf16 selects the
        bf16 contraction, f32 the exact one.
      sites: [capS, 3] int32 site coords (padded rows hold a huge sentinel).
      rows:  [ngrp, capR] int32 row lists (sentinel capS contributes 0).
      pos:   [ngrp, P, 3] f32 level-grid continuous positions.
      out:   optional [ngrp, P, C] f32 destination, possibly a column slice
        of a wider buffer (16-byte aligned, row stride a multiple of 4).

    Returns [ngrp, P, C] f32 (out, when given).
    """
    global LAUNCHES
    if feats.device.type == "cpu":
        res = hat_interp_level_plain(feats, sites, rows, pos)
        return res if out is None else out.copy_(res)
    if feats.device.type != "cuda":
        raise ValueError(f"no hat kernel for device {feats.device}")
    ngrp, P, _ = pos.shape
    if out is None:
        out = torch.empty((ngrp, P, feats.shape[1]), dtype=torch.float32,
                          device=feats.device)
    _check(feats, sites, rows, pos, out)
    if out.numel() == 0:
        return out
    if rows.shape[1] == 0:
        return out.zero_()
    fn = _kernels()[0]
    with torch.cuda.device(feats.device):
        err = fn(feats.data_ptr(), int(feats.dtype == torch.bfloat16),
                 sites.data_ptr(), rows.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), ngrp, P, rows.shape[1], feats.shape[0],
                 feats.shape[1], out.stride(1), int(LOOKUP),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hat_interp kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _check_bwd(grad, sites, rows, pos, dtype):
    dev = grad.device
    for name, t in (("sites", sites), ("rows", rows), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, grad on {dev}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"features must be bf16 or f32, got {dtype}")
    if (grad.dtype, sites.dtype, rows.dtype, pos.dtype) != (
            torch.float32, torch.int32, torch.int32, torch.float32):
        raise TypeError("grad and pos must be f32, sites and rows int32")
    ngrp, P, C = grad.shape
    if (sites.dim() != 2 or sites.shape[1] != 3 or rows.dim() != 2
            or rows.shape[0] != ngrp or pos.shape != (ngrp, P, 3)):
        raise ValueError(
            f"shapes: grad {tuple(grad.shape)}, sites {tuple(sites.shape)}, "
            f"rows {tuple(rows.shape)}, pos {tuple(pos.shape)}")
    if not all(t.is_contiguous() for t in (sites, rows, pos)):
        raise ValueError("sites, rows and pos must be contiguous")
    s = grad.stride(1)
    if grad.stride(2) != 1 or grad.stride(0) != P * s:
        raise ValueError(
            f"grad must be rows of one stride, got {grad.stride()}")
    if C % 32 or P * 35 * 4 > 48 * 1024:
        raise ValueError(f"backward kernel takes C % 32 == 0 and P <= 351, "
                         f"got C={C}, P={P}")


def hat_interp_level_bwd(grad, sites, rows, pos, dtype):
    """The gradient of hat_interp_level with respect to its features.

    Args:
      grad:  [ngrp, P, C] f32 cotangent of the level's output, possibly a
        column slice of a wider [ngrp, P, W] gradient (read through its row
        stride, never copied).
      sites, rows, pos: the forward's (see hat_interp_level).
      dtype: the features' dtype; bf16 selects the bf16-rounded weights.

    Returns d_feats [capS, C] f32 (capS = len(sites)). On the card the sum
    lands through float atomics in an order that changes from run to run,
    so it is reproducible to f32 rounding.
    """
    global BWD_LAUNCHES
    if grad.device.type == "cpu":
        return hat_interp_level_bwd_plain(grad, sites, rows, pos, dtype)
    if grad.device.type != "cuda":
        raise ValueError(f"no hat kernel for device {grad.device}")
    _check_bwd(grad, sites, rows, pos, dtype)
    ngrp, P, C = grad.shape
    capS = sites.shape[0]
    out = torch.zeros((capS, C), dtype=torch.float32, device=grad.device)
    if grad.numel() == 0 or rows.shape[1] == 0 or capS == 0:
        return out
    fn = _kernels()[1]
    with torch.cuda.device(grad.device):
        err = fn(grad.data_ptr(), grad.stride(1),
                 int(dtype == torch.bfloat16), sites.data_ptr(),
                 rows.data_ptr(), pos.data_ptr(), out.data_ptr(), ngrp, P,
                 rows.shape[1], capS, C,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"hat_interp backward kernel launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return out
