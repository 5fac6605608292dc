"""The four levels' site-feature sampler of the plan-free render: the
Hopper kernel, its plain version and the wrapper that picks between them
by the tensors' device.

The kernel (csrc/site_sample.cu: site_trilinear_kernel) computes
site_trilinear_plain, the four levels of ops/sparse_conv.
site_trilinear_sample side by side, in one launch a chunk: the corner
weights and index-volume reads, the row gathers and their sums, written
once as the [N, 352] f32 output, with the plain version's f32 arithmetic
(equal bits where the features are finite). It replaces no Pallas kernel:
the JAX package leaves the function to XLA. What bounds it on an H100:
writing the output, 1408 bytes a point. The source note says more.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. It carries no autograd graph: a caller
through which a gradient flows takes site_trilinear_plain
(models/latent_xyzc.interpolate_site_features decides).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..utils import cuda_build
from .sparse_conv import site_trilinear_sample

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "site_sample.cu"

CHANNELS = (32, 64, 128, 128)   # the levels' widths: 352 output columns

LAUNCHES = 0      # kernel launches since the last reset
PLAIN_CALLS = 0   # site_trilinear_plain calls (CPU, or a gradient flows)


def site_trilinear_plain(site_feats, index_vols, dhw_vox, out_sh, caps):
    """The levels' site_trilinear_sample at the same points, concatenated
    along the channels: [N, sum C_l] f32, differentiable by autograd to the
    features and coordinates.

    site_feats: per level [cap_l, C_l]; index_vols: per level [D_l, H_l,
    W_l] int32 (empty = cap_l); dhw_vox: [N, 3] full-res voxel coords;
    out_sh: the full-res grid shape; caps: per level cap_l.
    """
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return torch.cat([
        site_trilinear_sample(feats, ivol, dhw_vox, out_sh, cap)
        for feats, ivol, cap in zip(site_feats, index_vols, caps)], dim=-1)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = cuda_build.load("site_sample", [SOURCE])
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.site_trilinear_cuda
    fn.argtypes = [p, ll, p, i, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def build():
    """Build (or load) the kernel's library now rather than at first use."""
    _kernel()


def _check(site_feats, index_vols, dhw_vox, caps):
    if not (len(site_feats) == len(index_vols) == len(caps) == len(CHANNELS)):
        raise ValueError(
            f"the sampler takes {len(CHANNELS)} levels, got "
            f"{len(site_feats)} tables, {len(index_vols)} index volumes and "
            f"{len(caps)} caps")
    if any(t.device != dhw_vox.device for t in (*site_feats, *index_vols)):
        raise ValueError("dhw_vox, the features and the index volumes must "
                         "be on one device")
    dt = site_feats[0].dtype
    if dt not in (torch.float32, torch.bfloat16) or any(
            f.dtype != dt for f in site_feats):
        raise TypeError(f"the levels' features must share one dtype, f32 or "
                        f"bf16, got {[f.dtype for f in site_feats]}")
    if dhw_vox.dtype != torch.float32 or any(
            v.dtype != torch.int32 for v in index_vols):
        raise TypeError(f"dhw_vox must be f32 and the index volumes int32, "
                        f"got {dhw_vox.dtype}, "
                        f"{[v.dtype for v in index_vols]}")
    if dhw_vox.dim() != 2 or dhw_vox.shape[1] != 3:
        raise ValueError(f"dhw_vox must be [N, 3], got {tuple(dhw_vox.shape)}")
    for l, (f, v, cap, C) in enumerate(zip(site_feats, index_vols, caps,
                                           CHANNELS)):
        if tuple(f.shape) != (cap, C):
            raise ValueError(
                f"level {l}: features {tuple(f.shape)}, expected ({cap}, {C}): "
                f"the index volume's empty voxels point at row {cap}")
        if v.dim() != 3 or v.numel() >= 2 ** 31:
            raise ValueError(f"level {l}: index volume {tuple(v.shape)}")
    if not all(t.is_contiguous() for t in (dhw_vox, *site_feats,
                                           *index_vols)):
        raise ValueError("dhw_vox, the features and the index volumes must "
                         "be contiguous")


def site_trilinear(site_feats, index_vols, dhw_vox, out_sh, caps):
    """The four levels' trilinear site samples at dhw_vox, side by side.

    Args:
      site_feats: 4 level tables [cap_l, C_l], C = 32, 64, 128, 128, one
        dtype (f32 or bf16), read as stored.
      index_vols: 4 int32 volumes [D_l, H_l, W_l] of rows (empty = cap_l).
      dhw_vox: [N, 3] f32 continuous full-res voxel coords (dhw order).
      out_sh: the full-res grid shape (D, H, W).
      caps: the 4 levels' capacities.

    Returns [N, 352] f32. No autograd graph on the card.
    """
    global LAUNCHES
    caps = tuple(int(c) for c in caps)
    _check(site_feats, index_vols, dhw_vox, caps)
    dev = dhw_vox.device
    if dev.type == "cpu":
        return site_trilinear_plain(site_feats, index_vols, dhw_vox, out_sh,
                                    caps)
    if dev.type != "cuda":
        raise ValueError(f"no site sampling kernel for device {dev}")
    if any(f.data_ptr() % 16 for f in site_feats):
        raise ValueError("the feature tables must be 16-byte aligned")
    n = dhw_vox.shape[0]
    out = torch.empty((n, sum(CHANNELS)), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    ptrs = ctypes.c_void_p * 4
    ints = ctypes.c_int * 12
    feats = ptrs(*(f.data_ptr() for f in site_feats))
    ivols = ptrs(*(v.data_ptr() for v in index_vols))
    sizes = ints(*(s for v in index_vols for s in v.shape))
    with torch.cuda.device(dev):
        err = _kernel()(
            dhw_vox.data_ptr(), n, feats,
            int(site_feats[0].dtype == torch.bfloat16), ivols, sizes,
            (ctypes.c_int * 4)(*caps),
            (ctypes.c_int * 3)(*(int(s) for s in out_sh)), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"site_trilinear kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
