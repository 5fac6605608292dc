"""The sparse convolution with the gather inside: the Hopper kernel, its
plain version and the wrapper that picks between them by the tensors'
device.

    out[s, :] = sum_{k < K}  T[idx[k, s], :] @ W[k]

The kernel (csrc/sparse_conv.cu: sparse_conv_cuda) replaces the three TPU
probe kernels that gather inside the kernel
(tools/probes/pallas_gather.py:25, tools/probes/indexed_ops.py:122,
tools/probes/pallas_dconv_scatter.py:50) and serves every conv of the
encoder, forward and dx: K and E are arguments, so the submanifold conv
(K = 27, E = Cin), the w-triple packed one (K = 9, E = 3 Cin, T the packed
table) and the strided one (K = 27 through the down or the up table) are
one function. Neither the [K, S, E] gather nor a zero row reaches device
memory. What bounds it on an H100: one full-width encode is ~16.5 GFLOP at
the indices that name a row, over under 0.1 GB of compulsory bytes: bytes
with bf16 operands on the tensor cores (~0.03 ms), and with f32 operands,
which go to the tensor cores as three TF32 products, operations (~0.10 ms
at 495 TFLOP/s).

The kernel multiplies on the tensor cores (mma.sync: bf16, or three TF32
products of the f32 operands' halves), a block owning 64 sites x all of
Cout and gathering its rows with cp.async; `split_plan` cuts the reduction
(taps x E) over the blocks of a thread-block cluster where a layer's tiles
would leave the card's SMs idle or unevenly loaded, and the cluster adds
their partial tiles in its shared memory in a fixed order. The source's
note says more.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. The wrapper carries no autograd graph on the
card: ops/sparse_conv's autograd Functions call it in their forwards and
for dx in their backwards.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..utils import cuda_build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "sparse_conv.cu"

CONV_LAUNCHES = 0  # kernel launches since the last reset (plain counts none)
CONV_DX_LAUNCHES = 0   # those of them made for a backward's dx

_COUTS = (16, 32, 64, 128)
# The kernel's tiling, as the library reports it (sparse_conv_tiling; _kernel
# refuses a library that says otherwise): sites a block, the step along the
# reduction K E, the most taps and splits, the resident blocks an SM.
TILE_SITES = 64
STAGE_DEPTH = {torch.bfloat16: 64, torch.float32: 32}
MAX_TAPS = 32
MAX_SPLITS = 16
BLOCKS_PER_SM = 2
_SETUP_STEPS = 4   # a block's indices, tap list and first copies, in steps
_FULL_RATE = 1.5   # an SM's rate with BLOCKS_PER_SM blocks over one's


def _ceil_div(a, b):
    return -(-a // b)


def split_plan(B, S, K, E, dtype, sms):
    """How many blocks share the reduction of one tile of TILE_SITES sites,
    for B tables of S output sites, K taps and E channels in `dtype` on a
    card of `sms` SMs: the count of least modelled time, the fewest among
    equals, at most MAX_SPLITS (a cluster) and the reduction's steps.

    The model: a block costs its steps of the reduction plus _SETUP_STEPS;
    the busiest SM, with ceil(blocks / sms) of them, runs them BLOCKS_PER_SM
    at a time at _FULL_RATE times the rate of one alone, and what is left
    over at one block's rate. tools/conv_variants.py times every count on
    the card and fits the two constants."""
    tiles = B * _ceil_div(S, TILE_SITES)
    steps = _ceil_div(K * E, STAGE_DEPTH[dtype])

    def cost(splits):
        full, rest = divmod(_ceil_div(tiles * splits, sms), BLOCKS_PER_SM)
        block = _ceil_div(steps, splits) + _SETUP_STEPS
        return (full * BLOCKS_PER_SM / _FULL_RATE + rest) * block

    return min(range(1, min(MAX_SPLITS, steps) + 1), key=cost)


def gather_rows(feats, table):
    """feats [n, C] or [B, n, C] gathered by an index table of any shape
    [...] / [B, ...] (a tap-major [K, S], a row list [S]) -> [..., C] /
    [B, ..., C]. An index >= n reads a row of zeros."""
    n, C = feats.shape[-2:]
    idx = table.long().clamp(max=n)
    if feats.dim() == 2:
        fpad = torch.cat([feats, feats.new_zeros((1, C))], dim=0)
    else:
        # a batched gather as one gather of the flattened tables
        B = feats.shape[0]
        fpad = torch.cat([feats, feats.new_zeros((B, 1, C))],
                         dim=1).reshape(B * (n + 1), C)
        idx = idx + (torch.arange(B, device=idx.device) * (n + 1)).reshape(
            (B,) + (1,) * (idx.dim() - 1))
    return torch.index_select(fpad, 0, idx.reshape(-1)).reshape(
        *table.shape, C)


def sparse_conv_plain(T, idx, W):
    """The conv in plain torch: a row gather, a batched matmul over the
    taps and a tap sum. T [(B,) n_rows, E] f32 or bf16; idx [(B,) K, S]
    int; W [K, E, Cout] -> [(B,) S, Cout] f32.

    The operands are rounded to T's dtype and multiplied in f32: a bf16
    value is exact in f32, and so is the product of two, so with f32
    accumulation this is the bf16 x bf16 -> f32 contraction.
    """
    g = gather_rows(T, idx).float()
    w = W.to(T.dtype).float()
    if g.dim() == 3:
        return torch.bmm(g, w).sum(0)
    return torch.einsum("bkse,ked->bksd", g, w).sum(1)


def tiling():
    """The tiling the plan assumes, in the order sparse_conv_tiling reports
    it."""
    return (TILE_SITES, STAGE_DEPTH[torch.bfloat16],
            STAGE_DEPTH[torch.float32], MAX_TAPS, MAX_SPLITS, BLOCKS_PER_SM)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = cuda_build.load("sparse_conv", [SOURCE])
    got = (ctypes.c_int * 6)()
    lib.sparse_conv_tiling(got)
    if tuple(got) != tiling():
        raise RuntimeError(f"{SOURCE.name} tiles as {tuple(got)}, the plan "
                           f"assumes {tiling()}")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.sparse_conv_cuda
    fn.argtypes = [p, i, p, p, p, i, i, i, i, i, i, ll, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def build():
    """Build (or load) the kernel's library now rather than at first use."""
    _kernel()


def _check(T, idx, W):
    dev = T.device
    for name, t in (("idx", idx), ("W", W)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, T on {dev}")
    if T.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"T must be bf16 or f32, got {T.dtype}")
    if idx.dtype != torch.int32 or W.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and W f32, got {idx.dtype} and "
                        f"{W.dtype}")
    if T.dim() not in (2, 3) or idx.dim() != T.dim() or W.dim() != 3:
        raise ValueError(f"shapes: T {tuple(T.shape)}, idx {tuple(idx.shape)}"
                         f", W {tuple(W.shape)}")
    E = T.shape[-1]
    K, S = idx.shape[-2:]
    if W.shape[:2] != (K, E) or (T.dim() == 3 and
                                 idx.shape[0] != T.shape[0]):
        raise ValueError(f"shapes: T {tuple(T.shape)}, idx {tuple(idx.shape)}"
                         f", W {tuple(W.shape)}")
    if E % 16 or W.shape[2] not in _COUTS or K > MAX_TAPS:
        raise ValueError(f"kernel takes E % 16 == 0, Cout in {_COUTS} and "
                         f"K <= {MAX_TAPS}, got E={E}, Cout={W.shape[2]}, "
                         f"K={K}")
    if T.dim() == 3 and T.shape[0] > 65535:
        raise ValueError(f"kernel takes a batch of at most 65535, got "
                         f"{T.shape[0]}")
    if T.stride(-1) != 1 or T.stride(-2) != E:
        raise ValueError(f"T's rows must be contiguous, got {T.stride()}")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")
    if T.data_ptr() % 16 or (T.dim() == 3 and
                             T.stride(0) * T.element_size() % 16):
        raise ValueError("T must be 16-byte aligned")


def sparse_conv(T, idx, W, dx=False):
    """The sparse convolution of one table through one index table.

    Args:
      T:   [(B,) n_rows, E] rows to gather, f32 or bf16 (bf16 selects the
        bf16 x bf16 -> f32 contraction: W goes to the kernel in bf16).
      idx: [(B,) K, S] int32 tap-major row indices, none negative; an
        index >= n_rows reads zeros (the tables' zero-row sentinel).
      W:   [K, E, Cout] f32 weights, any strides.
      dx:  the call computes a backward's input gradient (its launch is
        counted in CONV_DX_LAUNCHES too).

    Returns [(B,) S, Cout] f32. The kernel takes E a multiple of 16,
    Cout in {16, 32, 64, 128} and K <= 32; its sums run in a fixed order.
    """
    global CONV_LAUNCHES, CONV_DX_LAUNCHES
    if T.device.type == "cpu":
        return sparse_conv_plain(T, idx, W)
    if T.device.type != "cuda":
        raise ValueError(f"no sparse-conv kernel for device {T.device}")
    _check(T, idx, W)
    w = W.to(T.dtype).contiguous()  # the tensor cores take W in T's type
    batched = T.dim() == 3
    B = T.shape[0] if batched else 1
    n_rows, E = T.shape[-2:]
    K, S = idx.shape[-2:]
    Cout = w.shape[2]
    out = torch.empty((*idx.shape[:-2], S, Cout), dtype=torch.float32,
                      device=T.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(T.device):
        splits = split_plan(B, S, K, E, T.dtype,
                            _sm_count(torch.cuda.current_device()))
        err = _kernel()(T.data_ptr(), int(T.dtype == torch.bfloat16),
                        idx.data_ptr(), w.data_ptr(), out.data_ptr(), B,
                        n_rows, E, K, S, Cout,
                        T.stride(0) if batched else 0, splits,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sparse_conv kernel launch failed: CUDA error "
                           f"{err}")
    CONV_LAUNCHES += 1
    CONV_DX_LAUNCHES += int(dx)
    return out
