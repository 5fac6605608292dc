"""The dense matrix product: the Hopper kernel, its plain version, the
wrapper that picks between them by the tensors' device, and the autograd
Function the NeRF baseline's dense layers go through.

    out[M, N] = A[M, K] @ B[K, N]      (products summed in f32, out f32)

The kernel (csrc/dense_mm.cu: dense_mm_cuda) replaces the TPU probe kernel
tools/probes/pallas_enc_interp.py:22 mm, a row-blocked a @ b with f32
accumulation. Both operands are f32, or both bf16 (bf16 x bf16 -> f32).
Each operand is read through its own row and column stride, so the
transposed views of the backward (dA = g @ B^T, dB = A^T @ g) and column
slices are never copied, and M, N and K need not be multiples of anything:
the kernel masks its ragged edges. What bounds it on an H100: operations on
the f32 CUDA cores (one full-width NeRF forward is ~311 GFLOP, ~4.6 ms at
67 TFLOP/s, a training step about three times that); the source's note says
more.

A product with few output tiles and a long reduction (dB: at most 319 x
256 outputs summed over up to 196,608 points) is split over the reduction:
`split_plan` cuts K into ranges, the kernel writes one partial product per
range into scratch, and a second small launch sums them in range order, so
the result is deterministic (no atomics).

On a CPU tensor `mm` runs the plain version; on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..utils import cuda_build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dense_mm.cu"

MM_LAUNCHES = 0      # launches of the product kernel since the last reset
SUM_LAUNCHES = 0     # launches of the kernel that sums a split's partials
# (one per split product, counted apart; the plain path counts neither)

TILE = 128           # the kernel's output tile, rows and columns
CHUNK = 16           # its step along K: a split range is a multiple
_FILL = 2 * 2 * 132  # blocks that fill the card twice: 132 SMs x 2 blocks
_MIN_RANGE = 512     # no split range shorter than this
_MAX_DIM = 2 ** 30


def mm_plain(A, B):
    """The product in plain torch: the operands as they are rounded in
    their dtype, multiplied in f32. A bf16 value is exact in f32 and so is
    the product of two, so with f32 sums this is the bf16 x bf16 -> f32
    contraction. A [M, K], B [K, N] -> [M, N] f32."""
    return torch.matmul(A.float(), B.float())


def _ceil_div(a, b):
    return -(-a // b)


def split_plan(M, N, K):
    """(splits, chunk): how the kernel cuts the reduction of an [M, K] x
    [K, N] product. One range unless the output has too few tiles to fill
    the card and K is long; then enough ranges to fill it twice, each a
    multiple of the kernel's K step and at least _MIN_RANGE long."""
    tiles = _ceil_div(M, TILE) * _ceil_div(N, TILE)
    if 2 * tiles >= _FILL or K < 2 * _MIN_RANGE:
        return 1, max(K, 1)
    splits = min(_ceil_div(_FILL, tiles), K // _MIN_RANGE)
    chunk = _ceil_div(_ceil_div(K, splits), CHUNK) * CHUNK
    return _ceil_div(K, chunk), chunk


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = cuda_build.load("dense_mm", [SOURCE])
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.dense_mm_cuda
    fn.argtypes = [p, p, i, p, p, i, i, i, ll, ll, ll, ll, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def build():
    """Build (or load) the kernel's library now rather than at first use."""
    _kernel()


def _check(A, B):
    if B.device != A.device:
        raise ValueError(f"B is on {B.device}, A on {A.device}")
    if A.dtype not in (torch.bfloat16, torch.float32) or B.dtype != A.dtype:
        raise TypeError(f"A and B must both be f32 or both bf16, got "
                        f"{A.dtype} and {B.dtype}")
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != B.shape[0]:
        raise ValueError(f"shapes: A {tuple(A.shape)}, B {tuple(B.shape)}")
    if max(*A.shape, B.shape[1]) > _MAX_DIM:
        raise ValueError(f"kernel takes M, N, K <= 2**30, got A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}")
    for name, t in (("A", A), ("B", B)):
        if min(t.stride()) < 0:
            raise ValueError(f"{name} has a negative stride: {t.stride()}")
        if t.data_ptr() % t.element_size():
            raise ValueError(f"{name} is not aligned to its element size")


def mm(A, B):
    """A [M, K] @ B [K, N] -> [M, N] f32, the products summed in f32.

    A and B are both f32 or both bf16, 2-d, with any (non-negative)
    strides: transposed views and column slices are read in place. No
    autograd graph is carried on the card (`matmul` is the differentiable
    form).
    """
    global MM_LAUNCHES, SUM_LAUNCHES
    if A.device.type == "cpu":
        _check(A, B)
        return mm_plain(A, B)
    if A.device.type != "cuda":
        raise ValueError(f"no dense kernel for device {A.device}")
    _check(A, B)
    M, K = A.shape
    N = B.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=A.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    splits, chunk = split_plan(M, N, K)
    scratch = (torch.empty((splits, M, N), dtype=torch.float32,
                           device=A.device) if splits > 1 else None)
    with torch.cuda.device(A.device):
        err = _kernel()(A.data_ptr(), B.data_ptr(),
                        int(A.dtype == torch.bfloat16), out.data_ptr(),
                        scratch.data_ptr() if splits > 1 else None,
                        M, N, K, A.stride(0), A.stride(1), B.stride(0),
                        B.stride(1), splits, chunk,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_mm kernel launch failed: CUDA error {err}")
    MM_LAUNCHES += 1
    SUM_LAUNCHES += splits > 1
    return out


class _Matmul(torch.autograd.Function):
    """x @ w through `mm`, forward and backward: dx = g @ w^T and
    dw = x^T @ g read the saved operands through transposed views. dx is
    skipped when x needs no gradient (a network's first layer)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return mm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul(x, w):
    """x [M, K] @ w [K, N] -> [M, N], f32, differentiable in both: every
    product of the forward and the backward is one `mm`."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"matmul differentiates f32 operands, got {x.dtype} "
                        f"and {w.dtype}")
    return _Matmul.apply(x, w)
