"""The dense layer: the Hopper kernels, their plain version, the wrapper
that picks between them by the tensors' device, and the autograd Functions
the NeRF baseline's dense layers go through.

    out[M, N] = act(A[M, K] @ B[K, N] + bias[N])   (f32 sums, out f32)

with the bias optional and act the ReLU or the identity. The kernels
(csrc/dense_mm.cu: dense_mm_cuda) replace the TPU probe kernel
tools/probes/pallas_enc_interp.py:22 mm, a row-blocked a @ b with f32
accumulation. Both operands are f32, or both bf16 (bf16 x bf16 -> f32).
Each operand is read through its own row and column stride, so the
transposed views of the backward (dA = g @ B^T, dB = A^T @ g) and column
slices are never copied, and M, N and K need not be multiples of anything:
the kernels mask their ragged edges.

What bounds it on an H100: operations. The f32 CUDA cores give 67 TFLOP/s
(one NeRF step's 70 products: 14.2 ms). The tensor cores take TF32
operands at 495 TFLOP/s, and an f32 product is three TF32 products of the
operands' high and low parts, so the main route (`route_plan`: "tf32x3")
is bound by 3 x operations / 495 TFLOP/s, 6.1 ms for the same step. The
dropped low x low term is 2**-22 of a product; what shows is the tensor
core's own summing, which cuts instead of rounding: a reduction of up to
320 (every forward and dx of the MLPs) is chained inside it and lands
within 5e-6 of the output's scale of the f32 product, a longer one (dW)
keeps its sums in rounded f32 adds and lands within 1e-6. bf16 operands,
which no path of the port uses, keep the f32 FMA loop ("fma"), as do
reductions of 8 or less (dx of a narrow layer); FORCE_MAIN sends every
f32 product to it, as the figure to compare with. A product with N <= 8
(the alpha and rgb heads) is bound by the bytes of its input and has two
routes of its own: "rows" (A contiguous along k: the forward) and "cols"
(A contiguous along m: dW, A = x^T). The source's note says more.

A product with few output tiles and a long reduction (dB: at most 319 x
256 outputs summed over up to 196,608 points) is split over the reduction:
`split_plan` cuts K into ranges, the kernel writes one partial product per
range into scratch, and a second small launch sums them in range order and
applies the bias and the ReLU, so the result is deterministic (no atomics).

`linear(x, w, b, relu)` is the differentiable dense layer: the forward is
one launch (bias and ReLU in the kernel's epilogue); the backward masks the
cotangent by out > 0 in one elementwise pass, takes db as its column sum,
and launches dx = g' @ w^T and dw = x^T @ g'. `matmul(x, w)` is the
differentiable product without an epilogue.

On a CPU tensor `mm` runs the plain version; on a CUDA tensor it launches
a kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..utils import cuda_build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dense_mm.cu"

ROUTES = {"fma": 0, "tf32x3": 1, "rows": 2, "cols": 3}

MM_LAUNCHES = 0      # launches of a product kernel (any route) since reset
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)  # the same launches, by route
EPILOGUE_LAUNCHES = 0  # those of them that carried a bias or the ReLU
SUM_LAUNCHES = 0     # launches of the kernel that sums a split's partials
# (one per split product, counted apart; the plain path counts none)
FORCE_MAIN = None    # "fma" or "tf32x3": every f32 product takes that main
# kernel, whatever its shape (measurements and tests; no path sets it)

TILE = 128           # the main kernels' output tile, rows and columns
CHUNK = 32           # their step along K: a split range is a multiple
NARROW_MAX = 8       # widest N of the narrow routes
_FILL = 2 * 2 * 132  # blocks that fill the card twice: 132 SMs x 2 blocks
_MIN_RANGE = 512     # no split range shorter than this
_COL_ROWS = 128      # output rows of a block of the "cols" route
_COL_FILL = 2 * 132  # its blocks of 1024 threads that fill the card
_COL_MIN_RANGE = 1024
_SHORT_K = 8         # a reduction this short (dx of a narrow layer: K = 1,
# 3) is bound by its output: the fma loop's 16-deep stage beats the ring
_ROWS_SMEM = 200 * 1024  # B of the "rows" route sits in shared memory
_MAX_DIM = 2 ** 30


def mm_plain(A, B, bias=None, relu=False):
    """The layer in plain torch: the operands as they are rounded in their
    dtype, multiplied in f32. A bf16 value is exact in f32 and so is the
    product of two, so with f32 sums this is the bf16 x bf16 -> f32
    contraction. A [M, K], B [K, N], bias [N] or None -> [M, N] f32."""
    out = torch.matmul(A.float(), B.float())
    if bias is not None:
        out = out + bias
    return torch.relu(out) if relu else out


def linear_plain(x, w, b, relu=False):
    """relu(mm_plain(x, w) + b), or without the ReLU."""
    return mm_plain(x, w, b, relu)


def _ceil_div(a, b):
    return -(-a // b)


def split_plan(M, N, K):
    """(splits, chunk): how the main kernels cut the reduction of an [M, K]
    x [K, N] product. One range unless the output has too few tiles to fill
    the card and K is long; then enough ranges to fill it twice, each a
    multiple of the kernels' K step and at least _MIN_RANGE long."""
    tiles = _ceil_div(M, TILE) * _ceil_div(N, TILE)
    if 2 * tiles >= _FILL or K < 2 * _MIN_RANGE:
        return 1, max(K, 1)
    splits = min(_ceil_div(_FILL, tiles), K // _MIN_RANGE)
    chunk = _ceil_div(_ceil_div(K, splits), CHUNK) * CHUNK
    return _ceil_div(K, chunk), chunk


def cols_split_plan(M, K):
    """(splits, chunk) of the "cols" route: enough ranges of the reduction
    for its blocks of 128 output rows to fill the card, none shorter than
    _COL_MIN_RANGE."""
    splits = max(1, min(_ceil_div(_COL_FILL, _ceil_div(M, _COL_ROWS)),
                        K // _COL_MIN_RANGE))
    chunk = _ceil_div(_ceil_div(K, splits), CHUNK) * CHUNK
    return _ceil_div(K, chunk), chunk


def route_plan(A, B):
    """(route, splits, chunk) of the product A @ B on the card, from the
    operands' dtype, shapes and strides alone."""
    M, K = A.shape
    N = B.shape[1]
    if A.dtype == torch.bfloat16:
        return ("fma", *split_plan(M, N, K))
    if FORCE_MAIN is not None:
        return (FORCE_MAIN, *split_plan(M, N, K))
    if N <= NARROW_MAX:
        if A.stride(1) == 1 and 4 * N * (K + 3) <= _ROWS_SMEM:
            return "rows", 1, max(K, 1)
        if A.stride(0) == 1:
            return ("cols", *cols_split_plan(M, K))
    if K <= _SHORT_K:
        return ("fma", *split_plan(M, N, K))
    return ("tf32x3", *split_plan(M, N, K))


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = cuda_build.load("dense_mm", [SOURCE])
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.dense_mm_cuda
    fn.argtypes = [p, p, i, p, i, p, p, i, i, i, ll, ll, ll, ll, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def build():
    """Build (or load) the kernel's library now rather than at first use."""
    _kernel()


def _check(A, B, bias):
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
    if bias is not None:
        if bias.device != A.device:
            raise ValueError(f"bias is on {bias.device}, A on {A.device}")
        if bias.dtype != torch.float32:
            raise TypeError(f"bias must be f32, got {bias.dtype}")
        if bias.shape != (B.shape[1],) or not bias.is_contiguous():
            raise ValueError(f"bias must be a contiguous [{B.shape[1]}], got "
                             f"{tuple(bias.shape)}")


def mm(A, B, bias=None, relu=False):
    """act(A [M, K] @ B [K, N] + bias [N]) -> [M, N] f32, the products
    summed in f32; bias may be None, act is the ReLU when `relu`.

    A and B are both f32 or both bf16, 2-d, with any (non-negative)
    strides: transposed views and column slices are read in place. No
    autograd graph is carried on the card (`linear` and `matmul` are the
    differentiable forms).
    """
    global MM_LAUNCHES, EPILOGUE_LAUNCHES, SUM_LAUNCHES
    if A.device.type == "cpu":
        _check(A, B, bias)
        return mm_plain(A, B, bias, relu)
    if A.device.type != "cuda":
        raise ValueError(f"no dense kernel for device {A.device}")
    _check(A, B, bias)
    M, K = A.shape
    N = B.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=A.device)
    if out.numel() == 0:
        return out
    if K == 0:
        out.zero_()
        if bias is not None:
            out += bias
        return out.relu_() if relu else out
    route, splits, chunk = route_plan(A, B)
    scratch = (torch.empty((splits, M, N), dtype=torch.float32,
                           device=A.device) if splits > 1 else None)
    with torch.cuda.device(A.device):
        err = _kernel()(A.data_ptr(), B.data_ptr(),
                        int(A.dtype == torch.bfloat16),
                        None if bias is None else bias.data_ptr(), int(relu),
                        out.data_ptr(),
                        scratch.data_ptr() if splits > 1 else None,
                        M, N, K, A.stride(0), A.stride(1), B.stride(0),
                        B.stride(1), splits, chunk, ROUTES[route],
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_mm kernel launch failed ({route}): CUDA "
                           f"error {err}")
    MM_LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    EPILOGUE_LAUNCHES += bias is not None or relu
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


class _Linear(torch.autograd.Function):
    """act(x @ w + b) as one `mm`. The backward masks the cotangent by
    out > 0 where the ReLU ran (one elementwise pass; the products read the
    masked cotangent), sums its columns into db, and launches dx and dw as
    `_Matmul` does. Only x, w and the output are kept for it."""

    @staticmethod
    def forward(ctx, x, w, b, relu):
        out = mm(x, w, b, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, w, out if relu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        if ctx.relu:
            g = torch.ops.aten.threshold_backward(g, out, 0.0)
        dx = mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = mm(x.t(), g) if ctx.needs_input_grad[1] else None
        db = g.sum(0) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None


def linear(x, w, b, relu=False):
    """The dense layer relu(x [M, K] @ w [K, N] + b [N]) (or without the
    ReLU) -> [M, N], f32, differentiable in x, w and b: one `mm` forward,
    with the bias and the ReLU in its epilogue, and one each for dx and dw."""
    if not (x.dtype == w.dtype == b.dtype == torch.float32):
        raise TypeError(f"linear differentiates f32 operands, got {x.dtype}, "
                        f"{w.dtype} and {b.dtype}")
    return _Linear.apply(x, w, b, bool(relu))
