"""The dense matrix-product kernel (csrc/dense_mm.cu) against its plain
PyTorch version on the card. Skips where no NVIDIA GPU is present; run on
the card with
`python -m pytest --noconftest tests/test_torch_dense_kernel_cuda.py -q`.

Tolerance: 1e-5 of the output's scale in f32 and with bf16 operands. Both
versions round the operands alike (bf16 values and their products are exact
in f32), so only the order of the f32 sum differs.
"""
import pytest
import torch

from neuralbody_tpu_torch.ops import dense_kernel as dk

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dk.build()
    return torch.device("cuda")


def _operands(seed, M, K, N, dtype, dev):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((M, K), generator=g).to(dtype).to(dev),
            torch.randn((K, N), generator=g).to(dtype).to(dev))


def _close(out, ref):
    scale = ref.abs().max().item()
    assert scale > 0 and out.shape == ref.shape
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= TOL * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (M, K, N): ragged in every dimension, around the tile and chunk edges
    (1, 1, 1), (127, 15, 129), (128, 16, 128), (129, 17, 127),
    (1000, 63, 256), (700, 319, 256), (515, 283, 128), (900, 256, 1),
    (333, 128, 3), (2048, 256, 256), (1024, 1024, 1024),
])
def test_kernel_matches_plain(dev, dtype, shape):
    M, K, N = shape
    A, B = _operands(0, M, K, N, dtype, dev)
    before = dk.MM_LAUNCHES
    out = dk.mm(A, B)
    torch.cuda.synchronize()
    assert dk.MM_LAUNCHES == before + 1
    _close(out, dk.mm_plain(A, B))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (M, K, N) with a long K and few tiles: the reduction is split
    (319, 20000, 256), (256, 70001, 1), (128, 9000, 3), (63, 5000, 256),
])
def test_split_reduction(dev, dtype, shape):
    M, K, N = shape
    assert dk.split_plan(M, N, K)[0] > 1
    # dW's operands: x^T as a view of [K, M], g [K, N]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((K, M), generator=gen).to(dtype).to(dev)
    g = torch.randn((K, N), generator=gen).to(dtype).to(dev)
    before = dk.MM_LAUNCHES, dk.SUM_LAUNCHES
    out = dk.mm(x.t(), g)
    torch.cuda.synchronize()
    assert (dk.MM_LAUNCHES, dk.SUM_LAUNCHES) == (before[0] + 1,
                                                 before[1] + 1)
    _close(out, dk.mm_plain(x.t(), g))
    again = dk.mm(x.t(), g)
    assert torch.equal(out, again)      # no atomics: bit for bit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_operands(dev, dtype):
    """Transposed views and column slices of either operand, read in
    place."""
    A, B = _operands(2, 300, 400, 200, dtype, dev)
    cases = [
        (A[:, 7:326], B[7:326]),                       # column slice of A
        (A, B[:, 3:131]),                              # column slice of B
        (A.t()[:150], B[:300, :77]),                   # A^T: unit row stride
        (A[:, :200], B.t()),                           # B^T: unit row stride
        (A.t()[:200].t()[::2], B[:200, ::3]),          # steps in both
        (A[:, :1].expand(300, 400), B),                # a zero stride
    ]
    for a, b in cases:
        assert not (a.is_contiguous() and b.is_contiguous())
        _close(dk.mm(a, b), dk.mm_plain(a, b))


def test_matmul_function_on_the_card(dev):
    """matmul's forward and backward launch the kernel (1 + 2, or 1 + 1
    when x needs no gradient) and equal the same Function on the CPU."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((5000, 319), generator=g)
    w = torch.randn((319, 256), generator=g) * 0.1
    gy = torch.randn((5000, 256), generator=g)

    def run(device, needs_dx):
        xd = x.clone().to(device).requires_grad_(needs_dx)
        wd = w.clone().to(device).requires_grad_()
        y = dk.matmul(xd, wd)
        y.backward(gy.to(device))
        return (y.detach().cpu(), wd.grad.cpu(),
                xd.grad.cpu() if needs_dx else None)

    for needs_dx in (True, False):
        before = dk.MM_LAUNCHES
        out = run(dev, needs_dx)
        torch.cuda.synchronize()
        assert dk.MM_LAUNCHES == before + 2 + needs_dx
        ref = run("cpu", needs_dx)
        assert dk.MM_LAUNCHES == before + 2 + needs_dx
        for o, r in zip(out, ref):
            if r is not None:
                _close(o, r)


def test_kernel_refuses_what_it_does_not_take(dev):
    A, B = _operands(4, 64, 32, 16, torch.float32, dev)
    with pytest.raises(TypeError):
        dk.mm(A.half(), B.half())
    with pytest.raises(TypeError):
        dk.mm(A.bfloat16(), B)
    with pytest.raises(ValueError):
        dk.mm(A, B.cpu())
    with pytest.raises(ValueError):
        dk.mm(A, B[:31])
    with pytest.raises(ValueError):
        dk.mm(A[None], B)
    before = dk.MM_LAUNCHES
    assert dk.mm(A[:0], B).shape == (0, 16)
    assert torch.equal(dk.mm(A[:, :0], B[:0]), torch.zeros((64, 16),
                                                           device=dev))
    assert dk.MM_LAUNCHES == before
