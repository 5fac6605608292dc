"""The dense-layer kernels (csrc/dense_mm.cu: the tf32x3 and fma main
routes, the narrow rows and columns routes, the bias and ReLU epilogue)
against their plain PyTorch version on the card. Skips where no NVIDIA GPU is present; run on
the card with
`python -m pytest --noconftest tests/test_torch_dense_kernel_cuda.py -q`.

Tolerance: 1e-5 of the output's scale in f32 and with bf16 operands. Both
versions round the operands alike (bf16 values and their products are exact
in f32), so only the order of the f32 sum differs; the tf32x3 route also
drops the low x low term of each f32 product, 2**-22 of it. Gradients of
`linear`: 1e-4 of each gradient's scale.
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


@pytest.fixture(params=["tf32x3", "fma"])
def f32_route(request, monkeypatch):
    """Both main kernels of f32 operands, each taking every shape."""
    monkeypatch.setattr(dk, "FORCE_MAIN", request.param)
    return request.param


SHAPES = [
    # (M, K, N): ragged in every dimension, around the tile and chunk edges
    (1, 1, 1), (127, 15, 129), (128, 16, 128), (129, 17, 127),
    (1000, 63, 256), (700, 319, 256), (515, 283, 128), (900, 256, 1),
    (333, 128, 3), (2048, 256, 256), (1024, 1024, 1024),
]


@pytest.mark.parametrize("shape", SHAPES[1:] + [(130, 33, 200),
                                               (256, 100, 64)])
def test_main_routes_match_plain(dev, f32_route, shape):
    """Either main route alone, on every shape (the narrow ones too), with
    and without the epilogue."""
    M, K, N = shape
    A, B = _operands(5, M, K, N, torch.float32, dev)
    bias = torch.randn(N, generator=torch.Generator().manual_seed(6)).to(dev)
    assert dk.route_plan(A, B)[0] == f32_route
    _close(dk.mm(A, B), dk.mm_plain(A, B))
    _close(dk.mm(A, B, bias, relu=True), dk.mm_plain(A, B, bias, relu=True))
    _close(dk.mm(A, B, bias), dk.mm_plain(A, B, bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
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


def test_strided_operands_on_both_main_routes(dev, f32_route):
    A, B = _operands(7, 300, 400, 200, torch.float32, dev)
    cases = [
        (A[:, 8:328], B[8:328]),          # aligned slices: 16-byte copies
        (A[:, 7:326], B[7:326]),          # a slice at an odd column
        (A.t()[:152], B[:300, :76]),      # A^T, aligned
        (A.t()[:150], B[:300, 1:78]),     # A^T and an odd slice of B
        (A[:, :200], B.t()),              # B^T
        (A.t()[:200].t()[::2], B[:200, ::3]),
        (A[:, :1].expand(300, 400), B),
    ]
    for a, b in cases:
        _close(dk.mm(a, b), dk.mm_plain(a, b))


@pytest.mark.parametrize("N", [1, 2, 3, 5, 8])
def test_narrow_routes(dev, N):
    """N <= 8: the rows route forward (aligned rows, a slice at an odd
    column, ragged K) and the columns route for A = x^T, split and not,
    with the epilogue; each counts under its route."""
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((5000, 288), generator=gen).to(dev)
    w = torch.randn((288, N), generator=gen).to(dev)
    bias = torch.randn(N, generator=gen).to(dev)
    g = torch.randn((5000, N), generator=gen).to(dev)
    fwd = [(x[:, :256], w[:256]), (x[:, 4:67], w[:63]),    # 16-byte pieces
           (x[:, :283], w[:283]),
           (x[:, 27:155], w[:128])]                        # an odd column
    before = (dk.MM_LAUNCHES, dk.ROUTE_LAUNCHES["rows"], dk.SUM_LAUNCHES,
              dk.ROUTE_LAUNCHES["cols"], dk.EPILOGUE_LAUNCHES)
    for a, b in fwd:
        assert dk.route_plan(a, b)[0] == "rows"
        _close(dk.mm(a, b), dk.mm_plain(a, b))
        _close(dk.mm(a, b, bias, relu=True), dk.mm_plain(a, b, bias, True))
    assert (dk.MM_LAUNCHES, dk.ROUTE_LAUNCHES["rows"], dk.SUM_LAUNCHES,
            dk.EPILOGUE_LAUNCHES) == (before[0] + 8, before[1] + 8, before[2],
                                      before[4] + 4)
    # dW: x^T [K, points] @ g [points, N], 4 ranges of the reduction
    route, splits, _ = dk.route_plan(x.t(), g)
    assert (route, splits) == ("cols", 4)
    out = dk.mm(x.t(), g)
    _close(out, dk.mm_plain(x.t(), g))
    assert torch.equal(out, dk.mm(x.t(), g))          # no atomics
    assert dk.SUM_LAUNCHES == before[2] + 2
    assert dk.ROUTE_LAUNCHES["cols"] == before[3] + 2
    _close(dk.mm(x.t(), g, bias, relu=True),
           dk.mm_plain(x.t(), g, bias, True))
    short = x[:700, 5:140].t()                         # one range, a slice
    assert dk.route_plan(short, g[:700]) == ("cols", 1, 704)
    _close(dk.mm(short, g[:700]), dk.mm_plain(short, g[:700]))


@pytest.mark.parametrize("relu", [False, True], ids=["id", "relu"])
@pytest.mark.parametrize("shape", [(5000, 63, 256), (3000, 319, 256),
                                   (4000, 256, 256), (6000, 256, 1),
                                   (6000, 128, 3)])
def test_linear_function_on_the_card(dev, shape, relu):
    """linear's forward is one launch (bias and ReLU in it), its backward
    two (or one when x needs no gradient); the output equals the plain
    layer's, and dx, dw and db the plain products of the cotangent masked by
    the kernel's own output (an output within rounding of 0 may fall on
    either side in the two versions, and its whole cotangent with it)."""
    M, K, N = shape
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((M, K), generator=gen).to(dev)
    w = (torch.randn((K, N), generator=gen) * 0.1).to(dev)
    b = torch.randn(N, generator=gen).to(dev)
    gy = torch.randn((M, N), generator=gen).to(dev)

    for needs_dx in (True, False):
        leaves = [x.clone().requires_grad_(needs_dx),
                  w.clone().requires_grad_(), b.clone().requires_grad_()]
        before = dk.MM_LAUNCHES
        y = dk.linear(*leaves, relu)
        y.backward(gy)
        torch.cuda.synchronize()
        assert dk.MM_LAUNCHES == before + 2 + needs_dx
        _close(y.detach(), dk.linear_plain(x, w, b, relu))
        gm = gy * (y.detach() > 0) if relu else gy
        ref = [dk.mm_plain(gm, w.t()) if needs_dx else None,
               dk.mm_plain(x.t(), gm), gm.sum(0)]
        for t, r in zip(leaves, ref):
            assert (t.grad is None) == (r is None)
            if r is not None:
                scale = r.abs().max().item()
                assert (t.grad - r).abs().max().item() <= 1e-4 * scale


def test_split_with_epilogue(dev, f32_route):
    """A split product applies the bias and the ReLU in the sum of its
    partials."""
    gen = torch.Generator().manual_seed(10)
    x = torch.randn((20000, 200), generator=gen).to(dev)
    g = torch.randn((20000, 100), generator=gen).to(dev)
    bias = torch.randn(100, generator=gen).to(dev)
    assert dk.route_plan(x.t(), g)[1] > 1
    _close(dk.mm(x.t(), g, bias, relu=True),
           dk.mm_plain(x.t(), g, bias, True))


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
