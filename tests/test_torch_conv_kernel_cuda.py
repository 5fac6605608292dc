"""The gather-fused sparse-conv kernel (csrc/sparse_conv.cu) against its
plain PyTorch version on the card: every layer shape of a full-width
encode, forward and dx (the deepest reduction, 9 x 384, at 1024 and 3072
sites, split over blocks), ragged site counts, taps that a tile never
names, tables of sentinels only, batched views, and a second call that must
be bit-equal.
Skips where no NVIDIA GPU is present; run on the card with
`python -m pytest --noconftest tests/test_torch_conv_kernel_cuda.py -q`.

Tolerance: 1e-5 of the output's scale in f32 and in bf16 storage. Both
versions round the operands alike (bf16 values and their products are
exact in f32; in f32 the three TF32 products drop 2**-22 of each), so
only the order of the f32 sum differs, and the tensor core's own sums,
which cut instead of rounding, run over at most 256 of the reduction.
"""
import pytest
import torch

from neuralbody_tpu_torch.ops import conv_kernel
from neuralbody_tpu_torch.ops import sparse_conv as sc

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    conv_kernel.build()
    return torch.device("cuda")


def _inputs(seed, lead, n_rows, E, K, S, Cout, dtype, dev):
    g = torch.Generator().manual_seed(seed)
    T = torch.randn((*lead, n_rows, E), generator=g).to(dtype)
    # a fifth of the entries point at the zero row, a few far past it
    idx = torch.randint(0, n_rows + n_rows // 4 + 1, (*lead, K, S),
                        generator=g, dtype=torch.int32)
    idx[idx > n_rows + n_rows // 8] = 2 ** 30
    W = torch.randn((K, E, Cout), generator=g) * 0.1
    return T.to(dev), idx.to(dev), W.to(dev)


def _close(out, ref):
    scale = ref.abs().max().item()
    assert scale > 0 and out.shape == ref.shape
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= TOL * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (lead, n_rows, E, K, S, Cout)
    ((), 700, 16, 27, 700, 16),
    ((), 700, 16, 27, 1500, 32),      # strided: S != n_rows
    ((), 900, 96, 9, 800, 32),        # packed: K = 9, E = 3 Cin
    ((), 500, 192, 9, 450, 64),
    ((), 300, 384, 9, 257, 128),      # ragged last tile, two channel blocks
    ((), 300, 128, 27, 300, 128),
    ((2,), 400, 64, 27, 333, 64),     # batch in the grid
    ((3,), 200, 48, 9, 190, 16),
])
def test_kernel_matches_plain(dev, dtype, shape):
    lead, n_rows, E, K, S, Cout = shape
    T, idx, W = _inputs(0, lead, n_rows, E, K, S, Cout, dtype, dev)
    before = conv_kernel.CONV_LAUNCHES
    out = conv_kernel.sparse_conv(T, idx, W)
    torch.cuda.synchronize()
    assert conv_kernel.CONV_LAUNCHES == before + 1
    _close(out, conv_kernel.sparse_conv_plain(T, idx, W))


def test_kernel_takes_transposed_weights_and_batch_views(dev):
    """dx hands the kernel a flipped, transposed view of w; a batch element
    of a larger table is read through its stride."""
    T, idx, W = _inputs(1, (3,), 250, 32, 27, 250, 64, torch.bfloat16, dev)
    w_t = torch.flip(W, (0,)).transpose(1, 2)       # [27, 64, 32]
    gy = torch.randn((3, 250, 64), device=dev).bfloat16()
    _close(conv_kernel.sparse_conv(gy, idx, w_t),
           conv_kernel.sparse_conv_plain(gy, idx, w_t))
    _close(conv_kernel.sparse_conv(T[1:], idx[1:], W),
           conv_kernel.sparse_conv_plain(T[1:], idx[1:], W))
    _close(conv_kernel.sparse_conv(T[2], idx[2], W),
           conv_kernel.sparse_conv_plain(T[2], idx[2], W))


def test_kernel_refuses_what_it_does_not_take(dev):
    T, idx, W = _inputs(2, (), 100, 32, 27, 100, 32, torch.float32, dev)
    conv = conv_kernel.sparse_conv
    with pytest.raises(TypeError):
        conv(T.half(), idx, W)
    with pytest.raises(TypeError):
        conv(T, idx.long(), W)
    with pytest.raises(ValueError, match="E % 16"):
        conv(T[:, :24].contiguous(), idx, W[:, :24])
    with pytest.raises(ValueError, match="Cout"):
        conv(T, idx, W[:, :, :24])
    with pytest.raises(ValueError):
        conv(T, idx.cpu(), W)
    with pytest.raises(ValueError, match="contiguous"):
        conv(T.t().contiguous().t(), idx, W)
    with pytest.raises(ValueError):
        conv(T, idx[:26], W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["subm", "xtri", "down"])
def test_conv_functions_launch_the_kernel(dev, dtype, kind):
    """The three autograd Functions on the card: one launch forward, one
    for dx, and y, dx and dW equal those of the same Function on the CPU
    (whose wrapper takes the plain version)."""
    from neuralbody_tpu_torch.utils.synthetic import make_batch
    batch, _ = make_batch(n_rays=16, n_verts=400, voxel_size=0.02, seed=3,
                          batch_size=2)
    g = {k: torch.from_numpy(v) for k, v in batch["geom"].items()}
    if kind == "subm":
        lvl, cin, cout, fn = 1, 32, 16, sc.subm_conv
        tabs = (g["nbr1"],)
    elif kind == "xtri":
        lvl, cin, cout, fn = 2, 32, 64, sc.subm_conv_xtri
        tabs = tuple(g[f"x{n}2"] for n in
                     ("lnbr", "rnbr", "nbr9", "augl", "augr"))
    else:
        lvl, cin, cout, fn = 0, 16, 32, sc.down_conv
        tabs = (g["down0"], g["up0"])
    cap_in = g[f"sites{lvl}"].shape[-2]
    cap_out = g["down0"].shape[-1] if kind == "down" else cap_in
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, cap_in, cin), generator=gen).to(dtype)
    w = torch.randn((27, cin, cout), generator=gen) * 0.1
    gy = torch.randn((2, cap_out, cout), generator=gen) * 0.1

    def run(device):
        xd = x.to(device).requires_grad_()
        wd = w.to(device).requires_grad_()
        y = fn(xd, wd, *(t.to(device) for t in tabs))
        dx, dw = torch.autograd.grad(y, (xd, wd), gy.to(device))
        return y.detach().cpu(), dx.cpu(), dw.cpu()

    before = conv_kernel.CONV_LAUNCHES
    y, dx, dw = run(dev)
    torch.cuda.synchronize()
    assert conv_kernel.CONV_LAUNCHES == before + 2
    ry, rdx, rdw = run("cpu")
    assert conv_kernel.CONV_LAUNCHES == before + 2
    assert dx.dtype == dtype and dw.dtype == torch.float32
    _close(y, ry)
    # dx is rounded to x's dtype once: a last-bit difference of the f32 sum
    # can flip it to the neighbouring bf16 value (2**-8)
    rel = TOL if dtype == torch.float32 else 1e-2
    assert (dx.float() - rdx.float()).abs().max().item() <= \
        rel * rdx.float().abs().max().item()
    assert (dw - rdw).abs().max().item() <= 1e-4 * rdw.abs().max().item()


# (name, n_rows, E, K, S, Cout) of the 17 convs of a full-width encode (site
# caps 6656 / 16128 / 9984 / 3072 / 1024; a packed table has cap + F rows)
# and of their dx: a packed conv's dx is a packed conv of the same shape
# with Cin and Cout swapped, a strided conv's dx goes through the up table
ENCODE = [
    ("conv0", 7000, 48, 9, 6656, 16),
    ("down0", 6656, 16, 27, 16128, 32),
    ("conv1", 16700, 96, 9, 16128, 32),
    ("down1", 16128, 32, 27, 9984, 64),
    ("conv2", 10400, 192, 9, 9984, 64),
    ("down2", 9984, 64, 27, 3072, 128),
    ("conv3", 3300, 384, 9, 3072, 128),
    ("down3", 3072, 128, 27, 1024, 128),
    ("conv4", 1100, 384, 9, 1024, 128),
    ("dx_conv0", 7000, 48, 9, 6656, 16),
    ("dx_down0", 16128, 32, 27, 6656, 16),
    ("dx_conv1", 16700, 96, 9, 16128, 32),
    ("dx_down1", 9984, 64, 27, 16128, 32),
    ("dx_conv2", 10400, 192, 9, 9984, 64),
    ("dx_down2", 3072, 128, 27, 9984, 64),
    ("dx_conv3", 3300, 384, 9, 3072, 128),
    ("dx_down3", 1024, 128, 27, 3072, 128),
    ("dx_conv4", 1100, 384, 9, 1024, 128),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", ENCODE, ids=[e[0] for e in ENCODE])
def test_encode_layers(dev, dtype, layer):
    _, n_rows, E, K, S, Cout = layer
    T, idx, W = _inputs(10, (1,), n_rows, E, K, S, Cout, dtype, dev)
    before = conv_kernel.CONV_LAUNCHES
    out = conv_kernel.sparse_conv(T, idx, W)
    torch.cuda.synchronize()
    assert conv_kernel.CONV_LAUNCHES == before + 1
    _close(out, conv_kernel.sparse_conv_plain(T, idx, W))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1000, 3001, 65, 1, 128])
def test_ragged_site_counts(dev, dtype, S):
    """S no multiple of the 64-site tile, with and without a split (S =
    128: two tiles, each split over a cluster of blocks)."""
    T, idx, W = _inputs(11, (), 1200, 384, 9, S, 128, dtype, dev)
    _close(conv_kernel.sparse_conv(T, idx, W),
           conv_kernel.sparse_conv_plain(T, idx, W))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [3072, 200])
def test_taps_no_site_names(dev, dtype, S):
    """Taps that no site of a tile names are skipped: the first tiles name
    only some taps, one tile names none, and a table of sentinels only
    gives exact zeros."""
    T, idx, W = _inputs(12, (), 900, 64, 27, S, 64, dtype, dev)
    idx[:5, :64] = 900                   # tile 0 lacks taps 0-4
    idx[::2, 64:128] = 2 ** 30           # tile 1 lacks the even taps
    idx[:, 128:192] = 900                # tile 2 names no tap
    out = conv_kernel.sparse_conv(T, idx, W)
    _close(out, conv_kernel.sparse_conv_plain(T, idx, W))
    assert (out[128:192] == 0).all()
    none = torch.full_like(idx, 900)
    none[::3] = 2 ** 30
    assert (conv_kernel.sparse_conv(T, none, W) == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_views_with_a_split(dev, dtype):
    """A batch whose layers split the reduction (a cluster per tile) and a
    view of a larger batch through its table stride."""
    T, idx, W = _inputs(13, (3,), 1100, 384, 9, 1024, 128, dtype, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert conv_kernel.split_plan(2, 1024, 9, 384, dtype, sms) > 1
    _close(conv_kernel.sparse_conv(T[1:], idx[1:], W),
           conv_kernel.sparse_conv_plain(T[1:], idx[1:], W))
    _close(conv_kernel.sparse_conv(T, idx, W),
           conv_kernel.sparse_conv_plain(T, idx, W))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", ["conv4", "conv2", "dx_down0"])
def test_second_call_is_bit_equal(dev, dtype, layer):
    """Every sum runs in a fixed order (the split's partials too)."""
    _, n_rows, E, K, S, Cout = next(e for e in ENCODE if e[0] == layer)
    T, idx, W = _inputs(14, (), n_rows, E, K, S, Cout, dtype, dev)
    a = conv_kernel.sparse_conv(T, idx, W)
    b = conv_kernel.sparse_conv(T, idx, W)
    assert torch.equal(a, b)
