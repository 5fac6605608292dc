"""The hat kernels (csrc/hat_interp.cu, forward and backward) against
their plain PyTorch versions on the card, the forward with its cell lookup
and with its scan (the backward has one path): at the working point's
level shapes, with sentinel rows,
duplicate cells, empty lists, several passes and column-slice outputs
(forward) or cotangents (backward). Skips where no NVIDIA GPU is present;
run on the card with
`python -m pytest --noconftest tests/test_torch_hat_kernel_cuda.py -q`.

Tolerances, of the output's scale, for both kernels:
  * f32 features: 1e-5 (the kernels sum in another order than the plain
    versions; the backward's order is fixed: two runs give equal bits,
    test_backward_sums_in_one_order, test_two_eager_steps_are_bit_equal).
  * bf16 features: the weight is rounded to bf16 in both; a weight that
    differs by one f32 ulp (another order of the three-factor product on
    the card) can round to the neighbouring bf16 value, 2**-8 relative on
    that one term, so 1e-3.
"""
import pytest
import torch

from neuralbody_tpu_torch.ops import hat_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    hat_kernel.build()
    return torch.device("cuda")


TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def _inputs(seed, ngrp, P, capR, C, capS, dtype, dev):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn((capS, C), generator=g).to(dtype)
    sites = torch.randint(0, 8, (capS, 3), generator=g, dtype=torch.int32)
    sites[-2:] = 2 ** 30
    rows = torch.randint(0, capS, (ngrp, capR), generator=g,
                         dtype=torch.int32)
    rows[:, -5:] = capS
    pos = torch.rand((ngrp, P, 3), generator=g) * 8
    return [t.to(dev) for t in (feats, sites, rows, pos)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 128, 256, 32, 300),
                                   (5, 128, 96, 128, 200),
                                   (3, 16, 40, 32, 50)])
def test_kernel_matches_plain(dev, dtype, shape):
    ngrp, P, capR, C, capS = shape
    args = _inputs(0, ngrp, P, capR, C, capS, dtype, dev)
    before = hat_kernel.LAUNCHES
    out = hat_kernel.hat_interp_level(*args)
    torch.cuda.synchronize()
    assert hat_kernel.LAUNCHES == before + 1
    ref = hat_kernel.hat_interp_level_plain(*args)
    scale = ref.abs().max().item()
    assert scale > 0
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    assert (out - ref).abs().max().item() <= tol * scale


def _cell_inputs(seed, ngrp, P, capR, C, capS, dtype, dev, n_rows=None):
    """Inputs as the planner makes them: every site its own integer cell,
    no row twice in a group, sentinels at the end of a row list."""
    g = torch.Generator().manual_seed(seed)
    side = 1
    while side ** 3 < capS:
        side += 1
    cells = torch.randperm(side ** 3, generator=g)[:capS]
    sites = torch.stack([cells // side ** 2, cells // side % side,
                         cells % side], dim=1).to(torch.int32)
    feats = torch.randn((capS, C), generator=g).to(dtype)
    n_rows = capR - 5 if n_rows is None else n_rows
    rows = torch.full((ngrp, capR), capS, dtype=torch.int32)
    for i in range(ngrp):
        rows[i, :n_rows] = torch.randperm(capS, generator=g)[:n_rows]
    # each point within a cell's reach of one of its group's rows
    pick = torch.randint(0, max(n_rows, 1), (ngrp, P), generator=g)
    near = sites[torch.gather(rows, 1, pick).clamp(max=capS - 1).long()]
    pos = near.float() + torch.rand((ngrp, P, 3), generator=g) * 1.8 - 0.9
    pos[:, 0] = pos[:, 0].round()          # a point on a cell
    return [t.to(dev) for t in (feats, sites, rows, pos)]


def _fwd_close(args, dtype, out=None):
    got = hat_kernel.hat_interp_level(*args, out=out)
    torch.cuda.synchronize()
    ref = hat_kernel.hat_interp_level_plain(*args)
    scale = ref.abs().max().item()
    assert scale > 0 and got.shape == ref.shape
    assert (got - ref).abs().max().item() <= TOL[dtype] * scale
    return got, ref


# (capR, C, capS) of the four levels at the reference working point (658
# groups of 128 points); f32 at (160, 128) stages 80 KB of features
LEVELS = [(256, 32, 16128), (288, 64, 9984), (160, 128, 3072),
          (96, 128, 1024)]


@pytest.mark.parametrize("lookup", [True, False], ids=["lookup", "scan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("level", LEVELS)
def test_forward_at_the_working_point(dev, monkeypatch, level, dtype, lookup):
    capR, C, capS = level
    monkeypatch.setattr(hat_kernel, "LOOKUP", lookup)
    args = _cell_inputs(10, 9, 128, capR, C, capS, dtype, dev)
    _, ref = _fwd_close(args, dtype)
    # every point is in reach of a listed row
    assert (ref.abs().sum(-1) > 0).float().mean().item() > 0.9


@pytest.mark.parametrize("lookup", [True, False], ids=["lookup", "scan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_with_duplicate_cells(dev, monkeypatch, dtype, lookup):
    """Rows listed twice and sites that share a cell: the lookup's blocks
    fall back to the scan, and both count every listed row."""
    monkeypatch.setattr(hat_kernel, "LOOKUP", lookup)
    args = _inputs(11, 6, 128, 200, 64, 150, dtype, dev)
    assert any(len(set(r.tolist())) < r.numel() for r in args[2])
    _fwd_close(args, dtype)


@pytest.mark.parametrize("lookup", [True, False], ids=["lookup", "scan"])
def test_forward_sentinel_rows_and_empty_lists(dev, monkeypatch, lookup):
    monkeypatch.setattr(hat_kernel, "LOOKUP", lookup)
    feats, sites, rows, pos = _cell_inputs(12, 4, 128, 64, 64, 400,
                                           torch.bfloat16, dev)
    rows[1] = 400                           # a group of only sentinel rows
    rows[2, 3:] = 400
    got, _ = _fwd_close((feats, sites, rows, pos), torch.bfloat16)
    assert (got[1] == 0).all()
    before = hat_kernel.LAUNCHES
    out = torch.full((4, 128, 64), 3.0, device=dev)
    hat_kernel.hat_interp_level(feats, sites, rows[:, :0], pos, out=out)
    assert (out == 0).all() and hat_kernel.LAUNCHES == before   # capR = 0


@pytest.mark.parametrize("lookup", [True, False], ids=["lookup", "scan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_in_several_passes(dev, monkeypatch, dtype, lookup):
    """More rows than 200 KB of shared memory hold: later passes add into
    the output."""
    monkeypatch.setattr(hat_kernel, "LOOKUP", lookup)
    args = _cell_inputs(13, 3, 64, 900, 128, 2000, dtype, dev)
    _fwd_close(args, dtype)


def test_forward_ragged_point_counts(dev):
    for P in (1, 3, 33, 130):
        _fwd_close(_cell_inputs(14, 2, P, 40, 32, 100, torch.float32, dev),
                   torch.float32)


def test_kernel_refuses_misaligned_out(dev):
    args = _inputs(15, 2, 16, 16, 32, 20, torch.float32, dev)
    buf = torch.zeros((2, 16, 354), device=dev)
    with pytest.raises(ValueError, match="aligned"):
        hat_kernel.hat_interp_level(*args, out=buf[..., 2:34])
    with pytest.raises(ValueError, match="aligned"):
        hat_kernel.hat_interp_level(*args, out=buf[..., 0:32])  # stride 354
    with pytest.raises(ValueError, match="C % 32"):
        hat_kernel.hat_interp_level(
            torch.zeros((20, 96), device=dev), *args[1:])


def test_kernel_writes_column_slice(dev):
    args = _inputs(1, 4, 64, 64, 64, 100, torch.bfloat16, dev)
    buf = torch.full((4, 64, 352), -7.0, device=dev)
    hat_kernel.hat_interp_level(*args, out=buf[..., 32:96])
    ref = hat_kernel.hat_interp_level_plain(*args)
    assert (buf[..., 32:96] - ref).abs().max().item() <= \
        1e-3 * ref.abs().max().item()
    assert (buf[..., :32] == -7).all() and (buf[..., 96:] == -7).all()


def test_kernel_refuses_what_it_does_not_take(dev):
    feats, sites, rows, pos = _inputs(2, 2, 16, 16, 32, 20, torch.float32,
                                      dev)
    with pytest.raises(TypeError):
        hat_kernel.hat_interp_level(feats.half(), sites, rows, pos)
    with pytest.raises(ValueError, match="C % 32"):
        hat_kernel.hat_interp_level(feats[:, :16].contiguous(), sites, rows,
                                    pos)
    with pytest.raises(ValueError):
        hat_kernel.hat_interp_level(feats, sites, rows, pos.cpu())
    with pytest.raises(ValueError):
        hat_kernel.hat_interp_level(feats.t().contiguous().t(), sites, rows,
                                    pos)


def _bwd_check(got, args, dtype):
    ref = hat_kernel.hat_interp_level_bwd_plain(*args, dtype)
    scale = ref.abs().max().item()
    assert scale > 0 and got.shape == ref.shape
    assert (got - ref).abs().max().item() <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 128, 256, 32, 300),
                                   (5, 128, 96, 128, 200),
                                   (3, 16, 40, 32, 50),
                                   (4, 100, 33, 64, 60)])
def test_bwd_kernel_matches_plain(dev, dtype, shape):
    ngrp, P, capR, C, capS = shape
    _, sites, rows, pos = _inputs(3, ngrp, P, capR, C, capS, dtype, dev)
    grad = torch.randn((ngrp, P, C), generator=torch.Generator(
        device=dev).manual_seed(4), device=dev)
    before = hat_kernel.BWD_LAUNCHES
    got = hat_kernel.hat_interp_level_bwd(grad, sites, rows, pos, dtype)
    torch.cuda.synchronize()
    assert hat_kernel.BWD_LAUNCHES == before + 1
    assert got.dtype == torch.float32
    _bwd_check(got, (grad, sites, rows, pos), dtype)


def test_bwd_kernel_reads_column_slice(dev):
    _, sites, rows, pos = _inputs(5, 4, 64, 64, 64, 100, torch.bfloat16, dev)
    buf = torch.randn((4, 64, 352), device=dev)
    got = hat_kernel.hat_interp_level_bwd(buf[..., 96:160], sites, rows, pos,
                                          torch.bfloat16)
    _bwd_check(got, (buf[..., 96:160].contiguous(), sites, rows, pos),
               torch.bfloat16)


def test_bwd_kernel_refuses_what_it_does_not_take(dev):
    _, sites, rows, pos = _inputs(6, 2, 16, 16, 32, 20, torch.float32, dev)
    grad = torch.randn((2, 16, 32), device=dev)
    bwd = hat_kernel.hat_interp_level_bwd
    with pytest.raises(TypeError):
        bwd(grad, sites, rows, pos, torch.float16)
    with pytest.raises(TypeError):
        bwd(grad.bfloat16(), sites, rows, pos, torch.float32)
    with pytest.raises(ValueError, match="C % 32"):
        bwd(grad[..., :16].contiguous(), sites, rows, pos, torch.float32)
    with pytest.raises(ValueError):
        bwd(grad, sites, rows, pos.cpu(), torch.float32)
    with pytest.raises(ValueError):
        bwd(grad.transpose(0, 1).contiguous().transpose(0, 1), sites, rows,
            pos, torch.float32)
    with pytest.raises(RuntimeError, match="launch failed"):
        big = torch.zeros((1, 5000, 3), device=dev)
        bwd(torch.zeros((1, 5000, 32), device=dev), sites, rows[:1], big,
            torch.float32)


def _bwd_close(args, dtype, grad=None):
    """The backward kernel against its plain version on the forward's
    inputs and a cotangent (random unless given)."""
    _, sites, rows, pos = args
    if grad is None:
        grad = torch.randn((*pos.shape[:2], args[0].shape[1]),
                           generator=torch.Generator(device=pos.device)
                           .manual_seed(21), device=pos.device)
    before = hat_kernel.BWD_LAUNCHES
    got = hat_kernel.hat_interp_level_bwd(grad, sites, rows, pos, dtype)
    torch.cuda.synchronize()
    assert hat_kernel.BWD_LAUNCHES == before + 1
    _bwd_check(got, (grad, sites, rows, pos), dtype)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("level", LEVELS)
def test_backward_at_the_working_point(dev, level, dtype):
    capR, C, capS = level
    got = _bwd_close(_cell_inputs(20, 9, 128, capR, C, capS, dtype, dev),
                     dtype)
    assert (got.abs().sum(-1) > 0).sum().item() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_with_duplicate_cells(dev, dtype):
    """Rows listed twice and sites that share a cell: every listed row
    gets its share."""
    args = _inputs(22, 6, 128, 200, 64, 150, dtype, dev)
    assert any(len(set(r.tolist())) < r.numel() for r in args[2])
    _bwd_close(args, dtype)


def test_backward_sentinel_rows_and_empty_lists(dev):
    feats, sites, rows, pos = _cell_inputs(23, 4, 128, 64, 64, 400,
                                           torch.bfloat16, dev)
    rows[1] = 400                           # a group of only sentinel rows
    rows[2, 3:] = 400
    _bwd_close((feats, sites, rows, pos), torch.bfloat16)
    grad = torch.randn((4, 128, 64), device=dev)
    before = hat_kernel.BWD_LAUNCHES
    out = hat_kernel.hat_interp_level_bwd(grad, sites, rows[:, :0], pos,
                                          torch.float32)
    assert (out == 0).all() and hat_kernel.BWD_LAUNCHES == before  # capR = 0


@pytest.mark.parametrize("level", LEVELS[1:3])
def test_backward_reads_a_column_slice(dev, level):
    """The cotangent as the path hands it over: the level's columns of the
    [ngrp, P, 352] gradient, read through its row stride."""
    capR, C, capS = level
    args = _cell_inputs(24, 5, 128, capR, C, capS, torch.float32, dev)
    buf = torch.randn((5, 128, 352), device=dev)
    got = hat_kernel.hat_interp_level_bwd(buf[..., 96:96 + C], *args[1:],
                                          torch.float32)
    _bwd_check(got, (buf[..., 96:96 + C].contiguous(), *args[1:]),
               torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_in_several_passes(dev, dtype):
    """More rows than fit in shared memory beside the group's cotangent
    (380 points x 128 channels leave room for 352 of the 900): each pass
    writes its rows' slots."""
    _bwd_close(_cell_inputs(25, 3, 380, 900, 128, 2000, dtype, dev), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interpolate_function_launches_both(dev, dtype):
    """ops/hat_interp.hat_interpolate on the card: 4 forward and 4 backward
    launches, and the gradient of each level is its backward kernel's."""
    from neuralbody_tpu_torch.models.latent_xyzc import ModelStatic
    from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic
    from neuralbody_tpu_torch.ops.hat_interp import hat_interpolate
    g = torch.Generator().manual_seed(7)
    out_sh, Cs, caps = (64, 64, 64), (32, 64, 128, 128), (90, 60, 40, 20)
    feats, geom, rows = [], {}, {}
    for lvl, (C, capS) in enumerate(zip(Cs, caps), 1):
        f, s, r, _ = _inputs(lvl, 6, 128, 48, C, capS, dtype, "cpu")
        s[:-2] = torch.randint(0, 64 // 2 ** lvl, (capS - 2, 3), generator=g,
                               dtype=torch.int32)
        feats.append(f.to(dev).requires_grad_())
        geom[f"sites{lvl}"] = s.to(dev)
        rows[lvl] = r.to(dev)
    dhw = (torch.rand((6, 128, 3), generator=g) * 63).to(dev)
    static = ModelStatic(encoder=EncoderStatic(out_sh=out_sh,
                                               site_caps=(128,) + caps))
    f0, b0 = hat_kernel.LAUNCHES, hat_kernel.BWD_LAUNCHES
    out = hat_interpolate(feats, geom, rows, dhw, static)
    gout = torch.randn(out.shape, device=dev)
    got = torch.autograd.grad(out, feats, gout)
    torch.cuda.synchronize()
    assert (hat_kernel.LAUNCHES - f0, hat_kernel.BWD_LAUNCHES - b0) == (4, 4)
    c0, sh = 0, torch.tensor(out_sh, dtype=torch.float32, device=dev)
    for lvl, (f, d) in enumerate(zip(feats, got), 1):
        C = f.shape[1]
        assert d.dtype == dtype
        sh_l = torch.tensor([s // 2 ** lvl for s in out_sh],
                            dtype=torch.float32, device=dev)
        pos = dhw * ((sh_l - 1.0) / sh)
        ref = hat_kernel.hat_interp_level_bwd_plain(
            gout[..., c0:c0 + C].contiguous(), geom[f"sites{lvl}"],
            rows[lvl], pos, dtype)
        # d is rounded to the features' dtype once
        tol = TOL[dtype] if dtype == torch.float32 else 1e-2
        assert (d.float() - ref).abs().max().item() <= \
            tol * ref.abs().max().item()
        c0 += C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_sums_in_one_order(dev, dtype):
    """The working point's level 4 (its 1024 sites shared by every group,
    so each row sums many groups' shares): two calls give equal bits."""
    capR, C, capS = LEVELS[3]
    _, sites, rows, pos = _cell_inputs(24, 64, 128, capR, C, capS, dtype,
                                       dev)
    grad = torch.randn((64, 128, C), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    first = hat_kernel.hat_interp_level_bwd(grad, sites, rows, pos, dtype)
    again = hat_kernel.hat_interp_level_bwd(grad, sites, rows, pos, dtype)
    assert torch.equal(first, again)


def test_two_eager_steps_are_bit_equal(dev):
    """Two eager bf16 runs of the first training step at the working point
    (tools/graph_noise.py's "full" scene, seeded weights): the loss, the
    rendered colours and every gradient equal bit for bit. (In f32 the
    vertex codes' index_add_, ops/sparse_conv.scatter_vertex_codes, still
    adds a voxel's three or more codes in an order that varies, in the last
    bits; bf16 storage of the codes rounds that away at this scene.)"""
    mode = "bfloat16"
    from neuralbody_tpu_torch.tools import graph_noise
    from neuralbody_tpu_torch.train.step import loss_and_grads
    (a, _), settings, init = graph_noise._hat_scene(
        dev, mode, 1024, 6890, 0.005, 64, 0, lambda: (lambda t: 5e-4))
    runs = [loss_and_grads(init()[0], a, settings) for _ in range(2)]
    (l1, (r1, _, _), g1), (l2, (r2, _, _), g2) = runs
    assert torch.equal(l1, l2) and torch.equal(r1["rgb_map"], r2["rgb_map"])
    leaves = [(graph_noise._named(g, "g")) for g in (g1, g2)]
    assert len(leaves[0]) == len(leaves[1]) > 40
    for (path, x), (_, y) in zip(*leaves):
        assert torch.equal(x, y), path
