"""The hat kernels (csrc/hat_interp.cu, forward and backward) against
their plain PyTorch versions on the card. Skips where no NVIDIA GPU is
present; run on the card with
`python -m pytest --noconftest tests/test_torch_hat_kernel_cuda.py -q`.

Tolerances, of the output's scale, for both kernels:
  * f32 features: 1e-5 (the kernels sum in another order; the backward's
    float atomics land in an order that changes from run to run).
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


TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


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
    with pytest.raises(ValueError, match="P <= 351"):
        big = torch.zeros((1, 400, 3), device=dev)
        bwd(torch.zeros((1, 400, 32), device=dev), sites, rows[:1], big,
            torch.float32)


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
