"""The four-level site sampler's wrapper (ops/site_sample_kernel) on the
CPU: its plain path against the levels' site_trilinear_sample side by side
(the sampler the plan-free render ran before the kernel) bit for bit, and
against the JAX package's interpolate_site_features; which path
interpolate_site_features takes, by whether a gradient flows; what the
wrapper refuses. The kernel on the card, against the plain path:
tests/test_torch_site_sample_cuda.py.

Tolerance against JAX: atol/rtol 1e-5 (tests/test_torch_eval_render.py's:
sums in another order). Everything else: equal bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralbody_tpu.models import latent_xyzc as j_lx
from neuralbody_tpu.models import sparse_conv_net as j_net
from neuralbody_tpu_torch.models import latent_xyzc as t_lx
from neuralbody_tpu_torch.models import sparse_conv_net as t_net
from neuralbody_tpu_torch.ops import site_sample_kernel as ssk
from neuralbody_tpu_torch.ops import sparse_conv as t_sc
from neuralbody_tpu_torch.renderer import renderer as t_rend
from neuralbody_tpu_torch.train import step as t_step
from neuralbody_tpu_torch.utils import synthetic as t_syn

torch.set_num_threads(1)

OUT_SH = (32, 48, 16)
TOL = dict(atol=1e-5, rtol=1e-5)


def _levels(seed, dtype=torch.float32):
    """Four levels of the grid OUT_SH: unique sites filling about half of
    each level's voxels, padded to cap with rows the index volume never
    names (nonzero, so a stray read shows)."""
    rng = np.random.RandomState(seed)
    feats, ivols, caps = [], [], []
    for lvl, C in enumerate(ssk.CHANNELS, 1):
        sh = tuple(s // 2 ** lvl for s in OUT_SH)
        n_vox = int(np.prod(sh))
        n = max(1, n_vox // 2)
        cap = n + 3
        ivol = np.full(n_vox, cap, np.int32)
        ivol[rng.permutation(n_vox)[:n]] = np.arange(n, dtype=np.int32)
        feats.append(torch.from_numpy(
            rng.randn(cap, C).astype(np.float32)).to(dtype))
        ivols.append(torch.from_numpy(ivol.reshape(sh)))
        caps.append(cap)
    return feats, ivols, tuple(caps)


def _points(seed, far):
    """Full-res voxel coords in and around the grid, with integer ones
    (corners of weight zero inside it) and, with far, the far-off rows of
    test_torch_eval_render.py::test_site_trilinear_sample[far]."""
    rng = np.random.RandomState(seed + 1)
    hi = np.asarray(OUT_SH, np.float32)
    dhw = (rng.uniform(0.0, 1.0, (700, 3)) * (hi + 6) - 3).astype(np.float32)
    dhw[5:25] = np.round(dhw[5:25])
    dhw[25] = hi - 1
    if far:
        dhw[:4] = np.array([1e12, -1e12, 3e9, -3e9])[:, None]
        dhw[4] = (-1e-3, 2.0, 2.0)
    return torch.from_numpy(dhw)


def _side_by_side(feats, ivols, dhw, caps):
    """The render's sampler before the kernel: each level's
    site_trilinear_sample, concatenated."""
    return torch.cat([t_sc.site_trilinear_sample(f, v, dhw, OUT_SH, cap)
                      for f, v, cap in zip(feats, ivols, caps)], dim=-1)


def _static(caps):
    enc = dict(out_sh=OUT_SH, site_caps=(1,) + tuple(caps),
               compute_dtype="float32")
    return (j_lx.ModelStatic(encoder=j_net.EncoderStatic(**enc)),
            t_lx.ModelStatic(encoder=t_net.EncoderStatic(**enc)))


def _bits(t):
    return t.detach().numpy().view(np.uint32)


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_path_equals_the_levels_side_by_side(dtype, far):
    """The wrapper on the CPU, and interpolate_site_features without a
    gradient, give the levels' samples side by side, bit for bit: empty
    voxels, corners outside the volume and far-off points included."""
    feats, ivols, caps = _levels(0, dtype)
    dhw = _points(0, far)
    ref = _side_by_side(feats, ivols, dhw, caps)
    assert ref.shape == (700, 352) and ref.dtype == torch.float32
    assert float(ref.abs().max()) > 0 and bool((ref == 0).any())
    before = (ssk.LAUNCHES, ssk.PLAIN_CALLS)
    out = ssk.site_trilinear(feats, ivols, dhw, OUT_SH, caps)
    with torch.no_grad():
        feat = t_lx.interpolate_site_features(feats, ivols, dhw,
                                              _static(caps)[1])
    assert (ssk.LAUNCHES, ssk.PLAIN_CALLS) == (before[0], before[1] + 2)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    np.testing.assert_array_equal(_bits(feat), _bits(ref))


def test_plain_path_matches_jax():
    feats, ivols, caps = _levels(2)
    dhw = _points(2, far=True)
    jm, tm = _static(caps)
    ref = j_lx.interpolate_site_features(
        [jnp.asarray(f.numpy()) for f in feats],
        [jnp.asarray(v.numpy()) for v in ivols], jnp.asarray(dhw.numpy()), jm)
    with torch.no_grad():
        out = t_lx.interpolate_site_features(feats, ivols, dhw, tm)
    assert float(jnp.abs(ref).max()) > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("case", ["feats_grad", "dhw_grad", "no_grad_mode",
                                  "nothing_requires_grad"])
def test_dispatch_by_gradient(monkeypatch, case):
    """interpolate_site_features takes the wrapper only where no gradient
    flows (to the features or the coordinates); else the plain autograd
    expression, whose gradients match jax.vjp of the JAX function. The CPU
    counts plain calls and launches nothing."""
    feats, ivols, caps = _levels(3)
    dhw = _points(3, far=False)
    jm, tm = _static(caps)
    wrapper_calls = []
    wrapper = ssk.site_trilinear

    def counted(*args):
        wrapper_calls.append(1)
        return wrapper(*args)

    monkeypatch.setattr(ssk, "site_trilinear", counted)
    if case == "feats_grad":
        feats = [f.requires_grad_() for f in feats]
    elif case in ("dhw_grad", "no_grad_mode"):
        dhw = dhw.requires_grad_()
    before = (ssk.LAUNCHES, ssk.PLAIN_CALLS)
    with torch.set_grad_enabled(case != "no_grad_mode"):
        out = t_lx.interpolate_site_features(feats, ivols, dhw, tm)
    assert (ssk.LAUNCHES, ssk.PLAIN_CALLS) == (before[0], before[1] + 1)
    grad = case in ("feats_grad", "dhw_grad")
    assert len(wrapper_calls) == (0 if grad else 1)
    assert out.requires_grad == grad
    if not grad:
        return
    gy = np.random.RandomState(4).randn(*out.shape).astype(np.float32)
    wrt = feats if case == "feats_grad" else [dhw]
    got = torch.autograd.grad(out, wrt, torch.from_numpy(gy))
    jf = [jnp.asarray(f.detach().numpy()) for f in feats]
    jiv = [jnp.asarray(v.numpy()) for v in ivols]
    jdhw = jnp.asarray(dhw.detach().numpy())
    if case == "feats_grad":
        _, vjp = jax.vjp(lambda f: j_lx.interpolate_site_features(
            f, jiv, jdhw, jm), jf)
        want = vjp(jnp.asarray(gy))[0]
    else:
        _, vjp = jax.vjp(lambda d: j_lx.interpolate_site_features(
            jf, jiv, d, jm), jdhw)
        want = vjp(jnp.asarray(gy))
    for g, w in zip(got, want):
        assert float(jnp.abs(w).max()) > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _refusals():
    def rows(f, v, d, c):
        f[1] = f[1][:-1]
    def three(f, v, d, c):
        del f[3], v[3]
        c[:] = c[:3]
    def mixed(f, v, d, c):
        f[2] = f[2].bfloat16()
    def f16(f, v, d, c):
        f[:] = [x.half() for x in f]
    def ivol64(f, v, d, c):
        v[0] = v[0].long()
    def dhw64(f, v, d, c):
        d[0] = d[0].double()
    def width(f, v, d, c):
        f[0] = torch.zeros((c[0], 16))
    def strided(f, v, d, c):
        d[0] = torch.cat([d[0], d[0]], 1)[:, ::2]
    def two_devices(f, v, d, c):
        v[2] = v[2].to("meta")
    def meta(f, v, d, c):
        f[:] = [x.to("meta") for x in f]
        v[:] = [x.to("meta") for x in v]
        d[0] = d[0].to("meta")
    return [(rows, ValueError, "point at row"),
            (three, ValueError, "4 levels"),
            (mixed, TypeError, "one dtype"),
            (f16, TypeError, "one dtype"),
            (ivol64, TypeError, "int32"),
            (dhw64, TypeError, "f32"),
            (width, ValueError, "expected"),
            (strided, ValueError, "contiguous"),
            (two_devices, ValueError, "one device"),
            (meta, ValueError, "no site sampling kernel")]


@pytest.mark.parametrize("fault,exc,match", _refusals(),
                         ids=lambda x: getattr(x, "__name__", None))
def test_wrapper_refuses(fault, exc, match):
    """A feature table whose rows differ from its cap (or whose width is
    not the level's), a level count other than 4, dtypes that differ or
    that the kernel does not take, a strided input, inputs on two devices,
    a device with no kernel: the wrapper raises before it computes."""
    feats, ivols, caps = _levels(5)
    caps = list(caps)
    dhw = [_points(5, far=False)]
    fault(feats, ivols, dhw, caps)
    before = (ssk.LAUNCHES, ssk.PLAIN_CALLS)
    with pytest.raises(exc, match=match):
        ssk.site_trilinear(feats, ivols, dhw[0], OUT_SH, caps)
    assert (ssk.LAUNCHES, ssk.PLAIN_CALLS) == before


def test_render_samples_once_a_chunk():
    """A plan-free render on the CPU (eval_step, no gradient) goes through
    the wrapper's plain path once a chunk and launches nothing."""
    batch, static = t_syn.make_batch(n_rays=64, n_verts=500,
                                     voxel_size=0.02, seed=3)
    model = t_lx.ModelStatic(encoder=t_net.EncoderStatic(
        out_sh=static["out_sh"], site_caps=static["site_caps"]))
    settings = t_rend.RenderSettings(
        model=model, voxel_size=(0.02,) * 3, n_samples=8, chunk_rays=16,
        site_interp=True)
    params, _ = t_lx.init(torch.Generator().manual_seed(0),
                          num_train_frame=4, nv=500, device="cpu")
    before = (ssk.LAUNCHES, ssk.PLAIN_CALLS)
    ret = t_step.eval_step(params, batch, settings, device="cpu")
    assert (ssk.LAUNCHES, ssk.PLAIN_CALLS) == (before[0], before[1] + 4)
    assert ret["rgb_map"].shape == (1, 64, 3)
    assert bool(torch.isfinite(ret["rgb_map"]).all())
