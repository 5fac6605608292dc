"""Parity of the PyTorch port's sparse-conv forward and encoder with the
JAX package, on the CPU at a small size (~500 vertices, 2 cm voxels),
with weights from neuralbody_tpu's init through params_from_jax.

Tolerances:
  * f32: atol/rtol 1e-5 per op (sums in another order).
  * one layer with bf16 storage: the inputs and weights are bf16 in both
    packages and the products exact in f32, so the f32 result matches at
    1e-5 as well.
  * the whole encoder with bf16 storage: each layer rounds its f32 output
    to bf16, and a sum that differs in its last f32 bit can round to the
    neighbouring bf16 value (2**-8 relative). Fourteen layers carry such
    flips forward, so the site features are held to 5e-2 of their largest
    magnitude and 2e-2 relative in the L2 norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralbody_tpu.models import latent_xyzc as j_lx
from neuralbody_tpu.models import sparse_conv_net as j_net
from neuralbody_tpu.ops import sparse_conv as j_sc
from neuralbody_tpu.utils.synthetic import make_batch
from neuralbody_tpu_torch.models import latent_xyzc as t_lx
from neuralbody_tpu_torch.models import sparse_conv_net as t_net
from neuralbody_tpu_torch.ops import sparse_conv as t_sc
from neuralbody_tpu_torch.utils.platform import to_device
from neuralbody_tpu_torch.utils.transplant import params_from_jax

torch.set_num_threads(1)

VOX = 0.02
NV = 500
TOL = dict(atol=1e-5, rtol=1e-5)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def scene():
    batch, static = make_batch(n_rays=16, n_verts=NV, voxel_size=VOX,
                               seed=3, batch_size=2)
    params, stats = j_lx.init(jax.random.PRNGKey(0), num_train_frame=4,
                              nv=NV)
    return batch, static, params, stats


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _feats(rng, shape, dtype):
    x = rng.randn(*shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("batched", [False, True])
def test_scatter_vertex_codes(scene, batched):
    batch, static, params, _ = scene
    cap = static["site_caps"][0]
    vidx = batch["geom"]["vert_idx"] if batched else \
        batch["geom"]["vert_idx"][0]
    codes = np.array(params["vertex_code"])
    ref = j_sc.scatter_vertex_codes(jnp.asarray(codes), jnp.asarray(vidx),
                                    cap)
    out = t_sc.scatter_vertex_codes(torch.from_numpy(codes),
                                    torch.from_numpy(vidx), cap)
    assert out.shape == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def _geom(batch, batched):
    return batch["geom"] if batched else {k: v[0] for k, v in
                                          batch["geom"].items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
def test_subm_conv(scene, dtype, batched):
    batch, static, params, _ = scene
    g = _geom(batch, batched)
    cap = static["site_caps"][1]
    rng = np.random.RandomState(0)
    xj, xt = _feats(rng, ((2,) if batched else ()) + (cap, 32), dtype)
    w = np.array(params["xyzc_net"]["conv1"][0]["w"])
    ref = j_sc.subm_conv(xj, jnp.asarray(w), jnp.asarray(g["nbr1"]))
    out = t_sc.subm_conv(xt, torch.from_numpy(w), torch.from_numpy(g["nbr1"]))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
def test_subm_conv_xtri(scene, dtype, batched):
    batch, static, params, _ = scene
    g = _geom(batch, batched)
    cap = static["site_caps"][2]
    rng = np.random.RandomState(1)
    xj, xt = _feats(rng, ((2,) if batched else ()) + (cap, 64), dtype)
    w = np.array(params["xyzc_net"]["conv2"][1]["w"])
    names = ("lnbr", "rnbr", "nbr9", "augl", "augr")
    ref = j_sc.subm_conv_xtri(xj, jnp.asarray(w),
                              *(jnp.asarray(g[f"x{n}2"]) for n in names))
    out = t_sc.subm_conv_xtri(xt, torch.from_numpy(w),
                              *(torch.from_numpy(g[f"x{n}2"]) for n in names))
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)
    # the packed conv is the plain submanifold conv, re-laid out
    plain = t_sc.subm_conv(xt, torch.from_numpy(w),
                           torch.from_numpy(g["nbr2"]))
    np.testing.assert_allclose(_np(out), _np(plain), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
def test_down_conv(scene, dtype, batched):
    batch, static, params, _ = scene
    g = _geom(batch, batched)
    cap = static["site_caps"][0]
    rng = np.random.RandomState(2)
    xj, xt = _feats(rng, ((2,) if batched else ()) + (cap, 16), dtype)
    w = np.array(params["xyzc_net"]["down0"][0]["w"])
    ref = j_sc.down_conv(xj, jnp.asarray(w), jnp.asarray(g["down0"]),
                         jnp.asarray(g["up0"]))
    out = t_sc.down_conv(xt, torch.from_numpy(w),
                         torch.from_numpy(g["down0"]),
                         torch.from_numpy(g["up0"]))
    assert out.shape == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_masked_batch_norm():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 40, 8).astype(np.float32) * 3 + 1
    mask = (rng.uniform(size=(2, 40)) > 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 2, 8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    y, (m, v) = j_sc.masked_batch_norm(*map(jnp.asarray,
                                            (x, mask, scale, bias)))
    ty, (tm, tv) = t_sc.masked_batch_norm(*map(torch.from_numpy,
                                               (x, mask, scale, bias)))
    for a, b in ((ty, y), (tm, m), (tv, v)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_init_keys_and_shapes(scene):
    """The port's init draws a tree of the JAX init's keys and shapes."""
    _, _, params, stats = scene
    p, s = t_lx.init(torch.Generator().manual_seed(0), num_train_frame=4,
                     nv=NV, device="cpu")
    flat_j, tree_j = jax.tree.flatten((params, stats))
    flat_t, tree_t = jax.tree.flatten(
        (p, s), is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert tree_j == tree_t
    assert [np.shape(x) for x in flat_j] == [tuple(t.shape) for t in flat_t]
    p2, _ = t_lx.init(torch.Generator().manual_seed(0), num_train_frame=4,
                      nv=NV, device="cpu")
    assert torch.equal(p["fc_0"]["w"], p2["fc_0"]["w"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_sites(scene, dtype):
    """Site features and BN batch statistics of the whole encoder."""
    batch, static, params, stats = scene
    jms = j_lx.ModelStatic(encoder=j_net.EncoderStatic(
        out_sh=static["out_sh"], site_caps=static["site_caps"],
        compute_dtype=dtype))
    tms = t_lx.ModelStatic(encoder=t_net.EncoderStatic(
        out_sh=static["out_sh"], site_caps=static["site_caps"],
        compute_dtype=dtype))
    jf, jstats = j_lx.encode_sparse_voxels(
        params, jax.tree.map(jnp.asarray, batch["geom"]), jms,
        densify=False)
    p, _ = params_from_jax(params, stats)
    tf, tstats = t_lx.encode_sparse_voxels(
        p, to_device(batch["geom"], "cpu"), tms, densify=False)
    assert len(tf) == 4
    for a, b in zip(tf, jf):
        assert a.dtype == torch.float32 and a.shape == b.shape
        a, b = _np(a), _np(b)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, **TOL)
        else:
            assert np.abs(a - b).max() <= 5e-2 * np.abs(b).max()
            assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    for name, layers in jstats.items():
        for jl, tl in zip(layers, tstats[name]):
            for k in ("mean", "var"):
                np.testing.assert_allclose(_np(tl[k]), _np(jl[k]),
                                           err_msg=f"{name} {k}", **tol)


def test_update_running_stats(scene):
    _, _, params, stats = scene
    rng = np.random.RandomState(4)
    new = jax.tree.map(
        lambda x: rng.randn(*np.shape(x)).astype(np.float32), stats)
    ref = j_net.update_running_stats(stats["xyzc_net"], new["xyzc_net"])
    _, s = params_from_jax(params, stats)
    _, n = params_from_jax(params, new)
    out = t_net.update_running_stats(s["xyzc_net"], n["xyzc_net"])
    for name, layers in ref.items():
        for jl, tl in zip(layers, out[name]):
            for k in jl:
                np.testing.assert_allclose(_np(tl[k]), _np(jl[k]), **TOL)
