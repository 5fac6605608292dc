"""The gather-fused sparse conv of the PyTorch port (ops/conv_kernel.py) on
the CPU, where the wrapper takes the plain version: against the JAX
package's three convs (forward and jax.vjp) and against the TPU probes' own
formulation of the same function, at a small size (~500 vertices, 2 cm
voxels; reduced S for the probes' shapes). Inputs come from numpy seeds and
go to both packages. The kernel itself is held against the plain version on
the card (tests/test_torch_conv_kernel_cuda.py).

Tolerances:
  * f32: rtol 1e-4 / atol 1e-5 (tests/test_custom_vjp_conv.py's): sums in
    another order.
  * bf16 storage, forward: the operands are bf16 in both packages and the
    products exact in f32, so 1e-5 of the output's scale.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralbody_tpu.ops import sparse_conv as j_sc
from neuralbody_tpu.utils.synthetic import make_batch
from neuralbody_tpu_torch.ops import conv_kernel
from neuralbody_tpu_torch.ops import sparse_conv as t_sc

torch.set_num_threads(1)

VOX = 0.02
NV = 500
CONV_TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def geom():
    batch, _ = make_batch(n_rays=16, n_verts=NV, voxel_size=VOX, seed=3,
                          batch_size=2)
    return batch["geom"]


def _case(kind, geom, batched, rng):
    g = geom if batched else {k: v[0] for k, v in geom.items()}
    lead = (2,) if batched else ()
    if kind == "subm":
        lvl, cin, cout = 1, 32, 16
        tabs = (g["nbr1"],)
    elif kind == "xtri":
        lvl, cin, cout = 2, 16, 32
        tabs = tuple(g[f"x{n}2"] for n in
                     ("lnbr", "rnbr", "nbr9", "augl", "augr"))
    else:
        lvl, cin, cout = 0, 16, 32
        tabs = (g["down0"], g["up0"])
    cap_in = g[f"sites{lvl}"].shape[-2]
    cap_out = g["down0"].shape[-1] if kind == "down" else cap_in
    x = rng.randn(*lead, cap_in, cin).astype(np.float32)
    w = (rng.randn(27, cin, cout) * 0.1).astype(np.float32)
    gy = (rng.randn(*lead, cap_out, cout) * 0.1).astype(np.float32)
    return x, w, gy, tabs


_J_CONV = {"subm": j_sc.subm_conv, "xtri": j_sc.subm_conv_xtri,
           "down": j_sc.down_conv}


def _plain(kind, x, w, tabs):
    """The conv as (T, idx, W) of sparse_conv_plain: what the port's
    Functions hand the wrapper."""
    if kind == "xtri":
        lnbr, rnbr, nbr9, augl, augr = tabs
        return conv_kernel.sparse_conv_plain(
            t_sc.xtri_table(x, lnbr, rnbr, augl, augr), nbr9,
            w.reshape(9, 3 * w.shape[1], w.shape[2]))
    return conv_kernel.sparse_conv_plain(x, tabs[0], w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("kind", ["subm", "xtri", "down"])
def test_plain_matches_jax_conv(geom, kind, batched, dtype):
    x, w, gy, tabs = _case(kind, geom, batched,
                           np.random.RandomState(len(kind)))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jtabs = tuple(map(jnp.asarray, tabs))
    jy, vjp = jax.vjp(lambda a, b: _J_CONV[kind](a, b, *jtabs),
                      jnp.asarray(x).astype(jd), jnp.asarray(w))
    ttabs = tuple(map(torch.from_numpy, tabs))
    tx = torch.from_numpy(x).to(td).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = _plain(kind, tx, tw, ttabs)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == jy.shape
    if dtype == "bfloat16":
        assert np.abs(_np(ty) - _np(jy)).max() <= 1e-5 * np.abs(_np(jy)).max()
        return
    np.testing.assert_allclose(_np(ty), _np(jy), **CONV_TOL)
    jdx, jdw = vjp(jnp.asarray(gy))
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(gy))
    np.testing.assert_allclose(_np(tdx), _np(jdx), **CONV_TOL)
    np.testing.assert_allclose(_np(tdw), _np(jdw), **CONV_TOL)


def _probe():
    """tools/probes/pallas_gather.py, loaded by path (tools/ is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_gather",
        os.path.join(ROOT, "tools", "probes", "pallas_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the probes' (S, C, Cout) per encoder level, S reduced
@pytest.mark.parametrize("shape", [(256, 16, 16), (512, 32, 32),
                                   (256, 64, 64), (128, 128, 128)])
def test_plain_matches_the_probes_formulation(monkeypatch, shape):
    """table[nbr].reshape(S, 27 C) @ w.reshape(27 C, Cout) with a site-major
    nbr [S, 27] into a [S + 1, C] table (pallas_gather.xla_conv, which the
    probe holds its Pallas kernel against) is sparse_conv_plain of the
    tap-major table."""
    S, C, cout = shape
    probe = _probe()
    for k, v in (("S", S), ("C", C), ("COUT", cout)):
        monkeypatch.setattr(probe, k, v)
    rng = np.random.RandomState(S)
    table = rng.randn(S + 1, C).astype(np.float32)
    nbr = rng.randint(0, S + 1, (S, 27)).astype(np.int32)
    w = (rng.randn(27, C, cout) * 0.1).astype(np.float32)
    ref = probe.xla_conv(jnp.asarray(table), jnp.asarray(nbr), jnp.asarray(w))
    out = conv_kernel.sparse_conv_plain(
        torch.from_numpy(table), torch.from_numpy(nbr.T.copy()),
        torch.from_numpy(w))
    np.testing.assert_allclose(_np(out), _np(ref), **CONV_TOL)
    # the same with the last table row as the implicit zero row
    table[S] = 0
    ref = probe.xla_conv(jnp.asarray(table), jnp.asarray(nbr), jnp.asarray(w))
    out = conv_kernel.sparse_conv_plain(
        torch.from_numpy(table[:S].copy()), torch.from_numpy(nbr.T.copy()),
        torch.from_numpy(w))
    np.testing.assert_allclose(_np(out), _np(ref), **CONV_TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_packed_conv_equals_the_27_tap_conv(geom, batched):
    """The w-triple packed (T, idx, W) computes the 27-tap conv."""
    g = geom if batched else {k: v[0] for k, v in geom.items()}
    g = {k: torch.from_numpy(np.asarray(v)) for k, v in g.items()}
    rng = np.random.RandomState(7)
    lead = (2,) if batched else ()
    cap = g["sites1"].shape[-2]
    x = torch.from_numpy(rng.randn(*lead, cap, 16).astype(np.float32))
    x = x * t_sc.site_mask(g["nsite1"], cap)[..., None]
    w = torch.from_numpy((rng.randn(27, 16, 32) * 0.1).astype(np.float32))
    tabs = tuple(g[f"x{n}1"] for n in ("lnbr", "rnbr", "nbr9", "augl", "augr"))
    a = _plain("xtri", x, w, tabs)
    b = _plain("subm", x, w, (g["nbr1"],))
    mask = t_sc.site_mask(g["nsite1"], cap)[..., None]
    np.testing.assert_allclose(_np(a * mask), _np(b * mask), atol=1e-5,
                               rtol=1e-5)


def test_gather_rows_batched_equals_per_element():
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(3, 20, 8).astype(np.float32))
    table = torch.from_numpy(rng.randint(0, 21, (3, 27, 15)).astype(np.int32))
    out = conv_kernel.gather_rows(feats, table)
    assert tuple(out.shape) == (3, 27, 15, 8)
    for b in range(3):
        one = conv_kernel.gather_rows(feats[b], table[b])
        assert torch.equal(out[b], one)
        fpad = np.concatenate([feats[b].numpy(), np.zeros((1, 8), np.float32)])
        np.testing.assert_array_equal(one.numpy(), fpad[table[b].numpy()])


def test_index_past_the_rows_reads_zeros():
    """Index n_rows is the tables' zero row; any larger index reads zeros
    too, and no row of T is touched for it."""
    rng = np.random.RandomState(1)
    T = torch.from_numpy(rng.randn(10, 16).astype(np.float32))
    W = torch.from_numpy(rng.randn(27, 16, 16).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 10, (27, 12)).astype(np.int32))
    far = idx.clone()
    far[::2] = 10
    way = idx.clone()
    way[::2] = 2 ** 30
    a = conv_kernel.sparse_conv(T, far, W)
    b = conv_kernel.sparse_conv(T, way, W)
    assert torch.equal(a, b)
    ref = torch.einsum("kse,ked->sd", T[idx[1::2].long()], W[1::2])
    np.testing.assert_allclose(a.numpy(), ref.numpy(), **CONV_TOL)


def test_wrapper_on_the_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on neither the CPU nor the card is refused, not computed somewhere
    else."""
    rng = np.random.RandomState(2)
    T = torch.from_numpy(rng.randn(2, 30, 32).astype(np.float32)).bfloat16()
    idx = torch.from_numpy(rng.randint(0, 31, (2, 9, 25)).astype(np.int32))
    W = torch.from_numpy(rng.randn(9, 32, 16).astype(np.float32))
    before = conv_kernel.CONV_LAUNCHES
    out = conv_kernel.sparse_conv(T, idx, W)
    assert conv_kernel.CONV_LAUNCHES == before
    assert torch.equal(out, conv_kernel.sparse_conv_plain(T, idx, W))
    # bf16 storage: W is rounded to bf16, the sum is f32
    ref = torch.einsum("bkse,ked->bsd",
                       conv_kernel.gather_rows(T, idx).double(),
                       W.bfloat16().double())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="no sparse-conv kernel"):
        conv_kernel.sparse_conv(T.to("meta"), idx.to("meta"), W.to("meta"))
