"""The T-pose variant of the port (ops/blend.py, models/tpose_xyzc.py,
renderer/tpose_renderer.py) against the JAX package's on the same inputs
and weights (utils/transplant.params_from_jax), on the CPU, over
tests/test_tpose.py's scene (300 template vertices in 4 cm T-pose voxels,
an identity warp onto an 8 x 12 x 8 posed grid, 64 rays x 8 samples).

Tolerances: blend, encode_tpose_voxels, warp_volumes, sample_warped and
decode at 1e-5 of the output's scale (f32, the same operations in another
library); the whole render at 1e-4 relative; its parameter gradients
against jax.vjp at 1e-3 L2 of each leaf's norm (the encoder's BatchNorm
backward divides by small batch variances, which magnifies rounding).
Only perturb = 0 is held against JAX: the port draws from a
torch.Generator, not a PRNG key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralbody_tpu.models import tpose_xyzc as j_tx
from neuralbody_tpu.ops import blend as j_blend
from neuralbody_tpu.renderer.tpose_renderer import render_tpose_rays as \
    j_render
from neuralbody_tpu.utils import smpl as j_smpl
from neuralbody_tpu_torch.models import sparse_conv_net as t_scn
from neuralbody_tpu_torch.models import tpose_xyzc as t_tx
from neuralbody_tpu_torch.ops import blend as t_blend
from neuralbody_tpu_torch.renderer import dispatch
from neuralbody_tpu_torch.renderer.tpose_renderer import (
    TposeRenderSettings, render_tpose_rays, tpose_grid_coords)
from neuralbody_tpu_torch.utils.platform import to_device
from neuralbody_tpu_torch.utils.transplant import params_from_jax
from test_tpose import _tpose_scene

torch.set_num_threads(1)


def close_to_scale(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= tol * scale, (np.abs(a - b).max(), scale)


# ---------------------------------------------------------------------------
# blend
# ---------------------------------------------------------------------------

def test_border_grid_sample_blend_weights(rng):
    bw = rng.rand(5, 6, 7, 4).astype(np.float32)
    bounds = np.array([[-1.0, -1, -1], [1, 1, 1]], np.float32)
    pts = rng.uniform(-1.5, 1.5, (40, 3)).astype(np.float32)
    ours = t_blend.bounds_grid_sample_blend_weights(
        torch.from_numpy(pts), torch.from_numpy(bw),
        torch.from_numpy(bounds))
    theirs = j_blend.bounds_grid_sample_blend_weights(
        jnp.asarray(pts), jnp.asarray(bw), jnp.asarray(bounds))
    close_to_scale(ours.numpy(), theirs, 1e-5)


def _skinning(rng, n_pts=60):
    """A synthetic model's skinning matrices and the JAX test's sharpened
    weights (tests/test_tpose.py:64: near one-hot, so the blended 3x3
    blocks stay far from singular)."""
    model = j_smpl.make_synthetic_model(n_verts=80, n_joints=5, seed=4)
    poses = (rng.randn(5, 3) * 0.2).astype(np.float32)
    joints = model["J_regressor"] @ model["v_template"]
    _, A = j_smpl.rigid_transform(j_smpl.rodrigues(jnp.asarray(poses)),
                                  jnp.asarray(joints), model["parents"])
    w = rng.rand(n_pts, 5).astype(np.float32) ** 8
    return np.array(A), (w / w.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("fn", ["ppts_to_pts", "pts_to_ppts"])
def test_pose_space_transforms(rng, fn):
    A, bw = _skinning(rng)
    pts = rng.randn(len(bw), 3).astype(np.float32)
    ours = getattr(t_blend, fn)(torch.from_numpy(pts), torch.from_numpy(bw),
                                torch.from_numpy(A))
    theirs = getattr(j_blend, fn)(jnp.asarray(pts), jnp.asarray(bw),
                                  jnp.asarray(A))
    close_to_scale(ours.numpy(), theirs, 1e-5)


def test_round_trip_is_the_identity(rng):
    A, bw = _skinning(rng)
    pts = torch.from_numpy(rng.randn(len(bw), 3).astype(np.float32))
    A, bw = torch.from_numpy(A), torch.from_numpy(bw)
    back = t_blend.pts_to_ppts(t_blend.ppts_to_pts(pts, bw, A), bw, A)
    np.testing.assert_allclose(back.numpy(), pts.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# the model's functions and the render, on tests/test_tpose.py's scene
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """(JAX batch, JAX settings, port batch, port settings, JAX params and
    bn, port params) with alpha_fc's bias raised as the JAX test does."""
    jbatch, jst = _tpose_scene(np.random.RandomState(20240817))
    jp, jbn = j_tx.init(jax.random.PRNGKey(0), num_train_frame=2, nv=300)
    jp["alpha_fc"]["b"] = jp["alpha_fc"]["b"] + 0.3
    tst = TposeRenderSettings(
        model=t_tx.TposeStatic(
            encoder=t_scn.EncoderStatic(out_sh=jst.model.encoder.out_sh,
                                        site_caps=jst.model.encoder.site_caps),
            ptot_shape=jst.model.ptot_shape),
        voxel_size=jst.voxel_size, ptot_vsize=jst.ptot_vsize,
        n_samples=jst.n_samples, chunk_rays=jst.chunk_rays)
    tbatch = to_device(jax.tree.map(np.asarray, jbatch), "cpu")
    tp, _ = params_from_jax(jax.tree.map(np.asarray, jp),
                            jax.tree.map(np.asarray, jbn))
    return jbatch, jst, tbatch, tst, jp, tp


def test_init_has_the_jax_leaves():
    jp, jbn = j_tx.init(jax.random.PRNGKey(0), num_train_frame=3, nv=50)
    tp, tbn = t_tx.init(torch.Generator().manual_seed(0), num_train_frame=3,
                        nv=50, device="cpu")
    for (jk, jv), (tk, tv) in zip(
            jax.tree_util.tree_flatten_with_path((jp, jbn))[0],
            jax.tree_util.tree_flatten_with_path((tp, tbn))[0]):
        assert jax.tree_util.keystr(jk) == jax.tree_util.keystr(tk)
        assert tuple(jv.shape) == tuple(tv.shape), jk
        assert tv.dtype == torch.float32


def test_encoder_and_both_samples(scene):
    jbatch, jst, tbatch, tst, jp, tp = scene
    jvols, jstats = jax.jit(lambda p, g: j_tx.encode_tpose_voxels(
        p, g, jst.model))(jp, jbatch["geom"])
    tvols, tstats = t_tx.encode_tpose_voxels(tp, tbatch["geom"], tst.model)
    for a, b in zip(tvols, jvols):
        assert tuple(a.shape) == tuple(b.shape)
        close_to_scale(a.numpy(), b, 1e-5)
    for name in jstats:
        for a, b in zip(tstats[name], jstats[name]):
            close_to_scale(a["mean"].numpy(), b["mean"], 1e-5)

    from neuralbody_tpu.renderer.tpose_renderer import tpose_grid_coords \
        as j_tgc
    jtgc = j_tgc(jbatch["ptot_pts"][0], jbatch["tbounds"][0],
                 jst.voxel_size, jst.model.encoder.out_sh)
    ttgc = tpose_grid_coords(tbatch["ptot_pts"][0], tbatch["tbounds"][0],
                             tst.voxel_size, tst.model.encoder.out_sh)
    close_to_scale(ttgc.numpy(), jtgc, 1e-6)
    jw = j_tx.warp_volumes([v[0] for v in jvols], jtgc, jst.model.ptot_shape)
    tw = t_tx.warp_volumes([torch.from_numpy(np.asarray(v[0]))
                            for v in jvols], torch.from_numpy(
                                np.asarray(jtgc)), tst.model.ptot_shape)
    for a, b in zip(tw, jw):
        close_to_scale(a.numpy(), b, 1e-5)
    pgc = np.random.RandomState(1).uniform(-1.1, 1.1, (200, 3)).astype(
        np.float32)
    close_to_scale(
        t_tx.sample_warped([torch.from_numpy(np.asarray(w)) for w in jw],
                           torch.from_numpy(pgc)).numpy(),
        j_tx.sample_warped(jw, jnp.asarray(pgc)), 1e-5)


def test_decode(scene, rng):
    _, jst, _, tst, jp, tp = scene
    feat = rng.randn(100, 352).astype(np.float32)
    wpts = rng.randn(100, 3).astype(np.float32)
    vdir = rng.randn(100, 3).astype(np.float32)
    close_to_scale(
        t_tx.decode(tp, torch.from_numpy(feat), torch.from_numpy(wpts),
                    torch.from_numpy(vdir), torch.tensor(1, dtype=torch.int32),
                    tst.model).numpy(),
        j_tx.decode(jp, jnp.asarray(feat), jnp.asarray(wpts),
                    jnp.asarray(vdir), jnp.int32(1), jst.model), 1e-5)


def test_render_matches_jax(scene):
    jbatch, jst, tbatch, tst, jp, tp = scene
    jret, _ = jax.jit(lambda p: j_render(p, jbatch, jst))(jp)
    with torch.no_grad():
        tret, _ = dispatch.get_render_fn(tst)(tp, tbatch, tst)
    assert sorted(tret) == sorted(jret)
    for k in jret:
        np.testing.assert_allclose(tret[k].numpy(), np.asarray(jret[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(tret["acc_map"].max()) > 0.1   # the rays hit something


def test_render_gradients_match_jax_vjp(scene, rng):
    jbatch, jst, tbatch, tst, jp, tp = scene
    cot = rng.randn(*jbatch["ray_o"].shape[:2], 3).astype(np.float32)
    @jax.jit
    def grads(p, cot):
        _, vjp = jax.vjp(lambda q: j_render(q, jbatch, jst)[0]["rgb_map"], p)
        return vjp(cot)[0]
    jg = jax.tree_util.tree_flatten_with_path(grads(jp, jnp.asarray(cot)))[0]

    leaves = [v for _, v in jax.tree_util.tree_flatten_with_path(tp)[0]]
    for p in leaves:
        p.requires_grad_(True)
    ret, _ = render_tpose_rays(tp, tbatch, tst)
    tg = torch.autograd.grad((ret["rgb_map"] * torch.from_numpy(cot)).sum(),
                             leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    checked = 0
    for (path, j), t in zip(jg, tg):
        j = np.asarray(j, np.float64)
        t = np.zeros_like(j) if t is None else t.double().numpy()
        norm = np.linalg.norm(j)
        if norm == 0:
            assert np.linalg.norm(t) == 0, path
            continue
        assert np.linalg.norm(t - j) <= 1e-3 * norm, (
            jax.tree_util.keystr(path), np.linalg.norm(t - j) / norm)
        checked += 1
    assert checked >= 40   # the encoder's, the decoder's and the codes'


def test_render_raises_on_a_ray_count_off_the_chunk(scene):
    _, _, tbatch, tst, _, tp = scene
    with pytest.raises(ValueError, match="multiple"):
        render_tpose_rays(tp, tbatch, tst._replace(chunk_rays=48))


def test_chunks_render_as_one(scene):
    _, _, tbatch, tst, _, tp = scene
    with torch.no_grad():
        one, _ = render_tpose_rays(tp, tbatch, tst)
        four, _ = render_tpose_rays(tp, tbatch, tst._replace(chunk_rays=16))
    for k in one:
        np.testing.assert_allclose(four[k].numpy(), one[k].numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_no_density_grid_for_tpose(scene):
    """As in the JAX package: mesh extraction has no T-pose path."""
    with pytest.raises(TypeError):
        dispatch.get_density_grid_fn(scene[3])
    assert dispatch.get_render_fn(scene[3]) is render_tpose_rays
