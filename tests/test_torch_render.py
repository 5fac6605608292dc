"""Parity of the PyTorch port's forward render (eval_step on the
host-planned hat path) with the JAX package, on the CPU at a small size
(~500 vertices, 2 cm voxels, 64 rays x 8 samples), f32, with weights from
neuralbody_tpu's init through params_from_jax.

Tolerances: the interpolated features and the raw field at atol/rtol 1e-5
(sums in another order); the composited maps at 1e-4 relative (rgb, acc,
depth, disp), with an absolute floor of 1e-6 for the near-empty renders of
random weights.

Random weights render nearly empty rays (mean acc ~1e-3), so the
quantities behind the composite are compared too, and one case raises the
alpha_fc bias in both packages' weights alike so that the composite is
far from zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralbody_tpu.models import latent_xyzc as j_lx
from neuralbody_tpu.models import sparse_conv_net as j_net
from neuralbody_tpu.ops import hat_interp as j_hat
from neuralbody_tpu.renderer import renderer as j_rend
from neuralbody_tpu.train.step import eval_step as j_eval_step
from neuralbody_tpu.utils.synthetic import make_batch
from neuralbody_tpu_torch.models import latent_xyzc as t_lx
from neuralbody_tpu_torch.models import sparse_conv_net as t_net
from neuralbody_tpu_torch.ops import hat_interp as t_hat
from neuralbody_tpu_torch.renderer import renderer as t_rend
from neuralbody_tpu_torch.train.step import eval_step
from neuralbody_tpu_torch.utils.platform import to_device
from neuralbody_tpu_torch.utils.transplant import params_from_jax

torch.set_num_threads(1)

VOX = 0.02
NV = 500
N_RAYS = 64
N_SAMPLES = 8
TOL = dict(atol=1e-5, rtol=1e-5)
MAP_TOL = dict(atol=1e-6, rtol=1e-4)
HW = (32, 32)


@pytest.fixture(scope="module")
def weights():
    params, stats = j_lx.init(jax.random.PRNGKey(0), num_train_frame=4,
                              nv=NV)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


def _scene(batch_size=1, quantize_z=False, num_views=0):
    batch, static = make_batch(n_rays=N_RAYS, n_verts=NV, voxel_size=VOX,
                               seed=3, batch_size=batch_size)
    if num_views:
        rng = np.random.RandomState(5)
        K = np.array([[20.0, 0, HW[1] / 2], [0, 20.0, HW[0] / 2],
                      [0, 0, 1]], np.float32)
        RT = np.tile(np.eye(4, dtype=np.float32), (num_views, 1, 1))
        RT[:, 2, 3] = 4.0
        batch["Ks"] = np.tile(K, (batch_size, num_views, 1, 1))
        batch["RT"] = np.tile(RT, (batch_size, 1, 1, 1))
        batch["msks"] = (rng.uniform(size=(batch_size, num_views) + HW)
                         > 0.2).astype(np.float32)
    if batch_size > 1:
        # distinct frames: another pose and appearance code per element
        batch["Th"][1] += np.float32(0.01)
        batch["latent_index"][1] = 2
    plan = dict(group_size=32, quantize_z=quantize_z)
    args = (static["out_sh"], static["site_caps"], (VOX,) * 3, N_SAMPLES)
    if batch_size > 1:
        # static sizes that fit every element: the max of their own plans
        sizes = [j_hat.prepare_hat_batch(
            {k: (v[b:b + 1] if k != "geom" else
                 {n: t[b:b + 1] for n, t in v.items()})
             for k, v in batch.items()}, *args, **plan)[1]
            for b in range(batch_size)]
        plan.update(n_groups=max(s["n_groups"] for s in sizes),
                    **{k: tuple(int(c) for c in np.max(
                        [s[k] for s in sizes], axis=0))
                       for k in ("rows_caps", "seg_caps")})
    batch, hs = j_hat.prepare_hat_batch(batch, *args, **plan)
    return batch, static, hs


def _settings(static, hs, num_views=0):
    kw = dict(voxel_size=(VOX,) * 3, hull_views=num_views, img_hw=HW,
              hat_rows_caps=hs["rows_caps"])
    jm = j_lx.ModelStatic(encoder=j_net.EncoderStatic(
        out_sh=static["out_sh"], site_caps=static["site_caps"]))
    tm = t_lx.ModelStatic(encoder=t_net.EncoderStatic(
        out_sh=static["out_sh"], site_caps=static["site_caps"]))
    return j_rend.RenderSettings(model=jm, n_samples=N_SAMPLES,
                                 chunk_rays=N_RAYS, **kw), \
        t_rend.RenderSettings(model=tm, **kw)


def _compare_maps(ret, ref):
    assert set(ret) == set(ref) == {"rgb_map", "disp_map", "acc_map",
                                    "depth_map"}
    for k in ref:
        assert tuple(ret[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(ret[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **MAP_TOL)


@pytest.mark.parametrize("case", [
    dict(),
    dict(quantize_z=True),
    dict(batch_size=2),
    dict(num_views=2),
    dict(batch_size=2, quantize_z=True, num_views=2),
])
def test_eval_step_matches_jax(weights, case):
    batch, static, hs = _scene(**case)
    js, ts = _settings(static, hs, case.get("num_views", 0))
    ref = j_eval_step(weights[0], jax.tree.map(jnp.asarray, batch), js)
    p, _ = params_from_jax(*weights)
    ret = eval_step(p, batch, ts, device="cpu")
    _compare_maps(ret, ref)


def test_eval_step_raised_alpha_bias(weights):
    """Both packages' alpha_fc bias raised alike: the rays are no longer
    empty and the composite itself is held to the JAX render."""
    params, stats = weights
    params = dict(params, alpha_fc=dict(
        params["alpha_fc"], b=params["alpha_fc"]["b"] + np.float32(3.0)))
    batch, static, hs = _scene()
    js, ts = _settings(static, hs)
    ref = j_eval_step(params, jax.tree.map(jnp.asarray, batch), js)
    assert float(np.mean(ref["acc_map"])) > 0.3
    ret = eval_step(params_from_jax(params, stats)[0], batch, ts,
                    device="cpu")
    _compare_maps(ret, ref)


def test_pre_expanded_rows_match(weights):
    """precompute_hat_device's pre-expanded rows and sorted points render
    what the compact segments render, in the port as in JAX."""
    batch, static, hs = _scene(batch_size=2, quantize_z=True)
    js, ts = _settings(static, hs)
    p, _ = params_from_jax(*weights)
    tb = to_device(batch, "cpu")
    pre = t_rend.precompute_hat_device(tb, hs["rows_caps"],
                                       static["site_caps"], N_SAMPLES)
    assert "hat_seg_a1" not in pre and pre["hat_wpts"].shape[-1] == 3
    jpre = j_rend.precompute_hat_device(
        jax.tree.map(jnp.asarray, batch), hs["rows_caps"],
        static["site_caps"], N_SAMPLES)
    for l in (1, 2, 3, 4):
        np.testing.assert_array_equal(pre[f"hat_rows{l}"].numpy(),
                                      np.asarray(jpre[f"hat_rows{l}"]))
    np.testing.assert_allclose(pre["hat_wpts"].numpy(),
                               np.asarray(jpre["hat_wpts"]), **TOL)
    seg = eval_step(p, tb, ts, device="cpu")
    ret = eval_step(p, pre, ts._replace(hat_rows_caps=()), device="cpu")
    for k in seg:
        np.testing.assert_allclose(ret[k].numpy(), seg[k].numpy(), **TOL)


def test_features_and_raw_match(weights):
    """The [ngrp, P, 352] interpolated features and the raw field before
    compositing, against the JAX functions on the same inputs."""
    params, stats = weights
    batch, static, hs = _scene(quantize_z=True)
    js, ts = _settings(static, hs)
    jb = jax.tree.map(jnp.asarray, batch)
    jfeats, _ = j_lx.encode_sparse_voxels(params, jb["geom"], js.model,
                                          densify=False)
    geom0 = {k: v[0] for k, v in jb["geom"].items()}
    rows = {l: j_hat.expand_segments(
        jb[f"hat_seg_a{l}"][0].astype(jnp.int32),
        jb[f"hat_seg_cum{l}"][0].astype(jnp.int32),
        hs["rows_caps"][l - 1], static["site_caps"][l]) for l in (1, 2, 3, 4)}
    wpts, vdir = map(jnp.asarray, j_hat.sorted_pts_np(batch, 0, N_SAMPLES))
    frame = {"R": jb["R"][0], "Th": jb["Th"][0], "bounds": jb["bounds"][0],
             "latent_index": jb["latent_index"][0]}
    dhw = j_lx.get_dhw_vox(j_lx.pts_to_can_pts(wpts, frame["R"], frame["Th"]),
                           frame["bounds"], (VOX,) * 3)
    jfeat = j_hat.hat_interpolate([x[0] for x in jfeats], geom0, rows, dhw,
                                  js.model)
    jraw = j_lx.decode_raw(params, jfeat, wpts, vdir, frame, js.model)

    p, _ = params_from_jax(params, stats)
    tb = to_device(batch, "cpu")
    tfeats, _ = t_lx.encode_sparse_voxels(p, tb["geom"], ts.model,
                                          densify=False)
    tgeom0 = {k: v[0] for k, v in tb["geom"].items()}
    trows = {l: t_hat.expand_segments(
        tb[f"hat_seg_a{l}"][0], tb[f"hat_seg_cum{l}"][0],
        hs["rows_caps"][l - 1], static["site_caps"][l]) for l in (1, 2, 3, 4)}
    tframe = {"R": tb["R"][0], "Th": tb["Th"][0], "bounds": tb["bounds"][0],
              "latent_index": tb["latent_index"][0]}
    z = t_hat.decode_z(tb["z_frac"][0], tb["near"][0], tb["far"][0])
    srt = tb["hat_sort"][0].long()
    twpts, tvdir = t_rend._sorted_pts_dirs(
        {"ray_o": tb["ray_o"][0], "ray_d": tb["ray_d"][0]}, z, srt,
        trows[1].shape[0], N_SAMPLES)
    np.testing.assert_array_equal(twpts.numpy(), np.asarray(wpts))
    tdhw = t_lx.get_dhw_vox(t_lx.pts_to_can_pts(twpts, tframe["R"],
                                                tframe["Th"]),
                            tframe["bounds"], (VOX,) * 3)
    tfeat = t_hat.hat_interpolate([x[0] for x in tfeats], tgeom0, trows,
                                  tdhw, ts.model)
    assert tuple(tfeat.shape) == jfeat.shape and jfeat.shape[-1] == 352
    assert float(jnp.abs(jfeat).max()) > 0
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), **TOL)
    traw = t_lx.decode_raw(p, tfeat, twpts, tvdir, tframe, ts.model)
    np.testing.assert_allclose(traw.numpy(), np.asarray(jraw), **TOL)
