"""The port's NeRF baseline family against the JAX package on the CPU:
ops/sample_pdf, models/nerf, renderer/volume_renderer, renderer/dispatch and
the NeRF steps of train/step, on the same inputs (numpy seeds; the JAX
weights go through utils/transplant.params_from_jax).

On the CPU every dense layer of the port runs ops/dense_kernel's plain
version (tests/test_torch_dense_kernel.py holds that against the JAX
product and the TPU kernel it replaces).

Tolerances (all f32; the family has no bf16 mode and no BatchNorm):
  * sample_pdf at given CDF values: 1e-5 absolute on depths of 1 to 5. A
    sample is bins_b + (u - cdf_b) / p_bin * width: one f32 ulp of the cdf
    (6e-8) over a bin probability of 1e-2 times a width of 0.3 is 2e-6
    (measured 4.3e-6);
  * the MLPs: rtol 1e-5, atol 1e-6 (sums in another order, 12 layers);
  * every map of a render: rtol 1e-4, atol 1e-6, as the latent_xyzc renders
    are held (tests/test_torch_render.py); disp maps, which divide by the
    accumulated weight, at rtol 1e-3;
  * the loss and each gradient leaf: 1e-4 of the leaf's scale;
  * after one Adam step, and after three, the parameters agree within
    0.1 lr per step (measured 0.027 and 0.039): Adam's first update is
    lr g / (|g| + 1e-8), so a gradient entry near 1e-7 turns a difference of
    1e-9 into a percent of an lr-sized update; the losses of all three steps
    agree at rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralbody_tpu.models import nerf as j_nerf
from neuralbody_tpu.ops.sample_pdf import sample_pdf as j_sample_pdf
from neuralbody_tpu.renderer import dispatch as j_dispatch
from neuralbody_tpu.renderer import volume_renderer as j_vr
from neuralbody_tpu.train import step as j_step
from neuralbody_tpu_torch.models import latent_xyzc as t_lx
from neuralbody_tpu_torch.models import nerf as t_nerf
from neuralbody_tpu_torch.models import sparse_conv_net as t_net
from neuralbody_tpu_torch.ops import sample_pdf as t_pdf
from neuralbody_tpu_torch.renderer import dispatch as t_dispatch
from neuralbody_tpu_torch.renderer import renderer as t_rend
from neuralbody_tpu_torch.renderer import volume_renderer as t_vr
from neuralbody_tpu_torch.train import optimizer as t_opt
from neuralbody_tpu_torch.train import step as t_step
from neuralbody_tpu_torch.utils.platform import to_device
from neuralbody_tpu_torch.utils.synthetic import make_batch
from neuralbody_tpu_torch.utils.transplant import params_from_jax

torch.set_num_threads(1)

LR = 5e-4
MAP_TOL = dict(rtol=1e-4, atol=1e-6)
PDF_ATOL = 1e-5
GRAD_TOL = 1e-4
NARROW = dict(depth=4, width=32, skips=(2,))
MAPS = ("rgb_map", "disp_map", "acc_map", "depth_map")
COARSE_MAPS = ("rgb0", "disp0", "acc0", "z_std")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _flat(tree):
    """(path, leaf) pairs in jax.tree's order, for trees of either
    package."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree)
                for p, x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}", x) for i, v in enumerate(tree)
                for p, x in _flat(v)]
    return [("", tree)]


def _weights(st_kw, fine=True, seed=0):
    """The JAX package's own init, as numpy, and its transplant."""
    st = j_nerf.NerfStatic(**st_kw)
    params, stats = j_nerf.init(jax.random.PRNGKey(seed), st,
                                st if fine else None)
    params = jax.tree.map(np.asarray, params)
    return params, params_from_jax(params, stats)[0]


def _rays(n_rays, batch_size=1, seed=0):
    """A batch of rays through a unit-scale scene, with target colours."""
    rng = np.random.RandomState(seed)
    d = rng.randn(batch_size, n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d *= rng.uniform(0.5, 1.5, (batch_size, n_rays, 1)).astype(np.float32)
    mask = np.ones((batch_size, n_rays), np.float32)
    mask[:, -3:] = 0.0
    return {
        "ray_o": rng.uniform(-1, 1, (batch_size, n_rays, 3)).astype(
            np.float32),
        "ray_d": d,
        "near": rng.uniform(0.5, 1.0, (batch_size, n_rays)).astype(
            np.float32),
        "far": rng.uniform(2.0, 3.0, (batch_size, n_rays)).astype(
            np.float32),
        "rgb": rng.uniform(0, 1, (batch_size, n_rays, 3)).astype(np.float32),
        "ray_mask": mask,
    }


def _settings(st_kw, **kw):
    js = j_vr.NerfRenderSettings(
        model=j_nerf.NerfStatic(**st_kw),
        model_fine=j_nerf.NerfStatic(**st_kw), **kw)
    ts = t_vr.NerfRenderSettings(
        model=t_nerf.NerfStatic(**st_kw),
        model_fine=t_nerf.NerfStatic(**st_kw), **kw)
    return js, ts


# -- ops/sample_pdf -----------------------------------------------------------

def _pdf_inputs(seed=0, R=40, B=15):
    rng = np.random.RandomState(seed)
    bins = np.sort(rng.uniform(1.0, 5.0, (R, B)).astype(np.float32), axis=-1)
    weights = rng.uniform(0, 1, (R, B - 1)).astype(np.float32)
    weights[rng.uniform(size=weights.shape) < 0.3] = 0.0   # empty bins
    weights[:3] = 0.0                                       # empty rays
    # An empty last bin makes the sample at u = 1 jump by a bin's width with
    # the last bit of cdf[-1] (>= 1 or not), which the two packages' cumsums
    # need not share; a bin the render weighs is not empty.
    weights[3:, -1] = np.maximum(weights[3:, -1], 0.1)
    return bins, weights


def test_sample_pdf_det_matches_jax():
    bins, weights = _pdf_inputs()
    ref = j_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 24, det=True)
    out = t_pdf.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights),
                           24, det=True)
    np.testing.assert_allclose(_np(out), _np(ref), atol=PDF_ATOL, rtol=0)


def test_sample_pdf_matches_jax_on_its_uniforms():
    bins, weights = _pdf_inputs(1)
    key = jax.random.PRNGKey(5)
    ref = j_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 24, key=key,
                       det=False)
    u = np.array(jax.random.uniform(key, (bins.shape[0], 24),
                                    dtype=jnp.float32))
    out = t_pdf.sample_pdf_at(torch.from_numpy(bins),
                              torch.from_numpy(weights), torch.from_numpy(u))
    np.testing.assert_allclose(_np(out), _np(ref), atol=PDF_ATOL, rtol=0)


def test_sample_pdf_random_draw_in_range_and_seeded():
    bins, weights = map(torch.from_numpy, _pdf_inputs(2))
    draw = [t_pdf.sample_pdf(bins, weights, 16,
                             generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    assert (draw[0] >= bins[:, :1]).all() and (draw[0] <= bins[:, -1:]).all()
    with pytest.raises(ValueError):
        t_pdf.sample_pdf(bins, weights, 16)


# -- models/nerf --------------------------------------------------------------

@pytest.mark.parametrize("st_kw", [{}, NARROW], ids=["D8W256", "narrow"])
def test_mlp_matches_jax(st_kw):
    jparams, tparams = _weights(st_kw, fine=False)
    rng = np.random.RandomState(3)
    pts = rng.uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
    dirs = rng.randn(300, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jst, tst = j_nerf.NerfStatic(**st_kw), t_nerf.NerfStatic(**st_kw)
    raw = t_nerf.apply_mlp(tparams["coarse"], torch.from_numpy(pts),
                           torch.from_numpy(dirs), tst)
    ref = j_nerf.apply_mlp(jparams["coarse"], jnp.asarray(pts),
                           jnp.asarray(dirs), jst)
    assert raw.shape == (300, 4)
    np.testing.assert_allclose(_np(raw), _np(ref), rtol=1e-5, atol=1e-6)
    alpha = t_nerf.apply_density(tparams["coarse"], torch.from_numpy(pts),
                                 tst)
    ref = j_nerf.apply_density(jparams["coarse"], jnp.asarray(pts), jst)
    assert alpha.shape == (300,)
    np.testing.assert_allclose(_np(alpha), _np(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(alpha), _np(raw[:, 3]), rtol=1e-6,
                               atol=1e-7)


def test_init_has_the_jax_tree_and_is_seeded():
    st = t_nerf.NerfStatic()
    jparams, _ = _weights({})
    params, stats = t_nerf.init(torch.Generator().manual_seed(0), st, st,
                                device="cpu")
    assert stats == {}
    jl, tl = _flat(jparams), _flat(params)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, path
        # torch Linear's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        fan_in = (t.shape[0] if path.endswith("w/")
                  else dict(tl)[path[:-2] + "w/"].shape[0])
        assert t.abs().max() <= 1.0 / np.sqrt(fan_in)
    again, _ = t_nerf.init(torch.Generator().manual_seed(0), st, st,
                           device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_flat(again), tl))
    coarse, _ = t_nerf.init(torch.Generator().manual_seed(0), st,
                            device="cpu")
    assert set(coarse) == {"coarse"}
    with pytest.raises(RuntimeError, match="CUDA"):
        t_nerf.init(torch.Generator().manual_seed(0), st)


def test_params_from_jax_takes_the_nerf_tree():
    jparams, tparams = _weights(NARROW)
    assert set(tparams) == {"coarse", "fine"}
    assert isinstance(tparams["fine"]["pts_linears"], list)
    for (path, j), (_, t) in zip(_flat(jparams), _flat(tparams)):
        assert np.array_equal(t.numpy(), j), path
    assert params_from_jax(jparams, {})[1] == {}


# -- renderer/volume_renderer -------------------------------------------------

_RENDER_CASES = {
    "hierarchical": dict(),
    "coarse-only": dict(n_importance=0, fine=False),
    "shared-mlp": dict(fine=False),
    "four-chunks": dict(chunk_rays=8),
    "white-bkgd": dict(white_bkgd=True),
    "lindisp": dict(lindisp=True, chunk_rays=16),
    "batch-of-2": dict(batch_size=2, chunk_rays=16),
}


@pytest.mark.parametrize("case", _RENDER_CASES, ids=list(_RENDER_CASES))
def test_render_matches_jax(case):
    kw = {**dict(n_samples=8, n_importance=12, chunk_rays=32),
          **_RENDER_CASES[case]}
    fine, B = kw.pop("fine", True), kw.pop("batch_size", 1)
    jparams, tparams = _weights(NARROW, fine=fine)
    # raise the density: random weights alone leave the scene empty
    for p in (jparams, tparams):
        for mlp in p.values():
            mlp["alpha_linear"]["b"] = mlp["alpha_linear"]["b"] + 2.0
    js, ts = _settings(NARROW, **kw)
    batch = _rays(32, B, seed=4)
    ref = j_step.nerf_eval_step(jparams, jax.tree.map(jnp.asarray, batch), js)
    ret = t_step.nerf_eval_step(tparams, batch, ts, device="cpu")
    want = MAPS + (COARSE_MAPS if kw["n_importance"] > 0 else ())
    assert set(ret) == set(ref) == set(want)
    assert float(jnp.mean(ref["acc_map"])) > 0.3
    for k in want:
        assert ret[k].shape == ref[k].shape, k
        tol = dict(MAP_TOL, rtol=1e-3) if k.startswith("disp") else MAP_TOL
        np.testing.assert_allclose(_np(ret[k]), _np(ref[k]), err_msg=k, **tol)


def test_render_refuses_a_ragged_chunk():
    _, tparams = _weights(NARROW)
    _, ts = _settings(NARROW, n_samples=8, n_importance=4, chunk_rays=24)
    with pytest.raises(ValueError, match="multiple"):
        t_vr.render_nerf_rays(tparams, to_device(_rays(32), "cpu"), ts)


def test_train_render_is_seeded_and_perturbed():
    """One generator serves the perturbation and the importance draw: the
    same seed gives the same render, another seed or no generator another;
    the importance samples stay within the ray's depth range."""
    _, tparams = _weights(NARROW)
    _, ts = _settings(NARROW, n_samples=8, n_importance=12, chunk_rays=16,
                      raw_noise_std=1.0)
    batch = to_device(_rays(32, seed=5), "cpu")

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return t_vr.render_nerf_rays(tparams, batch, ts, train=True,
                                         generator=gen)[0]

    a, b, c = run(1), run(1), run(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["rgb_map"], c["rgb_map"])
    assert not torch.equal(a["z_std"], c["z_std"])
    assert (a["z_std"] > 0).all() and torch.isfinite(a["rgb_map"]).all()
    span = batch["far"] - batch["near"]
    assert (a["z_std"] <= span).all()
    # an evaluation render draws nothing
    with torch.no_grad():
        e = t_vr.render_nerf_rays(tparams, batch, ts)[0]
        f = t_vr.render_nerf_rays(tparams, batch, ts,
                                  generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(e[k], f[0][k]) for k in e)


def test_density_grid_matches_jax():
    jparams, tparams = _weights(NARROW)
    js, ts = _settings(NARROW)
    pts = np.random.RandomState(6).uniform(-1, 1, (2, 96, 3)).astype(
        np.float32)
    for pt_chunk in (32, 2048 * 64):
        ref = j_vr.render_nerf_density_grid(jparams, {"pts": jnp.asarray(pts)},
                                            js, pt_chunk=pt_chunk)
        out = t_vr.render_nerf_density_grid(
            tparams, {"pts": torch.from_numpy(pts)}, ts, pt_chunk=pt_chunk)
        assert out.shape == (2, 96)
        np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        t_vr.render_nerf_density_grid(tparams, {"pts": torch.from_numpy(pts)},
                                      ts, pt_chunk=36)


# -- renderer/dispatch and train/step -----------------------------------------

def test_dispatch():
    js, ts = _settings(NARROW)
    assert t_dispatch.get_render_fn(ts) is t_vr.render_nerf_rays
    assert t_dispatch.get_density_grid_fn(ts) is t_vr.render_nerf_density_grid
    assert j_dispatch.get_render_fn(js) is j_vr.render_nerf_rays
    lx = t_rend.RenderSettings(model=t_lx.ModelStatic(
        encoder=t_net.EncoderStatic(out_sh=(32, 32, 32),
                                    site_caps=(8, 8, 8, 8, 8))))
    assert t_dispatch.get_render_fn(lx) is t_rend.render_rays
    assert t_dispatch.get_density_grid_fn(lx) is t_rend.render_density_grid
    for fn in (t_dispatch.get_render_fn, t_dispatch.get_density_grid_fn):
        with pytest.raises(TypeError, match="dict"):
            fn({})


def test_latent_xyzc_steps_unchanged_through_dispatch():
    """eval_step and loss_fn of a latent_xyzc batch are render_rays and its
    masked MSE, as before the dispatch: no rgb0 term, the same numbers."""
    batch, static = make_batch(n_rays=32, n_verts=300, voxel_size=0.03,
                               seed=2)
    params, _ = t_lx.init(torch.Generator().manual_seed(0),
                          num_train_frame=1, nv=300, device="cpu")
    s = t_rend.RenderSettings(
        model=t_lx.ModelStatic(encoder=t_net.EncoderStatic(
            out_sh=static["out_sh"], site_caps=static["site_caps"])),
        voxel_size=(0.03,) * 3, n_samples=8, chunk_rays=32, perturb=False)
    tb = to_device(batch, "cpu")
    with torch.no_grad():
        direct, _ = t_rend.render_rays(params, tb, s)
        trained, _ = t_rend.render_rays(params, tb, s, train=True)
        loss, (ret, new_bn, stats) = t_step.loss_fn(params, tb, s)
    ret_e = t_step.eval_step(params, batch, s, device="cpu")
    assert all(torch.equal(ret_e[k], direct[k]) for k in direct)
    assert set(stats) == {"img_loss", "psnr"} and new_bn
    assert torch.equal(ret["rgb_map"], trained["rgb_map"])
    assert torch.equal(loss, t_step.masked_mse(
        trained["rgb_map"], tb["rgb"], tb["ray_mask"]))


_J_VG = jax.jit(jax.value_and_grad(j_step.nerf_loss_fn, has_aux=True),
                static_argnames=("settings",))


@pytest.mark.parametrize("fine", [True, False], ids=["fine", "coarse-only"])
def test_loss_and_grads_match_jax(fine):
    """The loss with its auxiliary coarse term, the stats and every
    gradient leaf (perturb off: nothing random in either package)."""
    jparams, tparams = _weights(NARROW, fine=fine)
    js, ts = _settings(NARROW, n_samples=8, n_importance=12 if fine else 0,
                       chunk_rays=16, perturb=False)
    batch = _rays(32, seed=7)
    (jloss, (_, jst)), jgrads = _J_VG(
        jparams, jax.tree.map(jnp.asarray, batch), js, jax.random.PRNGKey(0))
    tloss, (ret, new_bn, tst), tgrads = t_step.loss_and_grads(
        tparams, to_device(batch, "cpu"), ts)
    assert new_bn == {} and set(tst) == set(jst)
    assert ("img_loss0" in tst) == ("rgb0" in ret) == fine
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for k in jst:
        np.testing.assert_allclose(tst[k].item(), float(jst[k]), rtol=1e-5)
    if fine:
        np.testing.assert_allclose(
            tloss.item(), (tst["img_loss"] + tst["img_loss0"]).item(),
            rtol=1e-6)
    jl, tl = _flat(jgrads), _flat(tgrads)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        j, t = _np(j), _np(t)
        assert np.abs(j).max() > 0, path
        assert np.abs(t - j).max() <= GRAD_TOL * np.abs(j).max(), path


def test_train_step_matches_jax_with_optax():
    """nerf_train_step against the JAX step with optax's clip + Adam on the
    same batch: the stats of each of three steps, the parameters after the
    first and after the third."""
    jparams, tparams = _weights(NARROW)
    js, ts = _settings(NARROW, n_samples=8, n_importance=12, chunk_rays=32,
                       perturb=False)
    batch = _rays(32, seed=8)
    jb = jax.tree.map(jnp.asarray, batch)
    tx = optax.chain(optax.clip(40.0), optax.adam(LR))
    # the JAX step donates its params: keep the numpy originals apart
    jp = jax.tree.map(jnp.asarray, jparams)
    jopt = tx.init(jp)
    opt = t_opt.make_optimizer(tparams, t_opt.make_lr_schedule(
        LR, "multi_step"))
    losses = []
    for step in range(1, 4):
        jp, jopt, jst = j_step.nerf_train_step(
            jp, jopt, jb, jax.random.PRNGKey(0), js, tx)
        tst = t_step.nerf_train_step(tparams, opt, batch, ts, device="cpu")
        assert set(tst) == set(jst) == {"img_loss", "img_loss0", "psnr",
                                        "loss"}
        for k in jst:
            np.testing.assert_allclose(tst[k].item(), float(jst[k]),
                                       rtol=1e-4, err_msg=f"{k} step {step}")
        assert opt.count == step
        losses.append(tst["loss"].item())
        if step in (1, 3):
            diff = max(np.abs(_np(t) - _np(j)).max() for (_, j), (_, t)
                       in zip(_flat(jp), _flat(tparams)))
            assert diff <= 0.1 * LR * step, (step, diff)
    assert losses[-1] < losses[0]
    moved = max(np.abs(_np(t) - j).max() for (_, j), (_, t)
                in zip(_flat(jparams), _flat(tparams)))
    assert 2 * LR <= moved <= 3.5 * LR


def test_nerf_steps_default_to_the_card():
    """Without a card and without device="cpu" the entry points raise; they
    never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tparams = _weights(NARROW)
    _, ts = _settings(NARROW, n_samples=8, n_importance=4)
    opt = t_opt.make_optimizer(tparams, lambda t: LR)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_step.nerf_eval_step(tparams, _rays(32), ts)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_step.nerf_train_step(tparams, opt, _rays(32), ts)


# -- the MLPs through ops/dense_kernel.linear --------------------------------

@pytest.mark.parametrize("st_kw", [{}, NARROW], ids=["D8W256", "narrow"])
def test_mlp_layers_go_through_linear(st_kw, monkeypatch):
    """Every dense layer of an MLP application is one product with its bias
    in the epilogue, and the trunk's and the view branch's also with their
    ReLU: no separate bias or ReLU pass."""
    from neuralbody_tpu_torch.ops import dense_kernel as dk
    calls = []
    real = dk.mm

    def spy(A, B, bias=None, relu=False):
        calls.append((tuple(B.shape), bias is not None, relu))
        return real(A, B, bias, relu)

    monkeypatch.setattr(dk, "mm", spy)
    _, tparams = _weights(st_kw, fine=False)
    tst = t_nerf.NerfStatic(**st_kw)
    rng = np.random.RandomState(4)
    pts = torch.from_numpy(rng.uniform(-1, 1, (50, 3)).astype(np.float32))
    t_nerf.apply_mlp(tparams["coarse"], pts, pts, tst)
    W = tst.width
    assert len(calls) == tst.depth + 4 and all(c[1] for c in calls)
    assert [c[2] for c in calls] == [True] * tst.depth + [False, False, True,
                                                          False]
    assert [c[0] for c in calls[tst.depth:]] == [(W, 1), (W, W),
                                                 (W + 27, W // 2),
                                                 (W // 2, 3)]
    calls.clear()
    t_nerf.apply_density(tparams["coarse"], pts, tst)
    assert len(calls) == tst.depth + 1 and not calls[-1][2]


@pytest.mark.parametrize("st_kw", [{}, NARROW], ids=["D8W256", "narrow"])
def test_mlp_grads_match_jax(st_kw):
    """The gradient of every parameter leaf through linear's backward (the
    masked cotangent, dx, dW, db) against jax.grad of the JAX MLP."""
    jparams, tparams = _weights(st_kw, fine=False)
    jst, tst = j_nerf.NerfStatic(**st_kw), t_nerf.NerfStatic(**st_kw)
    rng = np.random.RandomState(5)
    pts = rng.uniform(-1.5, 1.5, (120, 3)).astype(np.float32)
    dirs = rng.randn(120, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cot = rng.randn(120, 4).astype(np.float32)

    def j_loss(p):
        return jnp.sum(j_nerf.apply_mlp(p, jnp.asarray(pts),
                                        jnp.asarray(dirs), jst)
                       * jnp.asarray(cot))

    ref = jax.grad(j_loss)(jparams["coarse"])
    leaves = [x for _, x in _flat(tparams["coarse"])]
    for x in leaves:
        x.requires_grad_()
    raw = t_nerf.apply_mlp(tparams["coarse"], torch.from_numpy(pts),
                           torch.from_numpy(dirs), tst)
    grads = torch.autograd.grad((raw * torch.from_numpy(cot)).sum(), leaves)
    for (path, j), g in zip(_flat(ref), grads):
        j = _np(j)
        assert np.abs(_np(g) - j).max() <= GRAD_TOL * np.abs(j).max(), path
