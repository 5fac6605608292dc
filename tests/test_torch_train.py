"""Parity of the PyTorch port's training step with the JAX package, on the
CPU at a small size (~500 vertices, 2 cm voxels, 64 rays x 8 samples,
groups of 32 points), with weights from neuralbody_tpu's init through
params_from_jax and inputs from numpy seeds.

Tolerances, and why:
  * conv backwards, f32: rtol 1e-4 / atol 1e-5 (tests/test_custom_vjp_conv
    .py's): sums in another order.
  * conv backwards, bf16 storage: dW is an f32 sum of exact bf16 products,
    so 1e-4 of its scale; dx is rounded to bf16 after an f32 sum that may
    differ in its last bit, which can flip it to the neighbouring bf16
    value (2**-8 relative): 1e-2 of its scale.
  * hat backward, f32: 1e-5 of scale (sum order).
  * hat backward, bf16 weights: the Pallas reference rounds each group's
    d_rf to bf16 and scatter-adds in bf16; the port sums in f32 and rounds
    the total once. A few bf16 roundings of terms as large as the result:
    2e-2 of the scale.
  * loss, stats and each gradient leaf of one f32 step: 1e-4 of the leaf's
    largest magnitude (f32 sums in another order through ~20 layers, BN
    reductions included), floor 1e-9 for leaves that are all but zero.
    The loss of every step: rtol 1e-5.
  * Adam turns a gradient into an update of ~lr whatever its size, and an
    element whose gradient is within a few f32 errors (~2e-9 here) of
    Adam's eps (1e-8) moves by a visible fraction of lr. So after one step
    the parameters agree within 0.2 * lr, the Adam moments at 1e-3 of each
    leaf's scale and the BN running stats at 1e-5.
  * After 3 free-running steps the random-weight renders (nearly empty
    rays) drift apart through the model itself: JAX's own gradient at the
    two packages' parameters after one step differs by 1.8% of fc_0's
    scale, while the port's gradient at the same parameters matches JAX's
    at 2e-5. Measured after 3 steps: at most 1.55 lr on a few elements,
    0.0025 lr on average. So the parameters are held at a mean of
    0.01 * lr * steps and a maximum of lr * steps, the moments at 5e-2 of
    scale and the BN stats at 1e-2 of scale (the last layer's batch mean
    moved 0.16%). With the alpha_fc bias raised (rays not empty) nothing
    drifts (0.008 lr measured): the maximum is held at 0.05 * lr * steps,
    the moments at 1e-3 and the BN stats at 1e-4 of scale.
  * schedules: rtol 1e-6 (JAX evaluates them in f32, the port in Python
    floats).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralbody_tpu.config.node import CfgNode
from neuralbody_tpu.models import latent_xyzc as j_lx
from neuralbody_tpu.models import sparse_conv_net as j_net
from neuralbody_tpu.ops import hat_interp as j_hat
from neuralbody_tpu.ops import sparse_conv as j_sc
from neuralbody_tpu.ops.pallas_hat import hat_contract_fused
from neuralbody_tpu.renderer import renderer as j_rend
from neuralbody_tpu.train import optimizer as j_opt
from neuralbody_tpu.train import step as j_step
from neuralbody_tpu.utils.synthetic import make_batch
from neuralbody_tpu_torch.models import latent_xyzc as t_lx
from neuralbody_tpu_torch.models import sparse_conv_net as t_net
from neuralbody_tpu_torch.ops import compositing as t_comp
from neuralbody_tpu_torch.ops import conv_kernel
from neuralbody_tpu_torch.ops import hat_interp as t_hat
from neuralbody_tpu_torch.ops import hat_kernel
from neuralbody_tpu_torch.ops import sparse_conv as t_sc
from neuralbody_tpu_torch.renderer import renderer as t_rend
from neuralbody_tpu_torch.train import optimizer as t_opt
from neuralbody_tpu_torch.train import step as t_step
from neuralbody_tpu_torch.utils.platform import to_device
from neuralbody_tpu_torch.utils.transplant import (opt_state_from_jax,
                                                   params_from_jax)

torch.set_num_threads(1)

VOX = 0.02
NV = 500
N_RAYS = 64
N_SAMPLES = 8
LR = 5e-4
STEPS = 3
CONV_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-9


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_to_scale(a, b, rel, floor=0.0, what=""):
    """max |a - b| <= rel * max |b| (+ floor)."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    scale = np.abs(b).max() if b.size else 0.0
    assert err <= rel * scale + floor, (what, err, scale)


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


@pytest.fixture(scope="module")
def weights():
    params, stats = j_lx.init(jax.random.PRNGKey(0), num_train_frame=4,
                              nv=NV)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


# -- (a) the sparse convs' scatter-free backwards -----------------------------

@pytest.fixture(scope="module")
def geom():
    batch, static = make_batch(n_rays=16, n_verts=NV, voxel_size=VOX,
                               seed=3, batch_size=2)
    return batch["geom"], static


def _conv_case(kind, geom, batched, rng):
    g = geom if batched else {k: v[0] for k, v in geom.items()}
    lead = (2,) if batched else ()
    if kind == "subm":
        lvl, cin, cout = 1, 32, 16
        tabs = (g["nbr1"],)
    elif kind == "xtri":
        lvl, cin, cout = 2, 16, 24
        tabs = tuple(g[f"x{n}2"] for n in
                     ("lnbr", "rnbr", "nbr9", "augl", "augr"))
    else:
        lvl, cin, cout = 0, 16, 32
        tabs = (g["down0"], g["up0"])
    cap_in = g[f"sites{lvl}"].shape[-2]
    cap_out = g["down0"].shape[-1] if kind == "down" else cap_in
    # magnitudes of the encoder's: activations ~1, cotangents ~0.1
    x = rng.randn(*lead, cap_in, cin).astype(np.float32)
    w = (rng.randn(27, cin, cout) * 0.1).astype(np.float32)
    gy = (rng.randn(*lead, cap_out, cout) * 0.1).astype(np.float32)
    return x, w, gy, tabs


_J_CONV = {"subm": j_sc.subm_conv, "xtri": j_sc.subm_conv_xtri,
           "down": j_sc.down_conv}
_T_CONV = {"subm": t_sc.subm_conv, "xtri": t_sc.subm_conv_xtri,
           "down": t_sc.down_conv}


def _t_plain_conv(kind, x, w, tabs):
    """The forward without the custom backward: autograd of the gathers."""
    if kind == "xtri":
        lnbr, rnbr, nbr9, augl, augr = tabs
        tri = t_sc.xtri_table(x, lnbr, rnbr, augl, augr)
        return conv_kernel.sparse_conv_plain(
            tri, nbr9, w.reshape(9, 3 * w.shape[1], w.shape[2]))
    return conv_kernel.sparse_conv_plain(x, tabs[0], w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("kind", ["subm", "xtri", "down"])
def test_conv_backward_matches_jax_vjp(geom, kind, batched, dtype):
    g, _ = geom
    x, w, gy, tabs = _conv_case(kind, g, batched,
                                np.random.RandomState(len(kind)))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jtabs = tuple(map(jnp.asarray, tabs))
    jy, vjp = jax.vjp(lambda a, b: _J_CONV[kind](a, b, *jtabs),
                      jnp.asarray(x).astype(jd), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(gy))

    ttabs = tuple(map(torch.from_numpy, tabs))
    tx = torch.from_numpy(x).to(td).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = _T_CONV[kind](tx, tw, *ttabs)
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(gy))
    assert tdx.dtype == td and tdw.dtype == torch.float32
    _close_to_scale(ty, jy, 1e-5, what="y")
    if dtype == "float32":
        np.testing.assert_allclose(_np(tdx), _np(jdx), **CONV_TOL)
        np.testing.assert_allclose(_np(tdw), _np(jdw), **CONV_TOL)
    else:
        _close_to_scale(tdx, jdx, 1e-2, what="dx")
        _close_to_scale(tdw, jdw, 1e-4, what="dW")
    # the custom backward is the gradient of the plain gathers (in bf16,
    # autograd of the plain forward's w.to(bf16) rounds dW to bf16 too)
    px = torch.from_numpy(x).to(td).requires_grad_()
    pw = torch.from_numpy(w).requires_grad_()
    pdx, pdw = torch.autograd.grad(_t_plain_conv(kind, px, pw, ttabs),
                                   (px, pw), torch.from_numpy(gy))
    rel = 1e-2 if dtype == "bfloat16" else 1e-5
    _close_to_scale(tdx, pdx, rel, what="dx vs plain")
    _close_to_scale(tdw, pdw, rel, what="dW vs plain")


# -- (b) the hat backward -----------------------------------------------------

def _level_inputs(rng, ngrp, P, capR, C, capS):
    feats = rng.randn(capS, C).astype(np.float32)
    sites = rng.randint(0, 6, (capS, 3)).astype(np.int32)
    sites[-2:] = 2 ** 30                       # padded site rows
    rows = rng.randint(0, capS, (ngrp, capR)).astype(np.int32)
    rows[:, -3:] = capS                        # sentinel rows
    pos = rng.uniform(0, 6, (ngrp, P, 3)).astype(np.float32)
    grad = rng.randn(ngrp, P, C).astype(np.float32)
    return feats, sites, rows, pos, grad


def test_hat_bwd_plain_f32_matches_jax_vjp():
    feats, sites, rows, pos, grad = _level_inputs(
        np.random.RandomState(4), 5, 16, 48, 24, 40)
    _, vjp = jax.vjp(lambda f: j_hat.hat_interp_level(
        f, jnp.asarray(sites), jnp.asarray(rows), jnp.asarray(pos)),
        jnp.asarray(feats))
    ref, = vjp(jnp.asarray(grad))
    out = hat_kernel.hat_interp_level_bwd_plain(
        *map(torch.from_numpy, (grad, sites, rows, pos)), torch.float32)
    assert out.dtype == torch.float32 and out.shape == feats.shape
    _close_to_scale(out, ref, 1e-5)
    assert np.abs(_np(ref)).max() > 0


def test_hat_bwd_plain_bf16_matches_pallas_interpret():
    """At tests/test_pallas_hat.py's shapes: the VJP of the Pallas kernel
    in interpret mode (its _bwd_kernel) through the row gather."""
    NGRP, P, CAPR, C, capS = 4, 16, 32, 8, 24
    feats, sites, rows, pos, grad = _level_inputs(
        np.random.RandomState(0), NGRP, P, CAPR, C, capS)
    spad = np.concatenate([sites.astype(np.float32),
                           np.full((1, 3), 1e9, np.float32)])
    rc = jnp.asarray(spad[rows])

    def fwd(f):
        fpad = jnp.concatenate([f, jnp.zeros((1, C), f.dtype)])
        return hat_contract_fused(fpad[jnp.asarray(rows)], rc,
                                  jnp.asarray(pos), interpret=True)

    f_bf = jnp.asarray(feats).astype(jnp.bfloat16)
    _, vjp = jax.vjp(fwd, f_bf)
    ref, = vjp(jnp.asarray(grad))
    assert ref.dtype == jnp.bfloat16
    out = hat_kernel.hat_interp_level_bwd_plain(
        *map(torch.from_numpy, (grad, sites, rows, pos)), torch.bfloat16)
    _close_to_scale(out.bfloat16(), ref, 2e-2)
    # the f32 weights give another result: the bf16 mode is what is held
    out32 = hat_kernel.hat_interp_level_bwd_plain(
        *map(torch.from_numpy, (grad, sites, rows, pos)), torch.float32)
    assert not torch.equal(out32, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hat_function_backward_is_autograd_of_plain(dtype):
    """hat_interpolate's Function on the CPU: its forward is the plain
    forward per level, and its backward the gradient torch autograd takes
    through that plain forward."""
    rng = np.random.RandomState(6)
    ngrp, P, Cs, caps = 3, 16, (32, 64, 32, 32), (30, 20, 12, 8)
    out_sh = (32, 32, 32)
    feats, geom, rows = [], {}, {}
    for lvl, (C, capS) in enumerate(zip(Cs, caps), 1):
        f, s, r, _, _ = _level_inputs(rng, ngrp, P, 24, C, capS)
        s[:-2] = rng.randint(0, 32 // 2 ** lvl, (capS - 2, 3))
        feats.append(torch.from_numpy(f).to(dtype).requires_grad_())
        geom[f"sites{lvl}"] = torch.from_numpy(s)
        rows[lvl] = torch.from_numpy(r)
    dhw = torch.from_numpy(rng.uniform(0, 31, (ngrp, P, 3)).astype(
        np.float32))
    static = t_lx.ModelStatic(encoder=t_net.EncoderStatic(
        out_sh=out_sh, site_caps=(64,) + caps))
    out = t_hat.hat_interpolate(feats, geom, rows, dhw, static)
    gout = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    got = torch.autograd.grad(out, feats, gout)

    plain, c0 = [], 0
    for lvl, f in enumerate(feats, 1):
        sh_l = torch.tensor([s // 2 ** lvl for s in out_sh], dtype=torch.float32)
        pos = dhw * ((sh_l - 1.0) / torch.tensor(out_sh, dtype=torch.float32))
        plain.append(hat_kernel.hat_interp_level_plain(
            f, geom[f"sites{lvl}"], rows[lvl], pos))
    ref_out = torch.cat(plain, dim=-1)
    want = torch.autograd.grad(ref_out, feats, gout)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref_out.detach().numpy())
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        # bf16: autograd of the plain forward sums the gathered rows' bf16
        # gradients in bf16; the Function sums in f32 and rounds once
        _close_to_scale(a, b, 1e-5 if dtype == torch.float32 else 2e-2)
        assert np.abs(_np(b)).max() > 0


# -- (c) loss and schedules ---------------------------------------------------

def test_masked_mse():
    rng = np.random.RandomState(7)
    pred, target = rng.rand(2, 20, 3), rng.rand(2, 20, 3)
    mask = (rng.rand(2, 20) > 0.4).astype(np.float32)
    args = [a.astype(np.float32) for a in (pred, target, mask)]
    ref = j_step.masked_mse(*map(jnp.asarray, args))
    out = t_step.masked_mse(*map(torch.from_numpy, args))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    zero = np.zeros_like(args[2])
    assert t_step.masked_mse(*map(torch.from_numpy, args[:2] + [zero])) \
        == 0.0


_SCHEDULES = [
    dict(type="exponential", gamma=0.1, decay_epochs=3),
    dict(type="multi_step", milestones=[2, 5, 7], gamma=0.5),
    dict(type="warmup_multi_step", milestones=[4, 8], gamma=0.1,
         warmup_factor=1.0 / 3, warmup_iters=3, warmup_method="linear"),
    dict(type="warmup_multi_step", milestones=[4], gamma=0.2,
         warmup_factor=0.25, warmup_iters=2, warmup_method="constant"),
]


@pytest.mark.parametrize("sch", _SCHEDULES,
                         ids=lambda s: f"{s['type']}-"
                         f"{s.get('warmup_method', '')}")
def test_lr_schedule_matches_jax(sch):
    ep_iter = 4
    cfg = CfgNode({"train": {"lr": 1e-3, "scheduler": sch},
                   "ep_iter": ep_iter})
    ref = j_opt.make_lr_schedule(cfg)
    kw = {k: v for k, v in sch.items() if k != "type"}
    out = t_opt.make_lr_schedule(1e-3, sch["type"], ep_iter=ep_iter, **kw)
    for step in range(0, 45):
        np.testing.assert_allclose(out(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_matches_optax(weight_decay):
    """Three steps on the same gradients (some beyond the clip at 40), with
    and without coupled weight decay, against optax's chain: the moments
    at rtol 1e-6 (the bias corrections are f32 in optax, Python floats
    here), the parameters (size ~1) within a few f32 ulps, atol 1e-6."""
    rng = np.random.RandomState(9)
    params = {"a": rng.randn(5, 4).astype(np.float32),
              "b": [{"w": rng.randn(7).astype(np.float32)}]}
    grads = [jax.tree.map(lambda x: (rng.randn(*x.shape) * 30).astype(
        np.float32), params) for _ in range(3)]
    def schedule(t):
        return 1e-2 * 0.5 ** t

    chain = [optax.clip(40.0)]
    if weight_decay:
        chain.append(optax.add_decayed_weights(weight_decay))
    tx = optax.chain(*chain, optax.adam(schedule, eps=1e-8))
    jp, jst = params, tx.init(params)
    tp, _ = params_from_jax(params, {})
    opt = t_opt.make_optimizer(tp, schedule, weight_decay=weight_decay)
    for g in grads:
        u, jst = tx.update(g, jst, jp)
        jp = optax.apply_updates(jp, u)
        opt.step(tp, params_from_jax(g, {})[0])
    for (path, j), (_, t) in zip(_flat(jp), _flat(tp)):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-6, atol=1e-6,
                                   err_msg=path)
    for name in ("mu", "nu"):
        for (path, j), (_, t) in zip(_flat(getattr(jst[-1][0], name)),
                                     _flat(getattr(opt, name))):
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-6,
                                       err_msg=name + path)


def test_optimizers_outside_the_slice():
    p = {"w": torch.zeros(3)}
    for name in ("radam", "sgd"):
        with pytest.raises(NotImplementedError, match="training-harness"):
            t_opt.make_optimizer(p, lambda t: 1e-3, optim=name)
    with pytest.raises(ValueError):
        t_opt.make_optimizer(p, lambda t: 1e-3, optim="lamb")


# -- (d) the training step ----------------------------------------------------

def _scene(batch_size=1, seed=3):
    """make_batch(hat=True) with the perturbed host plan, group size 32;
    with B=2, static sizes that fit both elements."""
    batch, static = make_batch(n_rays=N_RAYS, n_verts=NV, voxel_size=VOX,
                               seed=seed, batch_size=batch_size)
    if batch_size > 1:
        batch["Th"][1] += np.float32(0.01)
        batch["latent_index"][1] = 2
    args = (static["out_sh"], static["site_caps"], (VOX,) * 3, N_SAMPLES)
    plan = dict(group_size=32)
    if batch_size > 1:
        # draw each element's depths in the order the batched call does
        rng = np.random.RandomState(seed + 1)
        sizes = [j_hat.prepare_hat_batch(
            {k: (v[b:b + 1] if k != "geom" else
                 {n: t[b:b + 1] for n, t in v.items()})
             for k, v in batch.items()}, *args, rng=rng, **plan)[1]
            for b in range(batch_size)]
        plan.update(n_groups=max(s["n_groups"] for s in sizes),
                    **{k: tuple(int(c) for c in np.max(
                        [s[k] for s in sizes], axis=0))
                       for k in ("rows_caps", "seg_caps")})
    batch, hs = j_hat.prepare_hat_batch(
        batch, *args, rng=np.random.RandomState(seed + 1), **plan)
    return batch, static, hs


def _settings(static, hs):
    kw = dict(voxel_size=(VOX,) * 3, hat_rows_caps=hs["rows_caps"])
    enc = dict(out_sh=static["out_sh"], site_caps=static["site_caps"])
    js = j_rend.RenderSettings(
        model=j_lx.ModelStatic(encoder=j_net.EncoderStatic(**enc)),
        n_samples=N_SAMPLES, chunk_rays=N_RAYS, **kw)
    ts = t_rend.RenderSettings(
        model=t_lx.ModelStatic(encoder=t_net.EncoderStatic(**enc)), **kw)
    return js, ts


_J_VG = jax.jit(jax.value_and_grad(j_step.loss_fn, has_aux=True),
                static_argnames=("settings",))


def _raise_alpha(params, by=3.0):
    return dict(params, alpha_fc=dict(
        params["alpha_fc"], b=params["alpha_fc"]["b"] + np.float32(by)))


def _compare_grads(tgrads, jgrads):
    jl, tl = _flat(jgrads), _flat(tgrads)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        _close_to_scale(t, j, GRAD_TOL, GRAD_FLOOR, what=path)


def _param_diffs(jp, tp):
    return np.concatenate([np.abs(_np(t) - _np(j)).ravel()
                           for (_, j), (_, t) in zip(_flat(jp), _flat(tp))])


def _compare_moments(jadam, opt, rel):
    for name in ("mu", "nu"):
        for (path, j), (_, t) in zip(_flat(getattr(jadam, name)),
                                     _flat(getattr(opt, name))):
            _close_to_scale(t, j, rel, GRAD_FLOOR ** 2, what=name + path)


@pytest.mark.parametrize("case", [dict(batch_size=1), dict(batch_size=2),
                                  dict(batch_size=1, alpha=3.0)],
                         ids=["B1", "B2", "B1-alpha"])
def test_train_steps_match_jax(weights, case):
    """The loss and every gradient of one step; the loss of every step; the
    params, the Adam moments and the BN running stats after one step and
    after STEPS steps (the tolerances are in the module docstring)."""
    params, stats = weights
    raised = "alpha" in case
    if raised:
        params = _raise_alpha(params, case["alpha"])
    batch, static, hs = _scene(case["batch_size"])
    js, ts = _settings(static, hs)
    jb = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(0)

    tp, tbn = params_from_jax(params, stats)
    tb = to_device(batch, "cpu")
    tloss, (_, _, tst), tgrads = t_step.loss_and_grads(tp, tb, ts)
    (jloss, (jret, _, jst)), jgrads = _J_VG(params, jb, js, key)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for k in ("img_loss", "psnr"):
        np.testing.assert_allclose(tst[k].item(), float(jst[k]), rtol=1e-5)
    if raised:
        assert float(jnp.mean(jret["acc_map"])) > 0.3
    _compare_grads(tgrads, jgrads)

    tx = optax.chain(optax.clip(40.0), optax.adam(LR))
    jp, jbn, jopt = params, stats, tx.init(params)
    opt = t_opt.make_optimizer(tp, t_opt.make_lr_schedule(
        LR, "multi_step"))
    for step in range(1, STEPS + 1):
        jp, jbn, jopt, jsteps = j_step.train_step(
            jp, jbn, jopt, jb, key, js, tx)
        tbn, tsteps = t_step.train_step(tp, tbn, opt, tb, ts, device="cpu")
        np.testing.assert_allclose(tsteps["loss"].item(),
                                   float(jsteps["loss"]), rtol=1e-5)
        assert opt.count == int(jopt[1][0].count) == step
        if step == 1:
            assert _param_diffs(jp, tp).max() <= 0.2 * LR
            _compare_moments(jopt[1][0], opt, 1e-3)
            for (path, j), (_, t) in zip(_flat(jbn), _flat(tbn)):
                np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5,
                                           atol=1e-5, err_msg=path)
    d = _param_diffs(jp, tp)
    assert d.mean() <= 0.01 * LR * STEPS
    assert d.max() <= (0.05 if raised else 1.0) * LR * STEPS
    _compare_moments(jopt[1][0], opt, 1e-3 if raised else 5e-2)
    for (path, j), (_, t) in zip(_flat(jbn), _flat(tbn)):
        _close_to_scale(t, j, 1e-4 if raised else 1e-2, 1e-5, what=path)


def test_train_steps_is_a_loop_of_train_step(weights):
    """train_steps over G batches: the params, BN stats and per-step stats
    of G train_step calls, bit for bit."""
    batch, static, hs = _scene(1)
    _, ts = _settings(static, hs)
    runs = []
    for stacked in (False, True):
        tp, tbn = params_from_jax(*weights)
        opt = t_opt.make_optimizer(tp, lambda t: LR)
        if stacked:
            tbn, st = t_step.train_steps(tp, tbn, opt, [batch, batch], ts,
                                         device="cpu")
        else:
            st = []
            for _ in range(2):
                tbn, s = t_step.train_step(tp, tbn, opt, batch, ts,
                                           device="cpu")
                st.append(s["loss"])
            st = {"loss": torch.stack(st)}
        runs.append((tp, tbn, st["loss"]))
    (p1, b1, l1), (p2, b2, l2) = runs
    assert l2.shape == (2,) and torch.equal(l1, l2)
    for (path, a), (_, b) in zip(_flat(p1) + _flat(b1), _flat(p2) + _flat(b2)):
        assert torch.equal(a, b), path


# -- (e) resuming a JAX run in the port --------------------------------------

def test_opt_state_from_jax_resumes(weights):
    params, stats = weights
    batch, static, hs = _scene(1)
    js, ts = _settings(static, hs)
    jb = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(0)
    tx = optax.chain(optax.clip(40.0), optax.adam(LR))
    jp, jbn, jopt = params, stats, tx.init(params)
    for _ in range(2):
        jp, jbn, jopt, _ = j_step.train_step(jp, jbn, jopt, jb, key, js, tx)
    tp, tbn = params_from_jax(jax.tree.map(np.asarray, jp),
                              jax.tree.map(np.asarray, jbn))
    opt = t_opt.make_optimizer(tp, lambda t: LR)
    opt.load_state_dict(opt_state_from_jax(jopt))
    assert opt.count == 2
    jp, jbn, jopt, _ = j_step.train_step(jp, jbn, jopt, jb, key, js, tx)
    tbn, _ = t_step.train_step(tp, tbn, opt, to_device(batch, "cpu"), ts,
                               device="cpu")
    assert opt.count == 3
    # one step from the same state: the one-step tolerances
    assert _param_diffs(jp, tp).max() <= 0.2 * LR
    _compare_moments(jopt[1][0], opt, 1e-3)
    for (path, j), (_, t) in zip(_flat(jbn), _flat(tbn)):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5,
                                   err_msg=path)


# -- (f) no silent CPU --------------------------------------------------------

def test_train_step_defaults_to_the_card(weights):
    batch, static, hs = _scene(1)
    _, ts = _settings(static, hs)
    tp, tbn = params_from_jax(*weights)
    opt = t_opt.make_optimizer(tp, lambda t: LR)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="params must be on"):
            t_step.train_step(tp, tbn, opt, batch, ts)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_step.train_step(tp, tbn, opt, batch, ts)
    assert opt.count == 0


# -- (g) the raw-noise term ---------------------------------------------------

def test_raw_noise_seeded_and_off_at_zero():
    rng = np.random.RandomState(8)
    raw = torch.from_numpy(rng.randn(16, 8, 4).astype(np.float32))
    z = torch.from_numpy(np.sort(rng.uniform(1, 4, (16, 8)), axis=1)
                         .astype(np.float32))
    d = torch.from_numpy(rng.randn(16, 3).astype(np.float32))
    clean = t_comp.raw2outputs(raw, z, d)
    a = t_comp.raw2outputs(raw, z, d, raw_noise_std=1.0,
                           generator=torch.Generator().manual_seed(5))
    b = t_comp.raw2outputs(raw, z, d, raw_noise_std=1.0,
                           generator=torch.Generator().manual_seed(5))
    for k in clean:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["acc_map"], clean["acc_map"])
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    off = t_comp.raw2outputs(raw, z, d, raw_noise_std=0.0, generator=gen)
    assert torch.equal(gen.get_state(), state)
    for k in clean:
        assert torch.equal(off[k], clean[k])
    with pytest.raises(ValueError, match="Generator"):
        t_comp.raw2outputs(raw, z, d, raw_noise_std=1.0)


def test_raw_noise_only_in_training_renders(weights):
    """raw_noise_std in the settings reaches the composite of a training
    render and never an eval render."""
    batch, static, hs = _scene(1)
    _, ts = _settings(static, hs)
    ts = ts._replace(raw_noise_std=1.0)
    tp, _ = params_from_jax(_raise_alpha(weights[0]), weights[1])
    tb = to_device(batch, "cpu")
    with torch.no_grad():
        ev, _ = t_rend.render_rays(tp, tb, ts)
        ev0, _ = t_rend.render_rays(tp, tb, ts._replace(raw_noise_std=0.0),
                                    train=True)
        tr1, _ = t_rend.render_rays(tp, tb, ts, train=True,
                                    generator=torch.Generator().manual_seed(1))
        tr2, _ = t_rend.render_rays(tp, tb, ts, train=True,
                                    generator=torch.Generator().manual_seed(1))
    assert torch.equal(ev["rgb_map"], ev0["rgb_map"])
    assert torch.equal(tr1["rgb_map"], tr2["rgb_map"])
    assert not torch.equal(tr1["rgb_map"], ev["rgb_map"])
