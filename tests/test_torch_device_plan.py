"""The hat plan built on the device (neuralbody_tpu_torch/ops/device_plan.py
and the render, step, loader and config run around it) against the JAX
package, on the CPU at tests/test_device_plan.py's size (512 vertices,
2 cm voxels, 64 rays x 8 samples, groups of 32), and the loader's plan_device
batches over tests/fake_data.py's ZJU tree.

Tolerances, and why: the plan is integer work on the same f32 voxel
coordinates, so perm, rows and the overflow flag are held bit for bit,
both the rowcum branch and the binary search over the site keys. The
device-planned render runs the same float operations as the JAX render on
the same z samples (perturb off), in another summation order: rgb and acc
at rtol 1e-5 / atol 1e-6 against JAX, and at tests/test_device_plan.py's
1e-4 / 1e-5 against the port's own site-interpolation render (another
interpolation path). The plan_overflow stat is exact. The loader's batches
are bit for bit, as tests/test_torch_loader.py holds the host-planned ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralbody_tpu.models import latent_xyzc as j_lx
from neuralbody_tpu.models.sparse_conv_net import EncoderStatic as JEnc
from neuralbody_tpu.ops import device_plan as j_dp
from neuralbody_tpu.renderer import renderer as j_rend
from neuralbody_tpu.train import step as j_step
from neuralbody_tpu.utils.synthetic import make_batch
import neuralbody_tpu_torch.datasets  # noqa: F401  (registers plugins)
from neuralbody_tpu_torch.config import make_cfg as t_make_cfg
from neuralbody_tpu_torch.datasets import loader as t_loader
from neuralbody_tpu_torch.models import latent_xyzc as t_lx
from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic
from neuralbody_tpu_torch.ops import device_plan as t_dp
from neuralbody_tpu_torch.ops import hat_interp as t_hat
from neuralbody_tpu_torch.renderer import renderer as t_rend
from neuralbody_tpu_torch.train import fresh
from neuralbody_tpu_torch.train import step as t_step
from neuralbody_tpu_torch.utils.platform import to_device
from neuralbody_tpu_torch.utils.transplant import params_from_jax

torch.set_num_threads(1)

VOX = 0.02
N_RAYS = 64
N_SAMPLES = 8
GROUP = 32
RENDER_TOL = dict(rtol=1e-5, atol=1e-6)
SITE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def scene():
    """tests/test_device_plan.py's scene: a host-planned batch only to
    derive the caps, the rays-only batch, the spec, both packages'
    weights."""
    hat_np, static = make_batch(
        n_rays=N_RAYS, n_verts=512, voxel_size=VOX, seed=3, hat=True,
        n_samples=N_SAMPLES, hat_perturb=False,
        hat_static=dict(group_size=GROUP))
    base_np, _ = make_batch(n_rays=N_RAYS, n_verts=512, voxel_size=VOX,
                            seed=3)
    hs = static["hat"]
    kw = dict(out_sh=static["out_sh"], site_caps=tuple(static["site_caps"]),
              group_size=GROUP, tile=(4, 8), n_groups=hs["n_groups"],
              rows_caps=tuple(hs["rows_caps"]),
              seg_caps=tuple(hs["seg_caps"]))
    jparams, jstats = j_lx.init(jax.random.PRNGKey(0), num_train_frame=4,
                                nv=512)
    tparams, _ = params_from_jax(jax.tree.map(np.asarray, jparams),
                                 jax.tree.map(np.asarray, jstats))
    return dict(hat=hat_np, base=base_np, static=static,
                jspec=j_dp.DevicePlanSpec(**kw),
                tspec=t_dp.DevicePlanSpec(**kw),
                jparams=jparams, tparams=tparams)


def _dhw(hat_np):
    """The host planner's voxel coordinates of element 0's samples."""
    z = hat_np["z_vals"][0]
    pts = (hat_np["ray_o"][0][:, None, :]
           + hat_np["ray_d"][0][:, None, :] * z[..., None]).reshape(-1, 3)
    Rm, Th = hat_np["R"][0], hat_np["Th"][0].reshape(1, 3)
    ppts = (pts - Th) @ Rm
    return ((ppts[:, [2, 1, 0]] - hat_np["bounds"][0][0][[2, 1, 0]])
            / np.float32(VOX)).astype(np.float32)


def _plans(sc, spec_over=None, rowcum=True):
    """(JAX plan, port plan) of element 0 as numpy."""
    dhw = _dhw(sc["hat"])
    geom = {k: v[0] for k, v in sc["hat"]["geom"].items()
            if rowcum or not k.startswith("rowcum")}
    jspec, tspec = sc["jspec"], sc["tspec"]
    if spec_over:
        jspec, tspec = jspec._replace(**spec_over), tspec._replace(
            **spec_over)
    jp, jr, jo = jax.jit(j_dp.plan_hat_device, static_argnames=("spec",))(
        jnp.asarray(dhw), {k: jnp.asarray(v) for k, v in geom.items()},
        jspec)
    tp, tr, to = t_dp.plan_hat_device(torch.from_numpy(dhw),
                                      to_device(geom, "cpu"), tspec)
    j = (np.asarray(jp), {l: np.asarray(r) for l, r in jr.items()},
         float(jo))
    t = (tp.numpy(), {l: r.numpy() for l, r in tr.items()}, float(to))
    return j, t


@pytest.mark.parametrize("rowcum", [True, False],
                         ids=["rowcum", "searchsorted"])
def test_device_plan_matches_jax_and_the_host_plan(scene, rowcum):
    (jp, jr, jo), (tp, tr, to) = _plans(scene, rowcum=rowcum)
    assert tp.dtype == np.int32 and to == jo == 0.0
    np.testing.assert_array_equal(tp, jp)
    spec, st = scene["tspec"], scene["static"]
    host = t_hat.plan_hat_groups(
        _dhw(scene["hat"]),
        {k: v[0] for k, v in scene["hat"]["geom"].items()},
        st["out_sh"], st["site_caps"], group_size=GROUP,
        rows_caps=spec.rows_caps, n_groups=spec.n_groups,
        seg_caps=spec.seg_caps)
    np.testing.assert_array_equal(tp, host["perm"])
    for li, l in enumerate((1, 2, 3, 4)):
        assert tr[l].dtype == np.int32
        np.testing.assert_array_equal(tr[l], jr[l], err_msg=f"level {l}")
        np.testing.assert_array_equal(
            tr[l], t_hat.expand_segments_np(
                host[f"seg_a{l}"], host[f"seg_cum{l}"], spec.rows_caps[li],
                st["site_caps"][l]), err_msg=f"level {l}")


@pytest.mark.parametrize("what", ["rows_caps", "seg_caps", "n_groups"])
def test_overflow_flag_fires_on_tight_caps(scene, what):
    """Rows past a level's cap, d-slices past seg_caps, points past the
    groups: the flag is 1 in both packages, and the plans still agree."""
    over = {"rows_caps": (8, 8, 8, 8), "seg_caps": (1, 1, 1, 1),
            "n_groups": 2}[what]
    (jp, jr, jo), (tp, tr, to) = _plans(scene, {what: over})
    assert to == jo == 1.0
    np.testing.assert_array_equal(tp, jp)
    for l in (1, 2, 3, 4):
        np.testing.assert_array_equal(tr[l], jr[l])


def _settings(sc, **over):
    st = sc["static"]
    ms = t_lx.ModelStatic(encoder=EncoderStatic(
        out_sh=st["out_sh"], site_caps=st["site_caps"]))
    jms = j_lx.ModelStatic(encoder=JEnc(out_sh=st["out_sh"],
                                        site_caps=st["site_caps"]))
    kw = dict(voxel_size=(VOX,) * 3, n_samples=N_SAMPLES,
              chunk_rays=N_RAYS, site_interp=True, perturb=False)
    return (j_rend.RenderSettings(model=jms, **kw)._replace(**{
                k: (sc["jspec"] if v else None) for k, v in over.items()}),
            t_rend.RenderSettings(model=ms, **kw)._replace(**{
                k: (sc["tspec"] if v else None) for k, v in over.items()}))


def test_device_planned_render_matches_jax_and_the_site_render(scene):
    j_site, t_site = _settings(scene)
    j_dev, t_dev = _settings(scene, hat_plan=True)
    jret, _ = j_rend.render_rays(
        scene["jparams"], jax.tree.map(jnp.asarray, scene["base"]), j_dev,
        key=jax.random.PRNGKey(7), train=True)
    batch = to_device(scene["base"], "cpu")
    with torch.no_grad():
        tret, _ = t_rend.render_rays(scene["tparams"], batch, t_dev,
                                     train=True)
        site, _ = t_rend.render_rays(scene["tparams"], batch, t_site,
                                     train=True)
    assert tret["plan_overflow"].shape == (1,)
    assert float(tret["plan_overflow"].max()) == 0.0
    for k in ("rgb_map", "acc_map"):
        np.testing.assert_allclose(tret[k].numpy(), np.asarray(jret[k]),
                                   err_msg=k, **RENDER_TOL)
        np.testing.assert_allclose(tret[k].numpy(), site[k].numpy(),
                                   err_msg=k, **SITE_TOL)


@pytest.mark.parametrize("tight", [False, True], ids=["fits", "tight"])
def test_plan_overflow_stat_through_loss_fn(scene, tight):
    """loss_fn's plan_overflow stat (JAX step.py:54-58), its loss and the
    other stats against the JAX loss_fn."""
    j_dev, t_dev = _settings(scene, hat_plan=True)
    if tight:
        j_dev = j_dev._replace(hat_plan=j_dev.hat_plan._replace(
            rows_caps=(8, 8, 8, 8)))
        t_dev = t_dev._replace(hat_plan=t_dev.hat_plan._replace(
            rows_caps=(8, 8, 8, 8)))
    jl, (_, _, jst) = j_step.loss_fn(
        scene["jparams"], jax.tree.map(jnp.asarray, scene["base"]), j_dev,
        jax.random.PRNGKey(7))
    with torch.no_grad():
        tl, (_, _, tst) = t_step.loss_fn(
            scene["tparams"], to_device(scene["base"], "cpu"), t_dev)
    assert float(tst["plan_overflow"]) == float(jst["plan_overflow"]) \
        == float(tight)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tst["psnr"]), float(jst["psnr"]),
                               rtol=1e-5)


# -- the loader and the config run -----------------------------------------


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    from fake_data import make_fake_zju
    return {pkg: make_fake_zju(str(tmp_path_factory.mktemp(pkg)
                                   / "CoreView_999"))
            for pkg in ("jax", "torch")}


def _plan_cfg(make_cfg, root):
    from test_torch_loader import small_cfg
    cfg = small_cfg(make_cfg, root)
    cfg.tpu.hat_plan_device = True
    return cfg


def test_plan_device_loader_matches_jax(roots):
    """DataLoader(plan_device=True): every batch, rays only, equal to the
    JAX loader's key for key (batch 0 too: it derives the caps on the host
    and ships without its plan); n_groups and rows_caps as JAX derives
    them (seg_caps differ on purpose: test_d_span_caps)."""
    import neuralbody_tpu.datasets  # noqa: F401
    from neuralbody_tpu.config import make_cfg as j_make_cfg
    from neuralbody_tpu.datasets import loader as j_loader
    from test_torch_datasets import assert_same
    jcfg = _plan_cfg(j_make_cfg, roots["jax"])
    jhs = {}
    want = list(j_loader.make_data_loader(
        jcfg, "train", dataset=j_loader.make_dataset(jcfg, "train"),
        hat_state=jhs))
    cfg = _plan_cfg(t_make_cfg, roots["torch"])
    hs = {}
    loader = t_loader.make_data_loader(
        cfg, "train", dataset=t_loader.make_dataset(cfg, "train"),
        hat_state=hs)
    assert loader.plan_device
    got = list(loader)
    assert len(got) == len(want) == cfg.ep_iter
    for bi, (w, g) in enumerate(zip(want, got)):
        assert "hat_sort" not in g[0] and "z_frac" not in g[0]
        assert sorted(g[0]) == sorted(w[0])
        assert_same(w, g, f"batch {bi}")
    assert hs["n_groups"] == jhs["n_groups"]
    assert hs["rows_caps"] == jhs["rows_caps"]


def test_d_span_caps(roots):
    """seg_caps from the largest d-span over the probe batches, by the
    margin rule of the other caps; every batch's device plan fits them."""
    cfg = _plan_cfg(t_make_cfg, roots["torch"])
    ds = t_loader.make_dataset(cfg, "train")
    hs = {}
    batches = list(t_loader.make_data_loader(cfg, "train", dataset=ds,
                                             hat_state=hs))
    spans = None
    for bi in range(min(8, len(batches))):
        probe = t_loader.make_data_loader(cfg, "train", dataset=ds,
                                          hat_state={})
        np.random.seed(t_loader._batch_seed(0, bi, probe.seed0))
        idx = probe.indices[bi * probe.batch_size:(bi + 1) * probe.batch_size]
        raw, _ = t_loader.collate([ds[j] for j in idx], probe.chunk_rays)
        _, st = t_loader.apply_hat_spec(
            raw, probe._spec(), t_loader._batch_seed(0, bi, probe.seed0 + 1),
            d_spans=True)
        spans = st["d_spans"] if spans is None else tuple(
            max(a, b) for a, b in zip(spans, st["d_spans"]))
    assert hs["seg_caps"] == tuple(-(-int(c * 1.25) // 8) * 8 for c in spans)
    run = fresh.ConfigRun(cfg, dataset=ds, device="cpu", bank=False)
    run.hat_state.update(hs)
    settings = run._settings(batches[1][0])
    assert settings.hat_plan.seg_caps == hs["seg_caps"]
    for b, _ in batches:
        with torch.no_grad():
            _, (_, _, st) = t_step.loss_fn(run.params, to_device(b, "cpu"),
                                           settings)
        assert float(st["plan_overflow"]) == 0.0


def test_config_run_raises_on_overflow(roots):
    """A config run whose device plans overflow their static sizes raises,
    naming cfg.tpu.hat_static_margin (the JAX Trainer only logs the
    flag); with the sizes derived as usual it trains."""
    cfg = _plan_cfg(t_make_cfg, roots["torch"])
    cfg.ep_iter = 4
    cfg.tpu.steps_per_dispatch = 2
    run = fresh.ConfigRun(cfg, device="cpu")
    assert len(list(run.epoch(0))) == 2 and run.bank is not None
    st = run.dispatch([fresh.with_geom(b, m, run.geom_cache)
                       for b, m in list(run.loader(1))[:2]])
    assert st["plan_overflow"].tolist() == [0.0, 0.0]
    cfg.tpu.hat_static_margin = 0.5
    tight = fresh.ConfigRun(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="hat_static_margin"):
        for _ in tight.epoch(0):
            pass


def test_device_planned_step_builds_no_tensor(scene, monkeypatch):
    """After a first step, a train_step that builds its plan on the device
    (depths perturbed from a generator) builds no tensor from a Python
    value and reads none back: tests/test_torch_scan.py's host-traffic
    check, which a CUDA graph's capture needs."""
    from test_torch_scan import _host_traffic
    from neuralbody_tpu_torch.train import optimizer as t_opt
    _, t_dev = _settings(scene, hat_plan=True)
    t_dev = t_dev._replace(perturb=True)
    tp = t_opt.tree_map(lambda t: t.clone(), scene["tparams"])
    _, tbn = params_from_jax(*[jax.tree.map(np.asarray, x) for x in
                               j_lx.init(jax.random.PRNGKey(0),
                                         num_train_frame=4, nv=512)])
    opt = t_opt.build_optimizer(tp, lambda t: 5e-4)
    tb = to_device(scene["base"], "cpu")
    gen = torch.Generator().manual_seed(0)
    tbn, _ = t_step.train_step(tp, tbn, opt, tb, t_dev, device="cpu",
                               generator=gen)
    built, real = [], torch.tensor

    def counting(*args, **kwargs):
        built.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "tensor", counting)
    traffic = _host_traffic(lambda: t_step.train_step(
        tp, tbn, opt, tb, t_dev, device="cpu", generator=gen))
    assert built == [] and traffic == []
