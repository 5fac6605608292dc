"""The port's G-step training dispatch (train/step.py:train_step_scan), what
makes a step capturable in a CUDA graph, and the port's bench, on the CPU
at test_torch_train.py's small size (~500 vertices, 2 cm voxels, 64 rays x
8 samples, groups of 32 points) with its fixtures.

Tolerances, and why:
  * train_step_scan against the JAX package's train_step_scan over G = 3
    steps, each on its own perturbed plan: the loss of every step at rtol
    1e-5 and the params, the Adam moments and the BN running stats at
    test_train_steps_match_jax's after-the-steps tolerances (params: a
    mean of 0.01 * lr * steps, a maximum of lr * steps; moments 5e-2 and
    BN stats 1e-2 of scale). Its docstring says where they come from: the
    random-weight model's gradients are ill-conditioned, so free-running
    steps drift apart. Its tighter case, the alpha_fc bias raised, holds
    for one batch repeated and not for three plans: there the deep convs'
    weights drift by up to 1.3 lr after three steps of the eager loop
    against the JAX package's train_step, and the scan drifts as far.
  * Everything else is bit for bit: train_step_scan on the CPU is
    train_steps' loop; the cached constants are the tensors torch.tensor
    built; an Adam step that reads its scalars from a tensor (f32, rounded
    once from the same double-precision arithmetic) multiplies and divides
    by the same f32 numbers as one given Python floats.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralbody_tpu.ops import hat_interp as j_hat
from neuralbody_tpu.train import step as j_step
from neuralbody_tpu.utils.synthetic import make_batch
from neuralbody_tpu_torch import bench
from neuralbody_tpu_torch.models import latent_xyzc as t_lx
from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic
from neuralbody_tpu_torch.ops import hat_interp as t_hat
from neuralbody_tpu_torch.ops import hat_kernel
from neuralbody_tpu_torch.train import graphs
from neuralbody_tpu_torch.train import optimizer as t_opt
from neuralbody_tpu_torch.train import step as t_step
from neuralbody_tpu_torch.utils.platform import constant, to_device
from neuralbody_tpu_torch.utils.transplant import params_from_jax
from test_torch_train import (LR, N_RAYS, N_SAMPLES, NV, VOX,  # noqa: F401
                              _close_to_scale, _compare_moments, _flat,
                              _param_diffs, _scene, _settings, weights)

torch.set_num_threads(1)

G = 3


def _stack(trees):
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else np.stack([t[k] for t in trees]) for k in trees[0]}


@pytest.fixture(scope="module")
def scan_scene():
    """G perturbed host plans of one scene (static sizes that fit all of
    them), stacked on a leading step axis."""
    batch, static = make_batch(n_rays=N_RAYS, n_verts=NV, voxel_size=VOX,
                               seed=3)
    args = (static["out_sh"], static["site_caps"], (VOX,) * 3, N_SAMPLES)

    def plans(**plan):
        return [j_hat.prepare_hat_batch(batch, *args,
                                        rng=np.random.RandomState(4 + g),
                                        group_size=32, **plan)
                for g in range(G)]

    sizes = [hs for _, hs in plans()]
    steps = plans(n_groups=max(s["n_groups"] for s in sizes),
                  **{k: tuple(int(c) for c in np.max([s[k] for s in sizes],
                                                     axis=0))
                     for k in ("rows_caps", "seg_caps")})
    return _stack([b for b, _ in steps]), static, steps[0][1]


def test_train_step_scan_matches_jax(weights, scan_scene):
    params, stats = weights
    batches, static, hs = scan_scene
    js, ts = _settings(static, hs)
    tx = optax.chain(optax.clip(40.0), optax.adam(LR))
    jp, jbn, jopt, jst = j_step.train_step_scan(
        params, stats, tx.init(params), jax.tree.map(jnp.asarray, batches),
        jax.random.split(jax.random.PRNGKey(0), G), js, tx)

    tp, tbn = params_from_jax(params, stats)
    opt = t_opt.build_optimizer(tp, t_opt.make_lr_schedule(LR, "multi_step"))
    tbn, tst = t_step.train_step_scan(tp, tbn, opt, batches, ts,
                                      device="cpu")
    assert tst["loss"].shape == (G,)
    np.testing.assert_allclose(tst["loss"].numpy(), np.asarray(jst["loss"]),
                               rtol=1e-5)
    assert opt.count == int(jopt[1][0].count) == G
    d = _param_diffs(jp, tp)
    assert d.mean() <= 0.01 * LR * G
    assert d.max() <= LR * G
    _compare_moments(jopt[1][0], opt, 5e-2)
    for (path, j), (_, t) in zip(_flat(jbn), _flat(tbn)):
        _close_to_scale(t, j, 1e-2, 1e-5, what=path)


def test_train_step_scan_is_train_steps_on_the_cpu(weights, scan_scene):
    batches, static, hs = scan_scene
    _, ts = _settings(static, hs)
    runs = []
    for scan in (True, False):
        tp, tbn = params_from_jax(*weights)
        opt = t_opt.build_optimizer(tp, lambda t: LR * 0.9 ** t)
        if scan:
            tbn, st = t_step.train_step_scan(tp, tbn, opt, batches, ts,
                                             device="cpu")
        else:
            tbn, st = t_step.train_steps(
                tp, tbn, opt, [t_step.scan_slice(batches, i)
                               for i in range(G)], ts, device="cpu")
        runs.append((tp, tbn, opt, st))
    (p1, b1, o1, s1), (p2, b2, o2, s2) = runs
    assert s1.keys() == s2.keys() and o1.count == o2.count == G
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k
    for (path, a), (_, b) in zip(_flat([p1, b1, o1.mu, o1.nu]),
                                 _flat([p2, b2, o2.mu, o2.nu])):
        assert torch.equal(a, b), path


def test_cached_constants_are_the_old_tensors():
    """The five constants that device code used to build from Python values
    on every call, against the torch.tensor formulas they replace."""
    rng = np.random.RandomState(0)
    ppts = torch.from_numpy(rng.randn(200, 3).astype(np.float32))
    bounds = torch.from_numpy(rng.randn(2, 3).astype(np.float32))
    vs, out_sh = (VOX, 0.015, VOX), (32, 96, 32)
    rev = [2, 1, 0]
    dhw = (ppts[..., rev] - bounds[0][rev]) / torch.tensor(vs,
                                                           dtype=ppts.dtype)
    assert torch.equal(t_lx.get_dhw_vox(ppts, bounds, vs), dhw)
    gc = (dhw / torch.tensor(out_sh, dtype=dhw.dtype) * 2.0 - 1.0)[..., rev]
    assert torch.equal(t_lx.get_grid_coords(ppts, bounds, vs, out_sh), gc)

    zf = torch.from_numpy(rng.randint(0, 65536, (16, 8)).astype(np.int32))
    near = torch.from_numpy(rng.uniform(1, 2, 16).astype(np.float32))
    far = near + torch.from_numpy(rng.uniform(0.5, 2, 16).astype(np.float32))
    z = near[:, None] + (far - near)[:, None] * (
        zf.float() * torch.tensor(1.0 / 65535.0, dtype=torch.float32))
    assert torch.equal(t_hat.decode_z(zf, near, far), z)

    # hat_interpolate's level positions: dhw * ((sh_l - 1) / out_sh)
    caps, C, ngrp, P, capR = (40, 30, 20, 10), (32, 64, 128, 128), 3, 8, 12
    feats = [torch.from_numpy(rng.randn(s, c).astype(np.float32))
             for s, c in zip(caps, C)]
    geom = {f"sites{l}": torch.from_numpy(
        rng.randint(0, 16, (s, 3)).astype(np.int32))
        for l, s in enumerate(caps, 1)}
    rows = {l: torch.from_numpy(rng.randint(0, s + 1, (ngrp, capR))
                                .astype(np.int32))
            for l, s in enumerate(caps, 1)}
    grouped = torch.from_numpy(rng.uniform(0, 30, (ngrp, P, 3))
                               .astype(np.float32))
    static = t_lx.ModelStatic(encoder=EncoderStatic(
        out_sh=out_sh, site_caps=(64,) + caps))
    old_sh = torch.tensor(out_sh, dtype=torch.float32)
    want = torch.cat([hat_kernel.hat_interp_level_plain(
        f, geom[f"sites{l}"], rows[l],
        grouped * ((torch.tensor([s // 2 ** l for s in out_sh],
                                 dtype=torch.float32) - 1.0) / old_sh))
        for l, f in enumerate(feats, 1)], dim=-1)
    assert torch.equal(t_hat.hat_interpolate(feats, geom, rows, grouped,
                                             static), want)
    cpu = torch.device("cpu")
    assert constant(out_sh, torch.float32, cpu) is constant(
        out_sh, torch.float32, "cpu")


def _host_traffic(fn):
    """The operations fn() runs that on the card move data between host and
    device: a tensor made from Python data (aten::lift_fresh: torch.tensor
    or indexing with a list, a blocking host-to-device copy) and a value
    read back to the host (aten::item: .item(), indexing with a 0-d tensor,
    a test inside an operator's backward; a device sync). A CUDA graph can
    capture neither. Read from torch.profiler, which sees the operators'
    backward and the C++ calls too."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()
            if e.name in ("aten::lift_fresh", "aten::item",
                          "aten::_local_scalar_dense")]


def test_second_train_step_builds_no_tensor(weights, monkeypatch):
    """After a first step, a CPU train_step on a tensor batch builds no
    tensor from a Python value and reads none back, and neither does an
    eval_step render (on the card each is a blocking copy, and a CUDA graph
    cannot capture one)."""
    batch, static, hs = _scene(1)
    _, ts = _settings(static, hs)
    tp, tbn = params_from_jax(*weights)
    opt = t_opt.build_optimizer(tp, lambda t: LR)
    tb = to_device(batch, "cpu")
    tbn, _ = t_step.train_step(tp, tbn, opt, tb, ts, device="cpu")
    built, real = [], torch.tensor

    def counting(*args, **kwargs):
        built.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "tensor", counting)
    traffic = _host_traffic(lambda: (
        t_step.train_step(tp, tbn, opt, tb, ts, device="cpu"),
        t_step.eval_step(tp, tb, ts, device="cpu")))
    assert built == [] and traffic == []


def _float_adam_step(opt, params, grads):
    """Adam's update with its per-step numbers as Python floats: the
    arithmetic the optimizer had before its scalars became a tensor."""
    p, g = t_opt.tree_leaves(params), t_opt.tree_leaves(grads)
    m, v = t_opt.tree_leaves(opt.mu), t_opt.tree_leaves(opt.nu)
    lr = opt.schedule(opt.count)
    opt.count += 1
    g = [x.clamp(-opt.clip, opt.clip) for x in g]
    if opt.weight_decay > 0:
        torch._foreach_add_(g, p, alpha=opt.weight_decay)
    torch._foreach_mul_(m, opt.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - opt.b1))
    torch._foreach_mul_(v, opt.b2)
    torch._foreach_add_(v, torch._foreach_mul(
        torch._foreach_mul(g, g), 1.0 - opt.b2))
    den = torch._foreach_div(v, 1.0 - opt.b2 ** opt.count)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, opt.eps)
    upd = torch._foreach_div(m, 1.0 - opt.b1 ** opt.count)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(p, upd)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_device_scalars_match_the_float_step(weight_decay):
    """Seventy steps under a schedule that changes every step (past the end
    of the optimizer's first table of scalars): the Python-float
    arithmetic, the optimizer's own step (its table) and steps given the
    rows of one scalars() table made before the first. Bit for bit."""
    rng = np.random.RandomState(11)

    def params():
        r = np.random.RandomState(5)
        return {"a": torch.from_numpy(r.randn(6, 5).astype(np.float32)),
                "b": [{"w": torch.from_numpy(r.randn(9).astype(np.float32))}]}

    def schedule(t):
        return 1e-2 * 0.97 ** t + 1e-4 * t

    n = t_opt.Adam.TABLE_STEPS + 6
    runs = [params() for _ in range(3)]
    opts = [t_opt.build_optimizer(p, schedule, weight_decay=weight_decay)
            for p in runs]
    table = opts[2].scalars(n)
    assert table.dtype == torch.float32 and table.shape == (n, 3)
    for i in range(n):
        g = t_opt.tree_map(lambda p: torch.from_numpy(
            (rng.randn(*p.shape) * 30).astype(np.float32)), runs[0])
        with torch.no_grad():
            _float_adam_step(opts[0], runs[0], g)
        opts[1].step(runs[1], g)
        opts[2].step(runs[2], g, scalars=table[i])
    assert [o.count for o in opts] == [n] * 3
    for k in (1, 2):
        for (path, a), (_, b) in zip(
                _flat([runs[0], opts[0].mu, opts[0].nu]),
                _flat([runs[k], opts[k].mu, opts[k].nu])):
            assert torch.equal(a, b), (k, path)


def test_load_state_dict_keeps_the_tensors():
    p = {"a": torch.zeros(4, 3), "b": [{"w": torch.zeros(5)}]}
    opt = t_opt.build_optimizer(p, lambda t: LR)
    before = [t.data_ptr() for t in t_opt.tree_leaves([opt.mu, opt.nu])]
    state = {"mu": t_opt.tree_map(lambda t: torch.rand(t.shape), p),
             "nu": t_opt.tree_map(lambda t: torch.rand(t.shape), p),
             "count": 7}
    opt.load_state_dict(state)
    assert opt.count == 7
    assert [t.data_ptr()
            for t in t_opt.tree_leaves([opt.mu, opt.nu])] == before
    for (path, a), (_, b) in zip(_flat([opt.mu, opt.nu]),
                                 _flat([state["mu"], state["nu"]])):
        assert torch.equal(a, b), path
    with pytest.raises(ValueError, match="structure"):
        opt.load_state_dict(dict(state, mu={"a": torch.zeros(4, 3)}))


@pytest.mark.parametrize("cls", [graphs.StepGraph, graphs.RenderGraph])
def test_graphs_raise_on_the_cpu(cls):
    with pytest.raises(ValueError, match="CUDA device"):
        cls(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()


def test_bench_broadcast_on_the_cpu():
    out = bench.measure_broadcast(device="cpu", n_verts=500, voxel=0.02,
                                  n_rays=16, n_iters=1)
    assert all(v > 0 for k, v in out.items() if k in (
        "broadcast_rays_per_s", "eager_broadcast_rays_per_s",
        "hat_render_eager_rays_per_s"))
    line = bench.summary(out, out)
    assert set(bench.BENCH_KEYS) <= line.keys()
    assert line.keys() == set(bench.BENCH_KEYS) | {
        "card", "steps_per_dispatch", "eager_broadcast_rays_per_s",
        "hat_render_graph_rays_per_s", "hat_render_eager_rays_per_s",
        "device_busy_share", "fresh_device_busy_share",
        "fresh_h2d_bytes_per_dispatch"}
    for k in ("value", "vs_baseline", "fresh_over_broadcast", "card",
              "hat_render_graph_rays_per_s", "device_busy_share",
              "fresh_device_busy_share", "fresh_h2d_bytes_per_dispatch"):
        assert line[k] is None, k
    assert line["steps_per_dispatch"] == bench.G
