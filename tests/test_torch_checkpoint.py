"""Checkpoints, optimizers and the smaller harness modules on the CPU
against the JAX package: train/checkpoint.py (its msgpack codec against
flax.serialization, files either package writes resumed by the other's
Trainer for adam with and without weight decay, radam and sgd, pruning),
train/optimizer.py (radam and sgd against optax, the cfg-driven
make_optimizer and schedules), utils/transplant (the reference .pth and
sgd's state), utils/profiling.

Tolerances: checkpoints are bit for bit (the same bytes of the same
arrays); radam and sgd against optax on the same gradients at rtol 1e-6
for the state and rtol 1e-6 / atol 1e-6 for the parameters (size ~1), as
tests/test_torch_train.py holds Adam (radam's per-step scalars are f32 as
in optax; the parameters differ by the f32 rounding of the learning-rate
products).
"""
import os

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import neuralbody_tpu.train.trainer as j_trainer
from neuralbody_tpu.config import make_cfg as j_make_cfg
from neuralbody_tpu.train import optimizer as j_opt
from neuralbody_tpu.utils import transplant as j_transplant
from neuralbody_tpu_torch.config import make_cfg as t_make_cfg
from neuralbody_tpu_torch.config.node import CfgNode
from neuralbody_tpu_torch.train import checkpoint, optimizer as t_opt
from neuralbody_tpu_torch.train import trainer as t_trainer
from neuralbody_tpu_torch.train.optimizer import tree_leaves
from neuralbody_tpu_torch.utils import profiling, transplant
from test_torch_harness import harness_cfg
from test_torch_train import _flat

torch.set_num_threads(1)

OPTIMIZERS = {"adam": ("adam", "0"), "adam_wd": ("adam", "1e-3"),
              "radam": ("radam", "0"), "sgd": ("sgd", "0")}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    from fake_data import make_fake_zju
    return {pkg: make_fake_zju(str(tmp_path_factory.mktemp(pkg)
                                   / "CoreView_999"))
            for pkg in ("jax", "torch")}


def _opts(name):
    optim, wd = OPTIMIZERS[name]
    return ["train.optim", optim, "train.weight_decay", wd]


def _grads(tree, rng):
    return jax.tree.map(
        lambda x: (rng.randn(*np.shape(x)) * 30).astype(np.float32), tree)


# -- the codec -------------------------------------------------------------

def test_codec_matches_flax():
    """Every msgpack form a checkpoint uses, both ways: the port's bytes
    through flax's reader, flax's through the port's."""
    tree = {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
        "strided": np.arange(12, dtype=np.float64).reshape(3, 4).T,
        "count": np.asarray(7, np.int32),
        "fixext16": np.array([5], np.uint32),        # a 16-byte payload
        "big": np.random.RandomState(0).randn(70000).astype(np.float32),
        "ints": {"small": 3, "neg": -5, "wide": 1 << 40, "negwide": -1000},
        "words": {"s": "x" * 40, "u": "é"}, "flag": True, "nil": None,
        "pi": 3.25, "list": {"0": {}, "1": {"count": np.asarray(1,
                                                                np.int32)}},
        "many": {str(i): i for i in range(20)},
    }
    ours = checkpoint.packb(tree)
    theirs = serialization.msgpack_serialize(tree)
    for back in (serialization.msgpack_restore(ours),
                 checkpoint.unpackb(theirs), checkpoint.unpackb(ours)):
        for (p, a), (_, b) in zip(_flat(back), _flat(tree)):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape, p
                np.testing.assert_array_equal(a, b, err_msg=p)
            else:
                assert a == b, p


def test_codec_refuses_what_a_checkpoint_has_not():
    with pytest.raises(TypeError):
        checkpoint.packb({1: 2})
    with pytest.raises(ValueError):
        checkpoint.unpackb(bytes([0xc1]))
    with pytest.raises(ValueError):
        checkpoint.unpackb(checkpoint.packb([1, 2])[:-1])


# -- files across the packages ---------------------------------------------

@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_jax_checkpoint_resumes_the_port(roots, tmp_path, name):
    """A JAX Trainer's state after three optimizer updates, saved by the
    JAX package, resumes the port's Trainer to the same values."""
    rng = np.random.RandomState(1)
    jt = j_trainer.Trainer(harness_cfg(j_make_cfg, roots["jax"], tmp_path,
                                  opts=_opts(name)))
    params, state = jt.params, jt.opt_state
    for _ in range(3):
        upd, state = jt.tx.update(_grads(params, rng), state, params)
        params = optax.apply_updates(params, upd)
    jt.params, jt.opt_state = params, state
    jt.bn_stats = jax.tree.map(
        lambda x: rng.rand(*np.shape(x)).astype(np.float32), jt.bn_stats)
    jt.recorder.step, jt.recorder.epoch = 12, 2
    jt.save(2, latest=True)

    tt = t_trainer.Trainer(harness_cfg(t_make_cfg, roots["torch"], tmp_path,
                                       opts=_opts(name)), device="cpu")
    assert tt.resume() == 3
    assert tt.recorder.step == 12 and tt.opt.count == 3
    want = serialization.to_state_dict(
        jax.tree.map(np.asarray, {"params": jt.params, "bn": jt.bn_stats,
                                  "opt": jt.opt_state}))
    got = {"params": checkpoint.state_dict(tt.params),
           "bn": checkpoint.state_dict(tt.bn_stats),
           "opt": checkpoint.opt_state_dict(tt.opt)}
    assert [p for p, _ in _flat(got)] == [p for p, _ in _flat(want)]
    for (p, a), (_, b) in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_port_checkpoint_resumes_jax(roots, tmp_path, name):
    """The port's Trainer after three optimizer steps, saved by the port,
    restores through flax's msgpack_restore and from_state_dict into the
    JAX Trainer's templates bit for bit (the JAX Trainer's own resume)."""
    rng = np.random.RandomState(2)
    tt = t_trainer.Trainer(harness_cfg(t_make_cfg, roots["torch"], tmp_path,
                                       opts=_opts(name)), device="cpu")
    for _ in range(3):
        tt.opt.step(tt.params, t_opt.tree_map(lambda x: torch.from_numpy(
            (rng.randn(*x.shape) * 30).astype(np.float32)), tt.params))
    with torch.no_grad():
        for x in tree_leaves(tt.bn_stats):
            x.copy_(torch.rand(x.shape, generator=torch.Generator()
                               .manual_seed(x.numel())))
    tt.recorder.step = 12
    tt.save(2)

    jt = j_trainer.Trainer(harness_cfg(j_make_cfg, roots["jax"], tmp_path,
                                  opts=_opts(name)))
    assert jt.resume() == 3 and jt.recorder.step == 12
    got = serialization.to_state_dict(jax.tree.map(np.asarray, {
        "params": jt.params, "bn": jt.bn_stats, "opt": jt.opt_state}))
    want = {"params": checkpoint.state_dict(tt.params),
            "bn": checkpoint.state_dict(tt.bn_stats),
            "opt": checkpoint.opt_state_dict(tt.opt)}
    assert [p for p, _ in _flat(got)] == [p for p, _ in _flat(want)]
    for (p, a), (_, b) in zip(_flat(got), _flat(want)):
        assert np.asarray(a).dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)
    # the JAX chain's own state for this optimizer has this layout
    template = serialization.to_state_dict(jax.tree.map(
        np.asarray, j_opt.make_optimizer(jt.cfg)[0].init(jt.params)))
    assert ([p for p, _ in _flat(template)]
            == [p for p, _ in _flat(want["opt"])])


def test_resume_keeps_the_tensors(tmp_path):
    """A load copies into the tensors it is given: their addresses stay."""
    params = {"w": torch.ones(3), "l": [{"b": torch.zeros(2)}]}
    opt = t_opt.build_optimizer(params, lambda t: 1e-2)
    opt.step(params, {"w": torch.ones(3), "l": [{"b": torch.ones(2)}]})
    checkpoint.save_checkpoint(str(tmp_path), 0, params, {}, opt,
                               latest=True)
    fresh = {"w": torch.zeros(3), "l": [{"b": torch.ones(2)}]}
    fopt = t_opt.build_optimizer(fresh, lambda t: 1e-2)
    ptrs = [t.data_ptr() for t in tree_leaves([fresh, fopt.mu, fopt.nu])]
    rec, begin = checkpoint.load_checkpoint(str(tmp_path), fresh, {}, fopt)
    assert begin == 1 and rec == {} and fopt.count == 1
    assert [t.data_ptr() for t in tree_leaves([fresh, fopt.mu,
                                               fopt.nu])] == ptrs
    for a, b in zip(tree_leaves([params, opt.mu, opt.nu]),
                    tree_leaves([fresh, fopt.mu, fopt.nu])):
        assert torch.equal(a, b)
    assert checkpoint.load_params(str(tmp_path), fresh, {}) == 1
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_params(str(tmp_path), {"w": torch.zeros(4), "l": [
            {"b": torch.zeros(2)}]}, {})


def test_prune_keeps_20(tmp_path):
    model_dir = str(tmp_path / "ckpts")
    params = {"w": torch.zeros(3)}
    opt = t_opt.build_optimizer(params, lambda t: 1e-3)
    for ep in range(25):
        checkpoint.save_checkpoint(model_dir, ep, params, {}, opt, keep=20)
    numbered = [f for f in os.listdir(model_dir) if f != "latest.ckpt"]
    assert len(numbered) == 20
    assert "0.ckpt" not in numbered and "24.ckpt" in numbered
    assert not any(f.endswith(".tmp") for f in os.listdir(model_dir))
    assert checkpoint._pick(model_dir, -1).endswith("24.ckpt")
    assert checkpoint._pick(model_dir, 3) is None
    assert checkpoint._pick(str(tmp_path / "none"), -1) is None


# -- the optimizers --------------------------------------------------------

def _against_optax(optim, weight_decay, steps):
    """`steps` steps of the port's optimizer and of the JAX package's chain
    for the same config on the same gradients (some beyond the clip at
    40): (JAX params, port params, JAX state dict, port state dict)."""
    rng = np.random.RandomState(9)
    params = {"a": rng.randn(5, 4).astype(np.float32),
              "b": [{"w": rng.randn(7).astype(np.float32)}]}
    opts = ["task", "t", "exp_name", "e", "train.optim", optim,
            "train.weight_decay", str(weight_decay), "train.lr", "1e-2",
            "ep_iter", "2"]
    tx, _ = j_opt.make_optimizer(j_make_cfg(opts=opts))
    jp, jst = params, tx.init(params)
    tp, _ = transplant.params_from_jax(params, {})
    opt, _ = t_opt.make_optimizer(t_make_cfg(opts=opts), tp)
    for _ in range(steps):
        g = _grads(params, rng)
        u, jst = tx.update(g, jst, jp)
        jp = optax.apply_updates(jp, u)
        opt.step(tp, transplant.params_from_jax(g, {})[0])
    return (jp, tp, serialization.to_state_dict(jax.tree.map(np.asarray,
                                                             jst)),
            checkpoint.opt_state_dict(opt))


@pytest.mark.parametrize("optim,weight_decay", [
    ("radam", 0.0), ("radam", 1e-2), ("sgd", 0.0)])
def test_optimizer_matches_optax(optim, weight_decay):
    """radam (unrectified in these 5 steps) and sgd against optax."""
    jp, tp, want, state = _against_optax(optim, weight_decay, 5)
    for (path, j), (_, t) in zip(_flat(jp), _flat(tp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6, err_msg=path)
    for (path, t), (_, j) in zip(_flat(state), _flat(want)):
        np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=path)


def test_radam_rectified_steps_match_optax():
    """9 radam steps: the rectification starts at step 6. The moments at
    rtol 1e-6; each rectified step's r comes from ro = ro_inf - 2t b2^t /
    (1 - b2^t), ~2000 less ~1995 in f32, so one ulp of the f32 power b2^t
    (XLA's and the port's differ by 1-3 ulps at small t) moves r by ~1%:
    the parameters within 2e-2 * lr per rectified step."""
    jp, tp, want, state = _against_optax("radam", 0.0, 9)
    for (path, t), (_, j) in zip(_flat(state), _flat(want)):
        np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=path)
    for (path, j), (_, t) in zip(_flat(jp), _flat(tp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=2e-2 * 1e-2 * 4, err_msg=path)


def test_make_optimizer_from_cfg():
    p = {"w": torch.zeros(3)}
    for optim, cls in (("adam", t_opt.Adam), ("radam", t_opt.RAdam),
                       ("sgd", t_opt.SGD)):
        cfg = t_make_cfg(opts=["task", "t", "exp_name", "e", "train.optim",
                               optim, "train.lr", "2e-3"])
        opt, schedule = t_opt.make_optimizer(cfg, p)
        assert type(opt) is cls and schedule(0) == pytest.approx(2e-3)


def test_warmup_multi_step():
    cfg = t_make_cfg(opts=["task", "if_nerf", "exp_name", "t"])
    cfg.ep_iter = 10
    cfg.train.lr = 1e-3
    cfg.train.scheduler = CfgNode({
        "type": "warmup_multi_step", "milestones": [20, 40],
        "gamma": 0.1, "warmup_factor": 1.0 / 3, "warmup_iters": 5,
        "warmup_method": "linear"})
    sch = t_opt.lr_schedule_from_cfg(cfg)
    assert np.isclose(sch(0), 1e-3 / 3)
    assert np.isclose(sch(10 * 10), 1e-3)
    assert np.isclose(sch(25 * 10), 1e-4)
    assert np.isclose(sch(45 * 10), 1e-5)


def test_opt_state_from_jax_takes_sgd_and_adam():
    params = {"a": np.ones((2, 3), np.float32)}
    rng = np.random.RandomState(3)
    for optim in ("sgd", "adam"):
        cfg = j_make_cfg(opts=["task", "t", "exp_name", "e",
                               "train.optim", optim])
        tx, _ = j_opt.make_optimizer(cfg)
        st = tx.init(params)
        for _ in range(2):
            _, st = tx.update(_grads(params, rng), st, params)
        got = transplant.opt_state_from_jax(st)
        assert got["count"] == 2
        key = "trace" if optim == "sgd" else "mu"
        opt = t_opt.build_optimizer(
            transplant.params_from_jax(params, {})[0], lambda t: 1e-3,
            optim=optim)
        opt.load_state_dict(got)
        assert opt.count == 2
        inner = st[-1][0]
        np.testing.assert_array_equal(
            getattr(opt, key)["a"].numpy(),
            np.asarray((inner.trace if optim == "sgd" else inner.mu)["a"]))


# -- the smaller modules ---------------------------------------------------

def test_transplant_from_pth(tmp_path, rng):
    """A reference-layout .pth maps into the port's params and BN stats as
    the JAX package maps it into its own."""
    from neuralbody_tpu.models import latent_xyzc as j_lx
    from neuralbody_tpu_torch.models import latent_xyzc as t_lx
    from test_transplant import make_reference_state_dict
    state = make_reference_state_dict(rng)
    path = str(tmp_path / "latest.pth")
    torch.save({"net": {f"module.{k}": torch.from_numpy(v)
                        for k, v in state.items()}, "epoch": 7}, path)
    jp, jbn = j_lx.init(jax.random.PRNGKey(0), num_train_frame=4, nv=300)
    jp, jbn, jep = j_transplant.transplant_from_pth(path, jp, jbn)
    tp, tbn = t_lx.init(torch.Generator().manual_seed(0),
                        num_train_frame=4, nv=300, device="cpu")
    tp, tbn, tep = transplant.transplant_from_pth(path, tp, tbn)
    assert tep == jep == 7
    for (p, a), (q, b) in zip(_flat([tp, tbn]), _flat([jp, jbn])):
        assert p == q
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=p)


class _Payload:
    """An object a weights-only load must refuse to build."""


def test_load_torch_checkpoint_reads_weights_only(tmp_path, rng):
    """The reference's whole .pth (net, optimizer, MultiStepLR, recorder,
    epoch) loads as weights only; a pickled object of any other class is
    refused instead of being built."""
    from test_transplant import make_reference_state_dict
    state = make_reference_state_dict(rng)
    net = {f"module.{k}": torch.from_numpy(v) for k, v in state.items()}
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(lin.parameters(), lr=5e-4)
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    sch = torch.optim.lr_scheduler.MultiStepLR(opt, [80, 120], gamma=0.5)
    path = str(tmp_path / "latest.pth")
    torch.save({"net": net, "optim": opt.state_dict(),
                "scheduler": sch.state_dict(), "recorder": {"step": 3},
                "epoch": 7}, path)
    got, epoch = transplant.load_torch_checkpoint(path)
    assert epoch == 7 and sorted(got) == sorted(net)
    for k, v in net.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    bad = str(tmp_path / "bad.pth")
    torch.save({"net": net, "extra": _Payload()}, bad)
    with pytest.raises(Exception, match="weights_only|Unsupported global"):
        transplant.load_torch_checkpoint(bad)


def test_profiling_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        assert '"matmul"' in f.read()
    profiling.enable_nan_checks()
    try:
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
