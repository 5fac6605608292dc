"""The device geometry bank (parallel/geom.py), the banked scan step
(train/step.train_step_scan_banked), the prefetcher and its staging ring
(parallel/transfer.py) and the busy share of a trace
(tools/trace_loss.busy_share), on the CPU. The scene is
tests/test_torch_scan.py's: 64 rays x 8 samples, 500 vertices, 2 cm voxels,
G = 3 perturbed plans of one frame.

Tolerances, and why:
  * the port's train_step_scan_banked against the JAX package's, the same
    frames installed in both banks (a decoy frame in row 0, the scene's in
    row 1) and the weights carried over by utils/transplant.params_from_jax:
    test_torch_scan.py's tolerances for train_step_scan (the loss of every
    step at rtol 1e-5; the params within a mean of 0.01 * lr * steps and a
    maximum of lr * steps; the Adam moments within 5e-2 and the BN running
    stats within 1e-2 of scale), for the reason its docstring gives: the
    random-weight model's gradients are ill-conditioned and free-running
    steps drift apart.
  * Everything else is bit for bit: the bank's rows hold the host's int32
    tables, and the banked steps on the CPU run the stacked steps' loop on
    the same numbers.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralbody_tpu.parallel.geom import GeomBank as JGeomBank
from neuralbody_tpu.train import step as j_step
from neuralbody_tpu_torch.parallel import geom, transfer
from neuralbody_tpu_torch.tools import trace_loss
from neuralbody_tpu_torch.train import optimizer as t_opt
from neuralbody_tpu_torch.train import step as t_step
from neuralbody_tpu_torch.utils.transplant import params_from_jax
from test_torch_scan import G, scan_scene  # noqa: F401  (fixture)
from test_torch_train import (LR, _close_to_scale, _compare_moments, _flat,
                              _param_diffs, _settings, weights)  # noqa: F401

torch.set_num_threads(1)

DECOY, FRAME = 9, 3   # frame keys: rows 0 and 1 of both banks


def _frames(batches):
    """{key: frame tables}: the scene's frame and a decoy of its shapes."""
    frame = {n: np.asarray(v[0, 0]) for n, v in batches["geom"].items()}
    return {DECOY: {n: (v + 7).astype(np.int32) for n, v in frame.items()},
            FRAME: frame}


def _banked(batches):
    """The batches with geom_rows [G, 1] in place of geom."""
    out = {k: v for k, v in batches.items() if k != "geom"}
    out["geom_rows"] = np.ones((G, 1), np.int64)
    return out


def test_bank_installs_each_frame_once_and_takes_exactly(scan_scene):
    frames = _frames(scan_scene[0])
    bank = geom.GeomBank(frames, capacity=3, device="cpu")
    rows = bank.rows([[DECOY, DECOY], [FRAME, DECOY]])
    assert rows.dtype == np.int64 and rows.tolist() == [[0, 0], [1, 0]]
    assert bank.installs == 2 and bank.storage.shape[0] == 3
    ptr = bank.storage.data_ptr()
    assert bank.rows([[FRAME]] * 4).tolist() == [[1]] * 4
    assert bank.installs == 2 and bank.storage.data_ptr() == ptr
    assert bank.nbytes == 3 * bank.width * 4
    for name, off, _ in bank.layout:
        assert off % geom.ALIGN == 0, name
    for keys in ([FRAME], [DECOY, FRAME]):
        got = geom.take(bank, torch.as_tensor(bank.rows([keys])[0]))
        assert sorted(got) == sorted(frames[FRAME])
        for n, v in got.items():
            assert v.dtype == torch.int32, n
            np.testing.assert_array_equal(
                v.numpy(), np.stack([frames[k][n] for k in keys]), err_msg=n)
    one = geom.take(bank, torch.tensor([1]))
    assert all(v.is_contiguous() and v._base is not None
               for v in one.values())


def test_bank_raises_on_overflow_and_on_a_leaf_not_int32(scan_scene):
    frames = _frames(scan_scene[0])
    frames[5] = frames[FRAME]
    bank = geom.GeomBank(frames, capacity=2, device="cpu")
    bank.rows([[DECOY, FRAME]])
    with pytest.raises(ValueError, match="overflow"):
        bank.rows([[5]])
    name = sorted(frames[FRAME])[1]
    bad = dict(frames[FRAME], **{name: frames[FRAME][name].astype(np.int64)})
    with pytest.raises(ValueError, match=name):
        geom.GeomBank({0: bad}, capacity=2, device="cpu").rows([[0]])
    bank = geom.GeomBank({0: frames[FRAME], 1: bad}, capacity=2,
                         device="cpu")
    bank.rows([[0]])
    with pytest.raises(ValueError, match="int32"):
        bank.rows([[1]])


def test_bank_capacity_is_the_jax_trainers_rule():
    class DS:
        num_cams = 4

        def __len__(self):
            return 16
    assert geom.bank_capacity(DS()) == 2 + 4
    ds = DS()
    ds.num_geoms = 60
    assert geom.bank_capacity(ds) == 60


def test_banked_scan_matches_jax(weights, scan_scene):
    params, stats = weights
    batches, static, hs = scan_scene
    frames = _frames(batches)
    js, ts = _settings(static, hs)
    tx = optax.chain(optax.clip(40.0), optax.adam(LR))
    jbank = JGeomBank(frames, capacity=2)
    jbank.rows([[DECOY]])
    bank_arrays, jrows = jbank.rows([[FRAME]] * G)
    jb = {k: jnp.asarray(v) for k, v in batches.items() if k != "geom"}
    jb["geom_rows"] = jrows
    jp, jbn, jopt, jst = j_step.train_step_scan_banked(
        params, stats, tx.init(params), jb,
        jax.random.split(jax.random.PRNGKey(0), G), bank_arrays, js, tx)

    bank = geom.GeomBank(frames, capacity=2, device="cpu")
    bank.rows([[DECOY]])
    tb = _banked(batches)
    tb["geom_rows"] = bank.rows([[FRAME]] * G)
    np.testing.assert_array_equal(tb["geom_rows"], np.asarray(jrows))
    tp, tbn = params_from_jax(params, stats)
    opt = t_opt.make_optimizer(tp, t_opt.make_lr_schedule(LR, "multi_step"))
    tbn, tst = t_step.train_step_scan_banked(tp, tbn, opt, tb, bank, ts,
                                             device="cpu")
    assert tst["loss"].shape == (G,) and opt.count == G
    np.testing.assert_allclose(tst["loss"].numpy(), np.asarray(jst["loss"]),
                               rtol=1e-5)
    d = _param_diffs(jp, tp)
    assert d.mean() <= 0.01 * LR * G
    assert d.max() <= LR * G
    _compare_moments(jopt[1][0], opt, 5e-2)
    for (path, j), (_, t) in zip(_flat(jbn), _flat(tbn)):
        _close_to_scale(t, j, 1e-2, 1e-5, what=path)


def test_banked_scan_is_the_stacked_scan_on_the_cpu(weights, scan_scene):
    batches, static, hs = scan_scene
    _, ts = _settings(static, hs)
    bank = geom.GeomBank(_frames(batches), capacity=2, device="cpu")
    bank.rows([[DECOY], [FRAME]])
    runs = []
    for banked in (True, False):
        tp, tbn = params_from_jax(*weights)
        opt = t_opt.make_optimizer(tp, lambda t: LR * 0.9 ** t)
        if banked:
            tbn, st = t_step.train_step_scan_banked(
                tp, tbn, opt, _banked(batches), bank, ts, device="cpu")
        else:
            tbn, st = t_step.train_step_scan(tp, tbn, opt, batches, ts,
                                             device="cpu")
        runs.append((tp, tbn, opt, st))
    (p1, b1, o1, s1), (p2, b2, o2, s2) = runs
    assert s1.keys() == s2.keys() and o1.count == o2.count == G
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k
    for (path, a), (_, b) in zip(_flat([p1, b1, o1.mu, o1.nu]),
                                 _flat([p2, b2, o2.mu, o2.nu])):
        assert torch.equal(a, b), path


# -- the prefetcher and the staging ring -------------------------------------

def test_prefetcher_keeps_order_and_bounds_what_waits():
    depth, started, gate = 2, [], threading.Event()

    def prep(i):
        started.append(i)
        gate.wait(timeout=10)
        return i * i

    pf = transfer.DevicePrefetcher(prep, depth=depth)
    done = threading.Event()

    def submit_all():
        for i in range(6):
            pf.submit(i)
        done.set()
    t = threading.Thread(target=submit_all, daemon=True)
    t.start()
    time.sleep(0.3)
    # one item in prep, `depth` waiting, the submitter blocked
    assert started == [0] and not done.is_set()
    assert pf._in.qsize() == depth
    assert list(pf.ready()) == []
    gate.set()
    t.join(timeout=10)
    assert done.is_set()
    assert list(pf.drain()) == [i * i for i in range(6)]
    pf.close()
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("where", ["ready", "drain"])
def test_prefetcher_raises_a_prep_error_on_the_callers_thread(where):
    def prep(i):
        if i == 1:
            raise KeyError("prep failed")
        return i

    pf = transfer.DevicePrefetcher(prep, depth=2)
    pf.submit(0)
    pf.submit(1)
    with pytest.raises(KeyError, match="prep failed"):
        if where == "ready":
            deadline = time.time() + 10
            got = []
            while time.time() < deadline:
                got += list(pf.ready())
                time.sleep(0.01)
        else:
            list(pf.drain())
    pf.close()
    assert not pf._thread.is_alive()


def _group(rng, n):
    return [{"a": rng.randint(0, 60000, (1, 5)).astype(np.uint16),
             "f": rng.randn(1, 3),
             "sub": {"x": rng.randn(2).astype(np.float32)}}
            for _ in range(n)]


def test_staging_ring_reuses_its_sets_on_the_cpu():
    """A ring of 2 sets over 6 groups: each staged tree equals its group
    (uint16 -> int32, float64 -> float32, as to_device), the sets are
    reused, and a set is not restaged before it is consumed."""
    rng = np.random.RandomState(0)
    ring = transfer.StagingRing("cpu", size=2)
    seen = set()
    for n in range(6):
        group = _group(rng, 3)
        st = ring.stage(group, before=lambda: {"r": np.full((3, 1), n)})
        assert isinstance(st, transfer.Staged)
        assert st["a"].dtype == torch.int32 and st["f"].dtype == torch.float32
        np.testing.assert_array_equal(st["a"].numpy(),
                                      np.stack([g["a"] for g in group]))
        np.testing.assert_array_equal(
            st["f"].numpy(), np.stack([g["f"] for g in group]).astype(
                np.float32))
        np.testing.assert_array_equal(
            st["sub"]["x"].numpy(), np.stack([g["sub"]["x"] for g in group]))
        assert st["r"].dtype == torch.int64 and (st["r"] == n).all()
        seen.add(st["a"].data_ptr())
        st.consumed()
    assert len(seen) == 2 and ring.copies == 6 and ring.leaves == 4
    assert ring.set_bytes == 3 * (5 * 4 + 3 * 4 + 2 * 4) + 3 * 8


def test_staging_ring_waits_for_a_consumed_set_and_close_wakes_it():
    rng = np.random.RandomState(1)
    ring = transfer.StagingRing("cpu", size=2)
    held = [ring.stage(_group(rng, 2)), ring.stage(_group(rng, 2))]
    got = []
    t = threading.Thread(target=lambda: got.append(ring.stage(
        _group(rng, 2))), daemon=True)
    t.start()
    time.sleep(0.2)
    assert t.is_alive() and not got     # both sets still held
    held[0].consumed()
    t.join(timeout=10)
    assert not t.is_alive() and got[0]["a"].data_ptr() == held[0][
        "a"].data_ptr()
    errors = []

    def blocked():
        try:
            ring.stage(_group(rng, 2))
        except RuntimeError as e:
            errors.append(e)
    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    time.sleep(0.2)
    ring.close()
    t.join(timeout=10)
    assert not t.is_alive() and "closed" in str(errors[0])
    ring.reopen()
    ring.stage(_group(rng, 2)).consumed()


# -- the busy share ----------------------------------------------------------

def test_busy_share_is_the_interval_union():
    """Two streams: kernels on one, copies on the other overlapping them.
    Summed durations (65) exceed the span (55); the union is 45."""
    ev = [{"ts": 0, "dur": 10}, {"ts": 10, "dur": 20},    # main: 0-30
          {"ts": 5, "dur": 15}, {"ts": 25, "dur": 10},    # side: 5-20, 25-35
          {"ts": 45, "dur": 10},                          # main: 45-55
          {"ts": 47, "dur": 0}]                           # a zero-length one
    busy, span, share = trace_loss.busy_share(ev)
    assert sum(e["dur"] for e in ev) == 65 > span
    assert (busy, span) == (35 + 10, 55) and share == pytest.approx(45 / 55)
    assert share <= 1
    assert trace_loss.busy_share(ev[:1]) == (10, 10, 1.0)
    with pytest.raises(ValueError):
        trace_loss.busy_share([])
