"""The port's loader (neuralbody_tpu_torch/datasets/loader.py) and its C++
hat planner (ops/hat_planner_native.py over csrc/hat_planner.cpp) against
the JAX package's, on tests/fake_data.py's ZJU tree at
tests/test_datasets.py's size.

Everything is bit for bit: for one seed every batch the port's
make_data_loader emits, with the thread iterator and with a pool of two
spawned workers over two epochs, equals the JAX loader's leaf for leaf, and
the derived hat_state is the same; the port's native plan equals its numpy
plan and the JAX package's native plan array for array.

This module imports neither JAX nor the JAX package at its top: a spawned
worker imports it to unpickle the probe datasets below, and the probe
reports what the worker has imported. The comparisons import them inside
the tests.
"""
import concurrent.futures
import os
import sys
import unittest.mock as mock

import numpy as np
import pytest
import torch

import neuralbody_tpu_torch.datasets  # noqa: F401  (registers plugins)
from neuralbody_tpu_torch.config import make_cfg as t_make_cfg
from neuralbody_tpu_torch.datasets import loader as t_loader
from neuralbody_tpu_torch.ops import hat_interp as t_hat
from neuralbody_tpu_torch.ops import hat_planner_native as t_native
from neuralbody_tpu_torch.utils import cuda_build
from neuralbody_tpu_torch.utils.synthetic import make_batch

torch.set_num_threads(1)

EP_ITER = 6
DEADLINE_S = 60   # a failing or dying worker raises in the parent by then


class ProbeDataset:
    """Rays of zeros; index 100 raises, index 200 kills its worker. Each
    sample reports what its process has imported and whether it sees a
    card."""

    def __len__(self):
        return 4

    def __getitem__(self, index):
        if index == 100:
            raise ValueError("probe dataset: index 100")
        if index == 200:
            os._exit(3)
        z = np.zeros((8, 3), np.float32)
        return {"rgb": z, "ray_o": z, "ray_d": z, "near": z[:, 0],
                "far": z[:, 0], "Th": np.zeros(3, np.float32),
                "imported": sorted(
                    m for m in sys.modules if m in ("jax", "neuralbody_tpu")
                    or m.startswith(("jax.", "neuralbody_tpu."))),
                "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "cuda_initialized": torch.cuda.is_initialized()}


def small_cfg(make_cfg, root):
    from test_torch_datasets import small_cfg as cfg_of
    cfg = cfg_of(make_cfg, root)
    cfg.ep_iter = EP_ITER
    cfg.perturb = 1
    return cfg


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    from fake_data import make_fake_zju
    return {pkg: make_fake_zju(str(tmp_path_factory.mktemp(pkg)
                                   / "CoreView_999"))
            for pkg in ("jax", "torch")}


@pytest.fixture(scope="module")
def jax_epochs(roots):
    """The JAX thread loader's batches and hat_state, epochs 0 and 1."""
    import neuralbody_tpu.datasets  # noqa: F401
    from neuralbody_tpu.config import make_cfg
    from neuralbody_tpu.datasets import loader
    cfg = small_cfg(make_cfg, roots["jax"])
    ds = loader.make_dataset(cfg, "train")
    out = []
    for epoch in (0, 1):
        hs = {}
        out.append((list(loader.make_data_loader(
            cfg, "train", dataset=ds, epoch=epoch, hat_state=hs)), hs))
    return out


def _assert_batches_equal(a, b, what):
    from test_torch_datasets import assert_same
    assert len(a) == len(b) == EP_ITER, what
    for bi, (x, y) in enumerate(zip(a, b)):
        assert_same(x, y, f"{what} batch {bi}")


def test_thread_loader_equals_jax(roots, jax_epochs):
    cfg = small_cfg(t_make_cfg, roots["torch"])
    ds = t_loader.make_dataset(cfg, "train")
    for epoch, (want, want_hs) in enumerate(jax_epochs):
        hs = {}
        got = list(t_loader.make_data_loader(cfg, "train", dataset=ds,
                                             epoch=epoch, hat_state=hs))
        assert hs == want_hs
        _assert_batches_equal(want, got, f"thread epoch {epoch}")


def test_geom_keys_loader_equals_jax(roots, jax_epochs):
    """attach_geom=False: the same batches without geometry, meta's
    geom_keys, and the frames' tables once in geom_cache."""
    cfg = small_cfg(t_make_cfg, roots["torch"])
    ds = t_loader.make_dataset(cfg, "train")
    cache = {}
    got = list(t_loader.make_data_loader(
        cfg, "train", dataset=ds, epoch=0, hat_state={},
        attach_geom=False, geom_cache=cache))
    for bi, ((jd, jm), (td, tm)) in enumerate(zip(jax_epochs[0][0], got)):
        assert "geom" not in td and tm["geom_keys"] == [int(jm["geom_key"])]
        for n, v in jd["geom"].items():
            np.testing.assert_array_equal(cache[tm["geom_keys"][0]][n], v[0],
                                          err_msg=f"batch {bi} geom {n}")
        for k in td:
            np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    assert len(cache) == 2


@pytest.mark.parametrize("attach_geom", [True, False])
def test_worker_pool_equals_jax(roots, jax_epochs, attach_geom):
    """Two spawned workers over two epochs: the JAX stream, the same
    hat_state, each frame's tables shipped to the parent once (with
    attach_geom=False the batches carry meta's geom_keys and the tables
    stay in the pool's geom_cache). The dataset has sampled rays in the
    parent first: its filled ray-pool caches travel to the workers."""
    cfg = small_cfg(t_make_cfg, roots["torch"])
    ds = t_loader.make_dataset(cfg, "train")
    ds[0]
    pool = t_loader.WorkerPool(ds, num_workers=2)
    try:
        for epoch, (want, want_hs) in enumerate(jax_epochs):
            hs = {}
            got = list(t_loader.make_data_loader(
                cfg, "train", dataset=ds, epoch=epoch, hat_state=hs,
                pool=pool, attach_geom=attach_geom))
            assert hs == want_hs
            if not attach_geom:
                for (jd, jm), (td, tm) in zip(want, got):
                    assert tm["geom_keys"] == [int(jm["geom_key"])]
                    td["geom"] = {n: v[None] for n, v in pool.geom_cache[
                        tm.pop("geom_keys")[0]].items()}
            _assert_batches_equal(want, got, f"pool epoch {epoch}")
        assert len(pool.geom_cache) == 2
    finally:
        pool.shutdown()
    assert not any(p.is_alive() for p in pool._procs)


def _within_deadline(fn):
    ex = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return ex.submit(fn).result(timeout=DEADLINE_S)
    finally:
        ex.shutdown(wait=False)


def test_workers_see_no_card_and_no_jax():
    """A spawned worker imports neither JAX nor the JAX package, sees no
    card (CUDA_VISIBLE_DEVICES="" while the children start, restored in the
    parent) and creates no CUDA context; a worker's exception is raised in
    the parent with its traceback."""
    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    pool = t_loader.WorkerPool(ProbeDataset(), num_workers=2)
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == before
    try:
        got = _within_deadline(lambda: list(t_loader.DataLoader(
            ProbeDataset(), range(4), chunk_rays=8, pool=pool)))
        assert len(got) == 4
        for _, meta in got:
            assert meta["imported"] == []
            assert meta["cuda_visible"] == ""
            assert meta["cuda_initialized"] is False
        with pytest.raises(RuntimeError, match="(?s)loader worker.*index 100"):
            _within_deadline(lambda: list(t_loader.DataLoader(
                ProbeDataset(), [0, 100, 1, 2], chunk_rays=8, pool=pool)))
    finally:
        pool.shutdown()
    assert not any(p.is_alive() for p in pool._procs)


def test_a_dying_worker_raises_in_the_parent():
    pool = t_loader.WorkerPool(ProbeDataset(), num_workers=1)
    pool.POLL_S = 0.5
    try:
        with pytest.raises(RuntimeError, match="died"):
            _within_deadline(lambda: list(t_loader.DataLoader(
                ProbeDataset(), [200, 0], chunk_rays=8, pool=pool)))
    finally:
        pool.shutdown()


def test_thread_iterator_raises():
    with pytest.raises(ValueError, match="index 100"):
        list(t_loader.DataLoader(ProbeDataset(), [0, 100, 1], chunk_rays=8))


def test_plan_device_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 11"):
        t_loader.DataLoader(ProbeDataset(), range(4), chunk_rays=8,
                            plan_device=True)


# -- the C++ planner -----------------------------------------------------


def _numpy_plan(dhw, geom, out_sh, site_caps, **kw):
    """The numpy planner: the native call patched to report an overflow,
    on which plan_hat_groups runs numpy."""
    with mock.patch.object(t_native, "plan_hat_segments_native",
                           lambda *a, **k: None):
        return t_hat.plan_hat_groups(dhw, geom, out_sh, site_caps, **kw)


def _scene(seed, n_rays=96, n_samples=8, vox=0.02):
    """tests/test_hat_planner_native.py's scene, from the port's make_batch."""
    batch, static = make_batch(n_rays=n_rays, n_verts=512, voxel_size=vox,
                               seed=seed)
    rng = np.random.RandomState(seed)
    z = t_hat.stratified_z_np(batch["near"][0], batch["far"][0], n_samples,
                              rng)
    pts = (batch["ray_o"][0][:, None, :]
           + batch["ray_d"][0][:, None, :] * z[..., None]).reshape(-1, 3)
    ppts = (pts - batch["Th"][0].reshape(1, 3)) @ batch["R"][0]
    rev = [2, 1, 0]
    dhw = ((ppts[:, rev] - batch["bounds"][0][0][rev]) / vox).astype(
        np.float32)
    return dhw, {k: v[0] for k, v in batch["geom"].items()}, static


def _assert_plans_equal(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        if k in ("rows_caps", "seg_caps", "n_groups"):
            assert a[k] == b[k], (what, k)
        else:
            assert a[k].dtype == b[k].dtype, (what, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("tile", [(4, 8), (4, 8, 8), (2, 4, 4)])
@pytest.mark.parametrize("seed", [0, 7])
def test_native_plan_equals_numpy_and_jax(tile, seed):
    from neuralbody_tpu.ops.hat_planner_native import \
        plan_hat_segments_native as j_native
    dhw, geom, static = _scene(seed)
    sh, caps = static["out_sh"], static["site_caps"]
    ref = _numpy_plan(dhw, geom, sh, caps, group_size=32, tile=tile)
    kw = dict(rows_caps=tuple(c + 32 for c in ref["rows_caps"]),
              seg_caps=tuple(c + 8 for c in ref["seg_caps"]),
              n_groups=ref["n_groups"] + 3)
    ref = _numpy_plan(dhw, geom, sh, caps, group_size=32, tile=tile, **kw)
    got = t_hat.plan_hat_groups(dhw, geom, sh, caps, group_size=32,
                                tile=tile, **kw)
    nat = t_native.plan_hat_segments_native(dhw, geom, sh, caps, 32, tile,
                                            **kw)
    jax_nat = j_native(dhw, geom, sh, caps, 32, tile, **kw)
    _assert_plans_equal(ref, got, "plan_hat_groups vs numpy")
    _assert_plans_equal(ref, nat, "native vs numpy")
    _assert_plans_equal(jax_nat, nat, "native vs the JAX package's")


@pytest.mark.parametrize("what,tile", [("rows", (4, 8)), ("segs", (4, 8, 8)),
                                       ("group", (4, 8))])
def test_native_overflow_falls_to_numpys_error(what, tile):
    """On overflow the native call returns None and plan_hat_groups raises
    numpy's error."""
    dhw, geom, static = _scene({"rows": 3, "segs": 5, "group": 4}[what])
    sh, caps = static["out_sh"], static["site_caps"]
    ref = _numpy_plan(dhw, geom, sh, caps, group_size=32, tile=tile)
    kw = dict(rows_caps=ref["rows_caps"], seg_caps=ref["seg_caps"],
              n_groups=ref["n_groups"])
    if what == "rows":
        kw["rows_caps"] = tuple(max(1, c // 8) for c in ref["rows_caps"])
    elif what == "segs":
        kw["seg_caps"] = tuple(max(1, c // 8) for c in ref["seg_caps"])
    else:
        kw["n_groups"] = max(1, ref["n_groups"] // 4)
    assert t_native.plan_hat_segments_native(dhw, geom, sh, caps, 32, tile,
                                             **kw) is None
    with pytest.raises(ValueError, match=f"hat {what} overflow"):
        t_hat.plan_hat_groups(dhw, geom, sh, caps, group_size=32, tile=tile,
                              **kw)


def test_native_build_failure_raises(monkeypatch):
    """A planner that does not build raises with the compiler's message;
    nothing falls back to the numpy planner."""
    dhw, geom, static = _scene(0)
    ref = _numpy_plan(dhw, geom, static["out_sh"], static["site_caps"],
                      group_size=32)
    monkeypatch.setattr(t_native, "_LIB", None)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "GXX_FLAGS",
                        cuda_build.GXX_FLAGS + ("--no-such-flag",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for hat_planner"):
        t_hat.plan_hat_groups(
            dhw, geom, static["out_sh"], static["site_caps"], group_size=32,
            rows_caps=ref["rows_caps"], seg_caps=ref["seg_caps"],
            n_groups=ref["n_groups"])
