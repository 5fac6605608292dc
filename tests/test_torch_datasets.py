"""The port's data layer (neuralbody_tpu_torch/datasets/: samplers,
ray_utils, frame_data, the multi_view and monocular datasets;
utils/synthetic.SyntheticDataset) against the JAX package's, on
tests/fake_data.py's ZJU-MoCap and People-Snapshot trees at
tests/test_datasets.py's size (64^2 views, 400 vertices, 2 cm voxels).

Everything is bit for bit: both sides are the same numpy code, so for one
seed of the global numpy RNG every sample is the same array for array.
Each package reads its own copy of the fixture tree, so neither reads the
other's on-disk geometry cache.
"""
import numpy as np
import pytest
import torch

import neuralbody_tpu.datasets  # noqa: F401  (registers plugins)
from neuralbody_tpu.config import make_cfg as j_make_cfg
from neuralbody_tpu.datasets import frame_data as j_fd
from neuralbody_tpu.datasets import loader as j_loader
from neuralbody_tpu.datasets import ray_utils as j_ru
from neuralbody_tpu.datasets import samplers as j_smp
from neuralbody_tpu.utils import synthetic as j_syn
import neuralbody_tpu_torch.datasets  # noqa: F401  (registers plugins)
from neuralbody_tpu_torch.config import make_cfg as t_make_cfg
from neuralbody_tpu_torch.datasets import frame_data as t_fd
from neuralbody_tpu_torch.datasets import loader as t_loader
from neuralbody_tpu_torch.datasets import ray_utils as t_ru
from neuralbody_tpu_torch.datasets import samplers as t_smp
from neuralbody_tpu_torch.utils import synthetic as t_syn

from fake_data import make_fake_snapshot, make_fake_zju

torch.set_num_threads(1)

N_VERTS = 400


def small_cfg(make_cfg, root, monocular=False):
    """tests/test_datasets.py's zju_cfg, in either package."""
    cfg = make_cfg()
    cfg.H = cfg.W = 64
    cfg.ratio = 1.0
    cfg.N_rand = 64
    cfg.num_train_frame = 2
    cfg.training_view = [0, 1]
    cfg.voxel_size = [0.02, 0.02, 0.02]
    cfg.nv = N_VERTS
    cfg.tpu.chunk_rays = 256
    cfg.train_dataset.data_root = root
    cfg.train_dataset.human = "CoreView_999"
    cfg.train_dataset.ann_file = f"{root}/annots.npy"
    if monocular:
        cfg.train_dataset.ann_file = f"{root}/params.npy"
        cfg.train_dataset_module = cfg.test_dataset_module = "monocular"
    cfg.test_dataset.update(cfg.train_dataset)
    cfg.test_dataset.split = "test"
    return cfg


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One ZJU and one People-Snapshot tree per package (same content)."""
    out = {}
    for pkg in ("jax", "torch"):
        base = tmp_path_factory.mktemp(pkg)
        out[pkg] = (make_fake_zju(str(base / "CoreView_999")),
                    make_fake_snapshot(str(base / "f9c")))
    return out


def assert_same(a, b, what=""):
    """Bit-for-bit equality of two samples (dicts, tuples, arrays)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            assert_same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}/{i}")
    elif a is None:
        assert b is None, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (
            what, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=what)


def _datasets(roots, split, monocular):
    out = []
    for pkg, make_cfg, loader in (("jax", j_make_cfg, j_loader),
                                  ("torch", t_make_cfg, t_loader)):
        cfg = small_cfg(make_cfg, roots[pkg][int(monocular)], monocular)
        out.append(loader.make_dataset(cfg, split))
    return out


@pytest.mark.parametrize("split,monocular", [
    ("train", False), ("test", False), ("train", True), ("test", True)])
def test_every_sample_equals_jax(roots, split, monocular):
    jds, tds = _datasets(roots, split, monocular)
    assert type(tds).__module__.startswith("neuralbody_tpu_torch.")
    assert len(jds) == len(tds) > 0
    assert (jds.geo.out_sh, jds.geo.site_caps, jds.geo.fix_caps) == (
        tds.geo.out_sh, tds.geo.site_caps, tds.geo.fix_caps)
    for seed in (0, 5):
        for i in range(len(jds)):
            np.random.seed(seed + i)
            a = jds[i]
            np.random.seed(seed + i)
            b = tds[i]
            assert_same(a, b, f"{split} sample {i} seed {seed}")


def test_image_size_sample_equals_jax(roots):
    """The multi-scale sampler's (index, h, w) items."""
    jds, tds = _datasets(roots, "train", False)
    for item in ((0, 32, 48), (1, -1, -1)):
        np.random.seed(3)
        a = jds[item]
        np.random.seed(3)
        assert_same(a, tds[item], str(item))


def test_samplers_equal_jax():
    for n, epoch, hosts, hid, ep_iter, shuffle in (
            (10, 0, 1, 0, -1, True), (10, 3, 2, 1, -1, True),
            (7, 1, 3, 2, 12, False), (5, 2, 1, 0, 3, True)):
        args = (n, epoch, shuffle, hosts, hid, ep_iter)
        assert t_smp.epoch_indices(*args) == j_smp.epoch_indices(*args)
    assert t_smp.frame_sampler_indices(120, 4, 10) == \
        j_smp.frame_sampler_indices(120, 4, 10)
    assert t_smp.host_shard(list(range(7)), 3, 1) == \
        j_smp.host_shard(list(range(7)), 3, 1)
    for strategy in ("range", "origin"):
        args = (list(range(13)), 2, (256, 256), (480, 640))
        kw = dict(epoch=4, strategy=strategy, n_buckets=4, drop_last=True)
        assert t_smp.image_size_batches(*args, **kw) == \
            j_smp.image_size_batches(*args, **kw)


def test_ray_utils_equal_jax():
    rng = np.random.RandomState(11)
    H = W = 48
    K = np.array([[50.0, 0, 24], [0, 50.0, 24], [0, 0, 1]])
    R = np.eye(3)
    T = np.array([[0.0], [0.0], [2.5]])
    bounds = np.array([[-0.3, -0.4, -0.2], [0.3, 0.4, 0.2]], np.float32)
    assert_same(j_ru.get_rays(H, W, K, R, T), t_ru.get_rays(H, W, K, R, T))
    ro, rd = j_ru.get_rays(H, W, K, R, T)
    assert_same(j_ru.get_near_far(bounds, ro.reshape(-1, 3),
                                  rd.reshape(-1, 3)),
                t_ru.get_near_far(bounds, ro.reshape(-1, 3),
                                  rd.reshape(-1, 3)))
    pose = np.concatenate([R, T], 1)
    assert_same(j_ru.get_bound_2d_mask(bounds, K, pose, H, W),
                t_ru.get_bound_2d_mask(bounds, K, pose, H, W))
    img = rng.rand(H, W, 3).astype(np.float32)
    msk = (rng.rand(H, W) > 0.5).astype(np.uint8)
    msk[20:28, 20:28] = 100
    for kw in (dict(body_ratio=0.5, face_ratio=0.0),
               dict(body_ratio=0.5, face_ratio=0.0, body_nonzero=True,
                    exclude_boundary=False)):
        outs = []
        for ru in (j_ru, t_ru):
            np.random.seed(2)
            pools = ru.PoolCache()
            outs.append([ru.sample_rays_train(
                img, msk, K, R, T, bounds, 64, cache=pools,
                cache_key=("k", H, W), **kw) for _ in range(2)])
        assert_same(*outs, str(kw))
    assert_same(j_ru.sample_rays_test(img, K, R, T, bounds),
                t_ru.sample_rays_test(img, K, R, T, bounds))
    assert_same(j_ru.image_rays(pose, K, bounds, H, W),
                t_ru.image_rays(pose, K, bounds, H, W))
    poses = rng.randn(4, 3).astype(np.float32)
    xyz = rng.randn(30, 3).astype(np.float32)
    assert_same(j_ru.batch_rodrigues(poses), t_ru.batch_rodrigues(poses))
    joints = rng.randn(4, 3).astype(np.float32)
    parents = np.array([-1, 0, 1, 1])
    assert_same(j_ru.get_rigid_transformation(poses, joints, parents),
                t_ru.get_rigid_transformation(poses, joints, parents))
    assert_same(j_ru.project(xyz, K, pose), t_ru.project(xyz, K, pose))
    assert_same(j_ru.transform_can_smpl(xyz, 0.5, np.pi / 8,
                                        np.random.RandomState(1)),
                t_ru.transform_can_smpl(xyz, 0.5, np.pi / 8,
                                        np.random.RandomState(1)))


def test_frame_data_equal_jax():
    xyz = j_syn.ellipsoid_vertices(N_VERTS, seed=4)
    Rh, Th = np.array([0.1, 0.3, -0.2]), np.array([[0.05, 0.0, 0.1]])
    for big_box, axis in ((False, 2), (True, 2), (False, 1)):
        assert_same(j_fd.voxelize_frame(xyz, Rh, Th, (0.02,) * 3, big_box,
                                        axis),
                    t_fd.voxelize_frame(xyz, Rh, Th, (0.02,) * 3, big_box,
                                        axis))
    caches = [fd.GeometryCache((0.02,) * 3) for fd in (j_fd, t_fd)]
    frames = [(i, xyz + 0.03 * i, Rh * i, Th) for i in range(3)]
    assert caches[0].finalize_static(frames) == \
        caches[1].finalize_static(frames)
    assert caches[0].fix_caps == caches[1].fix_caps
    for key, wxyz, rh, th in frames:
        assert_same(caches[0].frame(key, wxyz, rh, th),
                    caches[1].frame(key, wxyz, rh, th), f"frame {key}")


def test_synthetic_dataset_equals_jax():
    kw = dict(n_frames=2, n_cams=3, hw=(64, 64), n_verts=N_VERTS,
              voxel_size=0.02, n_rand=64, seed=2)
    jds, tds = j_syn.SyntheticDataset(**kw), t_syn.SyntheticDataset(**kw)
    assert (jds.out_sh, jds.site_caps) == (tds.out_sh, tds.site_caps)
    assert len(jds) == len(tds) == 6
    for i in range(len(jds)):
        np.random.seed(i)
        a = jds[i]
        np.random.seed(i)
        assert_same(a, tds[i], f"synthetic sample {i}")


def test_filled_pool_cache_pickles():
    """A filled PoolCache pickles as an empty cache of the same cap, so a
    dataset that has sampled rays can be sent to a spawned worker (the JAX
    package's dict subclass calls __setitem__ before its cap is set while
    unpickling, and raises)."""
    import pickle
    caches = {}
    for name, ru in (("jax", j_ru), ("torch", t_ru)):
        caches[name] = ru.PoolCache(cap=3)
        for k in range(5):
            caches[name][k] = np.full(4, k)
        assert len(caches[name]) == 3
    got = pickle.loads(pickle.dumps(caches["torch"]))
    assert type(got) is t_ru.PoolCache and got.cap == 3 and len(got) == 0
    got["a"] = np.zeros(1)
    assert list(got) == ["a"]
    with pytest.raises(AttributeError, match="cap"):
        pickle.loads(pickle.dumps(caches["jax"]))
