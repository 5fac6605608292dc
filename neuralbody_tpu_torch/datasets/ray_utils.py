"""Host-side (numpy) ray generation and sampling.
(Counterpart of neuralbody_tpu/datasets/ray_utils.py: an own copy, numpy.)

Clean-room implementations of the reference data-layer math (ref:
lib/utils/if_nerf/if_nerf_data_utils.py): pinhole rays from K/R/T, 3D-bbox
projection masks, ray-AABB slab intersection, and train-time ray sampling
with body/face/random ratios. These run on CPU in the input pipeline,
mirroring the reference's dataset layer; the device never sees ragged data.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


_RAY_CACHE = {}


def get_rays(H, W, K, R, T):
    """Pinhole rays in world space (ref: if_nerf_data_utils.py:8-21).

    Returns (ray_o [H,W,3] broadcast camera center, ray_d [H,W,3]).
    Cameras are fixed per sequence, so the full-image grid is memoized
    (recomputing 512^2 rays cost ~10 ms per loader sample — the single
    biggest host-pipeline item after the hat planner).
    """
    key = (H, W, np.asarray(K).tobytes(), np.asarray(R).tobytes(),
           np.asarray(T).tobytes())
    hit = _RAY_CACHE.get(key)
    if hit is not None:
        return hit
    cam_center = -R.T @ T.reshape(3)
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    pix = np.stack([i, j, np.ones_like(i)], axis=2)
    cam_dirs = pix @ np.linalg.inv(K).T
    world_pts = (cam_dirs - T.reshape(3)) @ R
    ray_d = world_pts - cam_center
    ray_o = np.broadcast_to(cam_center.astype(np.float32), ray_d.shape)
    out = (ray_o, ray_d.astype(np.float32))
    if len(_RAY_CACHE) < 256:  # bounded: sequences have few dozen cameras
        _RAY_CACHE[key] = out
    return out


def project(xyz, K, RT):
    """3D world points -> 2D pixels (ref: lib/utils/base_utils.py:17-26)."""
    xyz = xyz @ RT[:, :3].T + RT[:, 3:].T
    xyz = xyz @ K.T
    return xyz[:, :2] / xyz[:, 2:]


def bound_corners(bounds):
    mn, mx = bounds
    return np.array([
        [mn[0], mn[1], mn[2]], [mn[0], mn[1], mx[2]],
        [mn[0], mx[1], mn[2]], [mn[0], mx[1], mx[2]],
        [mx[0], mn[1], mn[2]], [mx[0], mn[1], mx[2]],
        [mx[0], mx[1], mn[2]], [mx[0], mx[1], mx[2]],
    ])


def get_bound_2d_mask(bounds, K, pose, H, W):
    """Projected-AABB fill mask (ref: if_nerf_data_utils.py:40-51)."""
    corners_2d = project(bound_corners(bounds), K, pose)
    corners_2d = np.round(corners_2d).astype(int)
    mask = np.zeros((H, W), dtype=np.uint8)
    faces = [[0, 1, 3, 2, 0], [4, 5, 7, 6, 5], [0, 1, 5, 4, 0],
             [2, 3, 7, 6, 2], [0, 2, 6, 4, 0], [1, 3, 7, 5, 1]]
    for f in faces:
        cv2.fillPoly(mask, [corners_2d[f]], 1)
    return mask


def get_near_far(bounds, ray_o, ray_d):
    """Slab-method ray-AABB intersection (ref: if_nerf_data_utils.py:54-69).

    Returns (near, far, hit_mask); near/far are compacted to hit rays and
    expressed in units of |ray_d| (as the reference divides by the norm).
    """
    norm_d = np.linalg.norm(ray_d, axis=-1, keepdims=True)
    viewdir = ray_d / norm_d
    viewdir[(viewdir < 1e-5) & (viewdir > -1e-10)] = 1e-5
    viewdir[(viewdir > -1e-5) & (viewdir < 1e-10)] = -1e-5
    tmin = (bounds[:1] - ray_o[:1]) / viewdir
    tmax = (bounds[1:2] - ray_o[:1]) / viewdir
    t1 = np.minimum(tmin, tmax)
    t2 = np.maximum(tmin, tmax)
    near = np.max(t1, axis=-1)
    far = np.min(t2, axis=-1)
    hit = near < far
    return near[hit] / norm_d[hit, 0], far[hit] / norm_d[hit, 0], hit


def build_ray_pools(msk, K, R, T, bounds, H, W, face_label=13,
                    body_nonzero=False, exclude_boundary=True):
    """Precompute the body/face/random pixel pools for sample_rays_train.

    The pools depend only on (mask, camera, bounds) — all static per
    (frame, cam) across epochs — while argwhere over a 512^2 mask costs
    ~2.5 ms/sample on this host. Stored as raveled int32 indices (4 bytes
    per candidate pixel)."""
    pose = np.concatenate([R, T.reshape(3, 1)], axis=1)
    bound_mask = get_bound_2d_mask(bounds, K, pose, H, W)
    msk = msk * bound_mask
    if exclude_boundary:
        bound_mask = bound_mask.copy()
        bound_mask[msk == 100] = 0
    body = (msk != 0) if body_nonzero else (msk == 1)
    return {
        "body": np.flatnonzero(body.ravel()).astype(np.int32),
        "face": np.flatnonzero((msk == face_label).ravel()).astype(np.int32),
        "rand": np.flatnonzero((bound_mask == 1).ravel()).astype(np.int32),
    }


class PoolCache(dict):
    """FIFO-bounded dict for ray pools (~0.4 MB/entry at 512^2)."""

    def __init__(self, cap=512):
        super().__init__()
        self.cap = cap

    def __setitem__(self, k, v):
        # evict only when inserting a NEW key: re-setting a live entry at
        # capacity must not drop an unrelated one
        if k not in self and len(self) >= self.cap:
            del self[next(iter(self))]
        super().__setitem__(k, v)

    def __reduce__(self):
        # pickled (to a loader worker) as an empty cache of the same cap:
        # a dict subclass's default pickle sets its items before `cap`,
        # and a worker that unpickles a filled cache dies (the JAX
        # package's does); the pools are a cache, rebuilt on first use
        return type(self), (self.cap,)


def sample_rays_train(img, msk, K, R, T, bounds, nrays,
                      body_ratio=0.5, face_ratio=0.0, face_label=13,
                      body_nonzero=False, exclude_boundary=True,
                      rng=None, cache=None, cache_key=None):
    """Sample exactly `nrays` training rays hitting the body AABB.

    Reproduces the reference strategy (ref: if_nerf_data_utils.py:153-232,
    sample_ray_h36m): a body/face/random mix drawn from the mask / bound
    mask, rejecting rays that miss the AABB, looping until filled. The
    boundary marker (msk==100) is excluded from the random pool.

    body_nonzero=True samples the body from msk!=0 (ref sample_ray:99);
    False samples from msk==1 (ref sample_ray_h36m:181).

    cache/cache_key: optional dict + hashable key memoizing the pixel
    pools per (frame, cam, H, W) — bit-identical sampling, ~3 ms/sample
    cheaper. The caller owns key correctness (mask and camera must be
    static for a given key).
    """
    rng = rng or np.random
    H, W = img.shape[:2]
    ray_o_full, ray_d_full = get_rays(H, W, K, R, T)

    pools = cache.get(cache_key) if cache is not None else None
    if pools is None:
        pools = build_ray_pools(msk, K, R, T, bounds, H, W,
                                face_label=face_label,
                                body_nonzero=body_nonzero,
                                exclude_boundary=exclude_boundary)
        if cache is not None:
            cache[cache_key] = pools
    body_pool, face_pool, rand_pool = (pools["body"], pools["face"],
                                       pools["rand"])

    outs = {k: [] for k in ("rgb", "ray_o", "ray_d", "near", "far", "coord")}
    n_got = 0
    while n_got < nrays:
        n_body = int((nrays - n_got) * body_ratio)
        n_face = int((nrays - n_got) * face_ratio)
        n_rand = (nrays - n_got) - n_body - n_face

        picks = [rand_pool[rng.randint(0, len(rand_pool), n_rand)]]
        if len(body_pool) > 0 and n_body > 0:
            picks.insert(0, body_pool[rng.randint(0, len(body_pool), n_body)])
        if len(face_pool) > 0 and n_face > 0:
            picks.insert(-1, face_pool[rng.randint(0, len(face_pool), n_face)])
        flat = np.concatenate(picks, axis=0).astype(np.int64)
        coord = np.stack([flat // W, flat % W], axis=1)

        ro = ray_o_full[coord[:, 0], coord[:, 1]]
        rd = ray_d_full[coord[:, 0], coord[:, 1]]
        rgb = img[coord[:, 0], coord[:, 1]]
        near, far, hit = get_near_far(bounds, ro, rd)

        outs["rgb"].append(rgb[hit])
        outs["ray_o"].append(ro[hit])
        outs["ray_d"].append(rd[hit])
        outs["near"].append(near)
        outs["far"].append(far)
        outs["coord"].append(coord[hit])
        n_got += hit.sum()

    cat = {k: np.concatenate(v)[:nrays] for k, v in outs.items()}
    return (
        cat["rgb"].astype(np.float32), cat["ray_o"].astype(np.float32),
        cat["ray_d"].astype(np.float32), cat["near"].astype(np.float32),
        cat["far"].astype(np.float32), cat["coord"],
        np.ones(nrays, bool),
    )


def sample_rays_test(img, K, R, T, bounds):
    """All pixels whose rays hit the AABB (ref else-branch :220-230).

    Returns compacted arrays plus the full [H*W] hit mask for re-assembly.
    """
    H, W = img.shape[:2]
    ray_o_full, ray_d_full = get_rays(H, W, K, R, T)
    ro = ray_o_full.reshape(-1, 3).astype(np.float32)
    rd = ray_d_full.reshape(-1, 3).astype(np.float32)
    rgb = img.reshape(-1, 3).astype(np.float32)
    near, far, hit = get_near_far(bounds, ro, rd)
    return (rgb[hit], ro[hit], rd[hit], near.astype(np.float32),
            far.astype(np.float32), np.zeros((hit.sum(), 2), np.int64), hit)


def image_rays(RT, K, bounds, H, W):
    """Full-image rays inside the AABB for demo rendering
    (ref: lib/utils/render_utils.py:120-137)."""
    ray_o, ray_d = get_rays(H, W, K, RT[:3, :3], RT[:3, 3:])
    ro = ray_o.reshape(-1, 3).astype(np.float32)
    rd = ray_d.reshape(-1, 3).astype(np.float32)
    near, far, hit = get_near_far(bounds, ro, rd)
    return (ro[hit], rd[hit], near.astype(np.float32),
            far.astype(np.float32), hit)


def transform_can_smpl(xyz, rot_ratio=0.0, rot_range=np.pi / 32, rng=None):
    """Random SMPL-frame augmentation (ref: if_nerf_data_utils.py:278-306)."""
    rng = rng or np.random
    center = np.zeros(3, np.float32)
    rot = np.eye(2, dtype=np.float32)
    trans = np.zeros(3, np.float32)
    if rng.uniform() > rot_ratio:
        return xyz, center, rot, trans

    xyz = xyz.copy()
    t = rng.uniform(-rot_range, rot_range)
    rot = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]],
                   np.float32)
    center = np.mean(xyz, axis=0)
    xyz = xyz - center
    xyz[:, [0, 2]] = xyz[:, [0, 2]] @ rot.T
    xyz = xyz + center
    trans = np.array([rng.uniform(-0.05, 0.05), 0,
                      rng.uniform(-0.025, 0.025)], np.float32)
    xyz = xyz + trans
    return xyz, center, rot, trans


def batch_rodrigues(poses):
    """Axis-angle [N,3] -> rotation matrices [N,3,3]
    (ref: if_nerf_data_utils.py:353-371)."""
    angle = np.linalg.norm(poses + 1e-8, axis=1, keepdims=True)
    rot_dir = poses / angle
    cos, sin = np.cos(angle)[:, None], np.sin(angle)[:, None]
    rx, ry, rz = np.split(rot_dir, 3, axis=1)
    zeros = np.zeros([poses.shape[0], 1])
    K = np.concatenate([zeros, -rz, ry, rz, zeros, -rx, -ry, rx], axis=1)
    K = np.concatenate([K, zeros], axis=1).reshape(-1, 3, 3)
    ident = np.eye(3)[None]
    return ident + sin * K + (1 - cos) * (K @ K)


def get_rigid_transformation(poses, joints, parents):
    """Kinematic chain of per-bone 4x4 world transforms
    (ref: if_nerf_data_utils.py:374-406)."""
    n = len(joints)
    rot_mats = batch_rodrigues(poses)
    rel_joints = joints.copy()
    rel_joints[1:] -= joints[parents[1:]]
    tf = np.zeros([n, 4, 4])
    tf[:, :3, :3] = rot_mats
    tf[:, :3, 3] = rel_joints
    tf[:, 3, 3] = 1
    chain = [tf[0]]
    for i in range(1, n):
        chain.append(chain[parents[i]] @ tf[i])
    transforms = np.stack(chain)
    joints_h = np.concatenate([joints, np.zeros([n, 1])], axis=1)
    posed = np.sum(transforms * joints_h[:, None], axis=2)
    transforms[..., 3] = transforms[..., 3] - posed
    return transforms.astype(np.float32)
