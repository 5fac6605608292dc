"""Synthetic scenes for tests, the chip smoke run and dry runs
(counterpart of neuralbody_tpu/utils/synthetic.py).

A human-scale ellipsoid "body" point cloud in SMPL coordinates plus
cameras/rays, shaped like the real data pipeline's output (numpy):
make_batch, one batch; SyntheticDataset, a picklable dataset that the
loader's workers read as they read a real one.
"""
from __future__ import annotations

import numpy as np

from ..ops.sparse_conv import build_frame_geometry, compute_site_caps


def ellipsoid_vertices(n=6890, radii=(0.3, 0.9, 0.15), seed=0):
    """Points on an ellipsoid surface (x-width, y-height, z-depth), meters."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v * np.asarray(radii)).astype(np.float32)


def voxelize(xyz, voxel_size=0.005, pad_z=0.05):
    """Vertices (SMPL frame) -> voxel coords + padded grid shape.

    Bounds +- pad on z, coords in dhw order, out_sh rounded up to a
    multiple of 32 (the reference's prepare_input voxelization).
    """
    min_xyz = xyz.min(0).copy()
    max_xyz = xyz.max(0).copy()
    min_xyz[2] -= pad_z
    max_xyz[2] += pad_z
    bounds = np.stack([min_xyz, max_xyz]).astype(np.float32)

    dhw = xyz[:, [2, 1, 0]]
    min_dhw = min_xyz[[2, 1, 0]]
    coord = np.round((dhw - min_dhw) / voxel_size).astype(np.int32)
    out_sh = np.ceil((max_xyz[[2, 1, 0]] - min_dhw) / voxel_size).astype(np.int32)
    out_sh = (out_sh | 31) + 1
    return coord, tuple(int(s) for s in out_sh), bounds


class SyntheticDataset:
    """Picklable reference-shaped dataset for the bench and loader tests.

    Mirrors the production data path's per-sample host work (ref training
    recipe, BASELINE.md): JPEG decode of a 512^2 view, body/random train-ray
    sampling (datasets.ray_utils.sample_rays_train), frame geometry tables.
    Images are stored JPEG-encoded so __getitem__ really decodes.
    """

    def __init__(self, n_frames=4, n_cams=4, hw=(512, 512), n_verts=6890,
                 voxel_size=0.005, n_rand=1024, seed=0):
        import cv2

        from ..datasets.frame_data import voxelize_frame
        from ..ops.sparse_conv import (build_frame_geometry,
                                       compute_site_caps)

        self.n_frames, self.n_cams = n_frames, n_cams
        self.hw, self.n_rand = hw, n_rand
        self.voxel_size = (voxel_size,) * 3
        self.num_cams = n_cams
        rng = np.random.RandomState(seed)
        base = ellipsoid_vertices(n_verts, seed=seed)

        H, W = hw
        f = 550.0 * H / 512.0
        self.K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                          np.float64)
        self.cams = []
        center = np.zeros(3, np.float32)
        for c in range(n_cams):
            az = 2 * np.pi * c / n_cams
            pos = center + np.array([2.8 * np.cos(az), 0.0,
                                     2.8 * np.sin(az)], np.float32)
            z = (center - pos) / np.linalg.norm(center - pos)
            up = np.array([0, -1, 0], np.float32)
            x = np.cross(up, z); x /= np.linalg.norm(x)
            y = np.cross(z, x)
            R = np.stack([x, y, z]).astype(np.float64)
            T = (-R @ pos).reshape(3, 1)
            self.cams.append((R, T))

        frames, coords = [], []
        for i in range(n_frames):
            Rh = np.array([0.0, 0.15 * i, 0.0])
            Th = np.array([[0.02 * i, 0.0, 0.0]], np.float32)
            Rm = cv2.Rodrigues(Rh)[0].astype(np.float32)
            wxyz = (base @ Rm.T + Th).astype(np.float32)
            coord, _, can_bounds, bounds, R2, Th2 = voxelize_frame(
                wxyz, Rm, Th, self.voxel_size)
            frames.append(dict(wxyz=wxyz, can_bounds=can_bounds,
                               bounds=bounds, R=R2, Th=Th2, coord=coord))
            coords.append(coord)
        max_sh = np.max([np.ceil(
            (f_["bounds"][1][[2, 1, 0]] - f_["bounds"][0][[2, 1, 0]])
            / voxel_size) for f_ in frames], axis=0).astype(np.int64)
        self.out_sh = tuple(int((s | 31) + 1) for s in max_sh)
        self.site_caps = tuple(compute_site_caps(coords, self.out_sh))
        from ..ops.sparse_conv import compute_fix_caps
        fix_caps = compute_fix_caps(coords, self.out_sh, self.site_caps)
        for i, f_ in enumerate(frames):
            f_["geom"] = build_frame_geometry(
                f_["coord"], self.out_sh, list(self.site_caps),
                fix_caps=fix_caps)

        # crude rendered views, stored JPEG-encoded (+ binary masks)
        self._jpgs, self._msks = {}, {}
        for i, f_ in enumerate(frames):
            for c, (R, T) in enumerate(self.cams):
                cam_pts = f_["wxyz"] @ R.T + T.reshape(3)
                uv = cam_pts @ self.K.T
                uv = (uv[:, :2] / uv[:, 2:]).astype(int)
                msk = np.zeros((H, W), np.uint8)
                ok = ((uv[:, 0] >= 0) & (uv[:, 0] < W)
                      & (uv[:, 1] >= 0) & (uv[:, 1] < H))
                msk[uv[ok, 1], uv[ok, 0]] = 1
                msk = cv2.dilate(msk, np.ones((9, 9), np.uint8))
                img = np.zeros((H, W, 3), np.uint8)
                img[msk > 0] = rng.randint(40, 220, 3)
                _, enc = cv2.imencode(".jpg", img)
                self._jpgs[(i, c)] = enc.tobytes()
                self._msks[(i, c)] = np.packbits(msk)
        for f_ in frames:
            del f_["wxyz"], f_["coord"]
        self.frames = frames
        # duck-typed .geo for make_data_loader's hat_cfg derivation
        from types import SimpleNamespace
        self.geo = SimpleNamespace(out_sh=self.out_sh,
                                   site_caps=self.site_caps)

    def __len__(self):
        return self.n_frames * self.n_cams

    def __getitem__(self, index):
        import cv2

        from ..datasets import ray_utils

        i, c = divmod(index, self.n_cams)
        f = self.frames[i]
        H, W = self.hw
        img = cv2.imdecode(
            np.frombuffer(self._jpgs[(i, c)], np.uint8),
            cv2.IMREAD_COLOR).astype(np.float32) / 255.0
        msk = np.unpackbits(self._msks[(i, c)])[:H * W].reshape(H, W)
        R, T = self.cams[c]
        if not hasattr(self, "_pools"):
            self._pools = ray_utils.PoolCache()
        rgb, ray_o, ray_d, near, far, _, mask_at_box = \
            ray_utils.sample_rays_train(
                img, msk, self.K, R, T / 1.0, f["can_bounds"],
                self.n_rand, body_ratio=0.5, face_ratio=0.0,
                cache=self._pools, cache_key=(i, c))
        return {
            "geom": f["geom"],
            "geom_key": np.int32(i),
            "rgb": rgb, "ray_o": ray_o, "ray_d": ray_d,
            "near": near, "far": far,
            "mask_at_box": mask_at_box,
            "bounds": f["bounds"], "R": f["R"], "Th": f["Th"],
            "latent_index": np.int32(i),
            "frame_index": np.int32(i),
            "cam_ind": np.int32(c),
            "img_hw": (H, W),
        }


def make_batch(n_rays=1024, n_verts=6890, voxel_size=0.005, seed=0,
               batch_size=1, num_views=0, img_hw=(512, 512),
               hat=False, n_samples=64, hat_perturb=True,
               hat_static=None):
    """A full batch in canonical layout (numpy).

    hat=True additionally runs the host hat planner
    (ops.hat_interp.prepare_hat_batch); static then also carries the plan's
    static sizes under "hat".

    Returns (batch dict of numpy arrays, static info dict with out_sh and
    site_caps).
    """
    rng = np.random.RandomState(seed)
    xyz = ellipsoid_vertices(n_verts, seed=seed)
    coord, out_sh, bounds = voxelize(xyz, voxel_size)
    caps = compute_site_caps([coord], out_sh)
    geom = build_frame_geometry(coord, out_sh, caps)

    # world frame = SMPL frame rotated/translated a bit
    theta = 0.3
    R = np.array([
        [np.cos(theta), -np.sin(theta), 0],
        [np.sin(theta), np.cos(theta), 0],
        [0, 0, 1],
    ], np.float32)
    Th = np.array([[0.1, 0.05, 1.0]], np.float32)
    world_center = (bounds.mean(0) @ R.T) + Th[0]

    # cameras on a ring looking at the body center
    ray_o = np.empty((n_rays, 3), np.float32)
    ray_d = np.empty((n_rays, 3), np.float32)
    phis = rng.uniform(0, 2 * np.pi, n_rays)
    cam = world_center + np.stack(
        [3 * np.cos(phis), rng.uniform(-0.5, 0.5, n_rays), 3 * np.sin(phis)],
        axis=1).astype(np.float32)
    target = world_center + rng.uniform(-0.3, 0.3, (n_rays, 3)).astype(np.float32)
    ray_o[:] = cam
    d = target - cam
    ray_d[:] = d / np.linalg.norm(d, axis=1, keepdims=True)

    # a generous sphere around the body for near/far (synthetic data)
    dist = np.linalg.norm(world_center - cam, axis=1)
    near = (dist - 1.2).astype(np.float32)
    far = (dist + 1.2).astype(np.float32)

    rgb = (0.5 + 0.5 * np.stack(
        [np.cos(phis), np.sin(2 * phis), np.cos(3 * phis)], axis=1
    )).astype(np.float32)

    def rep(x):
        return np.repeat(np.asarray(x)[None], batch_size, axis=0)

    batch = {
        "geom": {k: rep(v) for k, v in geom.items()},
        "ray_o": rep(ray_o), "ray_d": rep(ray_d),
        "near": rep(near), "far": rep(far),
        "rgb": rep(rgb),
        "ray_mask": np.ones((batch_size, n_rays), np.float32),
        "R": rep(R), "Th": rep(Th),
        "bounds": rep(bounds),
        "latent_index": np.zeros((batch_size,), np.int32),
    }
    if num_views > 0:
        H, W = img_hw
        K = np.array([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]],
                     np.float32)
        RT = np.tile(np.eye(4, dtype=np.float32), (num_views, 1, 1))
        msks = np.ones((num_views, H, W), np.float32)
        batch["Ks"] = rep(np.tile(K, (num_views, 1, 1)))
        batch["RT"] = rep(RT)
        batch["msks"] = rep(msks)

    static = {"out_sh": out_sh, "site_caps": tuple(caps)}
    if hat:
        from ..ops.hat_interp import prepare_hat_batch
        hs = hat_static or {}
        batch, hs = prepare_hat_batch(
            batch, out_sh, tuple(caps), voxel_size, n_samples,
            group_size=hs.get("group_size", 128),
            tile=hs.get("tile", (4, 8)),
            rows_caps=hs.get("rows_caps"),
            seg_caps=hs.get("seg_caps"),
            n_groups=hs.get("n_groups"),
            rng=np.random.RandomState(seed + 1) if hat_perturb else None)
        static["hat"] = hs
    return batch, static
