"""Per-frame SMPL voxelization and static-shape frame geometry.
(Counterpart of neuralbody_tpu/datasets/frame_data.py: an own copy, numpy.)

Mirrors the reference prepare_input (ref: lib/datasets/light_stage/
multi_view_dataset.py:68-118 / monocular_dataset.py:32-71): load posed SMPL
vertices, world->SMPL transform via Rh/Th, pad bounds, voxelize to dhw
coords. On top, builds (and caches) the TPU sparse-conv geometry tables with
a SEQUENCE-STATIC grid shape and site capacities so XLA compiles once
(SURVEY.md §7.3 #3 — the reference recomputes out_sh per frame; we take the
max over frames, which is exactly the reference's own batch-max mechanism in
prepare_sp_input, if_clight_renderer.py:40, extended to the sequence).
"""
from __future__ import annotations

import os

import numpy as np

from ..ops.sparse_conv import (build_frame_geometry, compute_fix_caps,
                               compute_site_caps)

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def rodrigues(rvec):
    return cv2.Rodrigues(np.asarray(rvec, np.float64).reshape(3, 1))[0].astype(
        np.float32)


def pad_bounds(xyz, big_box=False, pad=0.05, pad_axis=2):
    """Body AABB with reference padding: +-0.05 everywhere (big_box) or on
    one axis only (z for ZJU, y for snapshot)."""
    mn = xyz.min(0).copy()
    mx = xyz.max(0).copy()
    if big_box:
        mn -= pad
        mx += pad
    else:
        mn[pad_axis] -= pad if pad_axis == 2 else 0.1
        mx[pad_axis] += pad if pad_axis == 2 else 0.1
    return np.stack([mn, mx]).astype(np.float32)


def voxelize_frame(wxyz, Rh, Th, voxel_size, big_box=False, pad_axis=2):
    """World-posed vertices -> (coord, nominal_out_sh, can_bounds, bounds).

    can_bounds: world-frame AABB (ray near/far); bounds: SMPL-frame AABB
    (grid coords). coord is in dhw order.
    """
    R = rodrigues(Rh) if np.asarray(Rh).size == 3 else np.asarray(Rh, np.float32)
    Th = np.asarray(Th, np.float32).reshape(1, 3)
    can_bounds = pad_bounds(wxyz, big_box, pad_axis=pad_axis)
    sxyz = (wxyz - Th) @ R
    bounds = pad_bounds(sxyz, big_box, pad_axis=pad_axis)

    dhw = sxyz[:, [2, 1, 0]]
    min_dhw = bounds[0][[2, 1, 0]]
    max_dhw = bounds[1][[2, 1, 0]]
    vs = np.asarray(voxel_size)
    coord = np.round((dhw - min_dhw) / vs).astype(np.int32)
    out_sh = np.ceil((max_dhw - min_dhw) / vs).astype(np.int32)
    out_sh = (out_sh | 31) + 1
    return coord, tuple(int(s) for s in out_sh), can_bounds, bounds, R, Th


class GeometryCache:
    """Sequence-level static shapes + per-frame geometry table cache.

    Optional on-disk cache (cache_dir): rulebook tables are rebuilt only
    when the voxelization inputs change (keyed by frame id + voxel size +
    static shapes)."""

    def __init__(self, voxel_size, big_box=False, pad_axis=2,
                 cache_dir=None):
        self.voxel_size = voxel_size
        self.big_box = big_box
        self.pad_axis = pad_axis
        self.out_sh = None       # static (D, H, W)
        self.site_caps = None
        self._frames = {}
        self.cache_dir = cache_dir

    def finalize_static(self, frames):
        """Scan all frames' vertices to fix out_sh and site caps.

        frames: iterable of (key, world_xyz, Rh, Th).
        """
        metas = []
        max_sh = np.zeros(3, np.int64)
        for key, wxyz, Rh, Th in frames:
            coord, out_sh, *_ = voxelize_frame(
                wxyz, Rh, Th, self.voxel_size, self.big_box, self.pad_axis)
            max_sh = np.maximum(max_sh, out_sh)
            metas.append(coord)
        self.out_sh = tuple(int(s) for s in max_sh)
        self.site_caps = tuple(compute_site_caps(metas, self.out_sh))
        # xtri aug-row capacities must be sequence-static too (frame geoms
        # are stacked / banked together)
        self.fix_caps = tuple(compute_fix_caps(
            metas, self.out_sh, self.site_caps))
        return self.out_sh, self.site_caps

    def _disk_path(self, key):
        if self.cache_dir is None:
            return None
        tag = "_".join(map(str, self.out_sh)) + "-" + \
            "_".join(map(str, self.site_caps)) + \
            f"-{self.voxel_size[0]:.4f}-t27xr"  # t27xr: + rowcum tables
        return os.path.join(self.cache_dir, f"geom_{key}_{tag}.npz")

    def frame(self, key, wxyz, Rh, Th):
        """Full frame payload: geometry tables + transforms (cached by key)."""
        if key in self._frames:
            return self._frames[key]
        assert self.out_sh is not None, "call finalize_static first"
        coord, _, can_bounds, bounds, R, Th2 = voxelize_frame(
            wxyz, Rh, Th, self.voxel_size, self.big_box, self.pad_axis)

        path = self._disk_path(key)
        if path is not None and os.path.exists(path):
            with np.load(path) as z:
                geom = {k: z[k] for k in z.files}
        else:
            geom = build_frame_geometry(
                coord, self.out_sh, list(self.site_caps),
                fix_caps=getattr(self, "fix_caps", None))
            if path is not None:
                os.makedirs(self.cache_dir, exist_ok=True)
                tmp = path + ".tmp.npz"   # .npz suffix: savez keeps the name
                np.savez_compressed(tmp, **geom)
                os.replace(tmp, path)

        payload = {
            "geom": geom,
            "can_bounds": can_bounds,
            "bounds": bounds,
            "R": R,
            "Th": Th2,
        }
        self._frames[key] = payload
        return payload


def load_vertices(data_root, vertices_dir, i):
    return np.load(
        os.path.join(data_root, vertices_dir, f"{i}.npy")).astype(np.float32)


def imread(path):
    """An image file as imageio.v2.imread reads it (RGB or RGBA channel
    order, a grey image 2-D), decoded by OpenCV, which the port needs
    anyway, so that imageio need not be installed. Both decode the JPEG
    and PNG files the datasets read to the same pixels
    (tests/test_torch_datasets.py holds the datasets against the JAX
    package's, which read with imageio)."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(f"no image could be read from {path}")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[2] == 4
                           else cv2.COLOR_BGR2RGB)
    return img
