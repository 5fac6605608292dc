"""Mesh-extraction datasets: dense world grids culled by the visual hull.

Mirrors the reference mesh datasets (ref: lib/datasets/light_stage/
multi_view_mesh_dataset.py:117-181, monocular_mesh_dataset.py): a dense
grid of points over the world bounds at voxel_size, kept where every
(dilated) source-view mask agrees, then padded to a static chunk multiple
for device evaluation. (Counterpart of
neuralbody_tpu/datasets/mesh_dataset.py: an own copy, numpy; masks are
read with frame_data.imread, OpenCV, to imageio's pixels.)
"""
from __future__ import annotations

import os

import cv2
import numpy as np

from ..config import register
from .frame_data import imread, load_vertices
from .ray_utils import project
from .zju_mocap import MultiViewDataset
from .snapshot import MonocularDataset


def world_grid(can_bounds, voxel_size):
    """Dense xyz grid over the world AABB (ref: :150-158)."""
    axes = [
        np.arange(can_bounds[0, a], can_bounds[1, a] + voxel_size[a],
                  voxel_size[a])
        for a in range(3)
    ]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return pts.astype(np.float32)


def hull_inside(pts, Ks, RTs, masks):
    """Visual-hull test: keep points projecting into every mask
    (ref: :117-140, progressive narrowing)."""
    sh = pts.shape[:-1]
    pts3d = pts.reshape(-1, 3)
    inside = np.ones(len(pts3d), np.uint8)
    for K, RT, msk in zip(Ks, RTs, masks):
        ind = inside == 1
        if not ind.any():
            break
        pts2d = np.round(project(pts3d[ind], K, RT)).astype(np.int32)
        H, W = msk.shape
        pts2d[:, 0] = np.clip(pts2d[:, 0], 0, W - 1)
        pts2d[:, 1] = np.clip(pts2d[:, 1], 0, H - 1)
        inside[ind] = msk[pts2d[:, 1], pts2d[:, 0]]
    return inside.reshape(sh)


@register("dataset", "multi_view_mesh")
class MultiViewMeshDataset(MultiViewDataset):
    """One item per frame; returns padded inside-hull points + geometry."""

    def __init__(self, cfg, data_cfg, split):
        super().__init__(cfg, data_cfg, split)
        self.pt_chunk = int(cfg.tpu.mesh_pt_chunk)

    def _dilated_mask(self, index_in_frame, nv):
        im = self.ims[index_in_frame * self.num_cams + nv]
        msk_path = os.path.join(self.data_root, "mask_cihp", im)[:-4] + ".png"
        msk = (imread(msk_path) != 0).astype(np.uint8)
        K = np.array(self.cams["K"][self.cam_inds[
            index_in_frame * self.num_cams + nv]])
        D = np.array(self.cams["D"][self.cam_inds[
            index_in_frame * self.num_cams + nv]])
        msk = cv2.undistort(msk, K, D)
        return cv2.dilate(msk, np.ones((5, 5), np.uint8))

    def __getitem__(self, index):
        cfg = self.cfg
        i = self.frame_number(self.ims[index * self.num_cams])
        frame_index = i - 1 if self.human in ["CoreView_313",
                                              "CoreView_315"] else i

        wxyz = load_vertices(self.data_root, cfg.vertices, i)
        Rh, Th = self._frame_params(i)
        payload = self.geo.frame(i, wxyz, Rh, Th)

        pts = world_grid(payload["can_bounds"], cfg.voxel_size)

        Ks, RTs, masks = [], [], []
        for nv in range(self.num_cams):
            ci = self.cam_inds[index * self.num_cams + nv]
            K = np.array(self.cams["K"][ci])
            R = np.array(self.cams["R"][ci])
            T = np.array(self.cams["T"][ci]) / 1000.0
            Ks.append(K)
            RTs.append(np.concatenate([R, T.reshape(3, 1)], axis=1))
            masks.append(self._dilated_mask(index, nv))
        inside = hull_inside(pts, Ks, RTs, masks)

        flat = pts.reshape(-1, 3)[inside.reshape(-1) == 1]
        n = len(flat)
        n_pad = -(-max(n, 1) // self.pt_chunk) * self.pt_chunk
        pts_pad = np.zeros((n_pad, 3), np.float32)
        pts_pad[:n] = flat

        latent_index = min(index, cfg.num_train_frame - 1)
        return {
            "geom": payload["geom"],
            "pts": pts_pad,
            "inside": inside,
            "grid_shape": inside.shape,
            "grid_min_xyz": payload["can_bounds"][0],
            "bounds": payload["bounds"],
            "R": payload["R"], "Th": payload["Th"],
            "latent_index": np.int32(latent_index),
            "frame_index": np.int32(frame_index),
            "img_hw": (int(cfg.H * cfg.ratio), int(cfg.W * cfg.ratio)),
        }

    def __len__(self):
        return len(self.ims) // self.num_cams


@register("dataset", "monocular_mesh")
class MonocularMeshDataset(MonocularDataset):
    """Monocular variant: hull from the single view's dilated mask."""

    def __init__(self, cfg, data_cfg, split):
        super().__init__(cfg, data_cfg, split)
        self.pt_chunk = int(cfg.tpu.mesh_pt_chunk)

    def __getitem__(self, index):
        cfg = self.cfg
        wxyz = load_vertices(self.data_root, "vertices", index)
        Rh, Th = self._frame_params(index)
        payload = self.geo.frame(index, wxyz, Rh, Th)

        pts = world_grid(payload["can_bounds"], cfg.voxel_size)

        msk = (imread(
            os.path.join(self.data_root, "mask", f"{index}.png")) != 0
        ).astype(np.uint8)
        msk = cv2.dilate(msk, np.ones((5, 5), np.uint8))
        K, R, T = self.cam["K"], self.cam["R"], self.cam["T"]
        RT = np.concatenate([R, T.reshape(3, 1)], axis=1)
        inside = hull_inside(pts, [K], [RT], [msk])

        flat = pts.reshape(-1, 3)[inside.reshape(-1) == 1]
        n = len(flat)
        n_pad = -(-max(n, 1) // self.pt_chunk) * self.pt_chunk
        pts_pad = np.zeros((n_pad, 3), np.float32)
        pts_pad[:n] = flat

        return {
            "geom": payload["geom"],
            "pts": pts_pad,
            "inside": inside,
            "grid_shape": inside.shape,
            "grid_min_xyz": payload["can_bounds"][0],
            "bounds": payload["bounds"],
            "R": payload["R"], "Th": payload["Th"],
            "latent_index": np.int32(min(index, cfg.num_train_frame - 1)),
            "frame_index": np.int32(index),
            "img_hw": (int(cfg.H * cfg.ratio), int(cfg.W * cfg.ratio)),
        }
