"""Demo/visualization datasets: novel-view orbit, novel-pose playback,
rotate-SMPL, and the monocular demo.

Mirror the reference demo datasets (ref: lib/datasets/light_stage/
multi_view_demo_dataset.py, multi_view_perform_dataset.py,
rotate_smpl_dataset.py, monocular_demo_dataset.py): full-image rays inside
the body AABB from generated camera paths, source-view masks for
visual-hull culling, and SMPL rotation demos. (Counterpart of
neuralbody_tpu/datasets/demo_datasets.py: an own copy, numpy; masks
are read with frame_data.imread, OpenCV, to imageio's pixels.)
"""
from __future__ import annotations

import os

import cv2
import numpy as np

from ..config import register
from ..ops.sparse_conv import build_frame_geometry
from . import ray_utils, render_path
from .frame_data import imread, load_vertices, rodrigues, voxelize_frame
from .snapshot import MonocularDataset
from .zju_mocap import MultiViewDataset


class _DemoBase(MultiViewDataset):
    """Shared machinery: render path, per-view dilated masks."""

    def __init__(self, cfg, data_cfg, split):
        # demo datasets always index images by the TRAINING views
        # (ref: multi_view_demo_dataset.py:33-36), whatever the split
        super().__init__(cfg, data_cfg, "train")
        self.split = split
        self.Ks_full, self.RTs_full = render_path.load_cam(
            data_cfg.ann_file, cfg.ratio)
        tv = list(cfg.training_view)
        self.render_K = self.Ks_full[0]
        self.Ks = np.array(self.Ks_full, np.float32)[tv]
        self.RT = np.array(self.RTs_full, np.float32)[tv]
        self.Ds = np.array(self.cams["D"], np.float32)[tv]
        self.img_hw = (int(cfg.H * cfg.ratio), int(cfg.W * cfg.ratio))

    def view_masks(self, frame_pos):
        """Dilated training-view masks at render resolution
        (ref: multi_view_demo_dataset.py:107-130)."""
        H, W = self.img_hw
        msks = []
        for nv in range(self.num_cams):
            im = self.ims[frame_pos * self.num_cams + nv]
            msk_path = os.path.join(
                self.data_root, "mask_cihp", im)[:-4] + ".png"
            msk = (imread(msk_path) != 0).astype(np.uint8)
            K = self.Ks[nv].copy()
            K[:2] = K[:2] / self.cfg.ratio
            msk = cv2.undistort(msk, K, self.Ds[nv])
            msk = cv2.dilate(msk, np.ones((5, 5), np.uint8))
            msk = cv2.resize(msk, (W, H), interpolation=cv2.INTER_NEAREST)
            msks.append(msk)
        return np.array(msks, np.float32)

    def _frame_payload(self, i):
        wxyz = load_vertices(self.data_root, self.cfg.vertices, i)
        Rh, Th = self._frame_params(i)
        return self.geo.frame(i, wxyz, Rh, Th)

    def _ray_item(self, w2c, payload, msks, latent_index, frame_index,
                  view_index):
        H, W = self.img_hw
        ray_o, ray_d, near, far, hit = ray_utils.image_rays(
            w2c, self.render_K, payload["can_bounds"], H, W)
        return {
            "geom": payload["geom"],
            "rgb": np.zeros_like(ray_o),
            "ray_o": ray_o, "ray_d": ray_d, "near": near, "far": far,
            "mask_at_box": hit,
            "bounds": payload["bounds"],
            "R": payload["R"], "Th": payload["Th"],
            "latent_index": np.int32(latent_index),
            "frame_index": np.int32(frame_index),
            "view_index": np.int32(view_index),
            "cam_ind": np.int32(view_index),
            "img_hw": (H, W),
            "Ks": self.Ks, "RT": self.RT, "msks": msks,
        }


@register("dataset", "multi_view_demo")
class NovelViewDataset(_DemoBase):
    """Orbit around one frame (ref: multi_view_demo_dataset.py)."""

    def __init__(self, cfg, data_cfg, split):
        super().__init__(cfg, data_cfg, split)
        self.render_w2c = render_path.gen_orbit_path(
            self.RTs_full, cfg.num_render_views)

    def __getitem__(self, index):
        cfg = self.cfg
        i = cfg.ith_frame
        frame_index = i + cfg.begin_ith_frame
        fid = self.frame_number(self.ims[i * self.num_cams])
        payload = self._frame_payload(fid)
        msks = self.view_masks(i)
        latent = min(i, cfg.num_train_frame - 1)
        return self._ray_item(self.render_w2c[index], payload, msks,
                              latent, frame_index, index)

    def __len__(self):
        return len(self.render_w2c)


@register("dataset", "multi_view_perform")
class PerformDataset(_DemoBase):
    """Novel-pose playback with rotating camera
    (ref: multi_view_perform_dataset.py:129-176)."""

    def __init__(self, cfg, data_cfg, split):
        super().__init__(cfg, data_cfg, split)
        self.render_w2c = render_path.gen_orbit_path(
            self.RTs_full, cfg.num_render_views)
        self.ni = (cfg.num_render_frame if cfg.num_render_frame > 0
                   else len(self.ims) // self.num_cams)

    def __getitem__(self, index):
        cfg = self.cfg
        frame_index = index + cfg.begin_ith_frame
        fid = self.frame_number(self.ims[index * self.num_cams])
        payload = self._frame_payload(fid)
        msks = self.view_masks(index)
        cam_ind = index % len(self.render_w2c)
        latent = min(index, cfg.num_train_frame - 1)
        return self._ray_item(self.render_w2c[cam_ind], payload, msks,
                              latent, frame_index, cam_ind)

    def __len__(self):
        return self.ni


@register("dataset", "rotate_smpl")
class RotateSmplDataset(_DemoBase):
    """Render one frame with the SMPL rotated over 144 azimuths
    (ref: rotate_smpl_dataset.py:29-126): vertices rotate about their
    centroid; Rh/Th are composed with the rotation so the SMPL-frame
    voxelization stays canonical."""

    def __init__(self, cfg, data_cfg, split):
        super().__init__(cfg, data_cfg, split)
        self.ts = np.arange(0, np.pi * 2, np.pi / 72)

    def _rotated_payload(self, fid, index):
        cfg = self.cfg
        wxyz = load_vertices(self.data_root, cfg.vertices, fid)
        wxyz, rot, center = render_path.rotate_points_y(
            wxyz, self.ts[index], plane=(0, 1))
        Rh, Th = self._frame_params(fid)
        R = rot @ rodrigues(Rh)
        Th = (rot * (Th.reshape(3) - center)).sum(1) + center
        # rotation changes world bounds per index: bypass the frame cache
        coord, _, can_bounds, bounds, R2, Th2 = voxelize_frame(
            wxyz, R, Th, cfg.voxel_size, cfg.big_box, pad_axis=2)
        geom = build_frame_geometry(
            coord, self.geo.out_sh, list(self.geo.site_caps))
        return {"geom": geom, "can_bounds": can_bounds, "bounds": bounds,
                "R": R2, "Th": Th2}

    def __getitem__(self, index):
        cfg = self.cfg
        i = cfg.ith_frame
        fid = self.frame_number(self.ims[i * self.num_cams])
        payload = self._rotated_payload(fid, index)
        msks = self.view_masks(i)
        latent = min(i, cfg.num_train_frame - 1)
        return self._ray_item(self.RTs_full[0], payload, msks,
                              latent, i + cfg.begin_ith_frame, index)

    def __len__(self):
        return len(self.ts)


@register("dataset", "monocular_demo")
class MonocularDemoDataset(MonocularDataset):
    """Rotate the SMPL under the fixed monocular camera
    (ref: monocular_demo_dataset.py)."""

    def __init__(self, cfg, data_cfg, split):
        super().__init__(cfg, data_cfg, split)
        self.ts = np.arange(0, np.pi * 2, np.pi / 72)
        self.img_hw = (int(cfg.H * cfg.ratio), int(cfg.W * cfg.ratio))

    def __getitem__(self, index):
        cfg = self.cfg
        i = 0
        wxyz = load_vertices(self.data_root, "vertices", i)
        wxyz, rot, center = render_path.rotate_points_y(
            wxyz, self.ts[index], plane=(0, 2))
        Rh, Th0 = self._frame_params(i)
        R = rot @ rodrigues(Rh)
        Th = (rot * (Th0.reshape(3) - center)).sum(1) + center

        coord, _, can_bounds, bounds, R2, Th2 = voxelize_frame(
            wxyz, R, Th, cfg.voxel_size, cfg.big_box, pad_axis=1)
        geom = build_frame_geometry(
            coord, self.geo.out_sh, list(self.geo.site_caps))

        H, W = self.img_hw
        msk = imread(
            os.path.join(self.data_root, "mask", f"{i}.png"))
        K, D = self.cam["K"], self.cam["D"]
        msk = cv2.undistort(msk, K, D)
        msk = cv2.resize(msk, (W, H), interpolation=cv2.INTER_NEAREST)
        msk = cv2.dilate((msk != 0).astype(np.uint8),
                         np.ones((5, 5), np.uint8)).astype(np.float32)
        K = K.copy()
        K[:2] = K[:2] * cfg.ratio
        RT = np.concatenate(
            [self.cam["R"], self.cam["T"].reshape(3, 1)], axis=1)

        ray_o, ray_d, near, far, hit = ray_utils.image_rays(
            RT, K, can_bounds, H, W)
        return {
            "geom": geom,
            "rgb": np.zeros_like(ray_o),
            "ray_o": ray_o, "ray_d": ray_d, "near": near, "far": far,
            "mask_at_box": hit,
            "bounds": bounds, "R": R2, "Th": Th2,
            "latent_index": np.int32(i),
            "frame_index": np.int32(i),
            "view_index": np.int32(index),
            "cam_ind": np.int32(index),
            "img_hw": (H, W),
            # snapshot-hull fields (ref: if_clight_renderer_msk.py:12-49)
            "R0_snap": rodrigues(Rh), "Th0_snap": Th0.reshape(3),
            "K": K.astype(np.float32),
            "RT": RT.astype(np.float32)[None],
            "msks": msk[None],
        }

    def __len__(self):
        return len(self.ts)
