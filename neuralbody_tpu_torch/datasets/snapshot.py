"""People-Snapshot monocular dataset.
(Counterpart of neuralbody_tpu/datasets/snapshot.py: an own copy, numpy.)

Reproduces the reference monocular dataset (ref: lib/datasets/light_stage/
monocular_dataset.py): camera.pkl intrinsics, params.npy pose/trans,
per-frame vertices, y-axis bound padding (+-0.1), train-split ray sampling
from msk!=0 (sample_ray, not the h36m variant).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..config import register
from . import ray_utils
from .frame_data import GeometryCache, imread, load_vertices

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def load_snapshot_camera(camera_path):
    """camera.pkl -> dict(K, D, R, T) (ref: lib/utils/
    snapshot_data_utils.py:12-23)."""
    with open(camera_path, "rb") as f:
        cam = pickle.load(f, encoding="latin1")
    K = np.zeros((3, 3), np.float32)
    K[0, 0], K[1, 1] = cam["camera_f"]
    K[:2, 2] = cam["camera_c"]
    K[2, 2] = 1
    R = np.eye(3, dtype=np.float32)
    T = np.zeros(3, np.float32)
    D = cam["camera_k"] if "camera_k" in cam else np.zeros(5)
    return {"K": K, "D": np.asarray(D, np.float32).reshape(-1),
            "R": R, "T": T}


@register("dataset", "monocular")
class MonocularDataset:
    def __init__(self, cfg, data_cfg, split):
        self.cfg = cfg
        self.split = split
        self.data_root = data_cfg.data_root

        self.cam = load_snapshot_camera(
            os.path.join(self.data_root, "camera.pkl"))
        self.params = np.load(data_cfg.ann_file, allow_pickle=True).item()
        self.num_train_frame = cfg.num_train_frame
        self.nrays = cfg.N_rand

        cache_dir = (os.path.join(self.data_root, ".nb_tpu_cache")
                     if cfg.tpu.cache_frame_geometry else None)
        self.geo = GeometryCache(cfg.voxel_size, big_box=cfg.big_box,
                                 pad_axis=1, cache_dir=cache_dir)
        self.geo.finalize_static(self._frames())

    def _frame_params(self, i):
        Rh = self.params["pose"][i][:3]
        Th = self.params["trans"][i].astype(np.float32)
        return Rh, Th

    def _frames(self):
        for i in range(self.num_train_frame):
            wxyz = load_vertices(self.data_root, "vertices", i)
            Rh, Th = self._frame_params(i)
            yield i, wxyz, Rh, Th

    def __getitem__(self, index):
        cfg = self.cfg
        img = imread(
            os.path.join(self.data_root, "image", f"{index}.jpg")
        ).astype(np.float32) / 255.0
        msk = imread(
            os.path.join(self.data_root, "mask", f"{index}.png"))

        K, D = self.cam["K"], self.cam["D"]
        img = cv2.undistort(img, K, D)
        msk = cv2.undistort(msk, K, D)
        R, T = self.cam["R"], self.cam["T"]

        wxyz = load_vertices(self.data_root, "vertices", index)
        Rh, Th = self._frame_params(index)
        payload = self.geo.frame(index, wxyz, Rh, Th)

        H, W = int(img.shape[0] * cfg.ratio), int(img.shape[1] * cfg.ratio)
        img = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
        msk = cv2.resize(msk, (W, H), interpolation=cv2.INTER_NEAREST)
        if cfg.mask_bkgd:
            img[msk == 0] = 1 if cfg.white_bkgd else 0
        K = K.copy()
        K[:2] = K[:2] * cfg.ratio

        if self.split == "train":
            if not hasattr(self, "_pools"):
                self._pools = ray_utils.PoolCache()
            rgb, ray_o, ray_d, near, far, coord_, mask_at_box = \
                ray_utils.sample_rays_train(
                    img, msk, K, R, T, payload["can_bounds"], self.nrays,
                    body_ratio=cfg.body_sample_ratio,
                    face_ratio=cfg.face_sample_ratio,
                    body_nonzero=True, exclude_boundary=False,
                    cache=self._pools,
                    cache_key=(index, img.shape[0], img.shape[1]))
        else:
            rgb, ray_o, ray_d, near, far, coord_, mask_at_box = \
                ray_utils.sample_rays_test(
                    img, K, R, T, payload["can_bounds"])

        return {
            "geom": payload["geom"],
            "geom_key": np.int32(index),
            "rgb": rgb, "ray_o": ray_o, "ray_d": ray_d,
            "near": near, "far": far,
            "mask_at_box": mask_at_box,
            "bounds": payload["bounds"],
            "R": payload["R"], "Th": payload["Th"].reshape(1, 3),
            "latent_index": np.int32(index),
            "frame_index": np.int32(index),
            "cam_ind": np.int32(0),
            "img_hw": (H, W),
        }

    def __len__(self):
        return self.num_train_frame
