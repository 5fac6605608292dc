"""ZJU-MoCap multi-view dataset (train / test / novel-pose).
(Counterpart of neuralbody_tpu/datasets/zju_mocap.py: an own copy, numpy.)

Reproduces the reference dataset behavior (ref: lib/datasets/light_stage/
multi_view_dataset.py): annots.npy cameras, CIHP masks with a 5px
erode/dilate boundary marked 100, undistortion, `ratio` downscale,
mask_bkgd zeroing, per-view ray sampling, and novel-pose frame windows.
Adds the TPU frame-geometry tables via GeometryCache.
"""
from __future__ import annotations

import os

import numpy as np

from ..config import register
from . import ray_utils
from .frame_data import GeometryCache, imread, load_vertices, rodrigues

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def mask_with_boundary(msk_raw, border=5):
    """Binary mask with the erode/dilate boundary band set to 100
    (ref: multi_view_dataset.py:54-66)."""
    msk = (msk_raw != 0).astype(np.uint8)
    kernel = np.ones((border, border), np.uint8)
    eroded = cv2.erode(msk.copy(), kernel)
    dilated = cv2.dilate(msk.copy(), kernel)
    msk[(dilated - eroded) == 1] = 100
    return msk


@register("dataset", "multi_view")
class MultiViewDataset:
    def __init__(self, cfg, data_cfg, split):
        self.cfg = cfg
        self.split = split
        self.data_root = data_cfg.data_root
        self.human = data_cfg.human

        annots = np.load(data_cfg.ann_file, allow_pickle=True).item()
        self.cams = annots["cams"]

        num_cams = len(self.cams["K"])
        test_view = [i for i in range(num_cams)
                     if i not in cfg.training_view] or [0]
        view = cfg.training_view if split == "train" else test_view

        i = cfg.begin_ith_frame
        i_intv = cfg.frame_interval
        ni = cfg.num_train_frame
        if cfg.test_novel_pose:
            i = (i + cfg.num_train_frame) * i_intv
            ni = cfg.num_novel_pose_frame
            if self.human == "CoreView_390":
                i = 0

        self.ims = np.array([
            np.array(ims_data["ims"])[view]
            for ims_data in annots["ims"][i:i + ni * i_intv][::i_intv]
        ]).ravel()
        self.cam_inds = np.array([
            np.arange(len(ims_data["ims"]))[view]
            for ims_data in annots["ims"][i:i + ni * i_intv][::i_intv]
        ]).ravel()
        self.num_cams = len(view)
        self.nrays = cfg.N_rand

        cache_dir = (os.path.join(self.data_root, ".nb_tpu_cache")
                     if cfg.tpu.cache_frame_geometry else None)
        self.geo = GeometryCache(cfg.voxel_size, big_box=cfg.big_box,
                                 pad_axis=2, cache_dir=cache_dir)
        self._finalize_geometry(i, ni, i_intv)

    # -- geometry ---------------------------------------------------------
    def _frame_params(self, i):
        params = np.load(
            os.path.join(self.data_root, self.cfg.params, f"{i}.npy"),
            allow_pickle=True).item()
        return params["Rh"], params["Th"].astype(np.float32)

    def _frame_ids(self):
        """Distinct frame numbers referenced by self.ims (dataset order)."""
        ids = []
        for p in self.ims[::self.num_cams]:
            ids.append(self.frame_number(p))
        return ids

    def frame_number(self, img_path):
        if self.human in ["CoreView_313", "CoreView_315"]:
            return int(os.path.basename(img_path).split("_")[4])
        return int(os.path.basename(img_path)[:-4])

    def _finalize_geometry(self, i0, ni, i_intv):
        def frames():
            for i in self._frame_ids():
                wxyz = load_vertices(self.data_root, self.cfg.vertices, i)
                Rh, Th = self._frame_params(i)
                yield i, wxyz, Rh, Th
        self.geo.finalize_static(frames())

    # -- images -----------------------------------------------------------
    def get_mask(self, index):
        msk_path = os.path.join(
            self.data_root, "mask_cihp", self.ims[index])[:-4] + ".png"
        return mask_with_boundary(imread(msk_path))

    def __getitem__(self, index):
        cfg = self.cfg
        # image-size batch sampler passes (index, h, w); h=-1 keeps the
        # native ratio-scaled size (ref samplers.py:23-24, strategy=origin)
        target_hw = None
        if isinstance(index, tuple):
            index, th, tw = index
            if th > 0:
                target_hw = (int(th), int(tw))
        img_path = os.path.join(self.data_root, self.ims[index])
        img = imread(img_path).astype(np.float32) / 255.0
        img = cv2.resize(img, (cfg.W, cfg.H))
        msk = self.get_mask(index)

        cam_ind = self.cam_inds[index]
        K = np.array(self.cams["K"][cam_ind])
        D = np.array(self.cams["D"][cam_ind])
        img = cv2.undistort(img, K, D)
        msk = cv2.undistort(msk, K, D)

        R = np.array(self.cams["R"][cam_ind])
        T = np.array(self.cams["T"][cam_ind]) / 1000.0

        if target_hw is None:
            H, W = int(img.shape[0] * cfg.ratio), int(img.shape[1] * cfg.ratio)
            sy = sx = cfg.ratio
        else:
            H, W = target_hw
            sy, sx = H / img.shape[0], W / img.shape[1]
        img = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
        msk = cv2.resize(msk, (W, H), interpolation=cv2.INTER_NEAREST)
        if cfg.mask_bkgd:
            img[msk == 0] = 1 if cfg.white_bkgd else 0
        K = K.copy()
        K[0] = K[0] * sx
        K[1] = K[1] * sy

        i = self.frame_number(img_path)
        frame_index = i - 1 if self.human in ["CoreView_313",
                                              "CoreView_315"] else i

        wxyz = load_vertices(self.data_root, cfg.vertices, i)
        Rh, Th = self._frame_params(i)
        payload = self.geo.frame(i, wxyz, Rh, Th)

        if self.split == "train":
            if not hasattr(self, "_pools"):
                self._pools = ray_utils.PoolCache()
            rgb, ray_o, ray_d, near, far, coord_, mask_at_box = \
                ray_utils.sample_rays_train(
                    img, msk, K, R, T, payload["can_bounds"], self.nrays,
                    body_ratio=cfg.body_sample_ratio,
                    face_ratio=cfg.face_sample_ratio,
                    cache=self._pools,
                    cache_key=(index, img.shape[0], img.shape[1]))
        else:
            rgb, ray_o, ray_d, near, far, coord_, mask_at_box = \
                ray_utils.sample_rays_test(
                    img, K, R, T, payload["can_bounds"])

        latent_index = (frame_index - cfg.begin_ith_frame) // cfg.frame_interval
        if cfg.test_novel_pose:
            latent_index = cfg.num_train_frame - 1

        return {
            "geom": payload["geom"],
            # geom identity for the loader's ship-once worker protocol
            "geom_key": np.int32(i),
            "rgb": rgb, "ray_o": ray_o, "ray_d": ray_d,
            "near": near, "far": far,
            "mask_at_box": mask_at_box,
            "bounds": payload["bounds"],
            "R": payload["R"], "Th": payload["Th"],
            "latent_index": np.int32(latent_index),
            "frame_index": np.int32(frame_index),
            "cam_ind": np.int32(cam_ind),
            "img_hw": (H, W),
        }

    def __len__(self):
        return len(self.ims)
