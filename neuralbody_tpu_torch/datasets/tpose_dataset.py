"""T-pose (TPAMI) dataset: multi-view rays plus canonical-space geometry
(counterpart of neuralbody_tpu/datasets/tpose_dataset.py; numpy).

The images and rays come from the ZJU multi-view pipeline, while the
encoder's geometry lives in T-POSE space: the vertex codes are voxelized
once from the canonical template (tvertices.npy), and each frame carries
the warped-grid fields that tools/prepare_warping.py writes
(warping/{i}.npz: ptot_pts [X, Y, Z, 3], the T-pose coordinates of a dense
posed-space grid, pbounds, tbounds).

Static shapes: the frames' warped grids differ in extent, so each is
padded (edge-replicated) to the largest over the frames; the renderer
normalizes posed coordinates by this static ptot_shape, which keeps the
voxel -> index mapping exact for the real entries. Every sample shares one
geometry, under the key -1 (num_geoms = 1: one row of the device bank).
"""
from __future__ import annotations

import os

import numpy as np

from ..config import register
from ..ops.sparse_conv import build_frame_geometry, compute_site_caps
from .zju_mocap import MultiViewDataset


class _TGeo:
    """Static T-pose geometry (the model_static contract: out_sh + caps)."""

    def __init__(self, out_sh, site_caps, geom, tbounds):
        self.out_sh = out_sh
        self.site_caps = site_caps
        self.geom = geom
        self.tbounds = tbounds


def build_tpose_geometry(tverts, voxel_size, pad=0.05):
    """Canonical template vertices -> sparse-conv tables in T-pose space.

    Coordinates are in xyz order (the T-pose renderer normalizes xyz and
    flips to zyx at the sample; renderer/tpose_renderer.py)."""
    tb = np.stack([tverts.min(0) - pad, tverts.max(0) + pad]).astype(
        np.float32)
    vs = np.asarray(voxel_size, np.float32)
    coord = np.round((tverts - tb[0]) / vs).astype(np.int32)
    out_sh = ((np.ceil((tb[1] - tb[0]) / vs).astype(np.int64)) | 31) + 1
    out_sh = tuple(int(s) for s in out_sh)
    caps = compute_site_caps([coord], out_sh)
    geom = build_frame_geometry(coord, out_sh, caps)
    return _TGeo(out_sh, tuple(caps), geom, tb)


@register("dataset", "tpose")
class TposeDataset(MultiViewDataset):
    num_geoms = 1  # one shared T-pose geometry (the bank's capacity)

    def __init__(self, cfg, data_cfg, split):
        super().__init__(cfg, data_cfg, split)

        tverts = np.load(os.path.join(
            self.data_root, "tvertices.npy")).astype(np.float32)
        self.tgeo = build_tpose_geometry(tverts, cfg.voxel_size)

        # the frames' warped grids, padded to one static shape
        warp_dir = os.path.join(self.data_root,
                                cfg.get("warping_dir", "warping"))
        self._warp = {}
        max_sh = np.zeros(3, np.int64)
        for i in self._frame_ids():
            with np.load(os.path.join(warp_dir, f"{i}.npz")) as z:
                self._warp[i] = {k: z[k] for k in z.files}
            max_sh = np.maximum(max_sh, self._warp[i]["ptot_pts"].shape[:3])
        self.ptot_shape = tuple(int(s) for s in max_sh)
        for w in self._warp.values():
            sh = w["ptot_pts"].shape[:3]
            pad = [(0, self.ptot_shape[a] - sh[a]) for a in range(3)]
            w["ptot_pts"] = np.pad(w["ptot_pts"], pad + [(0, 0)],
                                   mode="edge")

    def __getitem__(self, index):
        sample = super().__getitem__(index)
        i = (int(sample["frame_index"])
             + (1 if self.human in ["CoreView_313", "CoreView_315"] else 0))
        warp = self._warp[i]
        sample["geom"] = self.tgeo.geom
        sample["geom_key"] = np.int32(-1)  # one shared T-pose geometry
        sample["tbounds"] = warp["tbounds"]
        sample["pbounds"] = warp["pbounds"]
        sample["ptot_pts"] = warp["ptot_pts"].reshape(-1, 3)
        return sample
