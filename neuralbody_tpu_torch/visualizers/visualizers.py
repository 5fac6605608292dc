"""Visualization sinks (counterpart of
neuralbody_tpu/visualizers/visualizers.py; numpy and OpenCV, host only).

Mirrors the reference visualizers (ref: lib/visualizers/): comparison
images during training eval, demo frame renders (novel-view orbit), perform
(novel-pose playback), cross-method pred_k.jpg layout, and mesh export.
A render's output and batch may arrive as tensors (eval_step's, on the card
or the CPU); each moves to numpy once per call.
"""
from __future__ import annotations

import os

import cv2
import numpy as np

from ..config import register
from ..evaluators.if_nerf import to_numpy
from ..utils.mesh_io import save_ply


def assemble_image(rays_rgb, mask_at_box, H, W, white_bkgd=False):
    img = np.zeros((H, W, 3)) + int(white_bkgd)
    img[mask_at_box.reshape(H, W)] = rays_rgb
    return img


def _valid_rgb(output, device_batch):
    n_valid = int(np.asarray(device_batch["ray_mask"][0]).sum())
    return np.asarray(output["rgb_map"][0])[:n_valid]


def _host(output, device_batch):
    """The render's output and the batch's ray mask and colours in numpy
    (to_numpy moves each tensor to the host once)."""
    return to_numpy(output), to_numpy(
        {k: device_batch[k] for k in ("ray_mask", "rgb") if k in device_batch})


@register("visualizer", "if_nerf")
class CompareVisualizer:
    """Side-by-side pred/gt (ref: lib/visualizers/if_nerf.py:7-29); saves
    PNGs instead of opening a matplotlib window."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.idx = 0

    def visualize(self, output, device_batch, meta):
        output, device_batch = _host(output, device_batch)
        H, W = meta["img_hw"]
        mask = np.asarray(meta["mask_at_box"])
        pred = assemble_image(_valid_rgb(output, device_batch), mask, H, W,
                              self.cfg.white_bkgd)
        gt_rays = np.asarray(device_batch["rgb"][0])[
            :int(np.asarray(device_batch["ray_mask"][0]).sum())]
        gt = assemble_image(gt_rays, mask, H, W, self.cfg.white_bkgd)
        out_dir = os.path.join(self.cfg.result_dir, "vis")
        os.makedirs(out_dir, exist_ok=True)
        both = np.concatenate([pred, gt], axis=1)
        cv2.imwrite(f"{out_dir}/{self.idx:04d}.png",
                    (both[..., ::-1] * 255))
        self.idx += 1


@register("visualizer", "if_nerf_demo")
class DemoVisualizer:
    """Novel-view orbit frames -> data/render/<exp>/frame_<i>/<view>.png
    (ref: lib/visualizers/if_nerf_demo.py:15-52)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def visualize(self, output, device_batch, meta):
        output, device_batch = _host(output, device_batch)
        cfg = self.cfg
        H, W = meta["img_hw"]
        mask = np.asarray(meta["mask_at_box"])
        pred = assemble_image(_valid_rgb(output, device_batch), mask, H, W,
                              cfg.white_bkgd)
        frame_index = int(meta.get("frame_index", 0))
        view_index = int(meta.get("view_index", meta.get("cam_ind", 0)))
        frame_dir = os.path.join("data/render", cfg.exp_name,
                                 f"frame_{frame_index:04d}")
        os.makedirs(frame_dir, exist_ok=True)
        cv2.imwrite(f"{frame_dir}/{view_index:04d}.png",
                    (pred[..., ::-1] * 255))


@register("visualizer", "if_nerf_perform")
class PerformVisualizer:
    """Novel-pose playback -> data/perform/<exp>/<i>.png
    (ref: lib/visualizers/if_nerf_perform.py:15-36)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.idx = 0

    def visualize(self, output, device_batch, meta):
        output, device_batch = _host(output, device_batch)
        cfg = self.cfg
        H, W = meta["img_hw"]
        mask = np.asarray(meta["mask_at_box"])
        pred = assemble_image(_valid_rgb(output, device_batch), mask, H, W,
                              cfg.white_bkgd)
        out_dir = os.path.join("data/perform", cfg.exp_name)
        os.makedirs(out_dir, exist_ok=True)
        cv2.imwrite(f"{out_dir}/{self.idx:04d}.png", (pred[..., ::-1] * 255))
        self.idx += 1


@register("visualizer", "if_nerf_test")
class TestLayoutVisualizer:
    """frame_i/pred_k.jpg cross-method comparison layout
    (ref: lib/visualizers/if_nerf_test.py:9-33)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def visualize(self, output, device_batch, meta):
        output, device_batch = _host(output, device_batch)
        cfg = self.cfg
        H, W = meta["img_hw"]
        mask = np.asarray(meta["mask_at_box"])
        pred = assemble_image(_valid_rgb(output, device_batch), mask, H, W,
                              cfg.white_bkgd)
        fi = int(meta.get("frame_index", 0))
        vi = int(meta.get("cam_ind", 0))
        out_dir = os.path.join(cfg.result_dir, f"frame_{fi}")
        os.makedirs(out_dir, exist_ok=True)
        cv2.imwrite(f"{out_dir}/pred_{vi}.jpg", (pred[..., ::-1] * 255))


@register("visualizer", "if_nerf_mesh")
class MeshVisualizer:
    """Export extracted mesh as .ply (ref: lib/visualizers/if_nerf_mesh.py).

    With cfg.vis_voxel_debug, also exports the reference's voxel debug view
    (ref if_nerf_mesh.py:13-24): threshold the density cube at mesh_th and
    emit the exposed-face quad mesh of the occupancy grid — saved as
    {frame}_voxel.ply rather than opened in a window."""

    def __init__(self, cfg):
        self.cfg = cfg

    def visualize_voxel(self, output, device_batch, meta):
        from ..utils.voxel_grid import VoxelGrid
        cube = np.array(output["cube"])
        cube = cube[10:-10, 10:-10, 10:-10]   # strip the mcubes pad
        occ = cube > float(self.cfg.mesh_th)
        sh = occ.shape
        square = np.zeros((max(sh),) * 3, bool)
        square[:sh[0], :sh[1], :sh[2]] = occ
        vertices, quads = VoxelGrid(square).to_mesh()
        # split quads into triangles for the .ply sink
        tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
        mesh_dir = os.path.join(self.cfg.result_dir, "mesh")
        os.makedirs(mesh_dir, exist_ok=True)
        i = int(meta.get("frame_index", 0))
        path = os.path.join(mesh_dir, f"{i:04d}_voxel.ply")
        save_ply(path, vertices, tris)
        return path

    def visualize(self, output, device_batch, meta):
        output, device_batch = _host(output, device_batch)
        mesh_dir = os.path.join(self.cfg.result_dir, "mesh")
        os.makedirs(mesh_dir, exist_ok=True)
        i = int(meta.get("frame_index", 0))
        save_ply(os.path.join(mesh_dir, f"{i:04d}.ply"),
                 output["vertices"], output.get("triangles"))
        if self.cfg.get("vis_voxel_debug", False):
            self.visualize_voxel(output, device_batch, meta)
