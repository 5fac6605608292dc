"""Novel-view PSNR/SSIM evaluators (counterpart of
neuralbody_tpu/evaluators/if_nerf.py; numpy and OpenCV, host only).

The reference evaluation protocol (ref: lib/evaluators/if_nerf.py:9-91):
rays are re-assembled into an H x W image through the mask_at_box hit
mask; PSNR over the masked pixels (or the whole image when
cfg.eval_whole_img), SSIM on the cv2.boundingRect crop (or the whole
image); comparison PNG pairs and metrics.npy are written under
cfg.result_dir. The render's output arrives as tensors (eval_step's, on
the card or the CPU) and moves to numpy once per batch.
"""
from __future__ import annotations

import os

import numpy as np

from ..config import register
from ..datasets.frame_data import imread
from .metrics import psnr, ssim

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def to_numpy(tree):
    """Tensors (any device) and arrays of a dict -> numpy arrays, each
    moved to the host once."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def _meta_at(meta, key, b, batch):
    """Per-element meta value: collate keeps a list for B > 1, the bare
    value for B = 1 (datasets/loader.collate)."""
    v = meta[key]
    return v[b] if batch > 1 else v


@register("evaluator", "if_nerf")
class Evaluator:
    def __init__(self, cfg):
        self.cfg = cfg
        self.mse, self.psnr, self.ssim = [], [], []
        # the last assembled (pred, gt) pair, for the recorder's image panel
        self.last_images = None

    def _assemble(self, rays_rgb, mask_at_box, H, W):
        img = np.zeros((H, W, 3)) + int(self.cfg.white_bkgd)
        img[mask_at_box.reshape(H, W)] = rays_rgb
        return img

    def evaluate(self, output, device_batch, meta):
        output, device_batch = to_numpy(output), to_numpy(device_batch)
        batch = int(device_batch["ray_mask"].shape[0])
        for b in range(batch):
            self._evaluate_one(output, device_batch, meta, b, batch)

    def _evaluate_one(self, output, device_batch, meta, b, batch):
        cfg = self.cfg
        n_valid = int(device_batch["ray_mask"][b].sum())
        rgb_pred = output["rgb_map"][b][:n_valid]
        rgb_gt = device_batch["rgb"][b][:n_valid]

        H, W = _meta_at(meta, "img_hw", b, batch)
        mask_at_box = np.asarray(_meta_at(meta, "mask_at_box", b, batch))
        img_pred = self._assemble(rgb_pred, mask_at_box, H, W)
        img_gt = self._assemble(rgb_gt, mask_at_box, H, W)

        if cfg.eval_whole_img:
            mse = np.mean((img_pred - img_gt) ** 2)
            psnr_v = psnr(img_pred, img_gt)
        else:
            mse = np.mean((rgb_pred - rgb_gt) ** 2)
            psnr_v = psnr(rgb_pred, rgb_gt)
        self.mse.append(mse)
        self.psnr.append(psnr_v)

        sp, sg = img_pred, img_gt
        if not cfg.eval_whole_img:
            x, y, w, h = cv2.boundingRect(
                mask_at_box.reshape(H, W).astype(np.uint8))
            sp = img_pred[y:y + h, x:x + w]
            sg = img_gt[y:y + h, x:x + w]
        self.ssim.append(ssim(sp, sg, multichannel=True))

        self.last_images = (img_pred, img_gt)
        self._write_comparison(img_pred, img_gt, meta, b, batch)

    def _write_comparison(self, img_pred, img_gt, meta, b=0, batch=1):
        result_dir = os.path.join(self.cfg.result_dir, "comparison")
        os.makedirs(result_dir, exist_ok=True)
        fi = int(_meta_at(meta, "frame_index", b, batch)
                 if "frame_index" in meta else 0)
        vi = int(_meta_at(meta, "cam_ind", b, batch)
                 if "cam_ind" in meta else 0)
        cv2.imwrite(f"{result_dir}/frame{fi:04d}_view{vi:04d}.png",
                    (img_pred[..., ::-1] * 255))
        cv2.imwrite(f"{result_dir}/frame{fi:04d}_view{vi:04d}_gt.png",
                    (img_gt[..., ::-1] * 255))

    def summarize(self):
        result_dir = self.cfg.result_dir
        os.makedirs(result_dir, exist_ok=True)
        metrics = {"mse": self.mse, "psnr": self.psnr, "ssim": self.ssim}
        np.save(os.path.join(result_dir, "metrics.npy"), metrics)
        out = {k: float(np.mean(v)) if v else float("nan")
               for k, v in metrics.items()}
        print(f"mse: {out['mse']}")
        print(f"psnr: {out['psnr']}")
        print(f"ssim: {out['ssim']}")
        self.mse, self.psnr, self.ssim = [], [], []
        return out


@register("evaluator", "neural_volume")
class NeuralVolumeEvaluator(Evaluator):
    """Score a competitor method's saved renders against the ground truth
    with the same masking (ref: lib/evaluators/neural_volume.py:37-84):
    reads frame_{i}/pred_{cam + 1}.jpg under cfg.pred_result_dir instead of
    the network's output."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.pred_root = cfg.get(
            "pred_result_dir",
            os.path.join("data/result/neural_volumes", f"{cfg.human}_nv"))

    def evaluate(self, output, device_batch, meta):
        device_batch = to_numpy(device_batch)
        i = int(meta.get("frame_index", 0))
        cam_ind = int(meta.get("cam_ind", 0))
        pred_path = os.path.join(self.pred_root, f"frame_{i}",
                                 f"pred_{cam_ind + 1}.jpg")

        H, W = meta["img_hw"]
        mask_at_box = np.asarray(meta["mask_at_box"]).reshape(H, W)
        n_valid = int(device_batch["ray_mask"][0].sum())
        rgb_gt = device_batch["rgb"][0][:n_valid]
        img_gt = np.zeros((H, W, 3))
        img_gt[mask_at_box] = rgb_gt

        img_pred = imread(pred_path).astype(np.float32) / 255.0
        img_pred[mask_at_box != 1] = 0
        rgb_pred = img_pred[mask_at_box]

        self.mse.append(np.mean((rgb_pred - rgb_gt) ** 2))
        self.psnr.append(psnr(rgb_pred, rgb_gt))
        x, y, w, h = cv2.boundingRect(mask_at_box.astype(np.uint8))
        self.ssim.append(ssim(img_pred[y:y + h, x:x + w],
                              img_gt[y:y + h, x:x + w], multichannel=True))


@register("evaluator", "if_nerf_mesh")
class MeshEvaluator:
    """Dump the thresholded density points of a mesh render
    (ref: lib/evaluators/if_nerf_mesh.py)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def evaluate(self, output, device_batch, meta):
        cube = to_numpy(output)["cube"]
        result_dir = os.path.join(self.cfg.result_dir, "mesh")
        os.makedirs(result_dir, exist_ok=True)
        i = int(meta.get("frame_index", 0))
        inside = cube > self.cfg.mesh_th
        np.save(os.path.join(result_dir, f"{i:04d}.npy"),
                np.argwhere(inside))

    def summarize(self):
        return {}
