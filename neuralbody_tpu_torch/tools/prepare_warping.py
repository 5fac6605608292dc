"""Blend-weight and warping preparation of the T-pose variant (the port's
counterpart of the repository's tools/prepare_warping.py).

For each frame, build a dense grid over the POSED body's bounds and map
every grid point to its T-pose location through the blend weights of its
closest point ON the posed SMPL surface (closest-face barycentric
interpolation of the per-vertex weights, ref prepare_warping.py:195-199;
utils/surface.py) and the frame's inverse bone transforms (ops/blend.py).
Writes warping/{i}.npz (ptot_pts [X, Y, Z, 3], pbounds, tbounds) and
tvertices.npy under the data root, which datasets/tpose_dataset.py reads.

    python -m neuralbody_tpu_torch.tools.prepare_warping --data_root <seq> \
        --model_path SMPL_NEUTRAL.pkl [--ptot_vsize 0.02] [--device cpu]

The SMPL layer and the inverse skinning run on the card unless --device
says otherwise; the closest-surface search runs on the host (scipy).
write_synthetic_warping writes the same files for a sequence from
utils/smpl.make_synthetic_model posed with seeded random poses: a warp
that is not the identity, for fixtures (no SMPL model file needed).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch

from ..ops.blend import ppts_to_pts
from ..utils import smpl
from ..utils.platform import resolve_device
from ..utils.surface import barycentric_blend_weights


def warp_grid_for_frame(model, poses, ptot_vsize, pad=0.05, device="cpu"):
    """(ptot_pts [X, Y, Z, 3], the T-pose coordinates of the posed grid;
    pbounds [2, 3]; tbounds [2, 3]), numpy f32."""
    device = resolve_device(device)
    poses = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    # posed vertices in the SMPL (root) frame and the skinning transforms
    pverts, _ = smpl.lbs(model, poses, np.zeros(10, np.float32))
    pverts = pverts.cpu().numpy()
    rot = smpl.rodrigues(poses.reshape(-1, 3))
    joints = model["J_regressor"] @ model["v_template"]
    _, A = smpl.rigid_transform(rot, joints, model["parents"])

    tverts = model["v_template"]
    pbounds = np.stack([pverts.min(0) - pad, pverts.max(0) + pad])
    tbounds = np.stack([tverts.min(0) - pad, tverts.max(0) + pad])

    vs = np.asarray(ptot_vsize)
    axes = [np.arange(pbounds[0, a], pbounds[1, a] + vs[a], vs[a])
            for a in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    X, Y, Z = grid.shape[:3]
    flat = grid.reshape(-1, 3).astype(np.float32)

    if len(model["faces"]):
        # the closest SURFACE point's barycentric weights (the reference's)
        bw = barycentric_blend_weights(
            pverts, model["faces"], model["weights"], flat)   # [N, J]
    else:  # a faceless point cloud (synthetic fixtures): closest vertex
        from scipy.spatial import cKDTree
        _, nn = cKDTree(pverts).query(flat, k=1)
        bw = model["weights"][nn]                             # [N, J]

    tpts = ppts_to_pts(torch.as_tensor(flat, device=device),
                       torch.as_tensor(np.asarray(bw, np.float32),
                                       device=device), A)
    return (tpts.cpu().numpy().reshape(X, Y, Z, 3).astype(np.float32),
            pbounds.astype(np.float32), tbounds.astype(np.float32))


def write_frame(out_dir, i, ptot, pbounds, tbounds):
    np.savez_compressed(osp.join(out_dir, f"{i}.npz"), ptot_pts=ptot,
                        pbounds=pbounds, tbounds=tbounds)


def write_synthetic_warping(root, n_frames, n_verts=6890, ptot_vsize=0.02,
                            pose_std=0.02, seed=0, device=None):
    """tvertices.npy and warping/{i}.npz for frames 0..n_frames-1 of a
    sequence, from make_synthetic_model(n_verts, faces=True) with its blend
    weights raised to the 8th power and renormalized (near one-hot: the
    blended 3x3 blocks that ppts_to_pts inverts stay far from singular),
    each frame posed by N(0, pose_std) axis angles from a numpy seed (the
    model's joints sit near its centre, so larger poses swell the posed
    grid fast: 0.2 gives ~8x the points of 0.02). Returns the model."""
    model = smpl.make_synthetic_model(n_verts=n_verts, faces=True,
                                      seed=seed)
    w = model["weights"] ** 8
    model["weights"] = (w / w.sum(1, keepdims=True)).astype(np.float32)
    rng = np.random.RandomState(seed)
    out_dir = osp.join(root, "warping")
    os.makedirs(out_dir, exist_ok=True)
    np.save(osp.join(root, "tvertices.npy"),
            np.asarray(model["v_template"], np.float32))
    n_joints = len(model["parents"])
    for i in range(n_frames):
        poses = (rng.randn(n_joints * 3) * pose_std).astype(np.float32)
        write_frame(out_dir, i, *warp_grid_for_frame(
            model, poses, (ptot_vsize,) * 3, device=device))
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--params_dir", default="params")
    ap.add_argument("--out_dir", default="warping")
    ap.add_argument("--ptot_vsize", type=float, default=0.02)
    ap.add_argument("--device", default=None,
                    help="the SMPL layer's device (default: the card)")
    args = ap.parse_args(argv)

    model = smpl.load_model(args.model_path)
    params_dir = osp.join(args.data_root, args.params_dir)
    out_dir = osp.join(args.data_root, args.out_dir)
    os.makedirs(out_dir, exist_ok=True)

    # the canonical template's vertices: the T-pose dataset voxelizes them
    np.save(osp.join(args.data_root, "tvertices.npy"),
            np.asarray(model["v_template"], np.float32))

    for fn in sorted(os.listdir(params_dir),
                     key=lambda s: int(s.split(".")[0])):
        i = fn.split(".")[0]
        params = np.load(osp.join(params_dir, fn), allow_pickle=True).item()
        poses = np.asarray(params["poses"]).reshape(-1)
        ptot, pbounds, tbounds = warp_grid_for_frame(
            model, poses, (args.ptot_vsize,) * 3, device=args.device)
        write_frame(out_dir, i, ptot, pbounds, tbounds)
        print(f"frame {i}: warped grid {ptot.shape}")


if __name__ == "__main__":
    main()
