"""Dataset tools of the port (counterpart of the repository's
tools/dataset_tools.py). So far it holds the occupancy voxelizer, which
run.py's light_stage runner uses; the commands that pose an SMPL body
(annots, easymocap, snapshot) come with the T-pose slice.

    python -m neuralbody_tpu_torch.tools.dataset_tools occupancy \
        --ply points.ply --out occ.npz [--res 256]
"""
from __future__ import annotations

import argparse

import numpy as np


def cmd_occupancy(args):
    """Point cloud -> packed res^3 occupancy npz (ref: ply_to_occupancy.py)."""
    from scipy.spatial import cKDTree

    from ..utils.mesh_io import load_ply

    pts, _ = load_ply(args.ply)
    res = args.res
    mn, mx = pts.min(0), pts.max(0)
    center = (mn + mx) / 2
    scale = (mx - mn).max() * 1.05
    grid_lin = (np.arange(res) + 0.5) / res - 0.5
    gx, gy, gz = np.meshgrid(grid_lin, grid_lin, grid_lin, indexing="ij")
    q = np.stack([gx, gy, gz], -1).reshape(-1, 3) * scale + center
    tree = cKDTree(pts)
    # only the distances under the threshold decide a voxel: the bound
    # prunes the search (the JAX tool's unbounded query gives the same
    # occupancy, about ten times slower)
    d, _ = tree.query(q, k=1, distance_upper_bound=scale / res)
    occ = (d < scale / res).reshape(res, res, res).astype(np.uint8)
    np.savez_compressed(
        args.out,
        compressed_occupancies=np.packbits(occ.reshape(-1)),
        bounds=np.stack([mn, mx]).astype(np.float32))
    print(f"occupancy: {occ.sum()} voxels occupied -> {args.out}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    occ = sub.add_parser("occupancy")
    occ.add_argument("--ply", required=True)
    occ.add_argument("--res", type=int, default=256)
    occ.add_argument("--out", required=True)
    occ.set_defaults(fn=cmd_occupancy)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
