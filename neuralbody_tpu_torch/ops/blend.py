"""LBS and pose-space utilities of the T-pose variant (counterpart of
neuralbody_tpu/ops/blend.py).

Functional equivalents of the reference blend utilities (ref:
lib/utils/blend_utils.py:6-83): blend-weight grid sampling with border
padding, and pose space <-> T pose through per-point blended bone
transforms.
"""
from __future__ import annotations

import torch

from .grid_sample import grid_sample_3d


def bounds_grid_sample_blend_weights(pts, bw, bounds):
    """Sample a blend-weight volume at world points.

    pts [N, 3] (pose-space xyz); bw [X, Y, Z, J] indexed by xyz;
    bounds [2, 3]. The normalization divides by the full extent (not
    extent - 1), as the reference does (blend_utils.py:34-40). Returns
    [N, J].
    """
    extent = bounds[1] - bounds[0]
    gc = (pts - bounds[0]) / extent * 2.0 - 1.0
    # the volume's spatial dims are (X, Y, Z) and the sampler's coord[0]
    # indexes the last one: xyz -> zyx (the reference's [..., [2, 1, 0]])
    return grid_sample_3d(bw, gc.flip(-1), padding_mode="border")


def _blend(bw, A):
    J = A.shape[0]
    return torch.einsum("nj,jab->nab", bw, A.reshape(J, 4, 4))


def ppts_to_pts(ppts, bw, A):
    """Pose space -> T pose: subtract the blended translation, then apply
    the inverse of the blended rotation (ref: blend_utils.py:73-83).

    ppts [N, 3]; bw [N, J]; A [J, 4, 4] skinning transforms.
    """
    T = _blend(bw, A)
    pts = ppts - T[:, :3, 3]
    R_inv = torch.linalg.inv(T[:, :3, :3])
    return torch.einsum("nab,nb->na", R_inv, pts)


def pts_to_ppts(pts, bw, A):
    """T pose -> pose space (forward skinning of points)."""
    T = _blend(bw, A)
    return torch.einsum("nab,nb->na", T[:, :3, :3], pts) + T[:, :3, 3]
