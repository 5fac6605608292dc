"""Closest point on a triangle mesh, with barycentric coordinates (the
port's own copy of neuralbody_tpu/utils/surface.py: numpy and scipy).

Replaces psbody.mesh's closest_faces_and_points /
barycentric_coordinates_for_points used by the reference blend-weight prep
(ref: tools/prepare_warping.py:186-199): grid points take the blend
weights of their closest SURFACE point (barycentric over the face), not
the closest vertex — which matters in concave regions (armpits, groin)
where the nearest vertex can belong to the wrong body part.

Pure numpy; exact point-triangle projection (Ericson, "Real-Time
Collision Detection" §5.1.5) on k candidate faces from a centroid
KD-tree. For SMPL-density meshes (~13.8k faces) k=16 recovers the true
nearest face essentially always (validated against brute force in
tests/test_tools.py, which holds the JAX package's copy).
"""
from __future__ import annotations

import numpy as np


def _point_triangle_bary(p, a, b, c):
    """Barycentric coords of the closest point on triangle (a,b,c) to p.

    All inputs [..., 3]; returns bary [..., 3] with bary @ (a,b,c) the
    closest point. Vectorized over leading dims.
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = np.einsum("...i,...i->...", ab, ap)
    d2 = np.einsum("...i,...i->...", ac, ap)
    bp = p - b
    d3 = np.einsum("...i,...i->...", ab, bp)
    d4 = np.einsum("...i,...i->...", ac, bp)
    cp = p - c
    d5 = np.einsum("...i,...i->...", ab, cp)
    d6 = np.einsum("...i,...i->...", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    with np.errstate(divide="ignore", invalid="ignore"):
        v_ab = d1 / (d1 - d3)
        w_ac = d2 / (d2 - d6)
        w_bc = (d4 - d3) / ((d4 - d3) + (d5 - d6))
        denom = 1.0 / np.maximum(va + vb + vc, 1e-30)
    v_in = vb * denom
    w_in = vc * denom

    zero = np.zeros_like(d1)
    one = np.ones_like(d1)
    conds = [
        (d1 <= 0) & (d2 <= 0),                       # vertex A
        (d3 >= 0) & (d4 <= d3),                      # vertex B
        (d6 >= 0) & (d5 <= d6),                      # vertex C
        (vc <= 0) & (d1 >= 0) & (d3 <= 0),           # edge AB
        (vb <= 0) & (d2 >= 0) & (d6 <= 0),           # edge AC
        (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),  # edge BC
    ]
    u_cands = [one, zero, zero, 1 - v_ab, 1 - w_ac, zero]
    v_cands = [zero, one, zero, v_ab, zero, 1 - w_bc]
    w_cands = [zero, zero, one, zero, w_ac, w_bc]
    u = np.select(conds, u_cands, default=1 - v_in - w_in)
    v = np.select(conds, v_cands, default=v_in)
    w = np.select(conds, w_cands, default=w_in)
    return np.stack([u, v, w], axis=-1)


def closest_point_on_mesh(verts, faces, query, k=16):
    """Closest surface point for each query point.

    Args:
      verts: [V, 3] float mesh vertices.
      faces: [F, 3] int triangle indices.
      query: [N, 3] float query points.
      k: candidate faces per query (centroid KD-tree neighbors).

    Returns:
      face_id [N] int, vert_ids [N, 3] int, bary [N, 3] float,
      points [N, 3] float (the closest surface points).
    """
    from scipy.spatial import cKDTree

    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    query = np.asarray(query, np.float64)
    k = min(int(k), len(faces))

    tri = verts[faces]                                  # [F, 3, 3]
    centroids = tri.mean(axis=1)
    _, cand = cKDTree(centroids).query(query, k=k)      # [N, k]
    if k == 1:
        cand = cand[:, None]

    a = tri[cand, 0]                                    # [N, k, 3]
    b = tri[cand, 1]
    c = tri[cand, 2]
    bary = _point_triangle_bary(query[:, None, :], a, b, c)   # [N, k, 3]
    closest = (bary[..., 0:1] * a + bary[..., 1:2] * b
               + bary[..., 2:3] * c)                    # [N, k, 3]
    d2 = np.einsum("nki,nki->nk", query[:, None] - closest,
                   query[:, None] - closest)
    best = np.argmin(d2, axis=1)
    rows = np.arange(len(query))
    face_id = cand[rows, best]
    return (face_id.astype(np.int64), faces[face_id],
            bary[rows, best].astype(np.float64),
            closest[rows, best])


def barycentric_blend_weights(verts, faces, vert_weights, query, k=16):
    """Blend weights of the closest surface point for each query
    (the reference prepare_warping semantics: barycentric_interpolation of
    smpl['weights'][vert_ids], ref tools/prepare_warping.py:195-199)."""
    _, vids, bary, _ = closest_point_on_mesh(verts, faces, query, k=k)
    return np.einsum("njc,nj->nc", np.asarray(vert_weights)[vids], bary)
