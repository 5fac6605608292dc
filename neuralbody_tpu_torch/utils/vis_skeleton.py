"""Skeleton / bbox debug plotting.

Covers the reference's vis_utils (ref: lib/utils/vis_utils.py:23-236):
3D and 2D skeleton plots over the SMPL 24-joint kinematic tree, cv2
skeleton overlay, and 3D-bbox drawing. Host-side debug sinks. An own
copy of neuralbody_tpu/utils/vis_skeleton.py; matplotlib is imported only
by the plots that need it.
"""
from __future__ import annotations

import cv2
import numpy as np

# SMPL 24-joint parent chain (ref kintree in vis_utils.py; same topology
# as the SMPL kinematic tree used by utils/smpl.py)
SMPL_KINTREE = [
    (0, 1), (0, 2), (0, 3), (1, 4), (2, 5), (3, 6), (4, 7), (5, 8),
    (6, 9), (7, 10), (8, 11), (9, 12), (9, 13), (9, 14), (12, 15),
    (13, 16), (14, 17), (16, 18), (17, 19), (18, 20), (19, 21),
    (20, 22), (21, 23),
]


def plot_skel_3d(pts, kintree=SMPL_KINTREE, ax=None, elev=0, azim=0,
                 max_range=1.0, linewidth=3, color="b"):
    """3D skeleton plot; pts [J, 3] (ref plotSkel3D, vis_utils.py:23-81)."""
    import matplotlib.pyplot as plt
    pts = np.asarray(pts)
    if ax is None:
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(111, projection="3d")
    for i, j in kintree:
        ax.plot([pts[i, 0], pts[j, 0]], [pts[i, 1], pts[j, 1]],
                [pts[i, 2], pts[j, 2]], lw=linewidth, color=color)
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], color="r", s=2)
    ax.view_init(elev, azim)
    ax.set_xlim(-max_range, max_range)
    ax.set_ylim(-max_range, max_range)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    return ax


def plot_skel_2d(pts, kintree=SMPL_KINTREE, ax=None, img=None,
                 linewidth=2, thres=0.1):
    """2D skeleton plot; pts [J, 2] or [J, 3] with confidence
    (ref plotSkel2D, vis_utils.py:84-147)."""
    import matplotlib.pyplot as plt
    pts = np.asarray(pts)
    conf = pts[:, 2] if pts.shape[1] > 2 else np.ones(len(pts))
    if ax is None:
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(111)
    if img is not None:
        ax.imshow(img)
    for i, j in kintree:
        if conf[i] > thres and conf[j] > thres:
            ax.plot([pts[i, 0], pts[j, 0]], [pts[i, 1], pts[j, 1]],
                    lw=linewidth, color="b")
    ok = conf > thres
    ax.scatter(pts[ok, 0], pts[ok, 1], color="r", s=4)
    return ax


def draw_skeleton(img, kpts2d, kintree=SMPL_KINTREE, thres=0.1):
    """cv2 overlay; kpts2d [J, 3] (x, y, conf)
    (ref draw_skeleton, vis_utils.py:150-156)."""
    img = np.ascontiguousarray(img)
    kpts2d = np.asarray(kpts2d)
    conf = kpts2d[:, 2] if kpts2d.shape[1] > 2 else np.ones(len(kpts2d))
    for i, j in kintree:
        if conf[i] > thres and conf[j] > thres:
            p = tuple(np.round(kpts2d[i, :2]).astype(int))
            q = tuple(np.round(kpts2d[j, :2]).astype(int))
            cv2.line(img, p, q, (0, 255, 0), 2)
    for k in np.flatnonzero(conf > thres):
        cv2.circle(img, tuple(np.round(kpts2d[k, :2]).astype(int)),
                   3, (0, 0, 255), -1)
    return img


_BBOX_EDGES = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
               (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]


def draw_bbox_3d(img, corners_2d, color=(0, 255, 0)):
    """Draw a projected 3D box from its 8 corners [8, 2]
    (ref vis_bbox, vis_utils.py:201-215)."""
    img = np.ascontiguousarray(img)
    c = np.round(np.asarray(corners_2d)).astype(int)
    for i, j in _BBOX_EDGES:
        cv2.line(img, tuple(c[i]), tuple(c[j]), color, 1)
    return img
