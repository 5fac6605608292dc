"""Render-camera path generation for demo visualizations.

Clean-room reimplementation of the reference orbit-path math (ref:
lib/utils/render_utils.py:11-106): build an average-up spiral/orbit of
world-to-camera matrices around the capture rig. (Counterpart of
neuralbody_tpu/datasets/render_path.py: an own copy, numpy.)
"""
from __future__ import annotations

import numpy as np


def _normalize(x):
    return x / np.linalg.norm(x)


def view_matrix(z, up, pos):
    """Camera-to-world [3,4] from forward z, up hint, position
    (ref: render_utils.py:15-21)."""
    vec2 = _normalize(z)
    vec1 = _normalize(np.cross(vec2, up))
    vec0 = _normalize(np.cross(vec1, vec2))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def load_cam(ann_file, ratio=0.5):
    """annots.npy -> per-view K (ratio-scaled) and 4x4 world-to-cam RT
    (ref: render_utils.py:29-50)."""
    annots = np.load(ann_file, allow_pickle=True).item()
    cams = annots["cams"]
    lower = np.array([[0.0, 0, 0, 1]])
    Ks, RTs = [], []
    for i in range(len(cams["K"])):
        K = np.array(cams["K"][i]).astype(np.float64).copy()
        K[:2] = K[:2] * ratio
        Ks.append(K)
        r = np.array(cams["R"][i])
        t = np.array(cams["T"][i]).reshape(3, 1) / 1000.0
        RTs.append(np.concatenate(
            [np.concatenate([r, t], axis=1), lower], axis=0))
    return Ks, RTs


def gen_orbit_path(RTs, num_views=50, center=None):
    """Orbit of world-to-cam matrices around the rig
    (ref: render_utils.py:61-106)."""
    lower = np.array([[0.0, 0, 0, 1]])
    c2w_all = np.linalg.inv(np.array(RTs))
    # axis shuffle into the reference's (up, right, -fwd) convention
    c2w_all = np.concatenate(
        [c2w_all[:, :, 1:2], c2w_all[:, :, 0:1],
         -c2w_all[:, :, 2:3], c2w_all[:, :, 3:4]], axis=2)

    up = _normalize(c2w_all[:, :3, 0].sum(0))
    z = _normalize(c2w_all[0, :3, 2])
    vec1 = _normalize(np.cross(z, up))
    vec2 = _normalize(np.cross(up, vec1))
    z_off = 0.0
    if center is None:
        center = c2w_all[:, :3, 3].mean(0)
        z_off = 1.3

    c2w = np.stack([up, vec1, vec2, center], axis=1)

    tt = np.matmul(
        c2w[:3, :3].T,
        (c2w_all[:, :3, 3] - c2w[:3, 3])[..., None])[..., 0].T
    rads = np.percentile(np.abs(tt), 80, axis=-1) * 1.3
    rads = np.array(list(rads) + [1.0])

    render_w2c = []
    for theta in np.linspace(0.0, 2 * np.pi, num_views + 1)[:-1]:
        cam_pos = np.array([0, np.sin(theta), np.cos(theta), 1]) * rads
        cam_pos_world = c2w[:3, :4] @ cam_pos
        z = _normalize(
            cam_pos_world - c2w[:3, :4] @ np.array([z_off, 0, 0, 1.0]))
        mat = view_matrix(z, up, cam_pos_world)
        mat = np.concatenate(
            [mat[:, 1:2], mat[:, 0:1], -mat[:, 2:3], mat[:, 3:4]], axis=1)
        mat = np.concatenate([mat, lower], axis=0)
        render_w2c.append(np.linalg.inv(mat))
    return render_w2c


def rotate_points_y(xyz, t, plane=(0, 2)):
    """Rotate points about their centroid in the given coordinate plane
    (ref rotate-SMPL demos: rotate_smpl_dataset.py:69-76 uses plane (0,1),
    monocular_demo_dataset.py:41-47 uses (0,2))."""
    a, b = plane
    rot2 = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    rot = np.eye(3)
    rot[np.ix_([a, b], [a, b])] = rot2
    center = xyz.mean(0)
    out = (xyz - center) @ rot.T + center
    return out.astype(np.float32), rot, center
