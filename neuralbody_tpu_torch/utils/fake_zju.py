"""A fabricated ZJU-MoCap sequence on disk (the port's own copy of
tests/fake_data.make_fake_zju, with its shaded writer).

    make_fake_zju("data/fake/CoreView_999", n_frames=4, n_cams=4, hw=1024,
                  n_verts=6890, shaded=True)

writes the reference's on-disk layout: a body (an ellipsoid of n_verts
vertices, turned and moved a little every frame) seen by n_cams cameras on
a ring, its per-frame SMPL-style params and vertices, the images and their
CIHP masks. With shaded=True each image is an analytic ray-traced render
whose colour is a function of the canonical surface point only, so a
held-out camera is predictable and its PSNR means something. The arrays
are the test module's; the files are written with OpenCV at the JPEG
qualities the test module gives imageio, and decode to the same pixels.
"""
from __future__ import annotations

import os

import numpy as np

from .synthetic import ellipsoid_vertices

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _look_at_camera(center, azimuth, dist=3.0, height=0.0):
    """World->cam R, T with camera on a ring looking at center."""
    pos = center + np.array([dist * np.cos(azimuth), height,
                             dist * np.sin(azimuth)], np.float32)
    z = center - pos
    z = z / np.linalg.norm(z)
    up = np.array([0, -1, 0], np.float32)
    x = np.cross(up, z); x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0).astype(np.float64)
    T = (-R @ pos).reshape(3, 1)
    return R, T


_RADII = (0.3, 0.8, 0.15)


def _shade_ellipsoid(K, R, T, Rh_mat, Th, hw, radii=_RADII):
    """Analytic ray-traced render of the posed ellipsoid.

    View-consistent and pose-attached: albedo + Lambert shading are
    functions of the CANONICAL surface point only, so every camera (and
    every frame) sees the same material point with the same color. This is
    what makes held-out-view PSNR a meaningful convergence metric (the old
    per-image random flat color was unpredictable by construction).
    Returns (img float [hw,hw,3] in [0,1], mask uint8 [hw,hw]).
    """
    radii = np.asarray(radii, np.float64)
    ys, xs = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs, np.float64)], -1)
    d_cam = pix.reshape(-1, 3) @ np.linalg.inv(K).T
    # x_cam = R x_world + T  =>  dir_w = R^T d_cam, origin_w = -R^T T
    d_w = d_cam @ R
    o_w = (-R.T @ np.asarray(T, np.float64).reshape(3, 1)).reshape(1, 3)
    # canonical: p = Rh^T (x - Th); unit sphere after /radii
    oc = ((o_w - np.asarray(Th, np.float64).reshape(1, 3)) @ Rh_mat) / radii
    dc = (d_w @ Rh_mat) / radii
    A = (dc * dc).sum(-1)
    B = 2.0 * (oc * dc).sum(-1)
    C = (oc * oc).sum(-1) - 1.0
    disc = B * B - 4.0 * A * C
    hit = disc > 0
    t = (-B - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * A)
    hit &= t > 0
    q = oc + t[:, None] * dc                      # unit-sphere canonical pt
    albedo = 0.55 + 0.40 * np.stack(
        [np.sin(2.0 * q[:, 0] + 0.0),
         np.sin(2.0 * q[:, 1] + 2.1),
         np.sin(2.0 * q[:, 2] + 4.2)], -1)
    n = q / radii
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    light = np.array([0.45, -0.7, 0.55])
    light /= np.linalg.norm(light)
    lam = 0.45 + 0.55 * np.clip(n @ light, 0.0, 1.0)
    img = np.where(hit[:, None], albedo * lam[:, None], 0.0)
    return (np.clip(img, 0, 1).reshape(hw, hw, 3).astype(np.float32),
            hit.reshape(hw, hw).astype(np.uint8))


def make_fake_zju(root, n_frames=3, n_cams=3, hw=64, n_verts=400, seed=0,
                  shaded=False, focal=None):
    """ZJU-MoCap layout under root: annots.npy, params/, vertices/,
    "Camera (c)/{frame:06d}.jpg" images and mask_cihp/ masks.

    shaded=True renders view-consistent analytic ellipsoid images (see
    _shade_ellipsoid) at JPEG quality 98 instead of per-image random flat
    colors — required for convergence/quality runs. focal defaults to the
    legacy 60 (tiny body) or ~hw for shaded fixtures (body fills ~55%).
    """
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    base = ellipsoid_vertices(n_verts, radii=_RADII, seed=seed)

    if focal is None:
        focal = float(hw) if shaded else 60.0
    K = np.array([[focal, 0, hw / 2], [0, focal, hw / 2], [0, 0, 1]])
    cams = {"K": [], "D": [], "R": [], "T": []}
    center = np.array([0.0, 0.0, 0.0], np.float32)
    for c in range(n_cams):
        R, T = _look_at_camera(center, 2 * np.pi * c / n_cams,
                               height=0.25 * ((c % 3) - 1) if shaded else 0.0)
        cams["K"].append(K.copy())
        cams["D"].append(np.zeros((5, 1)))
        cams["R"].append(R)
        cams["T"].append(T * 1000.0)  # reference divides by 1000

    os.makedirs(f"{root}/params", exist_ok=True)
    os.makedirs(f"{root}/vertices", exist_ok=True)
    ims = []
    for f in range(n_frames):
        Rh = np.array([0.0, 0.1 * f, 0.0])
        Th = np.array([[0.01 * f, 0.0, 0.0]], np.float32)
        R = cv2.Rodrigues(Rh)[0]
        wxyz = (base @ R.T + Th).astype(np.float32)
        np.save(f"{root}/vertices/{f}.npy", wxyz)
        np.save(f"{root}/params/{f}.npy",
                {"Rh": Rh.reshape(1, 3), "Th": Th, "poses": np.zeros((1, 72)),
                 "shapes": np.zeros((1, 10))})
        frame_ims = []
        for c in range(n_cams):
            img_rel = f"Camera ({c + 1})/{f:06d}.jpg"
            img_path = f"{root}/{img_rel}"
            os.makedirs(os.path.dirname(img_path), exist_ok=True)
            Rc, Tc = np.array(cams["R"][c]), np.array(cams["T"][c]) / 1000.0
            if shaded:
                img_f, msk = _shade_ellipsoid(K, Rc, Tc, R, Th, hw)
                img = (img_f * 255).round().astype(np.uint8)
                cv2.imwrite(img_path, img[..., ::-1],
                            [cv2.IMWRITE_JPEG_QUALITY, 98])
            else:
                # crude mask by projecting vertices; flat random color
                img = np.zeros((hw, hw, 3), np.uint8)
                msk = np.zeros((hw, hw), np.uint8)
                cam_pts = wxyz @ Rc.T + Tc.reshape(3)
                uv = cam_pts @ K.T
                uv = (uv[:, :2] / uv[:, 2:]).astype(int)
                ok = ((uv[:, 0] >= 1) & (uv[:, 0] < hw - 1)
                      & (uv[:, 1] >= 1) & (uv[:, 1] < hw - 1))
                for du in (-1, 0, 1):
                    for dv in (-1, 0, 1):
                        msk[uv[ok, 1] + dv, uv[ok, 0] + du] = 1
                img[msk > 0] = rng.randint(60, 200, 3)
                # quality 75: imageio's default, which the test module
                # writes with
                cv2.imwrite(img_path, img[..., ::-1],
                            [cv2.IMWRITE_JPEG_QUALITY, 75])
            msk_path = f"{root}/mask_cihp/{img_rel}"[:-4] + ".png"
            os.makedirs(os.path.dirname(msk_path), exist_ok=True)
            cv2.imwrite(msk_path, msk)
            frame_ims.append(img_rel)
        ims.append({"ims": frame_ims})

    np.save(f"{root}/annots.npy", {"cams": cams, "ims": ims},
            allow_pickle=True)
    return root


def add_fake_warping(root, n_frames=3, n_verts=400, seed=0,
                     ptot_vsize=0.04, pad=0.05):
    """T-pose fixtures on top of make_fake_zju (same seed): tvertices.npy
    and warping/{i}.npz, the arrays of tests/fake_data.add_fake_warping.
    The fake 'SMPL' pose is the rigid Rh/Th only, so in the SMPL frame the
    posed body is the template, an identity warp: ptot_pts equals the
    posed grid itself and tbounds == pbounds. A warp that is not the
    identity: tools/prepare_warping.write_synthetic_warping."""
    base = ellipsoid_vertices(n_verts, radii=(0.3, 0.8, 0.15), seed=seed)
    np.save(f"{root}/tvertices.npy", base.astype(np.float32))

    os.makedirs(f"{root}/warping", exist_ok=True)
    tb = np.stack([base.min(0) - pad, base.max(0) + pad]).astype(np.float32)
    axes = [np.arange(tb[0, a], tb[1, a] + ptot_vsize, ptot_vsize)
            for a in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).astype(np.float32)
    for i in range(n_frames):
        np.savez_compressed(f"{root}/warping/{i}.npz",
                            ptot_pts=grid, pbounds=tb, tbounds=tb)
    return root
