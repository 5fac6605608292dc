"""The benchmark's traffic generator: a seeded ZJU-MoCap sequence on disk.

A frozen copy of neuralbody_tpu_torch/utils/fake_zju.make_fake_zju with
shaded=True, rewritten in torch so that it runs on the card: an ellipsoid
body of n_verts vertices (drawn from the seed), turned and moved a little
every frame, seen by n_cams cameras on a ring, written in the reference's
layout (annots.npy, params/, vertices/, "Camera (c)/{frame:06d}.jpg" and
mask_cihp/). Each image is an analytic ray-traced render whose colour is a
function of the canonical surface point only, so every view of a frame
agrees. The sizes and the motion are the same for every seed; the seed
moves the vertices on the surface.
"""
from __future__ import annotations

import os

import cv2
import numpy as np
import torch

RADII = (0.3, 0.8, 0.15)
JPEG_QUALITY = 98


def ellipsoid_vertices(seed, n, device):
    """[n, 3] f32 points on the ellipsoid surface, from a torch.Generator
    on `device` seeded with `seed`."""
    gen = torch.Generator(device).manual_seed(seed)
    v = torch.randn((n, 3), generator=gen, device=device,
                    dtype=torch.float64)
    v = v / v.norm(dim=1, keepdim=True)
    return (v * torch.tensor(RADII, dtype=torch.float64, device=device)
            ).float()


def look_at_camera(azimuth, height, dist=3.0):
    """World -> camera R [3, 3], T [3, 1] of a camera on the ring around the
    origin, looking at it."""
    pos = np.array([dist * np.cos(azimuth), height, dist * np.sin(azimuth)],
                   np.float32)
    z = -pos / np.linalg.norm(pos)
    up = np.array([0, -1, 0], np.float32)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0).astype(np.float64)
    return R, (-R @ pos).reshape(3, 1)


def shade(K, R, T, Rh_mat, Th, hw, device):
    """The posed ellipsoid seen by camera (K, R, T): (uint8 image [hw, hw,
    3] RGB, uint8 mask [hw, hw]). Albedo and Lambert shading are functions
    of the canonical surface point."""
    f64 = dict(dtype=torch.float64, device=device)
    radii = torch.tensor(RADII, **f64)
    ys, xs = torch.meshgrid(torch.arange(hw, **f64), torch.arange(hw, **f64),
                            indexing="ij")
    pix = torch.stack([xs + 0.5, ys + 0.5, torch.ones_like(xs)], -1)
    d_cam = pix.reshape(-1, 3) @ torch.tensor(np.linalg.inv(K).T, **f64)
    Rt = torch.tensor(R, **f64)
    d_w = d_cam @ Rt
    o_w = (-Rt.T @ torch.tensor(T, **f64).reshape(3, 1)).reshape(1, 3)
    Rm = torch.tensor(Rh_mat, **f64)
    oc = ((o_w - torch.tensor(Th, **f64).reshape(1, 3)) @ Rm) / radii
    dc = (d_w @ Rm) / radii
    A = (dc * dc).sum(-1)
    B = 2.0 * (oc * dc).sum(-1)
    C = (oc * oc).sum(-1) - 1.0
    disc = B * B - 4.0 * A * C
    t = (-B - torch.sqrt(disc.clamp(min=0.0))) / (2.0 * A)
    hit = (disc > 0) & (t > 0)
    q = oc + t[:, None] * dc
    albedo = 0.55 + 0.40 * torch.stack(
        [torch.sin(2.0 * q[:, 0]), torch.sin(2.0 * q[:, 1] + 2.1),
         torch.sin(2.0 * q[:, 2] + 4.2)], -1)
    n = q / radii
    n = n / n.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    light = torch.tensor([0.45, -0.7, 0.55], **f64)
    light = light / light.norm()
    lam = 0.45 + 0.55 * (n @ light).clamp(0.0, 1.0)
    img = torch.where(hit[:, None], albedo * lam[:, None], 0.0)
    img = (img.clamp(0, 1) * 255).round().to(torch.uint8).reshape(hw, hw, 3)
    return img.cpu().numpy(), hit.reshape(hw, hw).to(torch.uint8).cpu().numpy()


def write_sequence(root, seed, n_frames, n_cams, hw, n_verts, device):
    """Write the sequence under `root` (made if missing); returns root."""
    os.makedirs(root, exist_ok=True)
    base = ellipsoid_vertices(seed, n_verts, device).cpu().numpy()
    K = np.array([[float(hw), 0, hw / 2], [0, float(hw), hw / 2], [0, 0, 1]])
    cams = {"K": [], "D": [], "R": [], "T": []}
    for c in range(n_cams):
        R, T = look_at_camera(2 * np.pi * c / n_cams, 0.25 * ((c % 3) - 1))
        cams["K"].append(K.copy())
        cams["D"].append(np.zeros((5, 1)))
        cams["R"].append(R)
        cams["T"].append(T * 1000.0)    # the reference divides by 1000
    for d in ("params", "vertices"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    ims = []
    for f in range(n_frames):
        Rh = np.array([0.0, 0.1 * f, 0.0])
        Th = np.array([[0.01 * f, 0.0, 0.0]], np.float32)
        Rm = cv2.Rodrigues(Rh)[0]
        np.save(os.path.join(root, "vertices", f"{f}.npy"),
                (base @ Rm.T + Th).astype(np.float32))
        np.save(os.path.join(root, "params", f"{f}.npy"),
                {"Rh": Rh.reshape(1, 3), "Th": Th, "poses": np.zeros((1, 72)),
                 "shapes": np.zeros((1, 10))})
        frame_ims = []
        for c in range(n_cams):
            rel = f"Camera ({c + 1})/{f:06d}.jpg"
            img, msk = shade(K, cams["R"][c], cams["T"][c] / 1000.0, Rm, Th,
                             hw, device)
            os.makedirs(os.path.dirname(os.path.join(root, rel)),
                        exist_ok=True)
            cv2.imwrite(os.path.join(root, rel), img[..., ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY])
            msk_path = os.path.join(root, "mask_cihp", rel)[:-4] + ".png"
            os.makedirs(os.path.dirname(msk_path), exist_ok=True)
            cv2.imwrite(msk_path, msk)
            frame_ims.append(rel)
        ims.append({"ims": frame_ims})
    np.save(os.path.join(root, "annots.npy"), {"cams": cams, "ims": ims},
            allow_pickle=True)
    return root
