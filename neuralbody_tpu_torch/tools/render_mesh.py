"""Render extracted meshes to rotating-view images (software rasterizer).

Replaces the reference's offscreen OpenGL/GLUT mesh renderer (ref:
tools/render_mesh.py + tools/render/*, 1148 LoC of GL) with a dependency-free
numpy z-buffer rasterizer with flat Lambertian shading — good enough for the
rotating-mesh turntable videos the reference produces. (Counterpart of the
repository's tools/render_mesh.py over the port's utils/mesh_io; numpy and
OpenCV, host only.)

Usage:
    python -m neuralbody_tpu_torch.tools.render_mesh \
        --mesh_dir data/result/if_nerf/<exp>/mesh \
        --out_dir data/render_mesh/<exp> [--num_views 36] [--size 512]
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np


def rasterize(verts, faces, size=512, azimuth=0.0, elevation=0.2,
              fov=0.8, light_dir=(0.3, -0.5, -1.0)):
    """Painter-free z-buffer rasterization of a triangle mesh."""
    center = verts.mean(0)
    radius = np.linalg.norm(verts - center, axis=1).max()
    dist = radius / np.tan(fov / 2) * 1.4

    ca, sa = np.cos(azimuth), np.sin(azimuth)
    ce, se = np.cos(elevation), np.sin(elevation)
    Ry = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
    Rx = np.array([[1, 0, 0], [0, ce, -se], [0, se, ce]])
    R = Rx @ Ry
    cam = (verts - center) @ R.T
    cam[:, 2] += dist

    f = size / (2 * np.tan(fov / 2))
    u = cam[:, 0] / cam[:, 2] * f + size / 2
    v = cam[:, 1] / cam[:, 2] * f + size / 2

    img = np.zeros((size, size, 3), np.float32)
    zbuf = np.full((size, size), np.inf, np.float32)

    tri_cam = cam[faces]                       # [T,3,3]
    n = np.cross(tri_cam[:, 1] - tri_cam[:, 0], tri_cam[:, 2] - tri_cam[:, 0])
    n_norm = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    ld = np.asarray(light_dir, np.float32)
    ld = ld / np.linalg.norm(ld)
    shade = np.clip(np.abs(n_norm @ ld), 0.15, 1.0)

    tu, tv, tz = u[faces], v[faces], tri_cam[..., 2]
    order = np.argsort(-tz.mean(1))            # far-to-near
    for t in order:
        us, vs = tu[t], tv[t]
        x0, x1 = int(max(0, us.min())), int(min(size - 1, us.max()) + 1)
        y0, y1 = int(max(0, vs.min())), int(min(size - 1, vs.max()) + 1)
        if x0 >= x1 or y0 >= y1:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
        d = ((us[1] - us[0]) * (vs[2] - vs[0])
             - (us[2] - us[0]) * (vs[1] - vs[0]))
        if abs(d) < 1e-9:
            continue
        w1 = ((xs - us[0]) * (vs[2] - vs[0])
              - (ys - vs[0]) * (us[2] - us[0])) / d
        w2 = ((ys - vs[0]) * (us[1] - us[0])
              - (xs - us[0]) * (vs[1] - vs[0])) / d
        w0 = 1 - w1 - w2
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        z = w0 * tz[t, 0] + w1 * tz[t, 1] + w2 * tz[t, 2]
        closer = inside & (z < zbuf[ys, xs])
        yy, xx = ys[closer], xs[closer]
        zbuf[yy, xx] = z[closer]
        img[yy, xx] = shade[t]
    return img


def main(argv=None):
    import cv2

    from ..utils.mesh_io import load_ply

    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--num_views", type=int, default=36)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    for fn in sorted(os.listdir(args.mesh_dir)):
        if not fn.endswith(".ply"):
            continue
        verts, faces = load_ply(osp.join(args.mesh_dir, fn))
        if faces is None or len(faces) == 0:
            continue
        stem = osp.splitext(fn)[0]
        for k in range(args.num_views):
            az = 2 * np.pi * k / args.num_views
            img = rasterize(verts, faces, size=args.size, azimuth=az)
            out = osp.join(args.out_dir, f"{stem}_{k:03d}.png")
            cv2.imwrite(out, (img[..., ::-1] * 255).astype(np.uint8))
        print(f"{fn}: {args.num_views} views")


if __name__ == "__main__":
    main()
