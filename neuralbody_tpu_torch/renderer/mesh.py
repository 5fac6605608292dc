"""Mesh extraction: dense density-grid evaluation on the device, then the
iso-surface on the host (counterpart of neuralbody_tpu/renderer/mesh.py).

Mirrors the reference mesh renderer (ref: lib/networks/renderer/
if_mesh_renderer.py:15-56): evaluate density at the grid points inside the
visual hull in fixed-size chunks, scatter them back into the dense cube on
the host, pad by 10, extract the iso-surface at mesh_th.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.mcubes import marching_cubes
from ..utils.platform import resolve_device, to_device
from .dispatch import get_density_grid_fn


def extract_mesh(params, batch, meta, settings, cfg, device=None):
    """batch['pts'] are the padded inside-hull points (a multiple of
    cfg.tpu.mesh_pt_chunk, or fewer: then one chunk); meta carries the
    dense grid's inside mask and grid_min_xyz. The density evaluator is
    picked by the settings' type (renderer/dispatch.get_density_grid_fn):
    latent_xyzc's render_density_grid or the NeRF baseline's
    render_nerf_density_grid. Runs on the card unless device="cpu".
    Returns dict(cube, vertices (world), triangles, grid_vertices)."""
    device = resolve_device(device)
    pt_chunk = int(cfg.tpu.mesh_pt_chunk)
    density_fn = get_density_grid_fn(settings)
    params = to_device(params, device)
    batch = to_device(batch, device)
    with torch.no_grad():
        alpha = density_fn(params, batch, settings, pt_chunk=min(
            pt_chunk, batch["pts"].shape[1]))[0]
    alpha = alpha.float().cpu().numpy()

    inside = np.asarray(meta["inside"]).astype(bool)
    n_valid = int(inside.sum())
    cube = np.zeros(inside.shape, np.float32)
    cube[inside] = alpha[:n_valid]

    cube = np.pad(cube, 10, mode="constant")
    vertices, triangles = marching_cubes(cube, float(cfg.mesh_th))
    # back to world scale (grid index -> meters), matching the commented-out
    # reference transform (if_mesh_renderer.py:49-50)
    voxel = float(cfg.voxel_size[0])
    world_verts = (vertices - 10.0) * voxel + np.asarray(
        meta["grid_min_xyz"], np.float32)
    return {"cube": cube, "vertices": world_verts, "triangles": triangles,
            "grid_vertices": vertices}
