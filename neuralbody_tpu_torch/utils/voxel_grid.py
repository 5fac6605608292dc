"""Occupancy voxel grid with a debug surface-mesh view.

Covers the reference's VoxelGrid utility (ref: lib/utils/if_nerf/
voxels.py:5-196): a boolean grid positioned by (loc, scale) that can be
turned into an exposed-face quad mesh for quick visual inspection, built
from a mesh, block-downsampled, and queried for containment. Host-side
numpy only (a debug sink, not a compute path). An own copy of
neuralbody_tpu/utils/voxel_grid.py.
"""
from __future__ import annotations

import numpy as np


class VoxelGrid:
    """data: [N, N, N] bool; world = grid/N - 0.5, scaled + shifted."""

    def __init__(self, data, loc=(0.0, 0.0, 0.0), scale=1.0):
        data = np.asarray(data)
        assert data.shape[0] == data.shape[1] == data.shape[2]
        self.data = data.astype(bool)
        self.loc = np.asarray(loc, np.float64)
        self.scale = float(scale)

    @property
    def resolution(self):
        return self.data.shape[0]

    @classmethod
    def from_mesh(cls, mesh, resolution, loc=None, scale=None):
        """Voxelize a trimesh (fill method: voxelized + filled interior)."""
        bounds = mesh.bounds
        if loc is None:
            loc = (bounds[0] + bounds[1]) / 2
        if scale is None:
            # scale the mesh into [-0.45, 0.45]^3 like the reference
            scale = (bounds[1] - bounds[0]).max() / 0.9
        m = mesh.copy()
        m.apply_translation(-np.asarray(loc))
        m.apply_scale(1.0 / float(scale))
        vox = m.voxelized(pitch=1.0 / resolution).fill()
        data = np.zeros((resolution,) * 3, bool)
        # map voxel centers back to grid indices
        centers = (vox.points + 0.5) * resolution - 0.5
        idx = np.clip(np.round(centers).astype(int), 0, resolution - 1)
        data[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        return cls(data, loc, scale)

    def down_sample(self, factor=2):
        if self.resolution % factor:
            raise ValueError("resolution must be divisible by factor")
        n = self.resolution // factor
        d = self.data.reshape(n, factor, n, factor, n, factor)
        return VoxelGrid(d.any(axis=(1, 3, 5)), self.loc, self.scale)

    def contains(self, points):
        """World points [..., 3] -> bool occupancy."""
        p = (np.asarray(points) - self.loc) / self.scale + 0.5
        idx = np.floor(p * self.resolution).astype(int)
        ok = np.all((idx >= 0) & (idx < self.resolution), axis=-1)
        idx = np.clip(idx, 0, self.resolution - 1)
        return ok & self.data[idx[..., 0], idx[..., 1], idx[..., 2]]

    def to_mesh(self):
        """Exposed-face surface mesh (vertices [V, 3], quad faces [F, 4]).

        A face is emitted wherever occupancy flips along an axis — the
        reference's boundary-face construction (voxels.py:48-168), with
        shared corner vertices.
        """
        occ = np.pad(self.data, 1)
        n = self.resolution
        grid = (n + 1,) * 3

        # occupancy flips along each axis (both orientations)
        fx = occ[:-1, 1:-1, 1:-1] ^ occ[1:, 1:-1, 1:-1]
        fy = occ[1:-1, :-1, 1:-1] ^ occ[1:-1, 1:, 1:-1]
        fz = occ[1:-1, 1:-1, :-1] ^ occ[1:-1, 1:-1, 1:]

        v = np.zeros(grid, bool)
        v[:, :-1, :-1] |= fx; v[:, :-1, 1:] |= fx
        v[:, 1:, :-1] |= fx;  v[:, 1:, 1:] |= fx
        v[:-1, :, :-1] |= fy; v[:-1, :, 1:] |= fy
        v[1:, :, :-1] |= fy;  v[1:, :, 1:] |= fy
        v[:-1, :-1, :] |= fz; v[:-1, 1:, :] |= fz
        v[1:, :-1, :] |= fz;  v[1:, 1:, :] |= fz

        v_idx = np.full(grid, -1, np.int64)
        v_idx[v] = np.arange(int(v.sum()))
        vx, vy, vz = np.nonzero(v)
        vertices = np.stack([vx / n - 0.5, vy / n - 0.5, vz / n - 0.5], 1)
        vertices = vertices * self.scale + self.loc

        faces = []
        for f, corners in (
            (fx, lambda x, y, z: [(x, y, z), (x, y, z + 1),
                                  (x, y + 1, z + 1), (x, y + 1, z)]),
            (fy, lambda x, y, z: [(x, y, z), (x, y, z + 1),
                                  (x + 1, y, z + 1), (x + 1, y, z)]),
            (fz, lambda x, y, z: [(x, y, z), (x, y + 1, z),
                                  (x + 1, y + 1, z), (x + 1, y, z)]),
        ):
            x, y, z = np.nonzero(f)
            if len(x) == 0:
                continue
            quad = np.stack([v_idx[cx, cy, cz]
                             for cx, cy, cz in corners(x, y, z)], 1)
            faces.append(quad)
        faces = (np.concatenate(faces, axis=0) if faces
                 else np.zeros((0, 4), np.int64))
        return vertices.astype(np.float32), faces
