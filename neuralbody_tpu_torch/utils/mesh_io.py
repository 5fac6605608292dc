"""Minimal PLY mesh IO (binary little-endian), replacing trimesh/plyfile
(an own copy of neuralbody_tpu/utils/mesh_io.py; numpy)."""
from __future__ import annotations

import numpy as np


def save_ply(path, vertices, faces=None):
    vertices = np.asarray(vertices, np.float32)
    faces = None if faces is None else np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        lines = [
            b"ply", b"format binary_little_endian 1.0",
            f"element vertex {len(vertices)}".encode(),
            b"property float x", b"property float y", b"property float z",
        ]
        if faces is not None:
            lines += [
                f"element face {len(faces)}".encode(),
                b"property list uchar int vertex_indices",
            ]
        lines.append(b"end_header")
        f.write(b"\n".join(lines) + b"\n")
        f.write(vertices.astype("<f4").tobytes())
        if faces is not None:
            rec = np.empty(len(faces),
                           dtype=[("n", "u1"), ("idx", "<i4", (3,))])
            rec["n"] = 3
            rec["idx"] = faces
            f.write(rec.tobytes())


def load_ply(path):
    """Reads the vertices (and faces if present) written by save_ply or
    ascii/binary_le PLY from common tools. Returns (vertices, faces|None).
    A file that ends before its header does raises ValueError."""
    with open(path, "rb") as f:
        header = []
        while True:
            raw = f.readline()
            if not raw:   # the JAX reader loops for ever here
                raise ValueError(f"{path}: no PLY end_header")
            line = raw.strip()
            header.append(line.decode("ascii", "ignore"))
            if line == b"end_header":
                break
        n_vert = n_face = 0
        fmt = "binary_little_endian"
        for h in header:
            if h.startswith("format"):
                fmt = h.split()[1]
            elif h.startswith("element vertex"):
                n_vert = int(h.split()[-1])
            elif h.startswith("element face"):
                n_face = int(h.split()[-1])
        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(n_vert)]
            verts = np.array(rows, np.float32)[:, :3]
            faces = None
            if n_face:
                faces = np.array(
                    [f.readline().split()[1:4] for _ in range(n_face)],
                    np.int32)
            return verts, faces
        verts = np.frombuffer(f.read(n_vert * 12), "<f4").reshape(n_vert, 3)
        faces = None
        if n_face:
            rec = np.frombuffer(
                f.read(n_face * 13),
                dtype=[("n", "u1"), ("idx", "<i4", (3,))])
            faces = rec["idx"].copy()
        return verts.copy(), faces
