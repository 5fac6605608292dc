"""Iso-surface extraction through the C++ extractor (marching tetrahedra),
csrc/iso_surface.cpp, a byte-for-byte copy of the JAX package's
native/iso_surface.cpp (counterpart of neuralbody_tpu/utils/mcubes.py).

Replaces the reference's PyMCubes dependency (ref: if_mesh_renderer.py:47:
`mcubes.marching_cubes(cube, cfg.mesh_th)`); same call signature: a dense
C-order [nx, ny, nz] grid and an iso value, returning (vertices [V,3] in
grid-index coordinates, triangles [T,3]). The library is built with g++ at
first use into build/neuralbody_tpu_torch/ (utils/cuda_build.py,
host=True); a failed build raises with the compiler's message.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import cuda_build

_LOCK = threading.Lock()
_LIB = None

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "iso_surface.cpp")


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = cuda_build.load("iso_surface", [SOURCE], host=True)
        lib.extract_iso_surface.restype = ctypes.c_int
        lib.extract_iso_surface.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.free_buffer.restype = None
        lib.free_buffer.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


def marching_cubes(grid: np.ndarray, iso: float):
    """Extract the iso-surface of a dense scalar grid.

    Args:
      grid: [nx, ny, nz] float array (C-order).
      iso: iso value (the reference's cfg.mesh_th).

    Returns:
      (vertices [V, 3] float32 in grid-index coords, triangles [T, 3] int32)
    """
    lib = _load()
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    if grid.ndim != 3:
        raise ValueError(f"grid must be 3-D, got shape {grid.shape}")
    nx, ny, nz = grid.shape

    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int()
    nt = ctypes.c_int()
    rc = lib.extract_iso_surface(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, ctypes.c_float(iso),
        ctypes.byref(verts_p), ctypes.byref(nv),
        ctypes.byref(tris_p), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError("iso-surface extraction failed (out of memory?)")
    try:
        verts = np.ctypeslib.as_array(verts_p, (nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        tris = np.ctypeslib.as_array(tris_p, (nt.value, 3)).copy() \
            if nt.value else np.zeros((0, 3), np.int32)
    finally:
        lib.free_buffer(verts_p)
        lib.free_buffer(tris_p)
    return verts, tris
