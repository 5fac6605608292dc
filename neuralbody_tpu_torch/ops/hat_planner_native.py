"""ctypes binding for the C++ hat planner (csrc/hat_planner.cpp, an own
copy of the JAX package's native/hat_planner.cpp; counterpart of
neuralbody_tpu/ops/hat_planner_native.py).

Steady-state planning (static rows_caps / n_groups) runs in C++: the numpy
planner takes about ten times as long a batch, too slow to feed the
graphed training step. Derive mode (the first batches of a sequence) stays
in numpy. Output parity with the numpy planner is bit for bit
(tests/test_torch_loader.py). The library is built with g++ at first use
into build/neuralbody_tpu_torch/ (utils/cuda_build.py, host=True); a
failed build raises with the compiler's message.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..utils import cuda_build

_LOCK = threading.Lock()
_LIB = None

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "hat_planner.cpp")

_I32P = ctypes.POINTER(ctypes.c_int32)


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = cuda_build.load("hat_planner", [SOURCE], host=True)
        lib.plan_hat_segments.restype = ctypes.c_int
        lib.plan_hat_segments.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            _I32P, ctypes.c_int32, _I32P,
            ctypes.POINTER(_I32P), _I32P, _I32P, _I32P,
            ctypes.c_int32,
            _I32P, ctypes.POINTER(_I32P), ctypes.POINTER(_I32P), _I32P,
        ]
        _LIB = lib
        return lib


def plan_hat_segments_native(dhw_pts, geom, out_sh, site_caps, group_size,
                             tile, rows_caps, seg_caps, n_groups,
                             levels=(1, 2, 3, 4)):
    """Drop-in for ops.hat_interp.plan_hat_groups when the static sizes are
    known. Returns the same dict, or None if the native call reports an
    overflow (the caller runs numpy then, for its error message)."""
    lib = _load()
    assert rows_caps is not None and seg_caps is not None
    assert n_groups is not None and tuple(levels) == (1, 2, 3, 4)
    N = dhw_pts.shape[0]
    P = int(group_size)

    dhw = np.ascontiguousarray(dhw_pts, np.float32)
    out_sh_a = np.asarray(out_sh, np.int32)
    tile_a = np.zeros(3, np.int32)
    tile_a[: len(tile)] = tile

    site_arrs = []
    nsite = np.empty(4, np.int32)
    sites_p = (_I32P * 4)()
    for li, lvl in enumerate(levels):
        ns = int(geom[f"nsite{lvl}"])
        s = np.ascontiguousarray(geom[f"sites{lvl}"][:ns], np.int32)
        site_arrs.append(s)  # keep alive
        nsite[li] = ns
        sites_p[li] = s.ctypes.data_as(_I32P)

    rows_caps_a = np.asarray(rows_caps, np.int32)
    seg_caps_a = np.asarray(seg_caps, np.int32)
    perm = np.empty(n_groups * P, np.int32)
    sa_arrs = [np.empty((n_groups, int(seg_caps[li])), np.int32)
               for li in range(4)]
    sc_arrs = [np.empty((n_groups, int(seg_caps[li])), np.int32)
               for li in range(4)]
    sa_p, sc_p = (_I32P * 4)(), (_I32P * 4)()
    for li in range(4):
        sa_p[li] = sa_arrs[li].ctypes.data_as(_I32P)
        sc_p[li] = sc_arrs[li].ctypes.data_as(_I32P)
    err_lvl = np.zeros(1, np.int32)

    rc = lib.plan_hat_segments(
        dhw.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(N),
        out_sh_a.ctypes.data_as(_I32P), ctypes.c_int32(P),
        tile_a.ctypes.data_as(_I32P),
        sites_p, nsite.ctypes.data_as(_I32P),
        rows_caps_a.ctypes.data_as(_I32P),
        seg_caps_a.ctypes.data_as(_I32P), ctypes.c_int32(int(n_groups)),
        perm.ctypes.data_as(_I32P), sa_p, sc_p,
        err_lvl.ctypes.data_as(_I32P))
    if rc != 0:
        return None  # overflow: numpy path raises the informative error

    out = {"perm": perm,
           "rows_caps": tuple(int(c) for c in rows_caps),
           "seg_caps": tuple(int(c) for c in seg_caps),
           "n_groups": int(n_groups)}
    for li, lvl in enumerate(levels):
        out[f"seg_a{lvl}"] = sa_arrs[li]
        out[f"seg_cum{lvl}"] = sc_arrs[li]
    return out
