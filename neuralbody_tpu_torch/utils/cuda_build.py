"""Build the package's native sources into plain-C shared libraries.

A CUDA library is one `nvcc` call, `-gencode arch=compute_90a,code=sm_90a`;
a host library (host=True: the C++ hat planner, csrc/hat_planner.cpp) is
one `g++ -O3 -shared -fPIC -std=c++17` call. Either goes into
`build/neuralbody_tpu_torch/` at the repository root, named by a hash of
its sources and flags, so a changed source rebuilds and an unchanged one
loads at once. Processes that build at once (the loader's spawned workers
each load the planner) take turns on a file lock; the library is linked to
a temporary name and published by an atomic rename, so a reader sees all
of it or none. The library exposes `extern "C"` entry points bound with
ctypes; nothing includes PyTorch's headers, which keeps a build to seconds.

Nothing here runs at import: the first call that needs a library builds
it. A failed build raises with the compiler's message.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "neuralbody_tpu_torch"

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _compiler(host):
    return (["g++"], GXX_FLAGS) if host else ([nvcc_path()], NVCC_FLAGS)


def library_path(name: str, sources, host=False) -> Path:
    """Where the library of these sources is (or will be) built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS if host else NVCC_FLAGS).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources, host=False) -> Path:
    """Compile `sources` into one shared library unless it is built."""
    out = library_path(name, sources, host)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():   # another process built it while we waited
            return out
        compiler, flags = _compiler(host)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [*compiler, *flags, "-o", tmp, *map(str, sources)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{compiler[0]} failed for {name} "
                                   f"({res.returncode}):\n{res.stderr}")
            os.replace(tmp, out)  # atomic: a reader sees all or none
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def load(name: str, sources, host=False) -> ctypes.CDLL:
    """The loaded library of `sources`, built at first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name, sources, host)))
    return _LOADED[name]
