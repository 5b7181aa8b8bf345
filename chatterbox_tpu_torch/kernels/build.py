"""Build the CUDA sources under csrc/ into shared libraries and load them.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (sm_90a) into `_build/lib<name>.so`, then loaded with ctypes; the
sources share the helpers of `csrc/common.cuh`. Nothing is built when a
module is imported: the first call that needs a library builds it, and a
library older than its source or a header is rebuilt. `build_all()`
starts one nvcc per source at once (used to front-load the build).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_libs: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing, or older than its source or a shared header."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    deps = [SRC_DIR / f"{name}.cu", *SRC_DIR.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def _start(name: str):
    """Start nvcc for one source into a temporary file; returns
    (process, tmp path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, _lib_path(name))
    return out


def build_all(force: bool = False) -> dict:
    """Compile every stale source (every source with force=True) in
    parallel. Returns {name: nvcc output} for the sources built."""
    with _lock:
        todo = [n for n in sources() if force or _stale(n)]
        started = [(n, *_start(n)) for n in todo]
        return {n: _finish(n, proc, tmp) for n, proc, tmp in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                _finish(name, *_start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
