"""The training host's WAV loader (the counterpart of
chatterbox_tpu/runtime/__init__.py's WavLoader): N native reader threads
(csrc/host/dataload.cpp over csrc/host/wavio.cpp, built with g++ at first
use into _build/libdataload.so and bound with ctypes) decode clips ahead of
the device step into a bounded queue. Where g++ cannot build it, a Python
fallback reads the same files lazily in-process with
utils/audio_io.read_wav, in the same order semantics.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc" / "host"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("dataload.cpp", "wavio.cpp")
LIB = BUILD_DIR / "libdataload.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _build() -> bool:
    """g++ the sources into LIB (through a temporary file); False when the
    toolchain is missing or the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="libdataload.", suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-pthread", "-o", tmp]
                       + [str(SRC_DIR / s) for s in SOURCES],
                       check=True, capture_output=True, timeout=180)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        logger.info(f"native data loader build unavailable ({e}); using the Python reader")
        return False
    os.replace(tmp, LIB)
    return True


def dataload_lib() -> Optional[ctypes.CDLL]:
    """The loaded native loader, built first when missing or older than a
    source; None when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        newest = max((SRC_DIR / s).stat().st_mtime for s in SOURCES)
        if (not LIB.exists() or LIB.stat().st_mtime < newest) and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(LIB))
        except OSError:
            return None
        lib.dl_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                                  ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
                                  ctypes.c_uint64, ctypes.c_int32, ctypes.c_int64]
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_next.argtypes = [ctypes.c_void_p, np.ctypeslib.ndpointer(np.float32),
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int64)]
        lib.dl_next.restype = ctypes.c_int32
        lib.dl_errors.argtypes = [ctypes.c_void_p]
        lib.dl_errors.restype = ctypes.c_int64
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        lib.dl_destroy.restype = None
        _lib = lib
        return _lib


class WavLoader:
    """Prefetching WAV clip loader over a list of paths.

    Iterating yields (wav float32 (n,) at the file's own rate, at most
    max_frames long, path index). The order reshuffles every epoch from
    `seed` (reproducible; the native path keeps it with one thread, more
    threads may deliver in another order), and unreadable files are
    skipped (counted by `errors()` on the native path). `native` says
    whether the C++ threads serve the clips.
    """

    def __init__(self, paths, *, n_threads: int = 4, max_frames: int,
                 epochs: int = 1, seed: int = 0, shuffle: bool = True,
                 queue_cap: int = 64):
        self.paths = [str(p) for p in paths]
        self.max_frames = int(max_frames)
        self.epochs = int(epochs)
        self.seed = seed
        self.shuffle = shuffle
        self._lib = dataload_lib()
        self._h = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._paths_arr = arr          # alive while the threads read it
            self._h = self._lib.dl_create(arr, len(self.paths), n_threads, self.max_frames,
                                          self.epochs, seed, int(shuffle), queue_cap)

    @property
    def native(self) -> bool:
        return self._h is not None

    def __iter__(self):
        if self._h is not None:
            buf = np.empty(self.max_frames, np.float32)
            n, pid, idx = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
            while self._lib.dl_next(self._h, buf, ctypes.byref(n), ctypes.byref(pid),
                                    ctypes.byref(idx)):
                yield buf[: n.value].copy(), int(pid.value)
            return
        from ..utils.audio_io import read_wav
        rng = np.random.default_rng(self.seed)
        for _ in range(max(self.epochs, 1)):
            order = np.arange(len(self.paths))
            if self.shuffle:
                rng.shuffle(order)
            for pid in order:
                try:
                    wav, _ = read_wav(self.paths[pid])
                except (OSError, ValueError):
                    continue
                yield wav[: self.max_frames], int(pid)

    def errors(self) -> int:
        return int(self._lib.dl_errors(self._h)) if self._h else 0

    def close(self):
        if getattr(self, "_h", None) is not None:
            self._lib.dl_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def batched_wavs(loader: WavLoader, batch: int):
    """Groups loader clips into right-padded (B, T_max) float32 batches.
    Yields (wavs, lens, path_ids); the final partial batch is included."""
    buf = []
    for wav, pid in loader:
        buf.append((wav, pid))
        if len(buf) == batch:
            yield _pack_batch(buf)
            buf = []
    if buf:
        yield _pack_batch(buf)


def _pack_batch(items):
    T = max(len(w) for w, _ in items)
    out = np.zeros((len(items), T), np.float32)
    lens = np.zeros(len(items), np.int64)
    pids = np.zeros(len(items), np.int64)
    for i, (w, p) in enumerate(items):
        out[i, : len(w)] = w
        lens[i] = len(w)
        pids[i] = p
    return out, lens, pids
