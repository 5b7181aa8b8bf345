"""Stage timing, counters and device traces (the counterpart of
chatterbox_tpu/utils/profiling.py).

Usage:
    from chatterbox_tpu_torch.utils.profiling import stage, metrics
    with stage("t3_decode"):
        ...
    print(metrics.report())

`trace(logdir)` records a block with torch.profiler (the CUDA activity,
and the host's) and writes a Chrome trace into logdir, where the JAX
package records an xprof trace.

Kernels run asynchronously, so a stage's time is the device's only around
a result read back to the host (or a torch.cuda.synchronize()).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass

import torch


@dataclass
class _StageStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)


class Metrics:
    """Stage timings and counters. Thread-safe: serving handlers record from
    their own threads while /metrics reads (an unlocked '+=' is a
    read-modify-write race, and a stage seen for the first time would change
    the dict under a reader's iteration)."""

    def __init__(self):
        self._stages: dict[str, _StageStats] = defaultdict(_StageStats)
        self._counters: dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()

    def add_stage(self, name: str, dt: float):
        with self._lock:
            self._stages[name].add(dt)

    def count(self, name: str, v: float = 1.0):
        with self._lock:
            self._counters[name] += v

    def report(self) -> dict:
        out = {}
        with self._lock:
            for name, s in sorted(self._stages.items()):
                out[name] = {"count": s.count, "total_s": round(s.total_s, 4),
                             "mean_s": round(s.total_s / max(s.count, 1), 4),
                             "min_s": round(s.min_s, 4),
                             "max_s": round(s.max_s, 4)}
            for name, v in sorted(self._counters.items()):
                out[name] = v
        return out

    def reset(self):
        with self._lock:
            self._stages.clear()
            self._counters.clear()

    def xrt(self, audio_seconds: float, *stage_names: str) -> float:
        """Realtime factor over the given stages' total time."""
        with self._lock:
            t = sum(self._stages[n].total_s
                    for n in stage_names if n in self._stages)
        return audio_seconds / t if t > 0 else float("inf")


metrics = Metrics()


@contextlib.contextmanager
def stage(name: str, m: Metrics = metrics):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        m.add_stage(name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block, the CUDA activity included where the
    card is there; the Chrome trace goes to
    logdir/<time>.<pid>.pt.trace.json (chrome://tracing, Perfetto,
    TensorBoard)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"{time.strftime('%Y%m%d-%H%M%S')}.{os.getpid()}.pt.trace.json"))
