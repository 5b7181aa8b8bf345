"""The state of one run, from set-up through the window and the check to
the result line. The cell's entry (portbench/entries/<entry>.py) drives the
program: `setup(run)`, `window(run)`, `release(run)` and `check(run,
control)`; the per-layer readers take what it leaves here."""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    """One request as its client saw it."""
    index: int
    client: int
    submit_t: float
    sizes: dict
    done_t: Optional[float] = None
    audio_s: float = 0.0
    output: object = None            # what the entry keeps for the check


class Run:
    def __init__(self, cell, args, t_start: float, device: str = "cuda",
                 control: bool = False):
        self.cell = cell
        self.config, self.workload, self.mix = cell.config, cell.workload, cell.mix
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.t_start = t_start
        self.device = torch.device(device)
        self.control = control
        self.requests: list = []
        self.counters: dict = {}
        self.t_open = self.t_close = None
        self.setup_s = None
        self.summary = None           # trace.TraceSummary of the traced slice
        self.slice_counters: dict = {}
        self.memory_peak = 0
        self.checks: dict = {}
        self.notes: dict = {}         # what the entry reports on standard error
        self.state: dict = {}         # the entry's program objects
        self.inputs: dict = {}        # the entry's inputs made from the seed
        self.served = (None, None)    # (audio seconds served in the window, its seconds)

    # ------------------------------------------------------------------
    def execute(self):
        drv = self.cell.driver
        drv.setup(self)
        cpu0 = _cpu_ticks()
        drv.window(self)
        cpu1 = _cpu_ticks()
        if cpu0 and cpu1:
            # the host's own account of the window: time its virtual CPUs
            # waited for the physical ones (steal), of all CPU time
            d = [b - a for a, b in zip(cpu0, cpu1)]
            self.notes["host_steal_pct"] = round(100.0 * d[7] / max(sum(d[:8]), 1), 2)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))
        drv.release(self)
        self.state.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.checks = drv.check(self, self.control)

    def seed_of(self, k: int) -> int:
        """The k-th seed derived from the run's seed (weights, voices, inputs)."""
        return int(np.random.SeedSequence([self.seed, k]).generate_state(1, np.uint64)[0] >> 2)

    def sample(self, recs: list, k: int) -> list:
        """k of recs drawn from the seed for the check, the one with the
        most audio first."""
        if not recs:
            return []
        rng = np.random.default_rng([self.seed, 0xc4ec, k])
        longest = max(recs, key=lambda r: (r.audio_s, r.index))
        rest = [r for r in recs if r is not longest]
        pick = rng.choice(len(rest), min(k - 1, len(rest)), replace=False)
        return [longest] + [rest[i] for i in sorted(pick)]

    def mark(self, step: str):
        """Note when a step of set-up ended (seconds from the process's start)."""
        self.notes.setdefault("setup_at", {})[step] = round(time.perf_counter() - self.t_start, 3)

    def in_window(self) -> list:
        """The requests that completed inside the window."""
        return [r for r in self.requests
                if r.done_t is not None and self.t_open < r.done_t <= self.t_close]

    @property
    def attempted(self) -> list:
        """The requests due in the window: submitted before it closed and
        not finished before it opened."""
        return [r for r in self.requests if r.submit_t <= self.t_close
                and (r.done_t is None or r.done_t > self.t_open)]

    def result(self, metrics: dict) -> dict:
        att = self.attempted
        failed = sum(1 for r in att if r.done_t is None)
        ok = failed == 0 and all(c["value"] <= c["limit"] for c in self.checks.values())
        on_gpu = self.device.type == "cuda"
        dev = {"platform": "gpu" if on_gpu else "cpu",
               "kind": torch.cuda.get_device_name(self.device) if on_gpu else "cpu",
               "count": self.cell.chips, "memory_peak_bytes": self.memory_peak}
        out = {"correct": bool(ok), "attempted": len(att), "failed": failed,
               "metrics": metrics, "device": dev}
        if self.trace and self.summary is not None:
            dev["busy_s"] = self.summary.busy_s
            dev["window_s"] = self.summary.window_s
            out["breakdown"] = self.summary.breakdown()
        out["checks"] = self.checks
        return out


def _cpu_ticks():
    """The host's CPU time counters (user, nice, system, idle, iowait,
    irq, softirq, steal), or None where /proc/stat is not there."""
    try:
        with open("/proc/stat") as f:
            return [int(v) for v in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None


def wait_until(t: float):
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))
