"""The traced slice of a run: torch.profiler over a steady part of the
window, on the thread that drives the program (the profiler records the
host operations of the thread that starts it; the card's work it records
whole), reduced once the slice ends to what the per-layer readers take:
device operations with their times, the share of the slice in which none
ran, and the host span each idle gap fell in.

Host spans are the benchmark's own: `span(name)` around its calls into the
program's layers, all named "pb:<layer>"; a device operation belongs to
the layer whose span was open on the host when it was launched.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import nullcontext

import torch

PREFIX = "pb:"


def span(name: str, on: bool):
    """A host span of the traced run (nothing when tracing is off)."""
    if not on:
        return nullcontext()
    return torch.profiler.record_function(PREFIX + name)


def wrap(obj, method: str, name: str, on: bool, record=None):
    """Replace obj.method on the instance by a call inside span(name);
    record(result, args, kwargs) sees every call when given."""
    orig = getattr(obj, method)

    def call(*args, **kwargs):
        with span(name, on):
            out = orig(*args, **kwargs)
        if record is not None:
            record(out, args, kwargs)
        return out

    setattr(obj, method, call)
    return orig


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Slice:
    """Start and stop the profiler from the driving thread: `request()`
    from anywhere, then `poll()` on the driving thread at each turn of its
    loop starts or stops it when due."""

    def __init__(self):
        self.prof = None
        self.want = None          # "warm" | "start" | "stop"
        self.t0 = self.t1 = None
        self.events = None

    def request(self, what: str):
        self.want = what

    def poll(self):
        want, self.want = self.want, None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        if want == "warm" and self.prof is None:
            # the profiler's first start in a process takes seconds: pay it in set-up
            with torch.profiler.profile(activities=acts):
                pass
        elif want == "start" and self.prof is None:
            _sync()
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif want == "stop" and self.prof is not None and self.t1 is None:
            _sync()
            self.t1 = time.perf_counter()
            self.prof.__exit__(None, None, None)
            self.events = self.prof.profiler.kineto_results.events()

    @property
    def done(self) -> bool:
        return self.events is not None


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceSummary:
    """What the readers take from a traced slice.

    ops: [(name, start_ns, end_ns, layer)] of every device operation in the
    slice, layer the innermost benchmark span open at its launch ("" for
    none); window_s: the slice's length; busy_s: the union of the device
    operations' intervals; gaps: {host span: idle seconds}."""

    def __init__(self, events, window_s: float):
        is_dev = lambda e: e.device_type() == torch.autograd.DeviceType.CUDA
        cpu = [e for e in events if not is_dev(e)]
        # the device timeline also carries the host spans projected onto it
        # (named like them): those are not device work
        dev = [e for e in events if is_dev(e) and e.duration_ns() > 0
               and not e.name().startswith(PREFIX)]
        spans = sorted((e.start_ns(), e.end_ns(), e.name()[len(PREFIX):]) for e in cpu
                       if e.name().startswith(PREFIX))
        launch = {e.correlation_id(): e.start_ns() for e in cpu
                  if e.name().startswith(("cuda", "cuLaunch"))}
        starts = [s[0] for s in spans]

        def layer_at(t):
            """The innermost span open at host time t."""
            i = bisect.bisect_right(starts, t)
            for s, e, name in reversed(spans[max(0, i - 64):i]):
                if s <= t < e:
                    return name
            return ""

        self.ops = []
        for e in dev:
            t = launch.get(e.correlation_id())
            self.ops.append((e.name(), e.start_ns(), e.end_ns(),
                             layer_at(t) if t is not None else ""))
        self.window_s = window_s
        busy = _merge([(s, e) for _, s, e, _ in self.ops])
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.gaps = defaultdict(float)
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            self.gaps[layer_at((e0 + s1) // 2) or "outside spans"] += (s1 - e0) / 1e9

    def device_s(self, keep=lambda name, layer: True) -> float:
        """Device seconds of the operations keep(name, layer) selects."""
        return sum(e - s for name, s, e, layer in self.ops if keep(name, layer)) / 1e9

    def breakdown(self) -> dict:
        by_name = defaultdict(float)
        for name, s, e, _ in self.ops:
            by_name[name[:160]] += (e - s) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}
