"""Spans, stage timings and counters, and device traces (the counterpart of
chatterbox_tpu/utils/profiling.py).

Spans: the program records its own spans while a torch profiler records in
the process (`trace(logdir)`, or any `torch.profiler.profile`), and nothing
otherwise:

    from chatterbox_tpu_torch.utils import profiling
    with profiling.span("s3gen.flow", device=self.device, tokens=G):
        ...
    profiling.spans()      # the finished spans, oldest first

A span records its name, its start and end on the clock of the profiler's
trace (`time.time_ns`, so a span can be put against the trace's device
intervals) and on `perf_counter_ns`, its parent (a stack per thread), the
request id its root span gave, and its attributes. A device span on a CUDA
device also records a timing event on the current stream at enter and at
exit; `Span.device_ms()` resolves them when read, never while recording.
The spans are kept in the recorder, not in the profiler: they do not enter
the trace's device timeline. With no profiler recording, a span costs one
flag check. The recorder keeps the last `SpanRecorder.CAP` spans and is
safe to use from several threads.

Host syncs: `to_host(t)` (t.cpu()) and `to_device(x, device)` (a copy
from pageable host memory, which waits for the device's queue) are the
program's blocking copies, each recorded as a `host.sync` span with its
`bytes`. They are counted where they are called, so a CPU run counts the
card's.

`Metrics` holds stage timings and counters for a serving front
(serve/http.py's /metrics). `trace(logdir)` records a block with
torch.profiler (the CUDA activity, and the host's) and writes a Chrome
trace into logdir, where the JAX package records an xprof trace.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler


def tracing() -> bool:
    """Whether spans record now: while a torch profiler records anywhere in
    the process (torch sets this flag as a profiler starts and clears it as
    the profiler stops)."""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """One span of the program; a context manager that records itself."""

    __slots__ = ("name", "attrs", "device", "id", "parent", "request", "depth", "thread",
                 "start_ns", "end_ns", "start_pc_ns", "end_pc_ns", "_rec", "_cuda", "_events")

    def __init__(self, rec: "SpanRecorder", name: str, device, attrs: dict):
        self.name, self.attrs, self._rec = name, attrs, rec
        self.device = device is not None
        self._cuda = device if self.device and torch.device(device).type == "cuda" else None
        self._events = None
        self.end_ns = self.end_pc_ns = None

    def __enter__(self) -> "Span":
        stack = self._rec._stack()
        parent = stack[-1] if stack else None
        self.id = next(self._rec._ids)
        self.parent = parent.id if parent else None
        self.request = parent.request if parent else self.id
        self.depth = len(stack)
        self.thread = threading.get_ident()
        if self._cuda is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._cuda))
            self._events = (ev, None)
        stack.append(self)
        self.start_pc_ns = time.perf_counter_ns()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self.end_pc_ns = time.perf_counter_ns()
        if self._events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._cuda))
            self._events = (self._events[0], ev)
        stack = self._rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._rec._finish(self)
        return False

    def device_ms(self) -> Optional[float]:
        """Stream time between the span's enter and exit events (ms): its
        device work and the stream's idle between them; None for a host
        span or off the card."""
        if self._events is None or self._events[1] is None:
            return None
        start, end = self._events
        end.synchronize()
        return start.elapsed_time(end)


class _Off:
    """The span when nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class SpanRecorder:
    """The finished spans of the process (the last CAP), and each thread's
    stack of open spans."""

    CAP = 1 << 16

    def __init__(self):
        self._done: collections.deque = collections.deque(maxlen=self.CAP)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def span(self, name: str, device=None, **attrs):
        """A span of `name` while tracing() (else a no-op context). device:
        None for a host span, else the device its work is queued on (a
        device span), whose current stream takes its CUDA events where it
        is a CUDA device."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return Span(self, name, device, attrs)

    def spans(self) -> list:
        """The finished spans, oldest first."""
        with self._lock:
            return list(self._done)

    def clear(self):
        with self._lock:
            self._done.clear()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _finish(self, s: Span):
        with self._lock:
            self._done.append(s)


recorder = SpanRecorder()
span = recorder.span
spans = recorder.spans


def to_host(t: torch.Tensor) -> torch.Tensor:
    """t.cpu(): from the card, a copy the host waits for (a `host.sync`
    span)."""
    if not _autograd_profiler._is_profiler_enabled:
        return t.cpu()
    with recorder.span("host.sync", bytes=t.nbytes):
        return t.cpu()


def to_device(x, device, dtype=None) -> torch.Tensor:
    """torch.as_tensor(x, dtype=dtype) on `device`: from pageable host
    memory, a copy that waits for the device's queue (a `host.sync`
    span)."""
    t = torch.as_tensor(x, dtype=dtype)
    if not _autograd_profiler._is_profiler_enabled:
        return t.to(device)
    with recorder.span("host.sync", bytes=t.nbytes):
        return t.to(device)


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

    def set(self, name: str, v: float):
        """A counter kept elsewhere, exported at its current value."""
        with self._lock:
            self._counters[name] = v

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


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block, the CUDA activity included where the
    card is there; the Chrome trace goes to
    logdir/<time>.<pid>.pt.trace.json (chrome://tracing, Perfetto,
    TensorBoard). The program's spans of the block are in spans()."""
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
