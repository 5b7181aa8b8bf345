"""The program's own spans of the traced slice, for the readers that put
them against the device trace. The port records them
(chatterbox_tpu_torch/utils/profiling.py `span`) only while a torch
profiler records, which in a run is the traced slice; the profiler never
sees them, so they move nothing the other readers read.

A span has its name, its start and end on the trace's clock (`start_ns`,
`end_ns`: time.time_ns, the clock of the trace's device intervals) and on
perf_counter_ns (`start_pc_ns`, `end_pc_ns`: the clock of the slice's t0
and t1), `depth` (0 for a root), `request` (its root span's id), `device`
(a device span: its work is queued on the card), `attrs` and
`device_ms()` (stream time between the CUDA events recorded at its enter
and exit; None off the card). A program without the recorder gives no
spans, and every reader then returns None."""
from __future__ import annotations

from portbench.harness.trace import _merge

TOKEN_S = 0.04          # audio seconds of a speech token (25 tokens a second)


def of_slice(run):
    """The program's spans recorded inside the traced slice, or None."""
    c = run.slice_counters
    if run.summary is None or "t0" not in c:
        return None
    try:
        from chatterbox_tpu_torch.utils import profiling
        recorded = profiling.spans
    except (ImportError, AttributeError):
        return None
    t0, t1 = c["t0"] * 1e9, c["t1"] * 1e9
    return [s for s in recorded() if t0 <= s.start_pc_ns and s.end_pc_ns <= t1] or None


def audio_seconds(spans) -> float:
    """The audio seconds vocoded: the generated tokens of the `s3gen.flow`
    spans."""
    return TOKEN_S * sum(s.attrs.get("tokens", 0) for s in spans if s.name == "s3gen.flow")


def device_ms_per_audio_s(run, names):
    """Device time of the work queued inside the spans named in `names`
    over the audio seconds vocoded, or None: each span's stream time
    (between its CUDA events) less the idle gaps that fall inside it or
    its child spans (`idle_gaps`), which launch_idle_pct counts."""
    spans, gaps = of_slice(run), idle_gaps(run)
    if spans is None or gaps is None:
        return None
    audio_s = audio_seconds(spans)
    ms = [s.device_ms() for s in spans if s.name in names]
    if audio_s <= 0 or not ms or any(m is None for m in ms):
        return None
    by_id = {s.id: s for s in spans}

    def inside(span):
        while span is not None:
            if span.name in names:
                return True
            span = by_id.get(span.parent)
        return False

    idle_ms = 1e3 * sum(sec for sec, span in gaps if inside(span))
    return (sum(ms) - idle_ms) / audio_s


def idle_gaps(run):
    """[(idle seconds, span)] for each gap between the slice's merged device
    intervals (as trace.TraceSummary takes them), span the innermost
    program span open on the host at the gap's midpoint (None outside
    every span); None without spans or device operations."""
    spans = of_slice(run)
    if spans is None or not run.summary.ops:
        return None
    busy = _merge([(s, e) for _, s, e, _ in run.summary.ops])
    order = sorted(spans, key=lambda s: s.start_ns)
    out, open_, i = [], [], 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        t = (e0 + s1) // 2
        while i < len(order) and order[i].start_ns <= t:
            open_.append(order[i])
            i += 1
        open_ = [s for s in open_ if s.end_ns > t]
        inner = max(open_, key=lambda s: (s.depth, s.start_ns), default=None)
        out.append(((s1 - e0) / 1e9, inner))
    return out
