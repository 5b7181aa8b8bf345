"""The port's span recorder (chatterbox_tpu_torch/utils/profiling.py) and
the benchmark readers that put its spans against the device trace
(portbench/metrics/program_spans.py and the six readers of the voice
conversion's layers), on the CPU.

Spans record exactly while a torch profiler records, nest per thread with
their parents and the request id of their root, and lie on the clock of
the profiler's own events; the profiler never sees them. A tiny
`ChatterboxVC.generate` gives the span tree of the VC path and its host
syncs, counted by site. Each reader, fed a hand-built trace and spans,
gives the number worked out by hand, and None where it finds nothing (a
program without the recorder)."""
from __future__ import annotations

import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from chatterbox_tpu_torch.api.pipelines import ChatterboxVC
from chatterbox_tpu_torch.models.s3gen.flow import FlowDims
from chatterbox_tpu_torch.models.s3tok.model import S3TokenizerConfig
from chatterbox_tpu_torch.utils import profiling
from chatterbox_tpu_torch.utils.audio_io import save_wav
from portbench.harness import core
from portbench.harness.trace import TraceSummary
from portbench.tests import tiny

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh():
    profiling.recorder.clear()
    yield
    profiling.recorder.clear()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_off_records_nothing():
    assert not profiling.tracing()
    with profiling.span("vc.generate") as a:
        with profiling.span("s3gen.flow", device="cpu", tokens=3) as b:
            profiling.to_host(profiling.to_device(np.arange(4.0), "cpu"))
    assert a is None and b is None
    assert profiling.spans() == []


def test_spans_nest_with_parents_and_request_ids():
    with torch.profiler.profile(activities=CPU):
        assert profiling.tracing()
        with profiling.span("vc.generate") as root:
            with profiling.span("s3gen.tokenize", device="cpu", samples=640) as tok:
                t = profiling.to_device(np.zeros(16, np.float32), "cpu")
            with profiling.span("watermark", samples=24):
                pass
        with profiling.span("vc.generate") as root2:
            profiling.to_host(t)
    assert not profiling.tracing()
    got = profiling.spans()
    assert [s.name for s in got] == ["host.sync", "s3gen.tokenize", "watermark",
                                     "vc.generate", "host.sync", "vc.generate"]
    sync, tok_, wm, r1, sync2, r2 = got
    assert r1 is root and tok_ is tok and r2 is root2
    assert root.parent is None and root.depth == 0 and root.request == root.id
    assert tok.parent == root.id and wm.parent == root.id and sync.parent == tok.id
    assert sync.depth == 2 and tok.depth == 1
    assert {s.request for s in (sync, tok, wm, root)} == {root.id}
    assert sync2.parent == root2.id and sync2.request == root2.request != root.request
    assert tok.attrs == {"samples": 640} and sync.attrs == {"bytes": 64}
    assert sync2.attrs == {"bytes": 64}
    assert tok.device and not wm.device and not root.device and not sync.device
    assert tok.device_ms() is None          # no CUDA events off the card
    for s in got:
        assert s.start_ns <= s.end_ns and s.start_pc_ns <= s.end_pc_ns
    assert root.start_ns <= tok.start_ns <= sync.start_ns <= sync.end_ns <= tok.end_ns
    assert tok.end_ns <= wm.start_ns <= wm.end_ns <= root.end_ns <= root2.start_ns


def test_spans_nest_per_thread_in_threads_at_once():
    """Threads that open spans at once each keep their own stack: every
    child's parent is its own thread's root, every request id its root's,
    and no span is lost (a short switch interval interleaves them)."""
    n_threads, n_req = 8, 60
    barrier = threading.Barrier(n_threads)
    errors = []

    def work(k):
        try:
            barrier.wait(timeout=30)
            for i in range(n_req):
                with profiling.span("vc.generate", worker=k, i=i):
                    with profiling.span("s3gen.flow", device="cpu", tokens=i):
                        with profiling.span("host.sync", bytes=k):
                            pass
                    with profiling.span("watermark"):
                        pass
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=CPU):
            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            [t.start() for t in threads]
            [t.join(timeout=60) for t in threads]
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    got = profiling.spans()
    assert len(got) == 4 * n_threads * n_req
    by_id = {s.id: s for s in got}
    assert len(by_id) == len(got)
    roots = [s for s in got if s.name == "vc.generate"]
    assert len(roots) == n_threads * n_req and len({s.request for s in roots}) == len(roots)
    for s in got:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.thread == s.thread and s.request == p.request and s.depth == p.depth + 1
            root = by_id[s.request]
            assert root.name == "vc.generate" and root.thread == s.thread
            if s.name == "host.sync":
                assert s.attrs["bytes"] == root.attrs["worker"] and p.name == "s3gen.flow"
            else:
                assert p is root


def test_a_span_lies_inside_the_profiler_event_it_was_opened_in():
    """The program's spans are on the clock of the profiler's events
    (time.time_ns), and the profiler never sees them."""
    with torch.profiler.profile(activities=CPU) as prof:
        with torch.profiler.record_function("outer"):
            with profiling.span("s3gen.flow", device="cpu", tokens=1):
                torch.ones(64).sum()
    s, = profiling.spans()
    events = prof.profiler.kineto_results.events()
    outer, = [e for e in events if e.name() == "outer"]
    assert outer.start_ns() <= s.start_ns <= s.end_ns <= outer.end_ns()
    assert not any(e.name() == "s3gen.flow" for e in events)


def test_the_recorder_is_capped():
    rec = profiling.SpanRecorder()
    assert rec.CAP == 1 << 16 and rec._done.maxlen == rec.CAP
    with torch.profiler.profile(activities=CPU):
        for _ in range(3):
            with rec.span("s"):
                pass
    assert len(rec.spans()) == 3 and profiling.spans() == []


# ---------------------------------------------------------------------------
# the VC path
# ---------------------------------------------------------------------------

# host syncs of one ChatterboxVC.generate with a target voice file, by site:
SYNCS = {
    # the target's embed_ref: its samples, the resampler's kernels (24 -> 16 kHz),
    # the tokenizer's length, sinusoids and FSQ powers; tokens, length, mels, x-vector back
    "s3gen.embed_ref": 9,
    # the source's tokenize: its samples, length, sinusoids, powers; length and tokens back
    "s3gen.tokenize": 6,
    # inference: device_ref's three arrays of the new voice, the tokens; the audio back
    "vc.generate": 5,
}


@pytest.fixture(scope="module")
def vc_and_target(tmp_path_factory):
    vc = ChatterboxVC.random_init(flow_dims=FlowDims.tiny_test(),
                                  tok_cfg=S3TokenizerConfig.tiny_test(), hift_base=32,
                                  seed=3, device="cpu")
    path = tmp_path_factory.mktemp("voice") / "target.wav"
    save_wav(str(path), 0.5 * chip_smoke.synthetic_voice(1.2, 24000, seed=5, f0=180.0),
             24000)
    return vc, str(path)


def test_vc_generate_span_tree_and_host_syncs(vc_and_target):
    vc, target = vc_and_target
    src = 0.5 * chip_smoke.synthetic_voice(1.0, 16000, seed=6, f0=120.0)
    vc.set_seed(1)
    want = vc.generate(src, target_voice_path=target)
    assert profiling.spans() == []
    with torch.profiler.profile(activities=CPU):
        vc.set_seed(1)
        got = vc.generate(src, target_voice_path=target)
    np.testing.assert_array_equal(got, want)         # tracing changes no result
    spans = profiling.spans()
    names = _by_name(spans)
    root, = names["vc.generate"]
    assert root.parent is None and {s.request for s in spans} == {root.id}
    G = 25                                            # 1 s of source, 25 tokens a second
    assert got.shape == (1, G * 960)
    children = [s.name for s in spans if s.parent == root.id and s.name != "host.sync"]
    assert children == ["s3gen.embed_ref", "s3gen.tokenize", "s3gen.flow", "s3gen.hift",
                        "watermark"]
    (emb,), (tok,), (flow,), (hift,), (wm,) = (names[n] for n in children)
    assert emb.attrs == {"samples": 28800} and tok.attrs == {"samples": 16000}
    assert flow.attrs == {"tokens": G} and hift.attrs == {} and wm.attrs == {"samples": G * 960}
    assert all(s.device for s in (emb, tok, flow, hift))
    assert not any(s.device for s in (root, wm))
    assert flow.end_ns <= hift.start_ns and tok.end_ns <= flow.start_ns
    by_id = {s.id: s for s in spans}
    syncs = {}
    for s in names["host.sync"]:
        syncs[by_id[s.parent].name] = syncs.get(by_id[s.parent].name, 0) + 1
        assert s.attrs["bytes"] > 0 and not s.device
    assert syncs == SYNCS and len(names["host.sync"]) == sum(SYNCS.values()) == 20
    # the source's samples and the audio, in bytes
    tok_syncs = [s for s in names["host.sync"] if s.parent == tok.id]
    assert tok_syncs[0].attrs["bytes"] == 4 * 16000
    assert [s for s in names["host.sync"] if s.parent == root.id][-1].attrs["bytes"] == \
        4 * G * 960


# ---------------------------------------------------------------------------
# the readers, on a hand-built trace
# ---------------------------------------------------------------------------

class _Event:
    def __init__(self, name, dev, s, e, corr=0):
        self._n, self._d, self._s, self._e, self._c = name, dev, s, e, corr

    def name(self): return self._n
    def device_type(self): return self._d
    def start_ns(self): return self._s
    def end_ns(self): return self._e
    def duration_ns(self): return self._e - self._s
    def correlation_id(self): return self._c


def _span(name, s, e, depth, id_, parent, request=1, device=False, ms=None, **attrs):
    """A span as the recorder keeps it; its perf_counter times are its
    trace times here."""
    return SimpleNamespace(name=name, start_ns=s, end_ns=e, start_pc_ns=s, end_pc_ns=e,
                           depth=depth, id=id_, parent=parent, request=request,
                           device=device, attrs=attrs, device_ms=lambda: ms)


NEW = ("flow_device_ms_per_audio_s.vc", "hift_device_ms_per_audio_s.vc",
       "frontend_device_ms_per_audio_s.vc", "watermark_host_ms_per_audio_s.vc",
       "launch_idle_pct.vc", "host_syncs_per_request.vc")


def _hand_run():
    """A slice of 1000 ns: one request (root 0-1000) whose flow span
    (100-400, a device span) has an idle gap of 50 ns at 150-200, and whose
    watermark (600-900, a host span) has one of 590 ns at 360-950; a host
    sync inside the flow; a second request's root and sync outside the
    slice (t1 = 1000 ns)."""
    C, D = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = [E for k, (s, e) in enumerate([(100, 150), (200, 300), (300, 360), (950, 1000)])
          for E in (_Event("cudaLaunchKernel", C, s - 5, s - 4, k + 1),
                    _Event(f"k{k}", D, s, e, k + 1))]
    spans = [
        _span("host.sync", 250, 260, 2, 9, 4, bytes=8),
        _span("s3gen.tokenize", 20, 90, 1, 3, 1, device="cpu", ms=0.004),
        _span("s3gen.embed_ref", 10, 20, 1, 2, 1, device="cpu", ms=0.002),
        _span("s3gen.flow", 100, 400, 1, 4, 1, device="cpu", ms=0.03, tokens=50),
        _span("s3gen.hift", 400, 500, 1, 5, 1, device="cpu", ms=0.01),
        _span("watermark", 600, 900, 1, 6, 1, samples=48000),
        _span("vc.generate", 0, 1000, 0, 1, None),
        _span("vc.generate", 1100, 1200, 0, 7, None, request=7),
        _span("host.sync", 1110, 1120, 1, 8, 7, request=7, bytes=8),
    ]
    run = SimpleNamespace(summary=TraceSummary(ev, 1000 / 1e9),
                          slice_counters={"t0": 0.0, "t1": 1000 / 1e9})
    return run, spans


def test_readers_on_a_hand_built_trace(monkeypatch):
    run, spans = _hand_run()
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    specs = [m for m in tiny.bench()["per_layer"] if m["name"] in NEW]
    assert [m["name"] for m in specs] == list(NEW)
    got = {k: v["value"] for k, v in core.read_metrics(specs, run).items()}
    audio_s = 50 * 0.04                                # the flow span's tokens
    assert got == {
        # the flow's stream time less its 50 ns gap
        "flow_device_ms_per_audio_s.vc": pytest.approx((0.03 - 50e-6) / audio_s),
        "hift_device_ms_per_audio_s.vc": pytest.approx(0.01 / audio_s),
        "frontend_device_ms_per_audio_s.vc": pytest.approx(0.006 / audio_s),
        "watermark_host_ms_per_audio_s.vc": pytest.approx(300 / 1e6 / audio_s),
        "launch_idle_pct.vc": pytest.approx(100 * 50 / 1000),
        "host_syncs_per_request.vc": 1.0,
    }
    from portbench.metrics import program_spans
    gaps = [(round(sec * 1e9), sp.name) for sec, sp in program_spans.idle_gaps(run)]
    assert gaps == [(50, "s3gen.flow"), (590, "watermark")]
    # the trace's own attribution (by the benchmark's spans) is untouched
    assert dict(run.summary.gaps) == {"outside spans": pytest.approx(640 / 1e9)}


def test_a_gap_outside_every_span_and_under_a_host_sync(monkeypatch):
    from portbench.metrics import program_spans
    run, spans = _hand_run()
    spans = [s for s in spans if s.name not in ("vc.generate", "watermark")]
    spans.append(_span("host.sync", 170, 180, 2, 10, 4, bytes=4))   # inside the flow's gap
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    gaps = [(round(sec * 1e9), sp and sp.name) for sec, sp in program_spans.idle_gaps(run)]
    assert gaps == [(50, "host.sync"), (590, None)]
    # a gap under a child of the flow is idle inside the flow
    assert program_spans.device_ms_per_audio_s(run, {"s3gen.flow"}) == \
        pytest.approx((0.03 - 50e-6) / 2.0)
    monkeypatch.setattr(run.summary, "ops", [])
    assert program_spans.idle_gaps(run) is None


def test_readers_find_nothing_without_the_recorder_or_the_slice(monkeypatch):
    run, spans = _hand_run()
    specs = [m for m in tiny.bench()["per_layer"] if m["name"] in NEW]
    monkeypatch.delattr(profiling, "spans")            # a program without the recorder
    assert core.read_metrics(specs, run) == {}
    monkeypatch.setattr(profiling, "spans", lambda: [], raising=False)
    assert core.read_metrics(specs, run) == {}
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert core.read_metrics(specs, SimpleNamespace(summary=None, slice_counters={})) == {}
    # off the card the device spans have no events: their readers find nothing
    cpu = [_span(s.name, s.start_ns, s.end_ns, s.depth, s.id, s.parent, s.request, s.device,
                 None, **s.attrs) for s in spans]
    monkeypatch.setattr(profiling, "spans", lambda: cpu)
    assert set(core.read_metrics(specs, run)) == {
        "watermark_host_ms_per_audio_s.vc", "launch_idle_pct.vc", "host_syncs_per_request.vc"}
