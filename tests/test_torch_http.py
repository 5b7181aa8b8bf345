"""The port's HTTP front (chatterbox_tpu_torch/serve/http.py) over a real
socket on 127.0.0.1, as tests/test_http.py holds the JAX package's: its
host helpers bit for bit against the JAX package's (PCM16 against the
native packetizer), every endpoint and error code on the whole-batch
backend (a ServingLoop over a BatchDecoder), the continuous backend
(streams included; and with draft_int8, whose replies equal draft off's)
and a CFG slot server; a reply's samples against the port's TTSServer for
the same request alone. Tiny models: the float32 2-layer GPT2_fused_test
T3 (Llama_fused_test for CFG) and a tiny meanflow S3Gen with its frontend.
Bytes exact."""
import base64
import json
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from chatterbox_tpu.serve import http as jhttp  # noqa: E402
from chatterbox_tpu.utils import profiling as jprof  # noqa: E402

from chatterbox_tpu_torch.api.pipelines import T3CondHost  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.flow import FlowDims  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.model import RefDict, S3GenEngine, s3gen_init  # noqa: E402
from chatterbox_tpu_torch.models.s3tok.model import S3TokenizerConfig  # noqa: E402
from chatterbox_tpu_torch.ops.sampling import SamplerParams  # noqa: E402
from chatterbox_tpu_torch.sampling.continuous import ContinuousTTSServer  # noqa: E402
from chatterbox_tpu_torch.serve import http  # noqa: E402
from chatterbox_tpu_torch.serve.batching import BatchDecoder, TTSRequest, TTSServer  # noqa: E402
from chatterbox_tpu_torch.serve.http import TTSHTTPServer, Voice, wav_bytes  # noqa: E402
from chatterbox_tpu_torch.utils import profiling  # noqa: E402

from tests import test_torch_t3 as G  # noqa: E402
from tests import test_torch_t3_llama as L  # noqa: E402
from tests.test_torch_convert import few_threads  # noqa: E402,F401


class _Tok:
    def __init__(self):
        self.last_language = "UNSET"

    def text_to_tokens(self, t, language_id=None):
        self.last_language = language_id
        return (np.arange(len(t)) % 60 + 1).astype(np.int32)[:16]


_ENG = {}


def _engine():
    """A tiny meanflow S3Gen with its frontend (S3 tokenizer, CAMPPlus) for /vc."""
    if not _ENG:
        tok, dims = S3TokenizerConfig.tiny_test(), FlowDims.tiny_test()
        _ENG["e"] = S3GenEngine(s3gen_init(1, "cpu", meanflow=True, tok_cfg=tok, dims=dims,
                                           hift_base=32), dims=dims, tok_cfg=tok)
    return _ENG["e"]


def _voice(hp):
    rng = np.random.default_rng(0)
    P = 8
    ref = RefDict(rng.integers(0, 6561, (1, P)).astype(np.int32), np.asarray([P], np.int32),
                  rng.standard_normal((1, 2 * P, 80)).astype(np.float32) * 0.1,
                  rng.standard_normal((1, 192)).astype(np.float32))
    cond = T3CondHost(np.zeros((1, 256), np.float32),
                      np.zeros((1, hp.speech_cond_prompt_len), np.int32), 0.5)
    return Voice(cond, ref)


def _t3():
    return G.models("f32", None)[1]


@pytest.fixture(scope="module")
def server():
    dec = BatchDecoder(_t3(), G.HP, max_batch=4, max_new_tokens=8, top_k=0)
    srv = TTSHTTPServer(dec, _engine(), _Tok(), {"default": _voice(G.HP)}, port=0,
                        timeout_s=240.0)
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def cont_server():
    slots = ContinuousTTSServer(_t3(), G.HP, n_slots=3, text_bucket=16, max_new_tokens=8,
                                chunk=4, top_k=40, s3gen=_engine(), stream_chunk=4)
    srv = TTSHTTPServer(None, _engine(), _Tok(), {"default": _voice(G.HP)}, port=0,
                        timeout_s=240.0, continuous=slots)
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


def _url(server, path):
    return f"http://{server.host}:{server.port}{path}"


def _post(server, payload, path="/tts", timeout=240):
    req = urllib.request.Request(_url(server, path), data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _read(server, payload, path="/tts"):
    with _post(server, payload, path) as r:
        return r.read()


def _parse_wav(body: bytes):
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    return struct.unpack("<I", body[24:28])[0], np.frombuffer(body[44:], np.int16)


def _code(server, payload, path="/tts"):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, payload, path)
    return ei.value.code


# ---------------------------------------------------------------------------
# host helpers against the JAX package
# ---------------------------------------------------------------------------

def test_pcm16_matches_the_native_packetizer():
    """pcm16_bytes against the JAX package's (its native wavio.cpp
    packetizer, built here): clipping, the float32 product and truncation
    toward zero, bit for bit, including values just past each code."""
    from chatterbox_tpu.runtime import get_lib
    assert get_lib() is not None
    rng = np.random.default_rng(0)
    codes = np.arange(-32767, 32768, dtype=np.float32)
    wav = np.concatenate([rng.uniform(-1.3, 1.3, 20000).astype(np.float32),
                          codes / 32767, np.nextafter(codes / 32767, np.float32(2)),
                          np.nextafter(codes / 32767, np.float32(-2)),
                          np.float32([0, -0.0, 1, -1, 1e-9, -1e-9, 2, -2])])
    ours = http.pcm16_bytes(wav)
    assert ours == jhttp.pcm16_bytes(wav)
    assert len(ours) == 2 * len(wav)


@pytest.mark.parametrize("sr", [16000, 24000])
def test_wav_bytes_and_stream_header_match_jax(sr):
    wav = (np.sin(np.linspace(0, 40, 4801)) * 0.7).astype(np.float32)
    assert wav_bytes(wav, sr) == jhttp.wav_bytes(wav, sr)
    assert http.wav_stream_header(sr) == jhttp.wav_stream_header(sr)
    got_sr, pcm = _parse_wav(wav_bytes(wav, sr))
    assert got_sr == sr and len(pcm) == len(wav)
    np.testing.assert_allclose(pcm / 32767.0, wav, atol=1.0 / 32767)


def test_metrics_text_matches_jax():
    """The same stages and counters recorded in both packages' Metrics:
    metrics_text and report() equal, a stage seen again, and reset behave
    alike; `set` exports a counter kept elsewhere at its value."""
    ours, theirs = profiling.Metrics(), jprof.Metrics()
    for m in (ours, theirs):
        for dt in (0.125, 0.5, 0.0625):
            m.add_stage("http_tts", dt)
        m.add_stage("t3 decode/step", 0.25)
        m.count("requests_total")
        m.count("audio_seconds_total", 2.75)
        m.count("errors_total", 3)
    assert http.metrics_text(ours) == jhttp.metrics_text(theirs)
    assert ours.report() == theirs.report()
    assert ours.report()["http_tts"]["total_s"] == 0.6875
    for m in (ours, theirs):
        m.add_stage("s", 0.5)
    assert ours.report()["s"] == theirs.report()["s"] and ours.report()["s"]["count"] == 1
    ours.set("rounds_total", 7)
    ours.set("rounds_total", 9)
    assert ours.report()["rounds_total"] == 9 and "chatterbox_rounds_total 9\n" in \
        http.metrics_text(ours)
    ours.reset()
    assert ours.report() == {} and http.metrics_text(ours) == "\n"


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1 and json.loads(files[0].read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# the whole-batch backend
# ---------------------------------------------------------------------------

def test_tts_roundtrip_equals_the_tts_server(server):
    """A seeded reply's samples are the PCM16 of the port's TTSServer result
    for the same request alone."""
    sr, pcm = _parse_wav(_read(server, {"text": "hello http", "voice": "default",
                                        "seed": 1, "temperature": 0.7}))
    assert sr == 24000 and len(pcm) > 0
    v = server.voices["default"]
    req = TTSRequest(np.asarray(_Tok().text_to_tokens("hello http"), np.int32), v.cond,
                     SamplerParams(temperature=0.7), request_id=0, seed=1, ref=v.ref)
    dec = BatchDecoder(_t3(), G.HP, max_batch=4, max_new_tokens=8, top_k=0)
    alone = TTSServer(dec, _engine()).synthesize_batch([req], [v.ref])[0]
    np.testing.assert_array_equal(pcm, np.frombuffer(http.pcm16_bytes(alone), np.int16))


def test_concurrent_requests(server):
    out = {}

    def call(i):
        out[i] = _parse_wav(_read(server, {"text": f"req {i}", "seed": i}))[1]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    [t.start() for t in threads]
    [t.join(timeout=240) for t in threads]
    assert sorted(out) == [0, 1, 2] and all(len(v) for v in out.values())


def test_same_seed_is_deterministic(server):
    assert _read(server, {"text": "determinism", "seed": 42}) == \
        _read(server, {"text": "determinism", "seed": 42})


def test_voices_health_and_404(server):
    with urllib.request.urlopen(_url(server, "/voices"), timeout=30) as r:
        assert json.load(r)["voices"] == ["default"]
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        assert json.load(r)["ok"] is True
    for path in ("/other", "/tts/x"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(_url(server, path), timeout=30)
        assert ei.value.code == 404
    assert _code(server, {"text": "x"}, path="/nope") == 404


def test_bad_requests_400(server):
    assert _code(server, {"text": "x", "voice": "nope"}) == 400
    assert _code(server, {"voice": "default"}) == 400                 # no text
    assert _code(server, {"text": "x", "temperature": "hot"}) == 400
    req = urllib.request.Request(_url(server, "/tts"), data=b"{not json",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400


def test_a_serving_failure_is_500(server, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("tokenizer fell over")

    monkeypatch.setattr(server.tokenizer, "text_to_tokens", boom)
    before = server.metrics.report().get("errors_total", 0)
    assert _code(server, {"text": "x"}) == 500
    assert server.metrics.report()["errors_total"] == before + 1


def test_timeout_returns_504_and_leaks_nothing(server):
    old = server.timeout_s
    server.timeout_s = 1e-3
    try:
        assert _code(server, {"text": "too slow", "seed": 99}) == 504
    finally:
        server.timeout_s = old
    deadline = time.time() + 120
    while time.time() < deadline and server.loop._q.qsize():
        time.sleep(0.2)
    time.sleep(2.0)                        # the loop finishes the request and drops it
    assert server._results == {} and server._events == {}


def test_streaming_endpoint_with_a_stream_fn(server):
    chunks = [np.full(100, 0.1, np.float32), np.full(50, -0.2, np.float32),
              np.zeros(10, np.float32)]
    calls = {}

    def sfn(text, voice, seed, **kw):
        calls["args"] = (text, seed, kw)
        yield from chunks

    server.stream_fn = sfn
    try:
        body = _read(server, {"text": "stream me", "stream": True, "seed": 9,
                              "temperature": 0.7})
    finally:
        server.stream_fn = None
    assert body[:44] == http.wav_stream_header(24000)
    assert body[44:] == b"".join(http.pcm16_bytes(c) for c in chunks)
    assert calls["args"] == ("stream me", 9, {"temperature": 0.7})
    assert _code(server, {"text": "x", "stream": True}) == 400       # no stream_fn now


def test_mid_stream_failure_truncates_cleanly(server):
    good = np.full(80, 0.25, np.float32)

    def sfn(text, voice, seed, **kw):
        yield good
        raise RuntimeError("device fell over")

    server.stream_fn = sfn
    before = server.metrics.report().get("errors_total", 0)
    try:
        body = _read(server, {"text": "x", "stream": True})
    finally:
        server.stream_fn = None
    assert body[44:] == http.pcm16_bytes(good)
    assert server.metrics.report()["errors_total"] == before + 1


def test_metrics_endpoints(server):
    _read(server, {"text": "metric me", "seed": 123})
    with urllib.request.urlopen(_url(server, "/metrics.json"), timeout=30) as r:
        rep = json.loads(r.read())
    assert rep["requests_total"] >= 1 and rep["audio_seconds_total"] > 0
    assert rep["http_tts"]["count"] >= 1 and rep["http_tts"]["mean_s"] > 0
    with urllib.request.urlopen(_url(server, "/metrics"), timeout=30) as r:
        text = r.read().decode()
        assert r.headers["Content-Type"].startswith("text/plain")
    assert "chatterbox_http_tts_count" in text and "chatterbox_requests_total" in text


def test_register_voice_and_per_request_audio(server):
    calls = {}

    def prep(path):
        calls["path"] = path
        return server.voices["default"]

    assert _code(server, {"name": "x", "wav_b64": ""}, path="/voices") == 400   # disabled
    server.prepare_fn = prep
    try:
        with _post(server, {"name": "newv", "wav_b64": base64.b64encode(b"RIFF").decode()},
                   path="/voices") as r:
            assert r.status == 201 and json.loads(r.read())["voice"] == "newv"
        assert calls["path"].endswith(".wav")
        with urllib.request.urlopen(_url(server, "/voices"), timeout=30) as r:
            assert "newv" in json.load(r)["voices"]
        assert len(_parse_wav(_read(server, {"text": "new voice", "voice": "newv",
                                             "seed": 5}))[1])
        assert _code(server, {"name": "", "wav_b64": "aGk="}, path="/voices") == 400
        # a request's own reference audio: an ephemeral voice, not registered
        n = len(server.voices)
        assert len(_parse_wav(_read(server, {"text": "ephemeral", "seed": 3,
                                             "wav_b64": "aGk="}))[1])
        assert len(server.voices) == n
    finally:
        server.prepare_fn = None
        server.voices.pop("newv", None)
    assert _code(server, {"text": "x", "wav_b64": "aGk="}) == 400        # no prepare_fn


def test_openai_compat_speech_endpoint(server):
    wav_body = _read(server, {"model": "tts-1", "input": "hello there", "voice": "alloy",
                              "seed": 11}, path="/v1/audio/speech")
    sr, pcm = _parse_wav(wav_body)
    assert sr == 24000 and len(pcm) > 0
    with _post(server, {"input": "hello there", "voice": "alloy", "seed": 11,
                        "response_format": "pcm"}, path="/v1/audio/speech") as r:
        raw = r.read()
        assert r.headers["Content-Type"] == "audio/pcm"
    assert raw == wav_body[44:]
    assert _code(server, {"input": "x", "response_format": "mp3"},
                 path="/v1/audio/speech") == 400
    assert _code(server, {"voice": "default"}, path="/v1/audio/speech") == 400


def test_vc_roundtrip_seeded_and_per_request_target(server):
    """POST /vc against the registered voice: a seeded conversion gives the
    same bytes twice, another seed other bytes; a per-request target voice;
    an unknown voice is a 400."""
    rng = np.random.default_rng(3)
    b64 = lambda w, sr: base64.b64encode(wav_bytes(w, sr)).decode()
    src = b64((0.1 * rng.standard_normal(16000)).astype(np.float32), 16000)
    a = _read(server, {"wav_b64": src, "voice": "default", "seed": 5}, path="/vc")
    sr, pcm = _parse_wav(a)
    assert sr == 24000 and len(pcm) > 0
    assert _read(server, {"wav_b64": src, "voice": "default", "seed": 5}, path="/vc") == a
    assert _read(server, {"wav_b64": src, "voice": "default", "seed": 6}, path="/vc") != a
    tgt = b64((0.1 * rng.standard_normal(24000)).astype(np.float32), 24000)
    assert len(_parse_wav(_read(server, {"wav_b64": src, "target_wav_b64": tgt, "seed": 6},
                                path="/vc"))[1])
    assert _code(server, {"wav_b64": "", "voice": "nope"}, path="/vc") == 400
    assert server.metrics.report()["vc_requests_total"] >= 4


def test_language_and_exaggeration_fields(server):
    _read(server, {"text": "bonjour", "seed": 6, "language": "fr"})
    assert server.tokenizer.last_language == "fr"
    _read(server, {"text": "hello", "seed": 6})
    assert server.tokenizer.last_language is None
    before = server.voices["default"].cond.emotion_adv
    assert len(_parse_wav(_read(server, {"text": "excited!", "seed": 8,
                                         "exaggeration": 0.9}))[1])
    assert server.voices["default"].cond.emotion_adv == before != 0.9


# ---------------------------------------------------------------------------
# the continuous backend
# ---------------------------------------------------------------------------

def test_continuous_roundtrip_and_determinism(cont_server):
    a = _read(cont_server, {"text": "determinism", "seed": 42, "temperature": 0.7})
    sr, pcm = _parse_wav(a)
    assert sr == 24000 and len(pcm) > 0
    assert _read(cont_server, {"text": "determinism", "seed": 42, "temperature": 0.7}) == a
    with urllib.request.urlopen(_url(cont_server, "/healthz"), timeout=30) as r:
        assert json.load(r)["ok"] is True


def test_continuous_metrics_export_the_slot_counters(cont_server):
    """A continuous backend's /metrics and /metrics.json carry its decode
    rounds, their steps and the finished requests' tokens as *_total."""
    slots = cont_server.loop.server
    before = slots.tokens_emitted
    _, pcm = _parse_wav(_read(cont_server, {"text": "count me", "seed": 7}))
    with urllib.request.urlopen(_url(cont_server, "/metrics.json"), timeout=30) as r:
        rep = json.loads(r.read())
    assert rep["rounds_total"] == slots.rounds >= 1
    assert rep["decode_steps_total"] == slots.decode_steps >= slots.rounds
    # the reply's tokens: 960 samples (40 ms) each
    assert rep["tokens_emitted_total"] == slots.tokens_emitted == before + len(pcm) // 960
    assert len(pcm) % 960 == 0 and len(pcm) > 0
    with urllib.request.urlopen(_url(cont_server, "/metrics"), timeout=30) as r:
        text = r.read().decode()
    assert f"chatterbox_tokens_emitted_total {slots.tokens_emitted}\n" in text
    assert f"chatterbox_rounds_total {slots.rounds}\n" in text


def test_continuous_concurrent_mixed_requests(cont_server):
    out = {}

    def call(i):
        out[i] = _parse_wav(_read(cont_server, {"text": "x" * (3 + 4 * i), "seed": i}))[1]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]   # 4 > 3 slots
    [t.start() for t in threads]
    [t.join(timeout=240) for t in threads]
    assert sorted(out) == [0, 1, 2, 3] and all(len(v) for v in out.values())


def test_continuous_streams_concurrent_and_identical_to_solo(cont_server):
    """Streams need no stream_fn on a continuous backend; three at once
    finish, a seeded one byte for byte its solo run, different seeds
    differ; a plain request beside a stream finishes too."""
    assert cont_server.stream_fn is None
    solo = _read(cont_server, {"text": "stream me", "seed": 21, "stream": True})
    assert solo[:44] == http.wav_stream_header(24000) and len(solo) > 44
    out = {}

    def call(i):
        out[i] = _read(cont_server, {"text": "stream me", "seed": 21 + i, "stream": True})

    def plain():
        out["p"] = _parse_wav(_read(cont_server, {"text": "plain", "seed": 40}))[1]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    threads.append(threading.Thread(target=plain))
    [t.start() for t in threads]
    [t.join(timeout=240) for t in threads]
    assert set(out) == {0, 1, 2, "p"} and len(out["p"])
    assert out[0] == solo and out[1] != out[2]
    rep = cont_server.metrics.report()
    assert rep["stream_requests_total"] >= 4 and rep["http_stream_ttfa"]["count"] >= 4


def test_continuous_draft_replies_equal_draft_off():
    """A continuous backend with draft_int8 answers /tts and a stream with
    the bytes of the same backend with draft off."""
    bodies = {}
    for draft in (False, True):
        slots = ContinuousTTSServer(_t3(), G.HP, n_slots=2, text_bucket=16, max_new_tokens=10,
                                    chunk=4, top_k=40, s3gen=_engine(), stream_chunk=4,
                                    draft_int8=draft, n_draft=3)
        srv = TTSHTTPServer(None, _engine(), _Tok(), {"default": _voice(G.HP)}, port=0,
                            timeout_s=240.0, continuous=slots)
        srv.start()
        try:
            bodies[draft] = (_read(srv, {"text": "speculate", "seed": 13}),
                             _read(srv, {"text": "stream it", "seed": 14, "stream": True}))
        finally:
            srv.stop()
        assert slots.spec_rounds > 0 if draft else slots.spec_rounds == 0
    assert bodies[True] == bodies[False] and len(bodies[True][1]) > 44


def test_cfg_continuous_streams():
    """A cfg=True slot server behind the front (SOT / EOT framing by
    frame_text): plain replies and a stream, the stream byte for byte its
    solo run when two run at once."""
    hp = L.HP

    def frame(ids):      # the test T3's SOT / EOT, inside its 64-id text vocabulary
        return np.concatenate([L.TEXT[0, :1], np.asarray(ids).reshape(-1),
                               L.TEXT[0, -1:]]).astype(np.int32)

    slots = ContinuousTTSServer(L.models("f32")[1], hp, n_slots=2, text_bucket=20,
                                max_new_tokens=8, chunk=4, top_k=40, s3gen=_engine(),
                                stream_chunk=4, cfg=True)
    srv = TTSHTTPServer(None, _engine(), _Tok(), {"default": _voice(hp)}, port=0,
                        timeout_s=240.0, continuous=slots, frame_text=frame)
    srv.start()
    try:
        assert srv._continuous_stream
        assert len(_parse_wav(_read(srv, {"text": "cfg plain", "seed": 5, "min_p": 0.02,
                                          "cfg_weight": 0.4}))[1])
        solo = _read(srv, {"text": "stream me", "seed": 61, "stream": True})
        out = {}

        def call(i):
            out[i] = _read(srv, {"text": "stream me", "seed": 61 + i, "stream": True})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
        [t.start() for t in threads]
        [t.join(timeout=240) for t in threads]
    finally:
        srv.stop()
    assert sorted(out) == [0, 1] and out[0] == solo and len(solo) > 44
