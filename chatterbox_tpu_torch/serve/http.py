"""The HTTP serving front over the batched and the continuous serving loops
(the counterpart of chatterbox_tpu/serve/http.py), on the stdlib
ThreadingHTTPServer:

  POST /tts     {"text": "...", "voice": "<id>", "seed": 3,
                 "temperature": 0.8, "top_p": 0.95,
                 "repetition_penalty": 1.2}          -> audio/wav (PCM16)
                 CFG-family servers also take "min_p", "cfg_weight",
                 "exaggeration" (the request's emotion) and, multilingual,
                 "language" (the tokenizer's language_id)
  POST /tts     {..., "stream": true}                -> chunked audio/wav,
                 each chunk sent as it is made (needs a stream_fn or a
                 continuous backend that vocodes, see TTSHTTPServer)
  POST /tts     {..., "wav_b64": "<WAV>"}            -> the request's own
                 reference audio (a voice not registered; needs prepare_fn)
  POST /voices  {"name": "...", "wav_b64": "<WAV>"}  -> register a voice
                 from reference audio (needs prepare_fn)
  POST /vc      {"wav_b64": "<WAV>", "voice": "<id>" |
                 "target_wav_b64": "<WAV>", "seed": 3} -> audio/wav: voice
                 conversion (source audio -> S3 tokens -> S3Gen in the
                 target voice, no T3)
  POST /v1/audio/speech {"input": "...", "voice": "<id>",
                 "response_format": "wav"|"pcm", "seed": 3}
                 -> the OpenAI speech endpoint's fields ("model" is
                 accepted and ignored)
  GET  /voices                                       -> {"voices": [...]}
  GET  /healthz                                      -> {"ok": true, ...}
  GET  /metrics                                      -> Prometheus text
                 (request counts and stage times, streamed time to first
                 audio, audio seconds made, errors; on a continuous backend
                 also rounds_total, decode_steps_total and
                 tokens_emitted_total); /metrics.json as JSON

Concurrent requests share device batches: the whole-batch backend (a
ServingLoop over a BatchDecoder; requests join at batch boundaries, both
families) or, with `continuous=` a ContinuousTTSServer, the slot engine
(requests join at the next decode round and finish on their own; Turbo, or
the CFG family on a cfg=True server with frame_text; text is cut at the
server's text_bucket). Error paths answer 400 (bad request, unknown voice),
404 (unknown path), 500 (a failure while serving) and 504 (timeout).

Audio becomes PCM16 as the JAX package's native packetizer makes it
(chatterbox_tpu/runtime/wavio.cpp `pcm16_from_f32`): clipped to [-1, 1],
scaled by 32767 in float32, truncated toward zero. A seeded /vc request
draws its noise from `vocode_seed(seed, stream=2)`, so it gives the same
bytes twice.

Not here: `warmup` (the JAX package's compile grid, `BatchDecoder.warmup`
and `S3GenEngine.warmup_grid`, which eager PyTorch does not need).
"""
from __future__ import annotations

import base64
import contextlib
import copy
import json
import logging
import os
import queue
import re
import struct
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..ops.sampling import SamplerParams
from ..utils.audio_io import load_audio
from ..utils.profiling import Metrics
from .batching import (BatchDecoder, ContinuousServingLoop, ServingLoop, TTSRequest,
                       register_lingering, vocode_seed)

logger = logging.getLogger(__name__)


def pcm16_bytes(wav: np.ndarray) -> bytes:
    """float32 mono -> raw PCM16 bytes: clipped to [-1, 1], times 32767 in
    float32, truncated toward zero."""
    wav = np.clip(np.asarray(wav, np.float32).reshape(-1), -1.0, 1.0)
    return (wav * np.float32(32767.0)).astype(np.int16).tobytes()


def wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """float32 mono -> in-memory RIFF/PCM16."""
    data = pcm16_bytes(wav)
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16,
        1, 1, sr, sr * 2, 2, 16, b"data", len(data))
    return hdr + data


def metrics_text(m: Metrics) -> str:
    """Metrics in the Prometheus text format (stages -> *_seconds_total /
    *_count / *_seconds_max, counters -> plain gauges)."""
    lines = []
    for name, v in m.report().items():
        base = "chatterbox_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)
        if isinstance(v, dict):
            lines.append(f"{base}_seconds_total {v['total_s']}")
            lines.append(f"{base}_count {v['count']}")
            lines.append(f"{base}_seconds_max {v['max_s']}")
        else:
            lines.append(f"{base} {v}")
    return "\n".join(lines) + "\n"


def wav_stream_header(sr: int) -> bytes:
    """RIFF/PCM16 header with unknown (maximal) sizes: the streaming endpoint
    sends it first and then raw PCM16 chunks; players read 0xFFFFFFFF as
    'until the stream ends'."""
    return struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 0xFFFFFFFF, b"WAVE", b"fmt ", 16,
        1, 1, sr, sr * 2, 2, 16, b"data", 0xFFFFFFFF)


class Voice:
    """A registered voice: T3 conditioning and the S3Gen reference."""

    def __init__(self, cond, ref):
        self.cond = cond          # api.pipelines.T3CondHost
        self.ref = ref            # RefDict


class TTSHTTPServer:
    """The HTTP front over a ServingLoop (whole batches of a BatchDecoder)
    or a ContinuousServingLoop (`continuous=`).

    tokenizer: an object with .text_to_tokens(text); voices: {id: Voice};
    frame_text (optional) maps raw ids to SOT/EOT-framed ids for the CFG
    family."""

    def __init__(self, decoder: Optional[BatchDecoder], s3gen, tokenizer,
                 voices: dict, sr: int = 24000, host: str = "127.0.0.1",
                 port: int = 8321, frame_text=None, timeout_s: float = 300.0,
                 stream_fn=None, prepare_fn=None, continuous=None):
        """stream_fn (optional) serves `"stream": true` requests: a callable
        (text, voice, seed, **sampler_kw) yielding float32 chunks as they
        are made (e.g. a pipeline's generate_stream); the answer is chunked
        audio/wav, one stream at a time. A continuous backend whose server
        has an s3gen engine streams without it and without the lock: the
        streams decode together in its slots, each chunk sent as its slot
        reaches it.

        prepare_fn (optional) serves POST /voices and per-request reference
        audio: a callable (wav_path) -> Voice (e.g. around a pipeline's
        prepare_conditionals).

        continuous (optional): a sampling.continuous.ContinuousTTSServer to
        serve on instead of whole batches; decoder may then be None, and
        the vocoder is the slot server's s3gen."""
        self.sr = sr
        self.tokenizer = tokenizer
        self.voices = voices
        self.frame_text = frame_text
        self.timeout_s = timeout_s
        self.stream_fn = stream_fn
        self.prepare_fn = prepare_fn
        self._stream_lock = threading.Lock()
        self.metrics = Metrics()      # GET /metrics (Prometheus) and /metrics.json
        self._events: dict[int, threading.Event] = {}
        self._results: dict[int, object] = {}
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._slot_server = continuous
        if continuous is not None:
            self.loop = ContinuousServingLoop(continuous, self._on_result)
        else:
            self.loop = ServingLoop(decoder, self._on_result, s3gen=s3gen)
        # streams ride the slot engine when it vocodes (both families)
        self._continuous_stream = (continuous is not None
                                   and continuous.s3gen is not None)
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.host, self.port = self._httpd.server_address[:2]

    # ------------------------------------------------------------------
    def _metrics(self) -> Metrics:
        """self.metrics with a continuous backend's counters as they are
        now (decode rounds, their steps, the finished requests' tokens)."""
        srv = self._slot_server
        if srv is not None:
            for name in ("rounds", "decode_steps", "tokens_emitted"):
                self.metrics.set(f"{name}_total", getattr(srv, name))
        return self.metrics

    def _on_result(self, result):
        ev = self._events.get(result.request_id)
        if ev is None:
            return   # the caller gave up (timeout): drop the result
        self._results[result.request_id] = result
        ev.set()
        if result.request_id not in self._events:
            # the caller timed out between the get() above and the store
            self._results.pop(result.request_id, None)

    def _ephemeral_voice(self, wav_b64: str):
        """A Voice for one request from base64 WAV bytes (needs prepare_fn)."""
        if self.prepare_fn is None:
            raise ValueError("per-request reference audio needs a prepare_fn")
        fd, path = tempfile.mkstemp(suffix=".wav")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(base64.b64decode(wav_b64))
            with self._stream_lock:              # one conditioning build at a time
                return self.prepare_fn(path)
        finally:
            os.unlink(path)

    def synthesize(self, text: str, voice_id: str, seed: Optional[int] = None,
                   voice_obj=None, language: Optional[str] = None,
                   exaggeration: Optional[float] = None,
                   **sampler_kw) -> np.ndarray:
        """One synthesis through the serving loop, waited for: the (T,)
        float32 waveform. voice_obj (a Voice) stands in for the registered
        voice; language goes to the tokenizer as language_id (the
        multilingual family); exaggeration replaces emotion_adv in a copy of
        the voice's conditioning (the CFG family)."""
        voice = voice_obj if voice_obj is not None else self.voices[voice_id]
        if language is not None:
            ids = np.asarray(self.tokenizer.text_to_tokens(
                text, language_id=language)).reshape(-1)
        else:
            ids = np.asarray(self.tokenizer.text_to_tokens(text)).reshape(-1)
        if self.frame_text is not None:
            ids = np.asarray(self.frame_text(ids)).reshape(-1)
        if exaggeration is not None and \
                float(exaggeration) != float(getattr(voice.cond,
                                                     "emotion_adv", 0.5)):
            cond = copy.copy(voice.cond)
            cond.emotion_adv = float(exaggeration)
            voice = Voice(cond, voice.ref)
        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
        ev = threading.Event()
        self._events[rid] = ev
        sampler = SamplerParams(**sampler_kw) if sampler_kw else None
        self.loop.submit(TTSRequest(
            text_tokens=ids.astype(np.int32), cond=voice.cond, ref=voice.ref,
            sampler=sampler, request_id=rid, seed=seed))
        if not ev.wait(self.timeout_s):
            self._events.pop(rid, None)
            self._results.pop(rid, None)
            raise TimeoutError(f"request {rid} timed out")
        self._events.pop(rid, None)
        result = self._results.pop(rid)
        if result.wav is None:
            raise RuntimeError("the serving loop returned no audio (no RefDict?)")
        wav = np.asarray(result.wav).reshape(-1)
        self.metrics.count("audio_seconds_total", len(wav) / self.sr)
        return wav

    def voice_convert(self, wav_b64: str, voice_id: str = "default",
                      target_wav_b64: Optional[str] = None,
                      seed: Optional[int] = None) -> np.ndarray:
        """Voice conversion: a source WAV's S3 tokens vocoded by S3Gen in a
        target voice, a registered voice's RefDict or one built from
        target_wav_b64 (its first 10 s). It changes no serving state, so
        /vc requests and the serving loop interleave."""
        eng = self.loop.s3gen
        if eng is None:
            raise ValueError("voice conversion needs an s3gen engine")

        def _to_tmp(b64: str):
            fd, path = tempfile.mkstemp(suffix=".wav")
            with os.fdopen(fd, "wb") as f:
                f.write(base64.b64decode(b64))
            return path

        src = _to_tmp(wav_b64)
        try:
            audio_16 = load_audio(src, 16_000)
            if target_wav_b64 is not None:
                tgt = _to_tmp(target_wav_b64)
                try:
                    ref = eng.embed_ref(
                        load_audio(tgt, self.sr)[: 10 * self.sr], self.sr)
                finally:
                    os.unlink(tgt)
            else:
                ref = self.voices[voice_id].ref
                if ref is None:
                    raise ValueError(f"voice {voice_id!r} has no RefDict")
        finally:
            os.unlink(src)
        # a seeded conversion's noise from the seed, apart from the seed's
        # synthesis vocode (stream 2, as the JAX package folds in 2)
        gen = torch.Generator(device=eng.device).manual_seed(
            vocode_seed(seed, stream=2) if seed is not None
            else int.from_bytes(os.urandom(8), "little") >> 1)
        tokens, _ = eng.tokenize(audio_16)
        wav = np.asarray(eng.inference(tokens, ref, generator=gen)).reshape(-1)
        self.metrics.count("vc_requests_total")
        self.metrics.count("audio_seconds_total", len(wav) / self.sr)
        return wav

    def synthesize_stream(self, text: str, voice_id: str,
                          seed: Optional[int] = None, voice_obj=None,
                          **sampler_kw):
        """The float32 chunks of one request streamed through the continuous
        backend, as its slot decodes (every `stream_chunk` tokens; the same
        bytes as the request alone). No lock: concurrent streams decode
        together."""
        voice = voice_obj if voice_obj is not None else self.voices[voice_id]
        if voice.ref is None:
            raise ValueError("streaming needs the voice's S3Gen RefDict")
        ids = np.asarray(self.tokenizer.text_to_tokens(text)).reshape(-1)
        if self.frame_text is not None:
            ids = np.asarray(self.frame_text(ids)).reshape(-1)
        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
        chunks: "queue.Queue[tuple]" = queue.Queue()

        def on_chunk(chunk, final):
            chunks.put((np.asarray(chunk), final))

        sampler = SamplerParams(**sampler_kw) if sampler_kw else None
        self.loop.submit_stream(TTSRequest(
            text_tokens=ids.astype(np.int32), cond=voice.cond,
            ref=voice.ref, sampler=sampler, request_id=rid, seed=seed),
            on_chunk)
        while True:
            try:
                chunk, final = chunks.get(timeout=self.timeout_s)
            except queue.Empty:
                raise TimeoutError(f"stream {rid} stalled "
                                   f"(> {self.timeout_s}s between chunks)")
            if chunk.size:
                yield chunk
            if final:
                return

    # ------------------------------------------------------------------
    def _make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            # chunked Transfer-Encoding is illegal on HTTP/1.0 responses
            # (RFC 7230 §3.3.1) — every non-stream path sends
            # Content-Length, so 1.1 keep-alive is safe
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass                                    # quiet by default

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"ok": True,
                                     "pending": server_self.loop._q.qsize()})
                elif self.path == "/voices":
                    self._json(200, {"voices": sorted(server_self.voices)})
                elif self.path == "/metrics":
                    body = metrics_text(server_self._metrics()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/metrics.json":
                    self._json(200, server_self._metrics().report())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/voices":
                    return self._register_voice()
                if self.path == "/vc":
                    return self._vc()
                openai_compat = self.path == "/v1/audio/speech"
                if self.path != "/tts" and not openai_compat:
                    return self._json(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    raw_pcm = False
                    if openai_compat:
                        # OpenAI field names: input/voice/response_format
                        # ("model" accepted and ignored; wav|pcm supported —
                        # no compressed-codec encoder in this stack)
                        req["text"] = req.pop("input")
                        fmt = req.get("response_format", "wav")
                        if fmt not in ("wav", "pcm"):
                            return self._json(400, {
                                "error": f"unsupported response_format "
                                         f"{fmt!r} (wav or pcm)"})
                        raw_pcm = fmt == "pcm"
                        if req.get("voice") not in server_self.voices:
                            req["voice"] = "default"   # ignore alloy/echo/...
                    text = req["text"]
                    voice = req.get("voice", "default")
                    voice_obj = None
                    if req.get("wav_b64"):
                        # the request's own reference audio
                        voice_obj = server_self._ephemeral_voice(
                            req["wav_b64"])
                    elif voice not in server_self.voices:
                        return self._json(400, {"error": f"unknown voice "
                                                f"{voice!r}"})
                    kw = {k: float(req[k]) for k in
                          ("temperature", "top_p", "min_p",
                           "repetition_penalty", "cfg_weight") if k in req}
                    if req.get("stream"):
                        if (server_self.stream_fn is None
                                and not server_self._continuous_stream):
                            return self._json(400, {
                                "error": "streaming not enabled (server has "
                                         "no stream_fn and no streaming-"
                                         "capable continuous backend)"})
                        return self._stream(text, voice, req.get("seed"),
                                            kw, voice_obj=voice_obj)
                    server_self.metrics.count("requests_total")
                    t0 = time.perf_counter()
                    wav = server_self.synthesize(
                        text, voice, seed=req.get("seed"),
                        voice_obj=voice_obj, language=req.get("language"),
                        exaggeration=req.get("exaggeration"), **kw)
                    server_self.metrics.add_stage(
                        "http_tts", time.perf_counter() - t0)
                except TimeoutError as e:
                    server_self.metrics.count("errors_total")
                    return self._json(504, {"error": str(e)})
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    return self._json(400, {"error": repr(e)})
                except Exception as e:
                    server_self.metrics.count("errors_total")
                    return self._json(500, {"error": repr(e)})
                if raw_pcm:
                    body, ctype = pcm16_bytes(wav), "audio/pcm"
                else:
                    body, ctype = wav_bytes(wav, server_self.sr), "audio/wav"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _vc(self):
                """POST /vc — voice conversion: source wav_b64 → wav of the
                same speech in the target voice (registered `voice` or a
                per-request `target_wav_b64`)."""
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    voice = req.get("voice", "default")
                    if (req.get("target_wav_b64") is None
                            and voice not in server_self.voices):
                        return self._json(400, {"error": f"unknown voice "
                                                f"{voice!r}"})
                    t0 = time.perf_counter()
                    wav = server_self.voice_convert(
                        req["wav_b64"], voice_id=voice,
                        target_wav_b64=req.get("target_wav_b64"),
                        seed=req.get("seed"))
                    server_self.metrics.add_stage(
                        "http_vc", time.perf_counter() - t0)
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    return self._json(400, {"error": repr(e)})
                except Exception as e:
                    server_self.metrics.count("errors_total")
                    return self._json(500, {"error": repr(e)})
                body = wav_bytes(wav, server_self.sr)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _register_voice(self):
                """POST /voices {"name": "...", "wav_b64": "<WAV file>"} —
                build and register a voice from reference audio at runtime
                (201 on success; re-POSTing a name replaces the voice)."""
                if server_self.prepare_fn is None:
                    return self._json(400, {
                        "error": "voice registration not enabled "
                                 "(server has no prepare_fn)"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    name = str(req["name"])
                    if not name:
                        raise ValueError("empty voice name")
                    wav = base64.b64decode(req["wav_b64"])
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    return self._json(400, {"error": repr(e)})
                fd, path = tempfile.mkstemp(suffix=".wav")
                try:
                    with os.fdopen(fd, "wb") as f:
                        f.write(wav)
                    with server_self._stream_lock:   # one conditioning build at a time
                        voice = server_self.prepare_fn(path)
                except Exception as e:
                    return self._json(400, {"error": repr(e)})
                finally:
                    os.unlink(path)
                server_self.voices[name] = voice
                server_self.metrics.count("voices_registered_total")
                self._json(201, {"ok": True, "voice": name})

            def _stream(self, text, voice, seed, kw, voice_obj=None):
                """Chunked audio/wav: WAV header first, then each synthesized
                chunk as PCM16 the moment it exists. A mid-stream failure can
                only truncate the stream (the 200 is already sent) — it is
                swallowed here, never re-raised into do_POST, which would
                write a second response onto the completed socket.

                Backend: the continuous slot machine when it can stream
                (concurrent — no lock, chunks flow while other streams and
                batch requests decode alongside); otherwise the serialized
                stream_fn path."""
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def emit(b: bytes):
                    self.wfile.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")

                emit(wav_stream_header(server_self.sr))
                server_self.metrics.count("stream_requests_total")
                t0 = time.perf_counter()
                first = True
                try:
                    if server_self._continuous_stream:
                        ctx = contextlib.nullcontext()
                        gen = server_self.synthesize_stream(
                            text, voice, seed, voice_obj=voice_obj, **kw)
                    else:
                        ctx = server_self._stream_lock
                        v = (voice_obj if voice_obj is not None
                             else server_self.voices[voice])
                        gen = server_self.stream_fn(text, v, seed, **kw)
                    with ctx:
                        for chunk in gen:
                            if first:
                                server_self.metrics.add_stage(
                                    "http_stream_ttfa",
                                    time.perf_counter() - t0)
                                first = False
                            server_self.metrics.count(
                                "audio_seconds_total",
                                np.asarray(chunk).size / server_self.sr)
                            emit(pcm16_bytes(chunk))
                except Exception as e:          # truncate, don't corrupt
                    server_self.metrics.count("errors_total")
                    logger.error(
                        "mid-stream failure (stream truncated): %r", e)
                finally:
                    server_self.metrics.add_stage(
                        "http_stream", time.perf_counter() - t0)
                    self.wfile.write(b"0\r\n\r\n")

        return Handler

    # ------------------------------------------------------------------
    def start(self):
        self.loop.start()
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="chatterbox-http-server")
        self._serve_thread.start()

    def stop(self):
        self._httpd.shutdown()
        self.loop.stop()
        if getattr(self, "_serve_thread", None) is not None:
            self._serve_thread.join(timeout=30)
            if self._serve_thread.is_alive():
                register_lingering(self._serve_thread)
