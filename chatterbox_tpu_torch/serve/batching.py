"""Batched serving (the counterpart of chatterbox_tpu/serve/batching.py):
  * `BatchDecoder`: requests grouped into one batched T3 decode. A batch is
    padded to a power of two by repeating its last request with that
    request's seed, so a pad row samples the same tokens as the row it
    copies and finishes with it. Each request's tokens depend on its own
    seed, prompt and sampler only (sampling/batched.py);
  * `TTSServer`: a batch decoded, then vocoded by one batched S3Gen call
    (models/s3gen/model.py `inference_batch`; requests may carry
    different voices);
  * `ServingLoop`: a thread that collects requests into batches and runs
    them two deep: batch N's vocode stays queued on the device while batch
    N+1's decode is launched, and is read back after it;
  * `ContinuousServingLoop`: the same surface over the slot engine
    (sampling/continuous.py `ContinuousTTSServer`): requests join at the
    next decode round and leave when their row finishes, streams included.
A seeded request's vocode draws from a generator seeded by `vocode_seed`,
apart from its decode's, so its audio is a function of the request alone;
an unseeded one draws from the server's own seeds. The loops' threads are
named "chatterbox-serving-loop"; a stop() whose bounded join times out
records the thread in LINGERING_THREADS.

Not here: `warmup` (the JAX package's compile grid of batch and text
buckets, which eager PyTorch does not need).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.fused_layer import MAX_B
from ..models.s3gen.model import EOS, SOS, SPEECH_VOCAB_SIZE
from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..ops.sampling import SamplerParams
from ..sampling.batched import t3_generate_batched


def pow2_sizes(n: int) -> list:
    """Powers of two up to and including next_pow2(n): the batch sizes a
    pow2-padding dispatch produces for batches of 1..n."""
    sizes, b = [], 1
    while b < n:
        sizes.append(b)
        b *= 2
    sizes.append(b)
    return sizes


# serving threads whose stop() join timed out (still finishing a round)
LINGERING_THREADS: list = []


def register_lingering(thread) -> None:
    """Record a thread whose stop() join timed out, pruning the dead ones
    first so a long-lived process cannot accumulate them."""
    LINGERING_THREADS[:] = [t for t in LINGERING_THREADS if t.is_alive()]
    LINGERING_THREADS.append(thread)


def vocode_seed(seed: int, stream: int = 1) -> int:
    """The seed of a seeded request's vocode generator: derived from the
    request's seed, apart from its decode's (which is the seed itself).
    stream tells apart the uses of one seed, as the JAX package's
    fold_in index does (1: a synthesis's vocode, 2: voice conversion)."""
    return int(np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        1, np.uint64)[0] >> 1)


def drop_invalid_tokens_sliced(tokens: np.ndarray, sos: int = SOS,
                               eos: int = EOS) -> np.ndarray:
    """The tokens strictly between the first SOS (or the start) and the
    first EOS (or the end)."""
    tokens = np.asarray(tokens).reshape(-1)
    sos_idx = np.nonzero(tokens == sos)[0]
    start = int(sos_idx[0]) + 1 if len(sos_idx) else 0
    eos_idx = np.nonzero(tokens == eos)[0]
    end = int(eos_idx[0]) if len(eos_idx) else len(tokens)
    return tokens[start:end]


@dataclasses.dataclass
class TTSRequest:
    text_tokens: np.ndarray            # (Lt,) ids: raw BPE (Turbo) or
                                       # SOT/EOT-framed (CFG family)
    cond: object                       # api.pipelines.T3CondHost
    sampler: Optional[SamplerParams] = None
    request_id: int = 0
    seed: Optional[int] = None         # per-request seed (reproducible rows)
    max_new: Optional[int] = None      # per-request token cap (continuous serving)
    ref: object = None                 # S3Gen RefDict: the loops vocode the result


@dataclasses.dataclass
class TTSResult:
    request_id: int
    speech_tokens: np.ndarray          # filtered (< 6561), no EOS
    wav: Optional[np.ndarray] = None   # the audio, when the loop vocodes


class BatchDecoder:
    """Groups requests and runs the batched T3 decode.

    cfg=True serves the 520M CFG family as 2B rows (cond and uncond). Each
    request's SamplerParams apply to its row; kv_int8 keeps the cache in
    int8, read by the int8 decode-attention kernel. A batch holds at most
    max_batch requests; on fused int8 layers the rows of a padded full batch
    (twice the requests for CFG) must fit the fused kernels' MAX_B."""

    def __init__(self, t3_params, hp: T3Config, max_batch: int = 8,
                 max_new_tokens: int = 1000, top_k: int = 1000, seed: int = 0,
                 cfg: bool = False, kv_int8: bool = False):
        self.t3_params = t3_params
        self.hp = hp
        self.max_batch = max_batch
        self.max_new_tokens = max_new_tokens
        self.top_k = top_k
        self.cfg = cfg
        self.kv_int8 = kv_int8
        self.device = t3_params["speech_emb"]["w"].device
        rows = pow2_sizes(max_batch)[-1] * (2 if cfg else 1)
        if "fused" in t3_params["backbone"]["layers"][0] and rows > MAX_B:
            raise ValueError(f"max_batch {max_batch} pads to {rows} rows; the fused "
                             f"decode-layer kernels take at most {MAX_B}")
        self._seeds = np.random.default_rng(seed)   # seeds of unseeded requests

    def _stack_samplers(self, requests: list) -> SamplerParams:
        default = SamplerParams(cfg_weight=0.5 if self.cfg else 0.0)
        rows = [r.sampler if r.sampler is not None else default for r in requests]
        return SamplerParams(*[[float(getattr(r, f.name)) for r in rows]
                               for f in dataclasses.fields(SamplerParams)])

    def _row_seeds(self, requests: list) -> list:
        return [r.seed if r.seed is not None else int(self._seeds.integers(2**62))
                for r in requests]

    def decode_batch(self, requests: list) -> list:
        return self.decode_batch_fetch(self.decode_batch_dispatch(requests))

    def batch_inputs(self, requests: list) -> tuple:
        """The batched engine's inputs for `requests`, padded to a power of
        two by repeating the last request and its seed: (cond, text,
        text_lens, sampler, generators)."""
        if not 1 <= len(requests) <= self.max_batch:
            raise ValueError(f"{len(requests)} requests; a batch holds 1..{self.max_batch}")
        seeds = self._row_seeds(requests)
        B = pow2_sizes(len(requests))[-1]
        requests = list(requests) + [requests[-1]] * (B - len(requests))
        seeds = seeds + [seeds[-1]] * (B - len(seeds))
        lens = [len(r.text_tokens) for r in requests]
        text = np.zeros((B, max(lens)), np.int64)
        for i, r in enumerate(requests):
            text[i, :lens[i]] = r.text_tokens
        dev = self.device
        cond = t3m.T3CondTensors(
            torch.as_tensor(np.concatenate([r.cond.speaker_emb for r in requests]),
                            dtype=torch.float32, device=dev),
            torch.as_tensor(np.concatenate([r.cond.cond_prompt_speech_tokens
                                            for r in requests]),
                            dtype=torch.long, device=dev),
            (torch.tensor([[[float(r.cond.emotion_adv)]] for r in requests], device=dev)
             if self.hp.emotion_adv else None))
        gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
        return (cond, torch.as_tensor(text, device=dev), lens,
                self._stack_samplers(requests), gens)

    def decode_batch_dispatch(self, requests: list):
        """Run the batched decode of `requests`; returns a handle for
        `decode_batch_fetch`, which reads the tokens back."""
        res = t3_generate_batched(
            self.t3_params, self.hp, *self.batch_inputs(requests),
            max_new_tokens=self.max_new_tokens, top_k=self.top_k, cfg_mode=self.cfg,
            kv_int8=self.kv_int8)
        return res, requests

    def decode_batch_fetch(self, handle) -> list:
        """Per-request results: each row's tokens up to its count, the CFG
        family's sliced between SOS and EOS, then ids below 6561."""
        res, requests = handle
        tokens, counts = res.tokens.cpu().numpy(), res.n_tokens.cpu().numpy()
        out = []
        for i, r in enumerate(requests):
            t = tokens[i, :counts[i]]
            if self.cfg:
                t = drop_invalid_tokens_sliced(t)
            out.append(TTSResult(request_id=r.request_id,
                                 speech_tokens=t[t < SPEECH_VOCAB_SIZE]))
        return out


class _VocodeSeeds:
    """Vocode generators of a batch of requests: a seeded request's from
    `vocode_seed`, an unseeded one's from this object's own seeds."""

    def __init__(self, seed: int, device):
        self._seeds = np.random.default_rng(seed)
        self.device = device

    def generators(self, requests: list) -> list:
        seeds = [vocode_seed(r.seed) if r.seed is not None
                 else int(self._seeds.integers(2**62)) for r in requests]
        return [torch.Generator(device=self.device).manual_seed(s) for s in seeds]


class TTSServer:
    """End-to-end batched TTS: the batched T3 decode, then one batched S3Gen
    call for the batch (models/s3gen/model.py inference_batch). Requests may
    carry different voices."""

    def __init__(self, decoder: BatchDecoder, s3gen, seed: int = 0):
        self.decoder = decoder
        self.s3gen = s3gen
        self._vocode = _VocodeSeeds(seed + 1, s3gen.device)

    def synthesize_batch(self, requests: list, refs: list) -> list:
        """refs[i] is the S3Gen RefDict of requests[i]. Returns the (T_i,)
        float32 waveforms in the order of `requests`."""
        results = self.decoder.decode_batch(requests)
        by_id = {r.request_id: r for r in results}
        rows = [by_id[req.request_id].speech_tokens for req in requests]
        return self.s3gen.inference_batch(rows, refs, self._vocode.generators(requests))


def _start_thread(target) -> threading.Thread:
    # the "chatterbox-" prefix names the serving threads, as in the JAX package
    thread = threading.Thread(target=target, daemon=True, name="chatterbox-serving-loop")
    thread.start()
    return thread


def _stop_thread(stop: threading.Event, thread: Optional[threading.Thread]) -> None:
    stop.set()
    if thread is not None:
        thread.join(timeout=30)
        if thread.is_alive():
            register_lingering(thread)


class ServingLoop:
    """A whole-batch serving loop: a thread collects queued requests into
    batches (up to max_batch, or what arrives within batch_wait_s), decodes
    each batch, vocodes it in one batched S3Gen call when every request
    carries a `ref` and the loop has an engine, and hands each TTSResult to
    on_result. Two deep: batch N's vocode is queued on the device, batch
    N+1's decode launched behind it, and N's audio read back only then.
    New requests join at batch boundaries; for token-level admission use
    ContinuousServingLoop."""

    def __init__(self, decoder: BatchDecoder, on_result: Callable[[TTSResult], None],
                 batch_wait_s: float = 0.02, s3gen=None, seed: int = 0):
        self.decoder = decoder
        self.on_result = on_result
        self.batch_wait_s = batch_wait_s
        self.s3gen = s3gen
        self._vocode = None if s3gen is None else _VocodeSeeds(seed + 7, s3gen.device)
        self._q: "queue.Queue[TTSRequest]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def submit(self, req: TTSRequest):
        self._q.put(req)

    def start(self):
        self._thread = _start_thread(self._run)

    def stop(self):
        """Stop after the batch in hand (its results are delivered) and join
        the thread (30 s at most; a thread still running then is recorded
        in LINGERING_THREADS)."""
        _stop_thread(self._stop, self._thread)

    def _finalize(self, pending):
        """Read a dispatched batch's audio back and deliver its results."""
        ordered, handle = pending
        if handle is not None:
            for r, w in zip(ordered, self.s3gen.inference_batch_fetch(handle)):
                r.wav = w
        for result in ordered:
            self.on_result(result)

    def _run(self):
        pending = None
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                if pending is not None:
                    self._finalize(pending)
                    pending = None
                continue
            batch = [first]
            while len(batch) < self.decoder.max_batch:
                try:
                    batch.append(self._q.get(timeout=self.batch_wait_s))
                except queue.Empty:
                    break
            dec_handle = self.decoder.decode_batch_dispatch(batch)
            if pending is not None:
                self._finalize(pending)
                pending = None
            results = self.decoder.decode_batch_fetch(dec_handle)
            if self.s3gen is not None and all(r.ref is not None for r in batch):
                by_id = {r.request_id: r for r in results}
                ordered = [by_id[req.request_id] for req in batch]
                handle = self.s3gen.inference_batch_dispatch(
                    [r.speech_tokens for r in ordered], [req.ref for req in batch],
                    self._vocode.generators(batch))
                pending = (ordered, handle)
            else:
                pending = (results, None)
        if pending is not None:
            self._finalize(pending)


class ContinuousServingLoop:
    """Token-level serving behind ServingLoop's surface (submit / start /
    stop / on_result): a thread drives a ContinuousTTSServer, so requests
    join at the next decode round rather than the next batch, and each
    result is delivered once its row has finished (and its audio, when
    vocoded, has been read back) while its former slot-mates decode on.
    Serves the family the server was built for (CFG requests carry
    SOT/EOT-framed text)."""

    def __init__(self, server, on_result: Callable[[TTSResult], None],
                 idle_wait_s: float = 0.05):
        self.server = server      # sampling.continuous.ContinuousTTSServer
        self.on_result = on_result
        self.s3gen = server.s3gen
        self.idle_wait_s = idle_wait_s
        self._q: "queue.Queue[tuple]" = queue.Queue()   # (request, on_chunk or None)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def submit(self, req: TTSRequest):
        self._q.put((req, None))

    def submit_stream(self, req: TTSRequest, on_chunk) -> None:
        """A streaming request: on_chunk(chunk, final) is called from the
        serving thread as its audio is made, while its slot-mates decode on
        (ContinuousTTSServer.submit says what a stream needs)."""
        self._q.put((req, on_chunk))

    def start(self):
        self._thread = _start_thread(self._run)

    def stop(self):
        """Graceful: the thread finishes every request already submitted,
        delivers the results, and is joined (30 s at most; a thread still
        running then is recorded in LINGERING_THREADS)."""
        _stop_thread(self._stop, self._thread)

    def _drain(self, block: bool) -> None:
        """Move queued requests into the server's pending list; wait a little
        for one only when the server is idle."""
        try:
            req, cb = (self._q.get(timeout=self.idle_wait_s) if block
                       else self._q.get_nowait())
        except queue.Empty:
            return
        self.server.submit(req, on_chunk=cb)
        while True:
            try:
                req, cb = self._q.get_nowait()
            except queue.Empty:
                return
            self.server.submit(req, on_chunk=cb)

    def _fire_ready(self) -> None:
        for rid, tokens, wav in self.server.pop_ready():
            self.on_result(TTSResult(request_id=rid, speech_tokens=tokens, wav=wav))

    def _run(self):
        busy = False
        while not self._stop.is_set():
            self._drain(block=not busy)
            busy = self.server.serve_round()
            self._fire_ready()
        # finish what is already queued or in the slots
        self._drain(block=False)
        while self.server.serve_round():
            self._fire_ready()
        self._fire_ready()
