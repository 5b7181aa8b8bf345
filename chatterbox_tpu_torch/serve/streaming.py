"""Streaming vocoding and chunked long-form synthesis (the counterpart of
chatterbox_tpu/serve/streaming.py).

`StreamingVocoder` turns speech tokens into audio as they arrive, with real
continuity across feeds:
  * one fixed flow-noise buffer per utterance, aligned to the packed
    [prompt | gen] mel layout, so every feed denoises the emitted region
    from the same numbers;
  * the HiFT source cache: the start of each feed's harmonic source is the
    previous feed's, so emitted audio never changes; the harmonic phases
    are drawn once per utterance, the source noise at every feed;
  * the lookahead: a feed that is not final holds back the frames of its
    last `lookahead_tokens` tokens, which the next tokens still change (the
    flow's pre-lookahead layer reads 3 tokens ahead).

Two modes:
  * exact (window_tokens=None): each feed runs the flow over every token so
    far. `feed` / `feed_dispatch` take host tokens; `feed_from_decode` takes
    a decode chunk's device output (sampling/chunked.py) and reads it back
    once, with the caller's extra scalars, in the same transfer.
    `feed_dispatch` returns device tensors and `feed_fetch` is where the
    host waits for the audio.
  * windowed (window_tokens=W): each feed runs the flow over [prompt | the
    last <= W tokens] and vocodes [the last ctx_mel frames | the new
    frames], the harmonic phase carried across windows in float64: O(chunk)
    work a feed, for narration of any length.

Every feed runs at its exact length: the flow over [prompt | tokens up to
the stream's tip], HiFT over the generated region up to the tip with the
held-back lookahead frames set to MEL_FLOOR, and nothing padded past the
tip. The JAX package vocodes a feed at a mel bucket from the host's upper
bound on the tokens, every frame past the vocoded length at MEL_FLOOR; with
exact buckets and every token of a chunk valid, its bucket is the tip and
the two agree.

Random numbers come through the engine's `draw_noise`: the flow buffer and
the phases once, when the vocoder is made, then the source noise of each
feed's vocoded frames.
"""
from __future__ import annotations

import re
from typing import Iterator, Optional

import numpy as np
import torch

from ..models.s3gen.flow import TOKEN_MEL_RATIO
from ..models.s3gen.hift import TOTAL_UPSAMPLE, hift_inference
from ..models.s3gen.model import SIL_TOKEN, RefDict, S3GenEngine, trim_fade
from ..nn import core as nn

PRE_LOOKAHEAD_LEN = 3           # tokens the flow's pre-lookahead layer reads ahead
_SENT_SPLIT = re.compile(r"(?<=[.!?。？！])\s+")


def chunk_text(text: str, max_chars: int = 300) -> list[str]:
    """Sentence-boundary chunking with a max-size fallback."""
    sentences = [s for s in _SENT_SPLIT.split(text.strip()) if s]
    chunks, cur = [], ""
    for s in sentences:
        if cur and len(cur) + len(s) + 1 > max_chars:
            chunks.append(cur)
            cur = s
        else:
            cur = f"{cur} {s}".strip()
        while len(cur) > max_chars:  # single overlong sentence
            chunks.append(cur[:max_chars])
            cur = cur[max_chars:]
    if cur:
        chunks.append(cur)
    return chunks or [text]


class StreamingVocoder:
    """Streams S3Gen over token chunks (see the module docstring)."""

    MAX_MEL_FRAMES = 8192    # the fixed noise buffer's frames (~164 s of audio)

    def __init__(self, engine: S3GenEngine, ref: RefDict, generator=None,
                 lookahead_tokens: int = PRE_LOOKAHEAD_LEN,
                 window_tokens: Optional[int] = None, ctx_mel: int = 16):
        if window_tokens is not None and window_tokens <= lookahead_tokens + 1:
            raise ValueError(
                f"window_tokens ({window_tokens}) must exceed "
                f"lookahead_tokens + 1 ({lookahead_tokens + 1})")
        self.engine = engine
        self.ref = ref
        self.generator = generator
        self.lookahead = lookahead_tokens
        self.window = window_tokens
        self.ctx_mel = ctx_mel
        noise = engine.draw_noise(self.MAX_MEL_FRAMES, 0, generator)
        self._noise = noise.z                # (1, MAX_MEL_FRAMES, 80), on the device
        self._phase = noise.source.phase     # HiFT's phases, fixed for the utterance
        self._tokens = np.zeros((1, 0), np.int32)
        self._fade = trim_fade()
        # exact mode: the source cache stays on the device
        self._emitted_samples = 0
        self._cache_dev = None
        self._src_cache_len = 0
        self._row_dev = None       # the device [prompt | gen] row (feed_from_decode)
        self._n_acc = 0            # its count of generated tokens
        # windowed mode
        self._emitted_tokens = 0
        self._mel_tail = torch.zeros((1, 0, 80), device=engine.device)
        self._phase_carry = torch.zeros((1, 9), dtype=torch.float64, device=engine.device)

    def feed(self, new_tokens, final: bool = False) -> np.ndarray:
        """Feed newly generated speech tokens; returns the new audio samples."""
        return self.feed_fetch(self.feed_dispatch(new_tokens, final=final))

    def feed_dispatch(self, new_tokens, final: bool = False):
        """The first half of feed(): queue the vocode on the device and
        return a handle for feed_fetch (None when there is nothing to
        vocode yet). Windowed mode computes here and its handle is the
        finished audio."""
        new_tokens = np.asarray(new_tokens, np.int32).reshape(1, -1)
        self._tokens = np.concatenate([self._tokens, new_tokens], axis=1)
        self._row_dev = None      # the device row is stale (rebuilt when needed)
        if not final and self._tokens.shape[1] <= self.lookahead:
            return None
        if self.window is None:
            return self._feed_exact_dispatch(final)
        return self._feed_windowed(final)

    def feed_fetch(self, handle) -> np.ndarray:
        """The second half of feed(): wait for the audio and bring it to the
        host, trim-faded at the stream's start."""
        if handle is None:
            return np.zeros((0,), np.float32)
        if isinstance(handle, np.ndarray):    # windowed mode: already on the host
            return handle
        dev, s0 = handle
        return self._faded(dev.float().cpu().numpy(), s0)

    def _faded(self, new: np.ndarray, s0: int) -> np.ndarray:
        if s0 < len(self._fade) and len(new):
            f = self._fade[s0: s0 + len(new)]
            new = new.copy()
            new[: len(f)] *= f
        return new

    @torch.no_grad()
    def feed_from_decode(self, gen_tokens, n_raw, *, vocab: int,
                         final: bool = False, append_sil: int = 0,
                         extra_fetch=()):
        """Feed a decode chunk's device output: gen_tokens (L,) and its count
        n_raw; the first n_raw ids below `vocab` count. append_sil silence
        tokens follow (a final feed's tail); extra_fetch: device scalars the
        caller needs (the chunk's count, `done`), read back in the same
        transfer as the chunk. Returns (new audio (T,) numpy, the count of
        tokens fed, the extras as host ints). Exact mode only; mixes freely
        with feed(): the device row is rebuilt from the host tokens when
        stale."""
        if self.window is not None:
            raise ValueError("feed_from_decode is exact-mode only (window_tokens=None)")
        eng = self.engine
        if self._cache_dev is None:
            self._cache_dev = eng.new_stream_cache()
        if self._row_dev is None:
            self._row_dev = eng.new_stream_row(self.ref)
            P = eng.device_ref(self.ref)[3]
            n = self._tokens.shape[1]
            if n:
                self._row_dev[0, P:P + n] = torch.from_numpy(self._tokens[0]).to(eng.device)
            self._n_acc = n
        wav_tail, self._row_dev, self._cache_dev, n_new, n_acc2, chunk_row, extras = \
            eng.fused_stream_append(
                self._row_dev, self._n_acc, gen_tokens, n_raw, self.ref, self._noise,
                self._phase, self._cache_dev, self._src_cache_len, self._emitted_samples, generator=self.generator, lookahead=self.lookahead,
                vocab=vocab, final=final, append_sil=append_sil, extra_fetch=extra_fetch)
        toks = np.concatenate([chunk_row[0], np.full(append_sil, SIL_TOKEN, np.int32)])
        self._tokens = np.concatenate([self._tokens, toks[None]], axis=1)
        self._n_acc = n_acc2
        vl = n_acc2 if final else max(0, n_acc2 - self.lookahead)
        s0, gen_samples = self._emitted_samples, vl * TOKEN_MEL_RATIO * TOTAL_UPSAMPLE
        new = self._faded(wav_tail[0].float().cpu().numpy(), s0)
        self._src_cache_len = self._emitted_samples = gen_samples
        return new, n_new, extras

    def _feed_exact_dispatch(self, final: bool):
        """One feed over every token so far, every intermediate on the
        device: returns (the new samples on the device, their offset)."""
        if self._cache_dev is None:
            self._cache_dev = self.engine.new_stream_cache()
        n_tok = self._tokens.shape[1]
        gen_frames = (n_tok if final else n_tok - self.lookahead) * TOKEN_MEL_RATIO
        wav, self._cache_dev, _ = self.engine.fused_stream_step(
            self._tokens, self.ref, self._noise, self._phase, self._cache_dev,
            self._src_cache_len, gen_frames, generator=self.generator)
        s0 = self._emitted_samples
        self._src_cache_len = self._emitted_samples = gen_frames * TOTAL_UPSAMPLE
        return wav[0, s0: gen_frames * TOTAL_UPSAMPLE], s0

    def _feed_windowed(self, final: bool) -> np.ndarray:
        """May run several window passes when one feed brings more tokens
        than a window can vocode (the window's start may not pass a token
        not yet emitted)."""
        chunks = []
        n_tok = self._tokens.shape[1]
        upto_total = n_tok if final else n_tok - self.lookahead
        while upto_total > self._emitted_tokens:
            t0 = max(0, min(self._emitted_tokens, n_tok - self.window))
            win_end = min(n_tok, t0 + self.window)
            # the window's lookahead tail is unreliable unless the window
            # reaches the stream's tip
            pass_upto = (min(upto_total, win_end) if win_end == n_tok
                         else min(upto_total, win_end - self.lookahead))
            assert pass_upto > self._emitted_tokens, \
                "window_tokens must exceed lookahead + 1"
            chunks.append(self._vocode_window(t0, win_end, pass_upto))
        return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)

    @torch.no_grad()
    def _vocode_window(self, t0: int, win_end: int, upto: int) -> np.ndarray:
        """Flow over tokens [t0, win_end), vocode the frames of tokens
        [emitted, upto), keep the mel tail and the harmonic phase carry."""
        eng, dev = self.engine, self.engine.device
        P = eng.device_ref(self.ref)[3]
        # noise for [prompt | window]: the buffer's prompt frames, then its
        # frames at the window's absolute offset, read cyclically (narration
        # past ~164 s reuses noise; a token's frames see the same numbers in
        # every window that holds them)
        M = self._noise.shape[1]
        idx = (2 * (P + t0) + torch.arange(2 * (win_end - t0), device=dev)) % M
        z = torch.cat([self._noise[:, :2 * P], self._noise[:, idx]], dim=1)
        gen_mels = eng.flow_mels(self._tokens[0, t0:win_end], self.ref, noise=z)
        lo = (self._emitted_tokens - t0) * TOKEN_MEL_RATIO
        hi = (upto - t0) * TOKEN_MEL_RATIO
        C = self._mel_tail.shape[1]
        mel_in = torch.cat([self._mel_tail, gen_mels[:, lo:hi]], dim=1)
        T = mel_in.shape[1]
        with nn.no_tf32_convs():
            wav, _, f0 = hift_inference(
                eng.params["mel2wav"], mel_in, eng.source_noise(self._phase, T, self.generator),
                phase_carry=self._phase_carry % 1.0)
        new = wav[0, C * TOTAL_UPSAMPLE:].float().cpu().numpy()
        if self._emitted_tokens == 0:
            new = self._faded(new, 0)
        # the carry adds the sum of f/sr over the frames leaving the window
        keep = min(self.ctx_mel, T)
        if T > keep:
            harmonics = torch.arange(1, 10, dtype=torch.float64, device=dev)
            f_sum = f0[0, :T - keep].double().sum() * TOTAL_UPSAMPLE
            self._phase_carry = (self._phase_carry + f_sum * harmonics[None] / 24000.0) % 1.0
        self._mel_tail = mel_in[:, T - keep:]
        self._emitted_tokens = upto
        return new


def synthesize_long_form(tts, text: str, max_chars: int = 300,
                         **generate_kwargs) -> Iterator[np.ndarray]:
    """Chunked long-form narration: yields one wav array per text chunk.
    Works with either pipeline (the conditionals are shared)."""
    for chunk in chunk_text(text, max_chars=max_chars):
        yield np.asarray(tts.generate(chunk, **generate_kwargs))[0]
