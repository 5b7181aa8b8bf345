"""S3Gen: decoded speech tokens + reference voice -> waveform (the
counterpart of the fused decode->vocode handoff of
chatterbox_tpu/models/s3gen/model.py: `_pack_body`, the `_fused` body and
`inference_from_decode`).

token filter and pack -> upsample-conformer flow encoder -> UNet flow
(2-step meanflow for Turbo, 10-step cosine CFM with CFG for the 520M
family) -> HiFT with iSTFT -> trim-fade. One utterance runs at its exact
length, so there are no buckets; the one host read is the count of valid
tokens (with the largest of them, checked against the flow's vocabulary).
The output stays float32. Convolutions run with cuDNN's TF32 off, so the
float32 S3Gen is float32 on the card too.

The engine also embeds a reference voice (`embed_ref`: resample, 24 kHz
prompt mels, the CAMPPlus x-vector and the S3 tokens of the prompt) and
tokenizes 16 kHz audio (`tokenize`). These run at the exact length: the
JAX package pads CAMPPlus's input to 0.5 s buckets with a mask that makes
the result the unpadded one.

Host-token calls (`inference` for voice conversion, `flow_to_mel`,
`mel_to_wav`, `mel_to_wav_stream`) and the streaming feeds
(`fused_stream_step`, `fused_stream_append`; serve/streaming.py drives
them) run at exact lengths too. A streaming feed runs the flow over
[prompt | every token so far] with the caller's fixed noise buffer,
vocodes the generated region up to the stream's tip with the held-back
lookahead frames set to MEL_FLOOR, and takes the start of the harmonic
source from the previous feed's (the source cache), so emitted audio never
changes. The JAX package vocodes a feed at a mel bucket instead, with every
frame past the vocoded length at MEL_FLOOR; where that bucket is the tip
(exact buckets, all tokens valid) the two agree. A voice's tensors are
uploaded once per RefDict object (`device_ref`).

The batched vocode (`inference_batch`, `_dispatch`, `_fetch`; serving)
runs B requests, possibly in different voices, through ONE masked flow
call (models/s3gen/flow.py `flow_inference_batch`), then HiFT over each
row's generated region at its exact length and the trim-fade. The JAX
package pads every row's mels with MEL_FLOOR to a shared bucket before one
batched HiFT call; HiFT's receptive field then carries the padding into a
row's last frames, so a row's audio would depend on its batchmates. Each
row's random numbers come from its own generator or S3GenNoise, so a row's
audio is the same alone, in any batch, and from `inference`. There is no
padding of the batch axis (XLA's compile reuse) and no compile grid
(`warmup_grid`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...audio.mels import mel_spectrogram_24k
from ...audio.resample import resample
from ...nn import core as nn
from ...utils import profiling
from ...utils.quantize import cast_params
from ..s3tok.model import S3_SR, S3TokenizerConfig, s3tokenizer_init, s3tokenizer_tokenize
from .campplus import campplus_embed_wav, campplus_init
from .flow import (FlowDims, TOKEN_MEL_RATIO, flow_inference, flow_inference_batch,
                   flow_init)
from .hift import TOTAL_UPSAMPLE, SourceNoise, hift_inference, hift_init

S3GEN_SR = 24_000
SIL_TOKEN = 4299                     # silence speech token
SPEECH_VOCAB_SIZE = 6561
SOS, EOS = 6561, 6562                # T3's start / stop speech tokens
MEL_FLOOR = float(np.log(1e-5))      # the mel log-clamp floor: a silent frame


def s3gen_init(seed: int = 0, device="cuda", meanflow: bool = True,
               dims: FlowDims = FlowDims(), hift_base: int = 512,
               tok_cfg: S3TokenizerConfig = S3TokenizerConfig()) -> dict:
    """Random float32 parameters: `flow` and `mel2wav`, then the frontend's
    `tokenizer` (S3 tokenizer) and `speaker_encoder` (CAMPPlus)."""
    init = nn.Init(seed, device)
    return {"flow": flow_init(init, meanflow=meanflow, dims=dims),
            "mel2wav": hift_init(init, base_channels=hift_base),
            "tokenizer": s3tokenizer_init(init, tok_cfg),
            "speaker_encoder": campplus_init(init)}


class RefDict(NamedTuple):
    """The reference-voice conditioning bundle (numpy arrays)."""
    prompt_token: np.ndarray      # (1, P) int
    prompt_token_len: np.ndarray  # (1,)
    prompt_feat: np.ndarray       # (1, T_feat, 80)
    embedding: np.ndarray         # (1, 192)


class S3GenNoise(NamedTuple):
    """Every random number of one vocode call."""
    z: torch.Tensor               # (1, T_mel, 80) flow starting noise
    source: SourceNoise           # HiFT harmonic phases and noise


def trim_fade(sr: int = S3GEN_SR) -> np.ndarray:
    """20 ms of silence then a 20 ms raised-cosine fade-in."""
    n = sr // 50
    fade = np.zeros(2 * n, np.float32)
    fade[n:] = (np.cos(np.linspace(np.pi, 0, n)) + 1) / 2
    return fade


def pack_tokens(gen_tokens: torch.Tensor, n_raw, prompt_token: torch.Tensor,
                append_sil: int = 0, cfg_slice: bool = False, sos: int = SOS,
                eos: int = EOS, vocab: int = SPEECH_VOCAB_SIZE) -> torch.Tensor:
    """[prompt | valid generated tokens | append_sil silence tokens] as one
    (1, P + G) row. Generated tokens count when they are among the first
    n_raw and below `vocab` (the Turbo filter). cfg_slice (the 520M tail)
    first keeps only the tokens strictly between the first `sos` and the
    first `eos` among the first n_raw, and vocodes one silence token when
    nothing is left.

    A kept id at or above the flow's SPEECH_VOCAB_SIZE embedding rows (only
    possible with vocab > SPEECH_VOCAB_SIZE) raises ValueError; the JAX
    package's gather returns NaN embeddings there instead."""
    gen = gen_tokens.reshape(-1).long()
    idx = torch.arange(gen.shape[0], device=gen.device)
    keep = idx < n_raw
    if cfg_slice:
        is_sos, is_eos = (gen == sos) & keep, (gen == eos) & keep
        start = torch.where(is_sos.any(), is_sos.int().argmax() + 1, 0)
        end = torch.where(is_eos.any(), is_eos.int().argmax(),
                          torch.as_tensor(n_raw, device=gen.device))
        keep = (idx >= start) & (idx < end)
    keep = keep & (gen < vocab)
    # the one host read: the count of kept ids and the largest of them
    n, top = torch.stack([keep.sum(), torch.where(keep, gen, -1).max()]).tolist()
    if top >= SPEECH_VOCAB_SIZE:
        raise ValueError(f"speech token id {top} is kept (vocab={vocab}) but the "
                         f"flow embeds only {SPEECH_VOCAB_SIZE} ids")
    # kept ids first, in order (a stable sort), without another host read
    gen = gen[torch.sort((~keep).to(torch.int8), stable=True).indices[:n]]
    if cfg_slice and append_sil == 0 and n == 0:
        append_sil = 1
    sil = torch.full((append_sil,), SIL_TOKEN, dtype=torch.long, device=gen.device)
    return torch.cat([prompt_token.reshape(-1).long(), gen, sil])[None]


def pack_prompt_gen(token_rows: list, refs: list):
    """Pack B requests' [prompt | gen] token rows, zero-padded to the batch's
    longest P + G. token_rows: (G_b,) host ids below the flow's vocabulary;
    refs: RefDicts. Returns (tokens (B, max P + G) int64 numpy, Ps, Gs)."""
    Ps = [int(np.asarray(r.prompt_token_len).reshape(-1)[0]) for r in refs]
    rows = [np.asarray(t).reshape(-1) for t in token_rows]
    Gs = [len(t) for t in rows]
    tokens = np.zeros((len(rows), max(p + g for p, g in zip(Ps, Gs))), np.int64)
    for i, (r, t) in enumerate(zip(refs, rows)):
        if len(t) and (t.min() < 0 or t.max() >= SPEECH_VOCAB_SIZE):
            raise ValueError(f"row {i}: speech token ids must lie in [0, {SPEECH_VOCAB_SIZE})")
        tokens[i, :Ps[i]] = np.asarray(r.prompt_token).reshape(-1)[:Ps[i]]
        tokens[i, Ps[i]:Ps[i] + Gs[i]] = t
    return tokens, Ps, Gs


class S3GenEngine:
    """Owns the parameters of an S3Gen: meanflow (Turbo, 2 steps by default)
    or CFM with CFG (520M, 10 steps), and the frontend (`tokenizer`,
    `speaker_encoder`) that embed_ref and tokenize need.

    batched_bf16_min_b: the batched vocode runs the flow (encoder and
    estimator) in bfloat16 when a batch has at least this many rows, as
    the JAX package does (None: float32 at every batch size). HiFT and
    every single-request and streaming call stay float32."""

    STREAM_CACHE_FRAMES = 3072    # the streaming source cache's capacity, mel frames
    STREAM_ROW_CAP = 1536         # the streaming token row's capacity, tokens
    _REF_CACHE_CAP = 16

    def __init__(self, params: dict, dims: FlowDims = FlowDims(), meanflow: bool = True,
                 tok_cfg: S3TokenizerConfig = S3TokenizerConfig(),
                 batched_bf16_min_b: Optional[int] = 16):
        self.params = params
        self.batched_bf16_min_b = batched_bf16_min_b
        self._params_flow_bf16 = None      # the bf16 flow copy, made on first use
        self.dims = dims
        self.meanflow = meanflow
        self.tok_cfg = tok_cfg
        self.n_timesteps = 2 if meanflow else 10
        self.device = params["flow"]["input_embedding"]["w"].device
        self._fade = torch.from_numpy(trim_fade()).to(self.device)
        self._ref_cache: dict = {}

    def draw_noise(self, n_mel: int, n_gen_mel: int, generator) -> S3GenNoise:
        """Random numbers for n_mel flow frames ([prompt | gen]) of which the
        last n_gen_mel are vocoded."""
        z = torch.randn((1, n_mel, 80), generator=generator, device=self.device)
        return S3GenNoise(z, SourceNoise.draw(1, n_gen_mel, generator, self.device))

    def source_noise(self, phase: torch.Tensor, n_frames: int, generator) -> SourceNoise:
        """HiFT's random numbers for n_frames with the given harmonic phases
        (a stream keeps one set of phases; its source noise is drawn anew
        at every feed, through draw_noise)."""
        return SourceNoise(phase, self.draw_noise(0, n_frames, generator).source.noise_u)

    def device_ref(self, ref: RefDict):
        """Device copies of a RefDict's arrays, uploaded once per object:
        (prompt tokens (1, P) long, prompt_feat (1, T, 80), embedding
        (1, 192), P). The cache holds the RefDict itself, so an id() is
        not reused while its entry lives (first in, first out, 16)."""
        entry = self._ref_cache.get(id(ref))
        if entry is None or entry[0] is not ref:
            P = int(np.asarray(ref.prompt_token_len).reshape(-1)[0])
            dev = (profiling.to_device(np.asarray(ref.prompt_token)[:, :P], self.device,
                                       torch.long),
                   profiling.to_device(np.asarray(ref.prompt_feat, np.float32), self.device),
                   profiling.to_device(np.asarray(ref.embedding, np.float32), self.device),
                   P)
            if len(self._ref_cache) >= self._REF_CACHE_CAP:
                self._ref_cache.pop(next(iter(self._ref_cache)))
            self._ref_cache[id(ref)] = entry = (ref, dev)
        return entry[1]

    def _flow(self, token: torch.Tensor, P: int, ref: RefDict, z: torch.Tensor,
              n_timesteps: Optional[int] = None) -> torch.Tensor:
        """[prompt | gen] tokens (1, P + G) -> mels (1, 2(P + G), 80), z the
        starting noise over at least that many frames."""
        _, feat, emb, _ = self.device_ref(ref)
        return flow_inference(self.params["flow"], token, P, feat, emb,
                              z[:, :token.shape[1] * TOKEN_MEL_RATIO],
                              n_timesteps=n_timesteps or self.n_timesteps, dims=self.dims,
                              meanflow=self.meanflow)

    def _vocode(self, token: torch.Tensor, P: int, ref: RefDict,
                noise: Optional[S3GenNoise], generator,
                n_timesteps: Optional[int]) -> torch.Tensor:
        """[prompt | gen] tokens (1, P + G) -> flow -> generated region ->
        HiFT -> trim-fade: (1, G*960) f32, on `noise` or draws from
        `generator`."""
        if noise is None:
            noise = self.draw_noise(token.shape[1] * TOKEN_MEL_RATIO,
                                    (token.shape[1] - P) * TOKEN_MEL_RATIO, generator)
        with nn.no_tf32_convs():
            with profiling.span("s3gen.flow", device=self.device, tokens=token.shape[1] - P):
                mels = self._flow(token, P, ref, noise.z, n_timesteps)
            with profiling.span("s3gen.hift", device=self.device):
                wav, _, _ = hift_inference(self.params["mel2wav"],
                                           mels[:, P * TOKEN_MEL_RATIO:], noise.source)
                return self._trim_fade(wav)

    def _trim_fade(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> the same with the trim-fade over its first samples."""
        n_fade = min(self._fade.shape[0], wav.shape[1])
        return torch.cat([wav[:, :n_fade] * self._fade[:n_fade], wav[:, n_fade:]], dim=1)

    def _host_tokens(self, speech_tokens) -> torch.Tensor:
        return profiling.to_device(np.asarray(speech_tokens).reshape(-1), self.device,
                                   torch.long)

    @torch.no_grad()
    def inference_from_decode(self, gen_tokens: torch.Tensor, n_tokens,
                              ref: RefDict, *, generator=None,
                              noise: Optional[S3GenNoise] = None,
                              n_timesteps: Optional[int] = None,
                              append_sil: int = 0, cfg_slice: bool = False,
                              sos: int = SOS, eos: int = EOS,
                              vocab: int = SPEECH_VOCAB_SIZE):
        """Vocode a T3 decode result. gen_tokens (L,) on the device, n_tokens
        the generated count (tensor or int); append_sil, cfg_slice, sos, eos
        and vocab pick the token tail (pack_tokens, which raises ValueError
        for a kept id the flow cannot embed). Returns (wav (1, T) float32
        numpy, n_gen vocoded tokens)."""
        prompt, _, _, P = self.device_ref(ref)
        token = pack_tokens(gen_tokens.to(self.device), n_tokens, prompt, append_sil,
                            cfg_slice, sos, eos, vocab)
        n_gen = token.shape[1] - P
        if n_gen == 0:
            return np.zeros((1, 0), np.float32), 0
        wav = self._vocode(token, P, ref, noise, generator, n_timesteps)
        return wav.float().cpu().numpy(), n_gen

    @torch.no_grad()
    def inference(self, speech_tokens, ref: RefDict, generator=None,
                  n_timesteps: Optional[int] = None,
                  noise: Optional[S3GenNoise] = None) -> np.ndarray:
        """Host speech tokens (G,) of the flow's vocabulary -> (1, G*960)
        float32 numpy: flow, HiFT and the trim-fade (voice conversion)."""
        prompt, _, _, P = self.device_ref(ref)
        gen = self._host_tokens(speech_tokens)
        if gen.numel() == 0:
            return np.zeros((1, 0), np.float32)
        token = torch.cat([prompt[0], gen])[None]
        return profiling.to_host(self._vocode(token, P, ref, noise, generator,
                                              n_timesteps).float()).numpy()

    @torch.no_grad()
    def flow_to_mel(self, speech_tokens, ref: RefDict, generator=None,
                    n_timesteps: Optional[int] = None, noise=None):
        """Host speech tokens (G,) -> (gen mels (1, 2G, 80) float32 numpy,
        2G). noise: the flow's starting noise aligned to the packed
        [prompt | gen] mel buffer, at least 2(P + G) frames (a stream
        slices one fixed buffer, so every feed denoises the emitted region
        from the same numbers); else drawn from `generator`."""
        mels = self.flow_mels(speech_tokens, ref, generator, n_timesteps, noise)
        return mels.cpu().numpy(), mels.shape[1]

    @torch.no_grad()
    def flow_mels(self, speech_tokens, ref: RefDict, generator=None,
                  n_timesteps: Optional[int] = None, noise=None) -> torch.Tensor:
        """flow_to_mel's generated mels, left on the device."""
        prompt, _, _, P = self.device_ref(ref)
        token = torch.cat([prompt[0], self._host_tokens(speech_tokens)])[None]
        n_mel = token.shape[1] * TOKEN_MEL_RATIO
        z = self.draw_noise(n_mel, 0, generator).z if noise is None else self._f32(noise)
        if z.shape[1] < n_mel:
            raise ValueError(f"aligned noise of {z.shape[1]} frames is shorter than the "
                             f"{n_mel} frames of [prompt | gen]")
        with nn.no_tf32_convs():
            return self._flow(token, P, ref, z, n_timesteps)[:, P * TOKEN_MEL_RATIO:]

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def mel_to_wav(self, gen_mels, generator=None,
                   noise: Optional[SourceNoise] = None) -> np.ndarray:
        """Mels (1, T, 80) -> (1, T*480) float32 numpy (HiFT alone)."""
        mel = self._f32(gen_mels)
        with nn.no_tf32_convs():
            wav, _, _ = hift_inference(self.params["mel2wav"], mel, noise, generator)
        return wav.float().cpu().numpy()

    @torch.no_grad()
    def mel_to_wav_stream(self, gen_mels, generator=None, cache_source=None,
                          cache_len: int = 0, phase_carry=None,
                          noise: Optional[SourceNoise] = None):
        """A streaming vocoder step. cache_source: the previous step's source,
        whose first cache_len samples replace this step's (glitch-free
        joins); phase_carry (1, 9): the sum of f/sr before this window
        (windowed streaming). Returns float32 numpy (wav (1, T*480),
        source (1, T*480, 1), f0 (1, T))."""
        mel = self._f32(gen_mels)
        if cache_source is not None:
            cache_source = self._f32(cache_source)
        with nn.no_tf32_convs():
            wav, s, f0 = hift_inference(self.params["mel2wav"], mel, noise, generator,
                                        cache_source=cache_source, cache_len=cache_len,
                                        phase_carry=phase_carry)
        return wav.cpu().numpy(), s.cpu().numpy(), f0.cpu().numpy()

    # ------------------------------------------------------------------
    # batched vocode (serving: one masked flow call for B requests)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def inference_batch(self, token_rows: list, refs: list, generators=None, *,
                        noises: Optional[list] = None,
                        n_timesteps: Optional[int] = None) -> list:
        """B requests, possibly in different voices, vocoded together.
        token_rows: (G_b,) host ids; refs: RefDicts. Returns B (G_b*960,)
        float32 waveforms, each equal (up to rounding) to `inference` of
        that row on the same random numbers."""
        return self.inference_batch_fetch(self.inference_batch_dispatch(
            token_rows, refs, generators, noises=noises, n_timesteps=n_timesteps))

    def _bf16_flow_params(self) -> dict:
        """The parameters with the flow's encoder and estimator in bfloat16
        (made once; the other subtrees shared)."""
        if self._params_flow_bf16 is None:
            flow = dict(self.params["flow"])
            for k in ("encoder", "decoder"):
                flow[k] = cast_params(flow[k], torch.bfloat16)
            self._params_flow_bf16 = dict(self.params, flow=flow)
        return self._params_flow_bf16

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without waiting for the
        device's queue: through pinned memory on the card."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    @torch.no_grad()
    def inference_batch_dispatch(self, token_rows: list, refs: list, generators=None, *,
                                 noises: Optional[list] = None,
                                 n_timesteps: Optional[int] = None):
        """The first half of inference_batch: queues the work on the device
        and returns a handle for inference_batch_fetch, reading nothing
        back. generators: one torch.Generator a row (each row's audio then
        depends on its own generator alone), or None (torch's default);
        noises: one S3GenNoise a row instead (`draw_noise`'s shapes for that
        row's 2(P + G) and 2G frames)."""
        B = len(token_rows)
        if B < 1 or len(refs) != B:
            raise ValueError(f"{B} token rows for {len(refs)} voices")
        if noises is not None and len(noises) != B:
            raise ValueError(f"{len(noises)} noises for {B} rows")
        gens = [None] * B if generators is None else list(generators)
        if len(gens) != B:
            raise ValueError(f"{len(gens)} generators for {B} rows")
        tokens, Ps, Gs = pack_prompt_gen(token_rows, refs)
        T = tokens.shape[1]
        feat_T = max(np.asarray(r.prompt_feat).shape[1] for r in refs)
        feats = np.zeros((B, feat_T, 80), np.float32)
        for i, r in enumerate(refs):
            f = np.asarray(r.prompt_feat, np.float32)
            feats[i, :f.shape[1]] = f[0]
        embs = np.concatenate([np.asarray(r.embedding, np.float32).reshape(1, -1)
                               for r in refs])
        dev = self.device
        rows = []
        for i in range(B):
            n_mel = (Ps[i] + Gs[i]) * TOKEN_MEL_RATIO
            if noises is not None:
                rows.append(noises[i])
            elif Gs[i]:
                rows.append(self.draw_noise(n_mel, Gs[i] * TOKEN_MEL_RATIO, gens[i]))
            else:
                rows.append(None)        # nothing to vocode: no draws, as `inference`
        z = torch.zeros((B, T * TOKEN_MEL_RATIO, 80), device=dev)
        for i, nz in enumerate(rows):
            if nz is not None:
                n_mel = (Ps[i] + Gs[i]) * TOKEN_MEL_RATIO
                z[i, :n_mel] = nz.z[0, :n_mel].to(dev, torch.float32)
        use_bf16 = self.batched_bf16_min_b is not None and B >= self.batched_bf16_min_b
        params = self._bf16_flow_params() if use_bf16 else self.params
        lens = self._upload(np.array([[p + g for p, g in zip(Ps, Gs)], Ps], np.int64))
        with nn.no_tf32_convs():
            with profiling.span("s3gen.flow", device=dev, tokens=sum(Gs)):
                mels = flow_inference_batch(
                    params["flow"], self._upload(tokens), lens[0], lens[1],
                    self._upload(feats), self._upload(embs), z,
                    n_timesteps=n_timesteps or self.n_timesteps, dims=self.dims,
                    meanflow=self.meanflow)
            wavs = []
            for i in range(B):
                if not Gs[i]:
                    continue
                p0 = Ps[i] * TOKEN_MEL_RATIO
                with profiling.span("s3gen.hift", device=dev):
                    wav, _, _ = hift_inference(self.params["mel2wav"],
                                               mels[i:i + 1, p0:p0 + Gs[i] * TOKEN_MEL_RATIO],
                                               rows[i].source)
                    wavs.append(self._trim_fade(wav)[0])
        flat = torch.cat(wavs) if wavs else torch.zeros((0,), device=dev)
        return flat, [g * TOKEN_MEL_RATIO * TOTAL_UPSAMPLE for g in Gs]

    def inference_batch_fetch(self, handle) -> list:
        """The second half of inference_batch: the one host read of the
        batch's audio, split into its rows' (G_b*960,) float32 waveforms."""
        flat, lengths = handle
        host = flat.float().cpu().numpy()
        return np.split(host, np.cumsum(lengths)[:-1])

    # ------------------------------------------------------------------
    # streaming feeds (serve/streaming.py StreamingVocoder)
    # ------------------------------------------------------------------
    def new_stream_cache(self) -> torch.Tensor:
        """The source cache of a stream, (1, STREAM_CACHE_FRAMES*480, 1) on
        the device; every feed updates it in place."""
        return torch.zeros((1, self.STREAM_CACHE_FRAMES * TOTAL_UPSAMPLE, 1),
                           device=self.device)

    def _stream_body(self, token, P, ref, z, source, cache_source, cache_len,
                     vocode_len):
        """One feed: flow over [prompt | gen] with the aligned noise z ->
        the generated region with the frames from vocode_len on set to
        MEL_FLOOR (the held-back lookahead) -> HiFT whose first cache_len
        source samples come from the cache; the new source written back to
        the cache. Returns (wav (1, 2G*480), cache, f0 (1, 2G))."""
        n_samp = (token.shape[1] - P) * TOKEN_MEL_RATIO * TOTAL_UPSAMPLE
        if token.shape[1] > self.STREAM_ROW_CAP or n_samp > cache_source.shape[1]:
            raise ValueError(f"stream of {token.shape[1]} tokens exceeds the streaming "
                             f"capacity ({self.STREAM_ROW_CAP} tokens)")
        with nn.no_tf32_convs():
            gen = self._flow(token, P, ref, z)[:, P * TOKEN_MEL_RATIO:].clone()
            gen[:, vocode_len:] = MEL_FLOOR
            wav, src, f0 = hift_inference(self.params["mel2wav"], gen, source,
                                          cache_source=cache_source, cache_len=cache_len)
        cache_source[:, :src.shape[1]] = src
        return wav, cache_source, f0

    @torch.no_grad()
    def fused_stream_step(self, tokens_all, ref: RefDict, noise_dev: torch.Tensor,
                          phase: torch.Tensor, cache_source_dev: torch.Tensor,
                          cache_len: int, vocode_frames: int, generator=None):
        """One streaming feed from host tokens, every intermediate on the
        device. tokens_all: (1, n) every generated token so far; noise_dev:
        the stream's flow noise aligned to [prompt | gen]; phase: its HiFT
        phases (the source noise is drawn here); cache_source_dev: from
        new_stream_cache (updated in place); vocode_frames: the mel frames
        to vocode after the lookahead trim. Returns device tensors (wav
        (1, 2n*480), the cache, f0 (1, 2n))."""
        prompt, _, _, P = self.device_ref(ref)
        gen = self._host_tokens(tokens_all)
        token = torch.cat([prompt[0], gen])[None]
        source = self.source_noise(phase, gen.numel() * TOKEN_MEL_RATIO, generator)
        return self._stream_body(token, P, ref, noise_dev, source, cache_source_dev,
                                 cache_len, vocode_frames)

    def new_stream_row(self, ref: RefDict) -> torch.Tensor:
        """The stream's packed [prompt | gen] token row on the device,
        (1, STREAM_ROW_CAP + 1) long (the last slot takes the rejected
        tokens), with the prompt written."""
        prompt, _, _, P = self.device_ref(ref)
        row = torch.zeros((1, self.STREAM_ROW_CAP + 1), dtype=torch.long, device=self.device)
        row[:, :P] = prompt
        return row

    @torch.no_grad()
    def fused_stream_append(self, row_dev: torch.Tensor, n_acc: int, gen_tokens, n_raw,
                            ref: RefDict, noise_dev: torch.Tensor, phase: torch.Tensor,
                            cache_source_dev: torch.Tensor, cache_len: int,
                            emitted_samples: int, *, generator=None, lookahead: int,
                            vocab: int = SPEECH_VOCAB_SIZE, final: bool = False,
                            append_sil: int = 0, extra_fetch=()):
        """One streaming feed straight from a decode chunk's device output.

        gen_tokens (L,) and n_raw (the chunk's count) stay on the device:
        the first n_raw ids below `vocab` are appended to row_dev (updated
        in place) after its n_acc tokens, then append_sil silence tokens.
        One host read brings back the count of appended ids, those ids and
        the `extra_fetch` device scalars; then the flow runs over [prompt |
        every token], HiFT vocodes up to the tip with the last `lookahead`
        tokens' frames held back unless `final`, and only the samples from
        emitted_samples on are returned. Returns (wav_tail (1, n) on the
        device, row, cache, n_new, n_acc', chunk_row (1, n_new) int32 numpy,
        the extras as host ints)."""
        prompt, _, _, P = self.device_ref(ref)
        gen = torch.as_tensor(gen_tokens, device=self.device).reshape(-1).long()
        if P + n_acc + gen.shape[0] + append_sil > self.STREAM_ROW_CAP:
            raise ValueError(f"stream exceeds the row capacity ({P + n_acc + gen.shape[0]} "
                             f"+ {append_sil} > {self.STREAM_ROW_CAP})")
        idx = torch.arange(gen.shape[0], device=self.device)
        valid = (idx < torch.as_tensor(n_raw, device=self.device)) & (gen < vocab)
        cap = row_dev.shape[1] - 1
        tgt = torch.where(valid, P + n_acc + torch.cumsum(valid, 0) - 1, cap)
        row_dev[0].scatter_(0, tgt, gen)
        # the one host read of the feed: the count, the kept ids, the extras
        extras = [torch.as_tensor(e, device=self.device).reshape(1).long()
                  for e in extra_fetch]
        got = torch.cat([valid.sum().reshape(1)] + extras
                        + [torch.where(valid, gen, -1)]).cpu().numpy()
        n_new, k = int(got[0]), len(extras)
        chunk_row = got[1 + k:][got[1 + k:] >= 0].astype(np.int32)[None]
        n_acc2 = n_acc + n_new + append_sil
        row_dev[0, P + n_acc + n_new:P + n_acc2] = SIL_TOKEN
        vl = n_acc2 if final else max(n_acc2 - lookahead, 0)
        wav_tail = torch.zeros((1, 0), device=self.device)
        if vl > 0:
            source = self.source_noise(phase, n_acc2 * TOKEN_MEL_RATIO, generator)
            wav, cache_source_dev, _ = self._stream_body(
                row_dev[:, :P + n_acc2], P, ref, noise_dev, source, cache_source_dev,
                cache_len, vl * TOKEN_MEL_RATIO)
            wav_tail = wav[:, emitted_samples:vl * TOKEN_MEL_RATIO * TOTAL_UPSAMPLE]
        return (wav_tail, row_dev, cache_source_dev, n_new, n_acc2, chunk_row,
                tuple(int(v) for v in got[1:1 + k]))

    @torch.no_grad()
    def embed_ref(self, ref_wav: np.ndarray, ref_sr: int) -> RefDict:
        """A reference voice -> RefDict: its S3 tokens, 24 kHz prompt mels
        (two frames a token) and CAMPPlus x-vector."""
        ref_wav = np.asarray(ref_wav, np.float32).reshape(-1)
        if len(ref_wav) > 10 * ref_sr:
            print("WARNING: s3gen received ref longer than 10s")
        with profiling.span("s3gen.embed_ref", device=self.device, samples=len(ref_wav)):
            return self._embed_ref(ref_wav, ref_sr)

    def _embed_ref(self, ref_wav: np.ndarray, ref_sr: int) -> RefDict:
        wav = profiling.to_device(ref_wav, self.device)
        with nn.no_tf32_convs():
            wav24 = resample(wav, ref_sr, S3GEN_SR)
            wav16 = resample(wav, ref_sr, S3_SR)
            embedding = campplus_embed_wav(self.params["speaker_encoder"], wav16[None])
            # a whole number of 40 ms tokens; the zero tail of under 40 ms
            # stands in for the reference's mel == 2 * token repair
            n_tok = int(np.ceil(wav16.shape[0] / (S3_SR / 25)))
            wav16p = torch.nn.functional.pad(wav16, (0, int(n_tok * S3_SR / 25) - wav16.shape[0]))
            n24 = n_tok * (S3GEN_SR // 25)
            wav24p = torch.nn.functional.pad(wav24, (0, max(0, n24 - wav24.shape[0])))[:n24]
            ref_mels = mel_spectrogram_24k(wav24p[None]).transpose(1, 2)
            tokens, token_len = s3tokenizer_tokenize(
                self.params["tokenizer"], self.tok_cfg, wav16p[None],
                profiling.to_device([wav16p.shape[0]], self.device))
        tokens = profiling.to_host(tokens).numpy().astype(np.int32)
        token_len = profiling.to_host(token_len).numpy().astype(np.int32)
        ref_mels = profiling.to_host(ref_mels).numpy()
        # mel_len == 2 * token_len
        if ref_mels.shape[1] != 2 * tokens.shape[1]:
            n_keep = ref_mels.shape[1] // 2
            tokens = tokens[:, :n_keep]
            token_len = np.minimum(token_len, n_keep)
        return RefDict(prompt_token=tokens, prompt_token_len=token_len,
                       prompt_feat=ref_mels, embedding=profiling.to_host(embedding).numpy())

    @torch.no_grad()
    def tokenize(self, wav_16k: np.ndarray, max_len: Optional[int] = None):
        """16 kHz audio -> (tokens (1, n) int32, token_len (1,) int32 numpy),
        at most max_len tokens."""
        wav_16k = np.asarray(wav_16k, np.float32).reshape(-1)
        with profiling.span("s3gen.tokenize", device=self.device, samples=len(wav_16k)):
            wav = profiling.to_device(wav_16k, self.device)
            n_tok = int(np.ceil(wav.shape[0] / (S3_SR / 25)))
            wav = torch.nn.functional.pad(wav, (0, int(n_tok * S3_SR / 25) - wav.shape[0]))
            with nn.no_tf32_convs():
                tokens, token_len = s3tokenizer_tokenize(
                    self.params["tokenizer"], self.tok_cfg, wav[None],
                    profiling.to_device([wav.shape[0]], self.device), max_len)
            token_len = profiling.to_host(token_len).numpy().astype(np.int32)
            tokens = profiling.to_host(tokens).numpy().astype(np.int32)
            return tokens[:, :int(token_len[0])], token_len
