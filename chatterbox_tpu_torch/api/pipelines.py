"""Public pipelines: text -> speech tokens (T3) -> waveform (S3Gen) (the
counterparts of the pipelines in chatterbox_tpu/api/pipelines.py).

  * ChatterboxTurboTTS: GPT-2 T3, batch-1 decode, 2-step meanflow S3Gen;
    `generate(draft=)` decodes speculatively (sampling/speculative.py),
    with a draft pipeline or its own weights quantized int8 as the draft;
  * ChatterboxTTS: the original 520M model, llama T3 with perceiver,
    emotion input and learned positions, batch-2 CFG decode, 10-step CFG
    S3Gen;
  * ChatterboxMultilingualTTS: the 520M family in 23 languages (a
    2454-token grapheme vocabulary, `MTLTokenizer`), batch-2 CFG decode at
    every cfg_weight, the last token's 40 ms trimmed;
  * ChatterboxVC: voice conversion, source wav -> S3 tokens -> the 520M
    family's 10-step CFG S3Gen in a target voice.

The TTS pipelines also stream (`generate_stream`): the T3 decodes in
chunks (sampling/chunked.py) and each chunk is vocoded as it lands
(serve/streaming.py), so the first audio comes after one chunk.

`from_local(ckpt_dir)` loads the reference's checkpoint directory
(convert/weights.py); `random_init` draws random weights at given widths.
The voice is a `Conditionals` bundle: built from a reference wav by
`prepare_conditionals` (or `generate(audio_prompt_path=...)`) through the
conditioning frontend (resampler, mels, S3 tokenizer, CAMPPlus, voice
encoder), loaded from conds.pt or .npz, or built in code.
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..audio.resample import resample
from ..models.s3gen.flow import FlowDims
from ..models.s3gen.model import (S3_SR, S3GEN_SR, SIL_TOKEN, SPEECH_VOCAB_SIZE, RefDict,
                                  S3GenEngine, s3gen_init)
from ..models.s3tok.model import S3TokenizerConfig
from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..models.ve import model as ve
from ..nn import core as nn
from ..ops.sampling import SamplerParams
from ..sampling.chunked import t3_decode_chunk, t3_prefill_decode
from ..sampling.decode import t3_generate
from ..sampling.speculative import t3_generate_speculative
from ..serve.streaming import StreamingVocoder
from ..text.tokenizer import punc_norm
from ..utils import profiling
from ..utils.audio_io import load_audio
from ..utils.loudness import norm_loudness
from ..utils.quantize import (best_serving_mode, cast_params, is_quantized,
                              quantize_t3_backbone)
from ..utils.watermark import Watermarker

logger = logging.getLogger(__name__)

# the multilingual model's languages
SUPPORTED_LANGUAGES = {
    "ar": "Arabic", "da": "Danish", "de": "German", "el": "Greek",
    "en": "English", "es": "Spanish", "fi": "Finnish", "fr": "French",
    "he": "Hebrew", "hi": "Hindi", "it": "Italian", "ja": "Japanese",
    "ko": "Korean", "ms": "Malay", "nl": "Dutch", "no": "Norwegian",
    "pl": "Polish", "pt": "Portuguese", "ru": "Russian", "sv": "Swedish",
    "sw": "Swahili", "tr": "Turkish", "zh": "Chinese",
}

# `t3_model` names of ChatterboxMultilingualTTS.from_local -> checkpoint files
MULTILINGUAL_T3_MODELS = {
    "v2": "t3_mtl23ls_v2.safetensors",
    "t3_mtl23ls_v2": "t3_mtl23ls_v2.safetensors",
    "v3": "t3_mtl23ls_v3.safetensors",
    "t3_mtl23ls_v3": "t3_mtl23ls_v3.safetensors",
}


@dataclasses.dataclass
class T3CondHost:
    """Host-side T3 conditioning (the reference's T3Cond fields)."""
    speaker_emb: np.ndarray                              # (1, 256)
    cond_prompt_speech_tokens: Optional[np.ndarray] = None  # (1, plen)
    emotion_adv: float = 0.5

    def as_tensors(self, device) -> t3m.T3CondTensors:
        tok = self.cond_prompt_speech_tokens
        return t3m.T3CondTensors(
            torch.as_tensor(np.asarray(self.speaker_emb, np.float32), device=device),
            None if tok is None else torch.as_tensor(np.asarray(tok, np.int64),
                                                     device=device),
            torch.full((1, 1, 1), float(self.emotion_adv), device=device))


@dataclasses.dataclass
class Conditionals:
    """(T3 conditioning, S3Gen reference) bundle."""
    t3: T3CondHost
    gen: RefDict

    def save(self, fpath):
        """The reference's conds.pt layout when the path ends in .pt, else
        .npz."""
        tok = self.t3.cond_prompt_speech_tokens
        if str(fpath).endswith(".pt"):
            t = lambda x: torch.from_numpy(np.asarray(x))
            torch.save({
                "t3": {"speaker_emb": t(self.t3.speaker_emb).float(),
                       "clap_emb": None,
                       "cond_prompt_speech_tokens": None if tok is None else t(tok).long(),
                       "cond_prompt_speech_emb": None,
                       "emotion_adv": torch.full((1, 1, 1), float(self.t3.emotion_adv))},
                "gen": {"prompt_token": t(self.gen.prompt_token).long(),
                        "prompt_token_len": t(self.gen.prompt_token_len).long(),
                        "prompt_feat": t(self.gen.prompt_feat).float(),
                        "prompt_feat_len": None,
                        "embedding": t(self.gen.embedding).float()},
            }, fpath)
            return
        np.savez(fpath, speaker_emb=self.t3.speaker_emb,
                 cond_prompt_speech_tokens=(np.zeros((1, 0), np.int32)
                                            if tok is None else tok),
                 emotion_adv=np.float32(self.t3.emotion_adv),
                 prompt_token=self.gen.prompt_token,
                 prompt_token_len=self.gen.prompt_token_len,
                 prompt_feat=self.gen.prompt_feat, embedding=self.gen.embedding)

    @classmethod
    def load(cls, fpath) -> "Conditionals":
        fpath = str(fpath)
        if fpath.endswith(".pt"):
            data = torch.load(fpath, map_location="cpu", weights_only=True)
            t3, gen = data["t3"], data["gen"]
            n = lambda x: x.numpy() if torch.is_tensor(x) else np.asarray(x)
            emo = t3.get("emotion_adv")
            tok = t3.get("cond_prompt_speech_tokens")
            return cls(
                T3CondHost(n(t3["speaker_emb"]).astype(np.float32).reshape(1, -1),
                           None if tok is None else n(tok).astype(np.int32).reshape(1, -1),
                           0.5 if emo is None else float(n(emo).reshape(-1)[0])),
                RefDict(n(gen["prompt_token"]).astype(np.int32),
                        n(gen["prompt_token_len"]).astype(np.int32).reshape(-1),
                        n(gen["prompt_feat"]).astype(np.float32),
                        n(gen["embedding"]).astype(np.float32).reshape(1, -1)))
        z = np.load(fpath)
        tok = z["cond_prompt_speech_tokens"]
        return cls(T3CondHost(z["speaker_emb"], None if tok.size == 0 else tok,
                              float(z["emotion_adv"])),
                   RefDict(z["prompt_token"], z["prompt_token_len"],
                           z["prompt_feat"], z["embedding"]))


class _TTSBase:
    """What the pipelines share: parameters, tokenizer, voice, RNG,
    watermarker, the conditioning frontend."""

    ENC_COND_SEC = 6          # seconds of prompt the T3 prompt tokens come from
    DEC_COND_SEC = 10         # seconds of prompt S3Gen's reference comes from

    def __init__(self, t3_params: dict, hp: T3Config, s3gen: S3GenEngine,
                 ve_params: Optional[dict], tokenizer, conds: Optional[Conditionals] = None,
                 seed: int = 0):
        self.sr = S3GEN_SR
        self.t3_params = t3_params
        self.hp = hp
        self.s3gen = s3gen
        self.ve_params = ve_params
        self.tokenizer = tokenizer
        self.conds = conds
        self.device = t3_params["speech_emb"]["w"].device
        self.watermarker = Watermarker()
        self.set_seed(seed)

    def set_seed(self, seed: int):
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @staticmethod
    def _random_t3(hp: T3Config, seed: int, device) -> dict:
        """Random T3 weights served as the JAX package's benchmark serves
        them: cast to bf16, then quantized with `best_serving_mode`
        (int8_fused for Turbo and Llama-520M)."""
        t3_params = cast_params(t3m.t3_init(hp, seed=seed, device=device),
                                torch.bfloat16)
        return quantize_t3_backbone(t3_params, mode=best_serving_mode(hp.backbone))

    @classmethod
    def _random_cfg_family(cls, hp: T3Config, flow_dims: FlowDims,
                           tok_cfg: S3TokenizerConfig, hift_base: int, tokenizer,
                           seed: int, device):
        """A 520M-family pipeline with random weights: T3 as `_random_t3`;
        non-meanflow S3Gen with its frontend and the voice encoder in
        float32."""
        s3 = S3GenEngine(s3gen_init(seed + 1, device, meanflow=False, dims=flow_dims,
                                    hift_base=hift_base, tok_cfg=tok_cfg),
                         dims=flow_dims, meanflow=False, tok_cfg=tok_cfg)
        return cls(cls._random_t3(hp, seed, device), hp, s3,
                   ve.ve_init(nn.Init(seed + 2, device)), tokenizer, seed=seed)

    def prepare_conditionals(self, wav_fpath, exaggeration: float = 0.5):
        """Build `self.conds` from a reference WAV file."""
        self._prepare_from_wav(load_audio(wav_fpath, S3GEN_SR), exaggeration)

    def _prepare_from_wav(self, ref_24k: np.ndarray, exaggeration: float):
        """S3Gen's reference from the first DEC_COND_SEC seconds; T3's
        prompt tokens (zero-padded to the prompt length) from the first
        ENC_COND_SEC; the voice-encoder embedding of the whole prompt."""
        with nn.no_tf32_convs():
            ref_16k = resample(torch.from_numpy(np.asarray(ref_24k, np.float32))
                               .to(self.s3gen.device), S3GEN_SR, S3_SR).cpu().numpy()
        gen_ref = self.s3gen.embed_ref(ref_24k[: self.DEC_COND_SEC * S3GEN_SR], S3GEN_SR)
        t3_tokens = None
        if self.hp.speech_cond_prompt_len:
            plen = self.hp.speech_cond_prompt_len
            tokens, _ = self.s3gen.tokenize(ref_16k[: self.ENC_COND_SEC * S3_SR],
                                            max_len=plen)
            t3_tokens = np.zeros((1, plen), np.int32)
            n = min(tokens.shape[1], plen)
            t3_tokens[0, :n] = tokens[0, :n]
        ve_embed = ve.embeds_from_wavs(self.ve_params, [ref_16k], sample_rate=S3_SR)
        self.conds = Conditionals(
            T3CondHost(ve_embed.mean(axis=0, keepdims=True), t3_tokens, exaggeration),
            gen_ref)

    def _conds_for(self, audio_prompt_path, **prepare_kw):
        if audio_prompt_path:
            self.prepare_conditionals(audio_prompt_path, **prepare_kw)
        if self.conds is None:
            raise ValueError("call `prepare_conditionals` or pass `audio_prompt_path` "
                             "(or set `conds`) first")
        return self.conds

    def _vocode(self, res, **tail):
        """S3Gen over a decode result with the pipeline's token tail, then
        the watermark: ((1, T) float32 waveform, the vocoded token count)."""
        wav, n_gen = self.s3gen.inference_from_decode(
            res.tokens, res.n_tokens, self.conds.gen, generator=self.generator, **tail)
        return self.watermarker.apply_watermark(wav[0], sample_rate=self.sr)[None], n_gen

    def _stream(self, ids: np.ndarray, sp: SamplerParams, *, cfg_mode: bool,
                max_new_tokens: int, chunk_tokens: int, top_k: int = 0,
                trim_tail_samples: int = 0):
        """The streaming loop of both families (the JAX package's
        `_stream_cfg`, and its Turbo loop at cfg_mode=False): prefill and
        the first chunk in one call, then chunks of chunk_tokens fed to the
        streaming vocoder straight from the device, one read of a chunk's
        tokens, count and `done` a chunk. A chunk stops at the token budget.

        The stream ends at the first EOS. Ids >= 6561 are dropped; a stray
        start token mid-stream cannot take back audio already streamed, so
        the CFG family's SOS..EOS slice is the first-EOS cut. At the end the
        Turbo tail appends 3 silence tokens; the CFG tail appends none, and
        an empty stream vocodes one silence token, as `generate` does.
        trim_tail_samples: samples held back and dropped from the stream's
        end (0 streams everything). Yields watermarked float32 chunks, the
        watermark continued across chunks (offset=)."""
        state, toks, n_new = t3_prefill_decode(
            self.t3_params, self.hp, self.conds.t3.as_tensors(self.device),
            torch.as_tensor(ids, dtype=torch.long, device=self.device), sp,
            generator=self.generator, max_new_tokens=max_new_tokens,
            n_steps=min(chunk_tokens, max_new_tokens), top_k=top_k, cfg_mode=cfg_mode)
        self.last_decode = state
        voc = StreamingVocoder(self.s3gen, self.conds.gen, self.generator)
        total = n_valid = emitted = 0
        held = np.zeros((0,), np.float32)      # the tail trim's delay
        while True:
            chunk, nv, (n, st_done) = voc.feed_from_decode(
                toks, n_new, vocab=SPEECH_VOCAB_SIZE, extra_fetch=(n_new, state.done))
            n_valid += nv
            total += n
            done = bool(st_done) or total >= max_new_tokens or n == 0
            if done:
                if cfg_mode:
                    tail = voc.feed(np.zeros(0, np.int32) if n_valid
                                    else np.full(1, SIL_TOKEN, np.int32), final=True)
                else:
                    tail, _, _ = voc.feed_from_decode(
                        toks[:1], 0, vocab=SPEECH_VOCAB_SIZE, final=True, append_sil=3)
                chunk = np.concatenate([chunk, tail])
            held = np.concatenate([held, chunk])
            # a stream of at most one valid token is not trimmed (the
            # non-streamed multilingual tail keeps max(1, n - 1) tokens)
            trim = trim_tail_samples if (not done or n_valid >= 2) else 0
            if len(held) > trim:
                out, held = held[:len(held) - trim], held[len(held) - trim:]
                yield self.watermarker.apply_watermark(out, sample_rate=self.sr,
                                                       offset=emitted)
                emitted += len(out)
            if done:
                return
            state, toks, n_new = t3_decode_chunk(
                self.t3_params, self.hp, state, sp,
                n_steps=min(chunk_tokens, max_new_tokens - total), top_k=top_k,
                cfg_mode=cfg_mode)
            self.last_decode = state


class ChatterboxTurboTTS(_TTSBase):
    """Turbo/Nano GPT-2 pipeline."""

    ENC_COND_SEC = 15

    def __init__(self, t3_params: dict, hp: T3Config, s3gen: S3GenEngine,
                 ve_params: Optional[dict], tokenizer, conds: Optional[Conditionals] = None,
                 seed: int = 0, model_label: str = "Turbo"):
        super().__init__(t3_params, hp, s3gen, ve_params, tokenizer, conds, seed)
        self.model_label = model_label

    @classmethod
    def random_init(cls, nano: bool = False, hp: Optional[T3Config] = None,
                    flow_dims: FlowDims = FlowDims(),
                    tok_cfg: S3TokenizerConfig = S3TokenizerConfig(),
                    hift_base: int = 512, tokenizer=None, seed: int = 0, device="cuda"):
        """Random weights at the given widths: T3 as `_random_t3`; meanflow
        S3Gen with its frontend and the voice encoder in float32."""
        hp = hp or (T3Config.nano() if nano else T3Config.turbo())
        s3 = S3GenEngine(s3gen_init(seed + 1, device, dims=flow_dims, hift_base=hift_base,
                                    tok_cfg=tok_cfg), dims=flow_dims, tok_cfg=tok_cfg)
        return cls(cls._random_t3(hp, seed, device), hp, s3,
                   ve.ve_init(nn.Init(seed + 2, device)), tokenizer, seed=seed,
                   model_label="Nano" if nano else "Turbo")

    @classmethod
    def from_local(cls, ckpt_dir, device="cuda", nano=False) -> "ChatterboxTurboTTS":
        """Load a reference checkpoint directory (convert/weights.py
        `load_turbo_tts`); T3 stays float32."""
        from ..convert.weights import load_turbo_tts
        return load_turbo_tts(cls, Path(ckpt_dir), nano=nano, device=device)

    def norm_loudness(self, wav, sr, target_lufs=-27):
        return norm_loudness(wav, sr, target_lufs)

    def _quantized_self_draft(self):
        """This model's own weights quantized with `best_serving_mode`
        (int8_fused at Turbo's widths), built once and kept: the draft of
        `generate(draft="int8")`. It shares this pipeline's conditionals;
        the float weights stay the verify target, so the sampling
        distribution is theirs."""
        if getattr(self, "_qdraft", None) is None:
            if is_quantized(self.t3_params):
                raise ValueError("t3 params are already quantized - the int8 self-draft "
                                 "needs the float model as the verify target")
            qp = quantize_t3_backbone(self.t3_params, mode=best_serving_mode(self.hp.backbone))
            outer = self

            class _QuantView:
                t3_params = qp
                hp = outer.hp

                @property
                def conds(self):
                    return outer.conds

                def prepare_conditionals(self, *a, **kw):
                    pass              # shares the outer model's conditionals

            self._qdraft = _QuantView()
        return self._qdraft

    def prepare_conditionals(self, wav_fpath, exaggeration=0.5, norm_loudness=True):
        """As the base, for a prompt longer than 5 s, brought to -27 LUFS
        unless norm_loudness is False."""
        ref_24k = load_audio(wav_fpath, S3GEN_SR)
        assert len(ref_24k) / S3GEN_SR > 5.0, "Audio prompt must be longer than 5 seconds!"
        if norm_loudness:
            ref_24k = self.norm_loudness(ref_24k, S3GEN_SR)
        self._prepare_from_wav(ref_24k, exaggeration)

    def generate(self, text, repetition_penalty=1.2, min_p=0.00, top_p=0.95,
                 audio_prompt_path=None, exaggeration=0.0, cfg_weight=0.0,
                 temperature=0.8, top_k=1000, norm_loudness=True,
                 max_new_tokens=1000, kv_int8=False, draft=None, n_draft=4):
        """Synthesize `text` in the voice of `self.conds`; returns a (1, T)
        float32 waveform at 24 kHz. kv_int8 keeps the KV cache in int8,
        read by the int8 decode-attention kernel.

        draft: speculative decoding (sampling/speculative.py): the draft
        proposes n_draft tokens a round and this model verifies them in one
        forward, so the output distribution is exactly this model's. Either
        a draft pipeline (e.g. a Nano ChatterboxTurboTTS, which builds its
        own conditionals from the same prompt) or "int8": this model's own
        weights quantized (`_quantized_self_draft`; needs float T3 weights).
        Speculative decode runs on the bf16 KV cache: with draft= set,
        kv_int8 is ignored with a warning and draft= is kept (the JAX
        package's behaviour; its docstring's "drops both knobs" is not what
        its code does)."""
        if draft is not None and kv_int8:
            logger.warning("kv_int8 is ignored when draft= is set: speculative decode "
                           "runs on the bf16 KV cache")
        if draft == "int8":
            draft = self._quantized_self_draft()
        conds = self._conds_for(audio_prompt_path, exaggeration=exaggeration,
                                norm_loudness=norm_loudness)
        if draft is not None:
            if audio_prompt_path:
                draft.prepare_conditionals(audio_prompt_path, exaggeration=exaggeration,
                                           norm_loudness=norm_loudness)
            if draft.conds is None:
                raise ValueError("the draft pipeline needs conditionals too")
        if cfg_weight > 0.0 or exaggeration > 0.0 or min_p > 0.0:
            logger.warning(f"CFG, min_p and exaggeration are not supported by the "
                           f"{self.model_label} version and will be ignored.")
        text = punc_norm(text, variant="turbo")
        # raw GPT-2 BPE ids, no SOT/EOT framing (as the reference Turbo)
        ids = np.asarray(self.tokenizer.text_to_tokens(text)).reshape(1, -1)
        sp = SamplerParams(temperature=temperature, top_p=top_p,
                           repetition_penalty=repetition_penalty)
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        if draft is not None:
            self.last_decode = res = t3_generate_speculative(
                self.t3_params, draft.t3_params, self.hp, draft.hp,
                conds.t3.as_tensors(self.device), draft.conds.t3.as_tensors(self.device),
                ids, sp, max_new_tokens=max_new_tokens, n_draft=n_draft, top_k=top_k,
                generator=self.generator)
        else:
            self.last_decode = res = t3_generate(
                self.t3_params, self.hp, conds.t3.as_tensors(self.device), ids, sp,
                max_new_tokens=max_new_tokens, top_k=top_k, generator=self.generator,
                kv_int8=kv_int8, fused_attn=kv_int8)
        # drop >= vocab, then three silence tokens (the reference Turbo tail)
        return self._vocode(res, append_sil=3)[0]

    def generate_stream(self, text, audio_prompt_path=None, temperature=0.8,
                        top_k=1000, top_p=0.95, repetition_penalty=1.2,
                        norm_loudness=True, max_new_tokens=1000, chunk_tokens=25):
        """Stream `text` in the voice of `self.conds`: yields (T,) float32
        chunks at 24 kHz as tokens decode, chunk_tokens at a time (the
        first audio after prefill, one chunk and its vocode). Each feed
        reruns the flow over the whole stream so far; for narration use
        serve.streaming.synthesize_long_form."""
        self._conds_for(audio_prompt_path, norm_loudness=norm_loudness)
        text = punc_norm(text, variant="turbo")
        ids = np.asarray(self.tokenizer.text_to_tokens(text)).reshape(1, -1)
        sp = SamplerParams(temperature=temperature, top_p=top_p,
                           repetition_penalty=repetition_penalty)
        yield from self._stream(ids, sp, cfg_mode=False, max_new_tokens=max_new_tokens,
                                chunk_tokens=chunk_tokens, top_k=top_k)


class ChatterboxTTS(_TTSBase):
    """The original English 520M pipeline: llama T3 with classifier-free
    guidance (batch 2: conditional and unconditional rows), 10-step CFG
    S3Gen."""

    @classmethod
    def random_init(cls, hp: Optional[T3Config] = None,
                    flow_dims: FlowDims = FlowDims(),
                    tok_cfg: S3TokenizerConfig = S3TokenizerConfig(),
                    hift_base: int = 512, tokenizer=None, seed: int = 0, device="cuda"):
        """Random weights at the given widths (default
        `T3Config.english_only()`): T3 as `_random_t3`; non-meanflow S3Gen
        with its frontend and the voice encoder in float32."""
        return cls._random_cfg_family(hp or T3Config.english_only(), flow_dims, tok_cfg,
                                      hift_base, tokenizer, seed, device)

    @classmethod
    def from_local(cls, ckpt_dir, device="cuda") -> "ChatterboxTTS":
        """Load a reference checkpoint directory (convert/weights.py
        `load_english_tts`); T3 stays float32."""
        from ..convert.weights import load_english_tts
        return load_english_tts(cls, Path(ckpt_dir), device=device)

    def frame_text(self, text: str) -> np.ndarray:
        """punc_norm, tokenize, then SOT/EOT framing: (1, Lt) ids."""
        ids = np.asarray(self.tokenizer.text_to_tokens(punc_norm(text))).reshape(-1)
        return np.concatenate([[self.hp.start_text_token], ids,
                               [self.hp.stop_text_token]]).astype(np.int64)[None]

    def generate(self, text, repetition_penalty=1.2, min_p=0.05, top_p=1.0,
                 audio_prompt_path=None, exaggeration=0.5, cfg_weight=0.5,
                 temperature=0.8, max_new_tokens=1000, kv_int8=False):
        """Synthesize `text` in the voice of `self.conds`; returns a (1, T)
        float32 waveform at 24 kHz. cfg_weight == 0 decodes batch 1 (the
        guidance is then the identity). kv_int8 keeps the KV cache in int8,
        read by the int8 decode-attention kernel."""
        conds = self._conds_for(audio_prompt_path, exaggeration=exaggeration)
        if exaggeration != conds.t3.emotion_adv:
            conds.t3.emotion_adv = exaggeration
        sp = SamplerParams(temperature=temperature, top_p=top_p,
                           repetition_penalty=repetition_penalty, min_p=min_p,
                           cfg_weight=cfg_weight)
        self.last_decode = res = t3_generate(
            self.t3_params, self.hp, conds.t3.as_tensors(self.device),
            torch.as_tensor(self.frame_text(text), device=self.device), sp,
            max_new_tokens=max_new_tokens, cfg_mode=True,
            cfg_batch2=cfg_weight > 0, generator=self.generator, kv_int8=kv_int8,
            fused_attn=kv_int8)
        # slice SOS..EOS, drop >= vocab, empty -> one silence token
        return self._vocode(res, cfg_slice=True)[0]

    def generate_stream(self, text, audio_prompt_path=None, exaggeration=0.5,
                        cfg_weight=0.5, temperature=0.8, repetition_penalty=1.2,
                        min_p=0.05, top_p=1.0, max_new_tokens=1000, chunk_tokens=25):
        """Stream `text` in the voice of `self.conds`: yields (T,) float32
        chunks at 24 kHz as tokens decode (the batch-2 CFG decode at every
        cfg_weight), the stream cut at its first EOS (see `_stream`)."""
        conds = self._conds_for(audio_prompt_path, exaggeration=exaggeration)
        if exaggeration != conds.t3.emotion_adv:
            conds.t3.emotion_adv = exaggeration
        sp = SamplerParams(temperature=temperature, top_p=top_p,
                           repetition_penalty=repetition_penalty, min_p=min_p,
                           cfg_weight=cfg_weight)
        yield from self._stream(self.frame_text(text), sp, cfg_mode=True,
                                max_new_tokens=max_new_tokens, chunk_tokens=chunk_tokens)


class ChatterboxMultilingualTTS(_TTSBase):
    """The 23-language pipeline: the 520M family's llama T3 with a
    2454-token grapheme text vocabulary (`MTLTokenizer`, a `[lang]` prefix
    on the text), batch-2 CFG decode at every cfg_weight, 10-step CFG
    S3Gen, and the last token's 40 ms trimmed from the waveform."""

    @classmethod
    def get_supported_languages(cls) -> dict:
        return SUPPORTED_LANGUAGES.copy()

    @classmethod
    def random_init(cls, hp: Optional[T3Config] = None,
                    flow_dims: FlowDims = FlowDims(),
                    tok_cfg: S3TokenizerConfig = S3TokenizerConfig(),
                    hift_base: int = 512, tokenizer=None, seed: int = 0, device="cuda"):
        """Random weights at the given widths (default
        `T3Config.multilingual()`), built as ChatterboxTTS.random_init
        builds them."""
        return cls._random_cfg_family(hp or T3Config.multilingual(), flow_dims, tok_cfg,
                                      hift_base, tokenizer, seed, device)

    @classmethod
    def from_local(cls, ckpt_dir, device="cuda",
                   t3_model: Optional[str] = None) -> "ChatterboxMultilingualTTS":
        """Load a reference checkpoint directory (convert/weights.py
        `load_mtl_tts`); t3_model names the T3 file (MULTILINGUAL_T3_MODELS,
        default v2). T3 stays float32."""
        from ..convert.weights import load_mtl_tts
        return load_mtl_tts(cls, Path(ckpt_dir), t3_model=t3_model, device=device)

    def _request(self, text, language_id, audio_prompt_path, exaggeration, **sampler):
        """The language check, the voice (with its exaggeration), and the
        framed text ids: punc_norm, the `[lang]`-prefixed grapheme ids,
        SOT/EOT. Returns ((1, Lt) ids, sampler)."""
        if language_id and language_id.lower() not in SUPPORTED_LANGUAGES:
            supported = ", ".join(SUPPORTED_LANGUAGES)
            raise ValueError(f"Unsupported language_id '{language_id}'. "
                             f"Supported languages: {supported}")
        conds = self._conds_for(audio_prompt_path, exaggeration=exaggeration)
        if float(exaggeration) != float(conds.t3.emotion_adv):
            conds.t3.emotion_adv = float(exaggeration)
        ids = np.asarray(self.tokenizer.text_to_tokens(
            punc_norm(text, variant="mtl"),
            language_id=language_id.lower() if language_id else None)).reshape(-1)
        framed = np.concatenate([[self.hp.start_text_token], ids, [self.hp.stop_text_token]])
        return framed.astype(np.int64)[None], SamplerParams(**sampler)

    def generate(self, text, language_id, audio_prompt_path=None, exaggeration=0.5,
                 cfg_weight=0.5, temperature=0.8, repetition_penalty=1.2, min_p=0.05,
                 top_p=1.0, max_new_tokens=1000):
        """Synthesize `text` in `language_id` (a key of SUPPORTED_LANGUAGES;
        ValueError otherwise) in the voice of `self.conds`; returns a (1, T)
        float32 waveform at 24 kHz. The decode is batch 2 even at
        cfg_weight 0, as the reference's multilingual loop; the last
        vocoded token's 40 ms are cut after the watermark."""
        ids, sp = self._request(text, language_id, audio_prompt_path, exaggeration,
                                temperature=temperature, top_p=top_p,
                                repetition_penalty=repetition_penalty, min_p=min_p,
                                cfg_weight=cfg_weight)
        self.last_decode = res = t3_generate(
            self.t3_params, self.hp, self.conds.t3.as_tensors(self.device),
            torch.as_tensor(ids, device=self.device), sp, max_new_tokens=max_new_tokens,
            cfg_mode=True, cfg_batch2=True, generator=self.generator)
        wav, n_gen = self._vocode(res, cfg_slice=True)
        return wav[:, : max(1, n_gen - 1) * (S3GEN_SR // 25)]

    def generate_stream(self, text, language_id, audio_prompt_path=None,
                        exaggeration=0.5, cfg_weight=0.5, temperature=0.8,
                        repetition_penalty=1.2, min_p=0.05, top_p=1.0,
                        max_new_tokens=1000, chunk_tokens=25):
        """Stream `text` in `language_id`: yields (T,) float32 chunks at
        24 kHz as tokens decode (see `_stream`); the 40 ms trim of
        `generate` is held back and dropped at the stream's end."""
        ids, sp = self._request(text, language_id, audio_prompt_path, exaggeration,
                                temperature=temperature, top_p=top_p,
                                repetition_penalty=repetition_penalty, min_p=min_p,
                                cfg_weight=cfg_weight)
        yield from self._stream(ids, sp, cfg_mode=True, max_new_tokens=max_new_tokens,
                                chunk_tokens=chunk_tokens,
                                trim_tail_samples=S3GEN_SR // 25)


class ChatterboxVC:
    """Voice conversion: the S3 tokens of a source wav vocoded in a target
    voice by the 520M family's S3Gen (10-step CFM with CFG)."""

    def __init__(self, s3gen: S3GenEngine, ref_dict: Optional[RefDict] = None,
                 seed: int = 0):
        self.sr = S3GEN_SR
        self.s3gen = s3gen
        self.ref_dict = ref_dict
        self.device = s3gen.device
        self.watermarker = Watermarker()
        self.set_seed(seed)

    def set_seed(self, seed: int):
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @classmethod
    def random_init(cls, flow_dims: FlowDims = FlowDims(),
                    tok_cfg: S3TokenizerConfig = S3TokenizerConfig(),
                    hift_base: int = 512, seed: int = 0, device="cuda") -> "ChatterboxVC":
        """Random float32 weights at the given widths: a CFM S3Gen with its
        frontend."""
        s3 = S3GenEngine(s3gen_init(seed, device, meanflow=False, dims=flow_dims,
                                    hift_base=hift_base, tok_cfg=tok_cfg),
                         dims=flow_dims, meanflow=False, tok_cfg=tok_cfg)
        return cls(s3, seed=seed)

    @classmethod
    def from_local(cls, ckpt_dir, device="cuda") -> "ChatterboxVC":
        """Load s3gen.safetensors and, when present, conds.pt's voice
        (convert/weights.py `load_vc`)."""
        from ..convert.weights import load_vc
        return load_vc(cls, Path(ckpt_dir), device=device)

    def set_target_voice(self, wav_fpath):
        """The target voice from the first 10 s of a WAV file."""
        ref = load_audio(wav_fpath, S3GEN_SR)
        self.ref_dict = self.s3gen.embed_ref(ref[: 10 * S3GEN_SR], S3GEN_SR)

    def generate(self, audio, target_voice_path=None) -> np.ndarray:
        """Convert `audio` (a path, or 16 kHz samples) to the target voice;
        returns a (1, T) float32 waveform at 24 kHz. One request: its spans
        (utils/profiling.py) share the root span's id."""
        with profiling.span("vc.generate"):
            if target_voice_path:
                self.set_target_voice(target_voice_path)
            elif self.ref_dict is None:
                raise ValueError("call `set_target_voice` or pass `target_voice_path` first")
            if isinstance(audio, (str, Path)):
                audio_16 = load_audio(audio, S3_SR)
            else:
                audio_16 = np.asarray(audio, np.float32).reshape(-1)
            tokens, _ = self.s3gen.tokenize(audio_16)
            wav = self.s3gen.inference(tokens, self.ref_dict, generator=self.generator)[0]
            return self.watermarker.apply_watermark(wav, sample_rate=self.sr)[None]
