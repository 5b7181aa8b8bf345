"""Public pipelines: text -> speech tokens (T3) -> waveform (S3Gen) (the
counterparts of ChatterboxTurboTTS and ChatterboxTTS in
chatterbox_tpu/api/pipelines.py).

  * ChatterboxTurboTTS: GPT-2 T3, batch-1 decode, 2-step meanflow S3Gen;
  * ChatterboxTTS: the original 520M model, llama T3 with perceiver,
    emotion input and learned positions, batch-2 CFG decode, 10-step CFG
    S3Gen.

The voice comes from a `Conditionals` bundle: built in code, or loaded from
the reference's `conds.pt` (or this package's .npz). Building it from a
reference wav (`audio_prompt_path`) needs the conditioning frontend (S3
tokenizer, CAMPPlus, voice encoder, mels), which is not ported yet.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from ..models.s3gen.flow import FlowDims
from ..models.s3gen.model import S3GEN_SR, RefDict, S3GenEngine, s3gen_init
from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..ops.sampling import SamplerParams
from ..sampling.decode import t3_generate
from ..text.normalize import punc_norm
from ..utils.quantize import best_serving_mode, cast_params, quantize_t3_backbone
from ..utils.watermark import Watermarker

logger = logging.getLogger(__name__)


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
    watermarker."""

    def __init__(self, t3_params: dict, hp: T3Config, s3gen: S3GenEngine,
                 tokenizer, conds: Optional[Conditionals] = None, seed: int = 0):
        self.sr = S3GEN_SR
        self.t3_params = t3_params
        self.hp = hp
        self.s3gen = s3gen
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

    def prepare_conditionals(self, wav_fpath, exaggeration=0.5, norm_loudness=True):
        raise NotImplementedError(
            "conditionals from a reference wav need the conditioning frontend "
            "(S3 tokenizer, CAMPPlus, voice encoder, mels), which is not "
            "ported yet; load a Conditionals bundle (conds.pt) instead")

    def _conds_for(self, audio_prompt_path, exaggeration, norm_loudness=True):
        if audio_prompt_path:
            self.prepare_conditionals(audio_prompt_path, exaggeration=exaggeration,
                                      norm_loudness=norm_loudness)
        if self.conds is None:
            raise ValueError("set `conds` (a Conditionals bundle) first")
        return self.conds

    def _vocode(self, res, **tail) -> np.ndarray:
        wav, _ = self.s3gen.inference_from_decode(
            res.tokens, res.n_tokens, self.conds.gen, generator=self.generator, **tail)
        return self.watermarker.apply_watermark(wav[0], sample_rate=self.sr)[None]


class ChatterboxTurboTTS(_TTSBase):
    """Turbo/Nano GPT-2 pipeline."""

    def __init__(self, t3_params: dict, hp: T3Config, s3gen: S3GenEngine,
                 tokenizer, conds: Optional[Conditionals] = None, seed: int = 0,
                 model_label: str = "Turbo"):
        super().__init__(t3_params, hp, s3gen, tokenizer, conds, seed)
        self.model_label = model_label

    @classmethod
    def random_init(cls, nano: bool = False, hp: Optional[T3Config] = None,
                    flow_dims: FlowDims = FlowDims(), hift_base: int = 512,
                    tokenizer=None, seed: int = 0, device="cuda"):
        """Random weights at the given widths: T3 as `_random_t3`; meanflow
        S3Gen in float32."""
        hp = hp or (T3Config.nano() if nano else T3Config.turbo())
        s3 = S3GenEngine(s3gen_init(seed + 1, device, dims=flow_dims,
                                    hift_base=hift_base), dims=flow_dims)
        return cls(cls._random_t3(hp, seed, device), hp, s3, tokenizer, seed=seed,
                   model_label="Nano" if nano else "Turbo")

    def generate(self, text, repetition_penalty=1.2, min_p=0.00, top_p=0.95,
                 audio_prompt_path=None, exaggeration=0.0, cfg_weight=0.0,
                 temperature=0.8, top_k=1000, norm_loudness=True,
                 max_new_tokens=1000, kv_int8=False):
        """Synthesize `text` in the voice of `self.conds`; returns a (1, T)
        float32 waveform at 24 kHz. kv_int8 keeps the KV cache in int8,
        read by the int8 decode-attention kernel."""
        conds = self._conds_for(audio_prompt_path, exaggeration, norm_loudness)
        if cfg_weight > 0.0 or exaggeration > 0.0 or min_p > 0.0:
            logger.warning(f"CFG, min_p and exaggeration are not supported by the "
                           f"{self.model_label} version and will be ignored.")
        text = punc_norm(text, variant="turbo")
        # raw GPT-2 BPE ids, no SOT/EOT framing (as the reference Turbo)
        ids = np.asarray(self.tokenizer.text_to_tokens(text)).reshape(1, -1)
        sp = SamplerParams(temperature=temperature, top_p=top_p,
                           repetition_penalty=repetition_penalty)
        self.last_decode = res = t3_generate(
            self.t3_params, self.hp, conds.t3.as_tensors(self.device),
            torch.as_tensor(ids, dtype=torch.long, device=self.device), sp,
            max_new_tokens=max_new_tokens, top_k=top_k, generator=self.generator,
            kv_int8=kv_int8, fused_attn=kv_int8)
        # drop >= vocab, then three silence tokens (the reference Turbo tail)
        return self._vocode(res, append_sil=3)


class ChatterboxTTS(_TTSBase):
    """The original English 520M pipeline: llama T3 with classifier-free
    guidance (batch 2: conditional and unconditional rows), 10-step CFG
    S3Gen."""

    @classmethod
    def random_init(cls, hp: Optional[T3Config] = None,
                    flow_dims: FlowDims = FlowDims(), hift_base: int = 512,
                    tokenizer=None, seed: int = 0, device="cuda"):
        """Random weights at the given widths (default
        `T3Config.english_only()`): T3 as `_random_t3`; non-meanflow S3Gen
        in float32."""
        hp = hp or T3Config.english_only()
        s3 = S3GenEngine(s3gen_init(seed + 1, device, meanflow=False, dims=flow_dims,
                                    hift_base=hift_base),
                         dims=flow_dims, meanflow=False)
        return cls(cls._random_t3(hp, seed, device), hp, s3, tokenizer, seed=seed)

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
        conds = self._conds_for(audio_prompt_path, exaggeration)
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
        return self._vocode(res, cfg_slice=True)
