"""S3Gen as plain PyTorch: speech tokens and a reference voice to a 24 kHz
waveform (flow encoder, UNet estimator by meanflow or CFM, HiFT,
trim-fade), and the frontend that makes a reference voice from a waveform
(resampler, mels, CAMPPlus, the S3 tokenizer). One request at its exact
length, float32; the caller turns TF32 off.

Frozen reference copy of chatterbox_tpu_torch/models/s3gen/model.py
(`s3gen_init`, `trim_fade`, `S3GenEngine.draw_noise`, `_vocode`,
`embed_ref`, `tokenize`) at commit f7b8e4d. It imports nothing of the
program under test.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .campplus import campplus_embed_wav, campplus_init
from .flow import TOKEN_MEL_RATIO, FlowDims, flow_inference, flow_init
from .hift import SourceNoise, hift_inference, hift_init
from .mels import mel_spectrogram_24k
from .resample import resample
from .s3tok import S3_SR, S3TokenizerConfig, s3tokenizer_init, s3tokenizer_tokenize

S3GEN_SR = 24_000
SPEECH_VOCAB_SIZE = 6561


class Ref(NamedTuple):
    """A reference voice: prompt tokens (P,) long, prompt mels (1, 2P, 80)
    and the CAMPPlus x-vector (1, 192), on the device."""
    prompt_token: torch.Tensor
    prompt_feat: torch.Tensor
    embedding: torch.Tensor


def dims_of(cfg: dict) -> FlowDims:
    return FlowDims(**cfg["s3gen"]["flow"])


def tok_cfg_of(cfg: dict) -> S3TokenizerConfig:
    return S3TokenizerConfig(**cfg["s3gen"]["tokenizer"])


PARTS = ("flow", "mel2wav", "tokenizer", "speaker_encoder")


def s3gen_init(init, cfg: dict, parts=PARTS) -> dict:
    """Random parameters in the program's layout, drawn by `init`: the
    flow, HiFT (`mel2wav`), the S3 tokenizer and CAMPPlus, or those of
    them named in `parts` (a vocoder without its frontend)."""
    s = cfg["s3gen"]
    make = {"flow": lambda: flow_init(init, meanflow=s["meanflow"], dims=dims_of(cfg)),
            "mel2wav": lambda: hift_init(init, base_channels=s["hift_base_channels"]),
            "tokenizer": lambda: s3tokenizer_init(init, tok_cfg_of(cfg)),
            "speaker_encoder": lambda: campplus_init(init)}
    return {k: make[k]() for k in parts}


def trim_fade(device) -> torch.Tensor:
    """20 ms of silence then a 20 ms raised-cosine fade-in."""
    n = S3GEN_SR // 50
    fade = np.zeros(2 * n, np.float32)
    fade[n:] = (np.cos(np.linspace(np.pi, 0, n)) + 1) / 2
    return torch.from_numpy(fade).to(device)


@torch.no_grad()
def vocode(params: dict, cfg: dict, ref: Ref, gen_tokens: torch.Tensor,
           generator: torch.Generator) -> torch.Tensor:
    """[prompt | gen] tokens -> flow -> the generated region -> HiFT ->
    trim-fade: (G * 960,) float32. The random numbers are drawn from
    `generator` in the program's order: the flow's starting noise over
    2(P + G) frames, then HiFT's source phases and noise over 2G frames."""
    s = cfg["s3gen"]
    dev = ref.prompt_feat.device
    P, G = ref.prompt_token.shape[0], gen_tokens.shape[0]
    token = torch.cat([ref.prompt_token.long(), gen_tokens.long().to(dev)])[None]
    z = torch.randn((1, (P + G) * TOKEN_MEL_RATIO, 80), generator=generator, device=dev)
    source = SourceNoise.draw(1, G * TOKEN_MEL_RATIO, generator, dev)
    mels = flow_inference(params["flow"], token, P, ref.prompt_feat, ref.embedding, z,
                          n_timesteps=s["flow_steps"], dims=dims_of(cfg),
                          meanflow=s["meanflow"])
    wav, _, _ = hift_inference(params["mel2wav"], mels[:, P * TOKEN_MEL_RATIO:], source)
    fade = trim_fade(dev)
    n = min(fade.shape[0], wav.shape[1])
    return torch.cat([wav[0, :n] * fade[:n], wav[0, n:]])


@torch.no_grad()
def tokenize(params: dict, cfg: dict, wav_16k: torch.Tensor, max_len=None):
    """16 kHz audio (T,) -> (tokens (n,) long, margins (n,)): the S3 tokens
    of a whole number of 40 ms frames, and each token's distance from FSQ's
    nearest rounding boundary."""
    n_tok = int(np.ceil(wav_16k.shape[0] / (S3_SR / 25)))
    wav = torch.nn.functional.pad(wav_16k, (0, int(n_tok * S3_SR / 25) - wav_16k.shape[0]))
    tokens, token_len, margin = s3tokenizer_tokenize(
        params["tokenizer"], tok_cfg_of(cfg), wav[None],
        torch.tensor([wav.shape[0]], device=wav.device), max_len, with_margin=True)
    n = int(token_len[0])
    return tokens[0, :n], margin[0, :n]


@torch.no_grad()
def embed_ref(params: dict, cfg: dict, ref_wav: torch.Tensor, ref_sr: int):
    """A reference waveform (T,) at ref_sr -> (Ref, token margins): its S3
    tokens, 24 kHz prompt mels (two frames a token) and CAMPPlus x-vector."""
    wav24 = resample(ref_wav, ref_sr, S3GEN_SR)
    wav16 = resample(ref_wav, ref_sr, S3_SR)
    embedding = campplus_embed_wav(params["speaker_encoder"], wav16[None])
    n_tok = int(np.ceil(wav16.shape[0] / (S3_SR / 25)))
    n24 = n_tok * (S3GEN_SR // 25)
    wav24p = torch.nn.functional.pad(wav24, (0, max(0, n24 - wav24.shape[0])))[:n24]
    ref_mels = mel_spectrogram_24k(wav24p[None]).transpose(1, 2)
    tokens, margin = tokenize(params, cfg, wav16)
    n_keep = min(tokens.shape[0], ref_mels.shape[1] // 2)
    return Ref(tokens[:n_keep], ref_mels, embedding), margin[:n_keep]
