"""S3 speech tokenizer: 16 kHz audio -> 25 Hz discrete tokens, FSQ over a
3^8 vocabulary (the counterpart of chatterbox_tpu/models/s3tok/model.py):
the whisper-style 128-mel frontend, two stride-2 convs, sinusoidal
positions, pre-norm transformer blocks, then an 8-dim tanh projection, each
dimension rounded to 3 levels and composed as a base-3 index.

The architecture is the JAX package's reconstruction of S3TokenizerV2; only
a real checkpoint can confirm it."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ...audio.mels import log_mel_spectrogram_s3tok
from ...nn import core as nn
from ...utils.profiling import to_device

SPEECH_VOCAB_SIZE = 6561   # 3 ** 8
S3_SR = 16_000
S3_HOP = 160               # 100 mel frames a second
S3_TOKEN_RATE = 25


@dataclass(frozen=True)
class S3TokenizerConfig:
    n_mels: int = 128
    n_state: int = 1280
    n_heads: int = 20
    n_layers: int = 12
    fsq_dim: int = 8
    fsq_levels: int = 3

    @classmethod
    def tiny_test(cls):
        return cls(n_mels=128, n_state=64, n_heads=4, n_layers=2)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal embedding."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def s3tokenizer_init(init: nn.Init, cfg: S3TokenizerConfig = S3TokenizerConfig()) -> dict:
    d = cfg.n_state
    return {
        "conv1": init.conv1d(cfg.n_mels, d, 3),
        "conv2": init.conv1d(d, d, 3),
        "blocks": [{
            "ln1": init.layer_norm(d),
            "q": init.linear(d, d),
            "k": init.linear(d, d, bias=False),
            "v": init.linear(d, d),
            "out": init.linear(d, d),
            "ln2": init.layer_norm(d),
            "fc1": init.linear(d, 4 * d),
            "fc2": init.linear(4 * d, d),
        } for _ in range(cfg.n_layers)],
        "ln_post": init.layer_norm(d),
        "fsq_proj": init.linear(d, cfg.fsq_dim),
    }


def s3tokenizer_encode_mel(params: dict, cfg: S3TokenizerConfig, mel: torch.Tensor,
                           mel_len: torch.Tensor):
    """mel (B, T_mel, 128) whisper-normalized log mel at 100 frames a
    second, mel_len (B,) -> (tokens (B, T_mel // 4) long, zero past each
    row's length; token_len (B,))."""
    h = nn.gelu_exact(nn.conv1d(params["conv1"], mel, stride=2, padding=1))
    h = nn.gelu_exact(nn.conv1d(params["conv2"], h, stride=2, padding=1))
    T = h.shape[1]
    h = h + to_device(_sinusoids(T, cfg.n_state), h.device)
    token_len = mel_len // 4
    key_mask = torch.arange(T, device=h.device)[None] < token_len[:, None]
    for blk in params["blocks"]:
        x = nn.layer_norm(blk["ln1"], h)
        q, k, v = (nn.split_heads(nn.linear(blk[n], x), cfg.n_heads) for n in "qkv")
        a = nn.mha(q, k, v, mask=key_mask[:, None, None, :])
        h = h + nn.linear(blk["out"], nn.merge_heads(a))
        x = nn.layer_norm(blk["ln2"], h)
        h = h + nn.linear(blk["fc2"], nn.gelu_exact(nn.linear(blk["fc1"], x)))
    h = nn.layer_norm(params["ln_post"], h)
    z = torch.tanh(nn.linear(params["fsq_proj"], h)) * 0.9990000128746033
    digits = torch.round(z) + 1.0                                    # {0, 1, 2}
    powers = to_device(3.0 ** np.arange(cfg.fsq_dim, dtype=np.float32), h.device)
    tokens = (digits * powers).sum(-1).long()
    return torch.where(key_mask, tokens, 0), token_len


def s3tokenizer_tokenize(params: dict, cfg: S3TokenizerConfig, wav_16k: torch.Tensor,
                         wav_len: torch.Tensor, max_len: int | None = None):
    """(B, T) 16 kHz waveform (a multiple of 640 samples) and its lengths
    (B,) -> (tokens, token_len): log mel, then the encoder and FSQ; with
    max_len, at most that many tokens (4 mel frames each)."""
    mel = log_mel_spectrogram_s3tok(wav_16k).transpose(1, 2)        # (B, T_mel, 128)
    mel_len = wav_len // S3_HOP
    if max_len is not None:
        mel = mel[:, : max_len * 4]
        mel_len = torch.clamp(mel_len, max=max_len * 4)
    tokens, token_len = s3tokenizer_encode_mel(params, cfg, mel, mel_len)
    if max_len is not None:
        token_len = torch.clamp(token_len, max=max_len)
    return tokens, token_len


def drop_invalid_tokens(tokens: np.ndarray) -> np.ndarray:
    """Strip the special tokens (ids >= the vocabulary)."""
    tokens = np.asarray(tokens).reshape(-1)
    return tokens[tokens < SPEECH_VOCAB_SIZE]
