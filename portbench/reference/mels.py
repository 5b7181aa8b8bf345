"""Frozen reference copy of chatterbox_tpu_torch/audio/mels.py at commit f7b8e4d,
plain PyTorch / numpy, importing nothing of the program under test.

The four audio feature frontends of the Chatterbox stack (the
counterparts of chatterbox_tpu/audio/mels.py), on torch tensors:

| frontend          | sr    | n_fft | hop | mels | used by                     |
|-------------------|-------|-------|-----|------|-----------------------------|
| matcha mel        | 24000 | 1920  | 480 | 80   | S3Gen reference prompt mels |
| whisper-style mel | 16000 | 400   | 160 | 128  | S3 speech tokenizer         |
| voice-encoder mel | 16000 | 400   | 160 | 40   | voice encoder (GE2E)        |
| kaldi fbank       | 16000 | 512   | 160 | 80   | CAMPPlus x-vector           |
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .filters import hann_window, kaldi_mel_banks, mel_filterbank, povey_window
from .stft import basis, frame_signal, power, reflect_pad, stft_real_imag

_MATCHA_NFFT, _MATCHA_HOP = 1920, 480
_matcha_window = hann_window(1920)
_s3tok_window = hann_window(400)
_ve_window = hann_window(400)
_KALDI_PADDED = 512          # the 400-sample window rounded up to a power of two
_kaldi_window = povey_window(400)


@functools.lru_cache(maxsize=16)
def _const(name: str, device: str) -> torch.Tensor:
    """A filterbank or window as a float32 tensor on `device` (built once)."""
    a = {"matcha": lambda: mel_filterbank(24000, 1920, 80, 0, 8000),       # (80, 961)
         "s3tok": lambda: mel_filterbank(16000, 400, 128),                  # (128, 201)
         "ve": lambda: mel_filterbank(16000, 400, 40, 0, 8000),             # (40, 201)
         "kaldi_t": lambda: kaldi_mel_banks(80, _KALDI_PADDED, 16000.0).T,  # (257, 80)
         "povey": lambda: _kaldi_window}[name]()
    return torch.from_numpy(a.copy()).to(device)


def mel_spectrogram_24k(y: torch.Tensor) -> torch.Tensor:
    """(B, T) 24 kHz audio -> (B, 80, T // 480) log mel: reflect-pad of 720
    on both sides, center=False STFT, sqrt(power + 1e-9), mel,
    log(clamp(x, 1e-5))."""
    pad = (_MATCHA_NFFT - _MATCHA_HOP) // 2
    re, im = stft_real_imag(reflect_pad(y, pad, pad), _MATCHA_NFFT, _MATCHA_HOP,
                            _matcha_window, center=False)
    mag = torch.sqrt(power(re, im) + 1e-9)
    mel = _const("matcha", str(y.device)) @ mag
    return torch.log(torch.clamp(mel, min=1e-5))


def log_mel_spectrogram_s3tok(audio: torch.Tensor) -> torch.Tensor:
    """(B, T) 16 kHz audio -> (B, 128, T // 160) whisper-normalized log mel:
    center=True STFT, the last frame dropped, power, mel, log10(clamp 1e-10),
    floored at the maximum less 8, then (x + 4) / 4."""
    re, im = stft_real_imag(audio, 400, 160, _s3tok_window, center=True)
    mel = _const("s3tok", str(audio.device)) @ power(re, im)[..., :-1]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def melspectrogram_ve(wav: torch.Tensor) -> torch.Tensor:
    """(B, T) 16 kHz audio -> (B, 40, 1 + T // 160) power mel (center=True
    STFT, magnitude squared, no dB)."""
    re, im = stft_real_imag(wav, 400, 160, _ve_window, center=True)
    return _const("ve", str(wav.device)) @ power(re, im)


def kaldi_fbank_80(wav: torch.Tensor) -> torch.Tensor:
    """(B, T) 16 kHz waveform in [-1, 1] -> (B, n_frames, 80) log fbank, as
    torchaudio.compliance.kaldi.fbank(num_mel_bins=80): int16 scale,
    snip_edges, 25 ms frames every 10 ms, DC removed per frame, preemphasis
    0.97, povey window, 512-point power spectrum, log(max(x, eps))."""
    dev = str(wav.device)
    frames = frame_signal(wav * 32768.0, 400, 160)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    # preemphasis with kaldi's first-sample convention: x[0] -= 0.97 * x[0]
    frames = torch.cat([frames[..., :1] * (1.0 - 0.97),
                        frames[..., 1:] - 0.97 * frames[..., :-1]], dim=-1)
    frames = F.pad(frames * _const("povey", dev), (0, _KALDI_PADDED - 400))
    re_b, im_b = basis(_KALDI_PADDED, None, wav.device)
    p = power(frames @ re_b, frames @ im_b)
    return torch.log(torch.clamp(p @ _const("kaldi_t", dev), min=1.1920928955078125e-07))
