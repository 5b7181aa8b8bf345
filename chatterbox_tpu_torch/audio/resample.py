"""Polyphase windowed-sinc resampler (the counterpart of
chatterbox_tpu/audio/resample.py): torchaudio's sinc_interp_hann
(lowpass_filter_width 6, rolloff 0.99) as one strided conv1d whose `new`
output channels are the output phases."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import to_device


@functools.lru_cache(maxsize=32)
def resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                    rolloff: float = 0.99):
    """(kernels (new, K) float32, width, orig, new) for the gcd-reduced
    rates, as torchaudio builds them."""
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels = kernels * window * (base_freq / orig)
    return kernels.astype(np.float32), width, orig, new


def resample(wav: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Resample a (..., T) waveform (torchaudio.functional.resample with its
    sinc_interp_hann defaults) to ceil(new * T / orig) samples."""
    if orig_freq == new_freq:
        return wav
    kernels, width, orig, new = resample_kernel(orig_freq, new_freq)
    length = wav.shape[-1]
    x = F.pad(wav.reshape(-1, 1, length), (width, width + orig))
    k = to_device(kernels, wav.device, wav.dtype)[:, None, :]
    y = F.conv1d(x, k, stride=orig)                      # (N, new, frames)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)        # interleave the phases
    n = int(math.ceil(new * length / orig))
    return y[:, :n].reshape(*wav.shape[:-1], n)
