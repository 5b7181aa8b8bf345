"""Frozen reference copy of chatterbox_tpu_torch/audio/filters.py at commit f7b8e4d,
plain PyTorch / numpy, importing nothing of the program under test.

Filterbank and window constants of the audio frontends (the port's own
copy of chatterbox_tpu/audio/filters.py): plain numpy, computed once.

  * mel_filterbank: librosa.filters.mel (slaney scale, slaney norm), for the
    24 kHz S3Gen mel, the 128-mel S3 tokenizer mel and the 40-mel voice
    encoder mel;
  * kaldi_mel_banks and povey_window: torchaudio's kaldi fbank, for
    CAMPPlus;
  * dft_basis: the windowed real / imaginary DFT basis the STFTs multiply
    frames by.
"""
from __future__ import annotations

import numpy as np

# slaney (librosa default) mel scale
_F_SP = 200.0 / 3            # Hz per mel below the knee
_MIN_LOG_HZ = 1000.0         # knee of the linear / log split
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    return np.where(log_region,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
                    mel)


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filters, (n_mels,
    n_fft // 2 + 1) float32 (librosa.filters.mel's defaults)."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:] - hz_pts[:-2]))[:, None]   # equal-area triangles
    return weights.astype(np.float32)


def hz_to_mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def kaldi_mel_banks(num_bins: int, padded_window_size: int, sample_freq: float,
                    low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi's mel triangles over the FFT bins (torchaudio's
    kaldi.get_mel_banks), (num_bins, padded_window_size // 2 + 1) with the
    Nyquist column zero."""
    num_fft_bins = padded_window_size // 2
    if high_freq <= 0.0:
        high_freq = 0.5 * sample_freq + high_freq
    mel_low, mel_high = hz_to_mel_htk(low_freq), hz_to_mel_htk(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    mel = hz_to_mel_htk(sample_freq / padded_window_size * np.arange(num_fft_bins))
    bins = np.zeros((num_bins, num_fft_bins + 1), dtype=np.float32)
    for i in range(num_bins):
        left = mel_low + i * mel_delta
        center = mel_low + (i + 1) * mel_delta
        right = mel_low + (i + 2) * mel_delta
        tri = np.minimum((mel - left) / (center - left), (right - mel) / (right - center))
        bins[i, :num_fft_bins] = np.maximum(0.0, tri)
    return bins


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """torch.hann_window (periodic by default)."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1))
    return w[:win_length].astype(np.float32)


def povey_window(win_length: int) -> np.ndarray:
    """Kaldi's 'povey' window: hann(periodic=False) ** 0.85."""
    a = 2.0 * np.pi / (win_length - 1)
    return ((0.5 - 0.5 * np.cos(a * np.arange(win_length))) ** 0.85).astype(np.float32)


def dft_basis(n_fft: int, window: np.ndarray | None = None):
    """(real, imag), each (n_fft, n_fft // 2 + 1) float32, the window folded
    in: frame @ real, frame @ imag is rfft(frame * window)."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    re, im = np.cos(ang), np.sin(ang)
    if window is not None:
        re = re * window[:, None]
        im = im * window[:, None]
    return re.astype(np.float32), im.astype(np.float32)
