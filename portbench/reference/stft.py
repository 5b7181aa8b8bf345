"""Frozen reference copy of chatterbox_tpu_torch/audio/stft.py at commit f7b8e4d,
plain PyTorch / numpy, importing nothing of the program under test.

STFT as a product with a windowed DFT basis (the counterpart of
chatterbox_tpu/audio/stft.py's analysis half): frames, then one matmul for
the real and one for the imaginary part, so the result is the JAX
package's own formulation. The iSTFT of HiFT is torch.istft
(models/s3gen/hift.py)."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .filters import dft_basis


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., 1 + (T - n_fft) // hop, n_fft) frames (torch's
    center=False convention)."""
    return x.unfold(-1, n_fft, hop)


@functools.lru_cache(maxsize=16)
def _basis(n_fft: int, window: bytes | None, device: str):
    w = None if window is None else np.frombuffer(window, np.float32)
    re, im = dft_basis(n_fft, w)
    return torch.from_numpy(re).to(device), torch.from_numpy(im).to(device)


def basis(n_fft: int, window: np.ndarray | None, device) -> tuple:
    """The DFT basis of `dft_basis` as tensors on `device` (built once)."""
    key = None if window is None else np.asarray(window, np.float32).tobytes()
    return _basis(n_fft, key, str(torch.device(device)))


def reflect_pad(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Reflect-pad the last axis of (..., T) (numpy's mode="reflect")."""
    lead = x.shape[:-1]
    return F.pad(x.reshape(-1, 1, x.shape[-1]), (lo, hi), mode="reflect").reshape(
        *lead, -1)


def stft_real_imag(x: torch.Tensor, n_fft: int, hop: int, window: np.ndarray,
                   center: bool = True):
    """(real, imag), each (..., n_fft // 2 + 1, n_frames): torch.stft(x,
    n_fft, hop, window=window, center=center, pad_mode="reflect",
    onesided=True) as a matmul."""
    if center:
        x = reflect_pad(x, n_fft // 2, n_fft // 2)
    re_b, im_b = basis(n_fft, window, x.device)
    frames = frame_signal(x, n_fft, hop)
    return (frames @ re_b).transpose(-1, -2), (frames @ im_b).transpose(-1, -2)


def magnitude(re: torch.Tensor, im: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    p = re * re + im * im
    if eps:
        p = p + eps
    return torch.sqrt(p)


def power(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return re * re + im * im
