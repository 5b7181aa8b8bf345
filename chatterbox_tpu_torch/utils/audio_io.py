"""WAV file input and output on the host (the counterpart of
chatterbox_tpu/utils/audio_io.py), through scipy's reader and writer. PCM
(8, 16 and 32 bit) and float WAVs are read as mono float32 in [-1, 1] and
resampled by the shared resampler; other formats raise.

The samples are scaled to [-1, 1] before the channels are averaged (in
float64), which is what the JAX package's native reader
(runtime/wavio.cpp, used wherever it builds) returns. Its scipy fallback
averages integer channels before scaling and so leaves a multichannel PCM
file unscaled; the port does not copy that. The training data loader
(chatterbox_tpu_torch/runtime) reads through the native reader where g++
builds it, and through `read_wav` otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..audio.resample import resample


def read_wav(path):
    """(mono float32 samples in [-1, 1], the file's sample rate)."""
    from scipy.io import wavfile
    try:
        sr, data = wavfile.read(str(path))
    except ValueError as e:
        raise ValueError(
            f"Could not read {str(path)!r} — only WAV files are supported in this "
            f"build (install soundfile/librosa for other formats): {e}") from e
    scale = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0}
    if data.dtype == np.uint8:
        wav = (data.astype(np.float64) - 128.0) / 128.0
    elif data.dtype in scale:
        wav = data.astype(np.float64) / scale[data.dtype]
    else:
        wav = data.astype(np.float64)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    return wav.astype(np.float32), int(sr)


def load_audio(path, target_sr: int) -> np.ndarray:
    """Mono float32 in [-1, 1] at target_sr."""
    wav, sr = read_wav(path)
    if sr != target_sr:
        wav = resample(torch.from_numpy(wav), sr, target_sr).numpy()
    return wav


def save_wav(path, wav: np.ndarray, sr: int):
    """A float32 WAV of `wav` clipped to [-1, 1]."""
    from scipy.io import wavfile
    wavfile.write(str(path), sr, np.clip(np.asarray(wav).reshape(-1), -1.0, 1.0)
                  .astype(np.float32))
