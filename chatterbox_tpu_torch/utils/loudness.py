"""ITU-R BS.1770-4 integrated loudness and gain normalization, on the host
with numpy and scipy (the port's own copy of
chatterbox_tpu/utils/loudness.py): Turbo brings reference prompts to
-27 LUFS. The two-stage K-weighting prefilter is designed for the sample
rate, as pyloudnorm designs it, then the standard two-stage gating."""
from __future__ import annotations

import math

import numpy as np
from scipy.signal import lfilter


def _high_shelf(fs: float):
    G, Q, fc = 3.999843853973347, 0.7071752369554196, 1681.974450955533
    K = math.tan(math.pi * fc / fs)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b = np.array([(Vh + Vb * K / Q + K * K) / a0,
                  2.0 * (K * K - Vh) / a0,
                  (Vh - Vb * K / Q + K * K) / a0])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    return b, a


def _high_pass(fs: float):
    Q, fc = 0.5003270373238773, 38.13547087602444
    K = math.tan(math.pi * fc / fs)
    a0 = 1.0 + K / Q + K * K
    b = np.array([1.0, -2.0, 1.0])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    return b, a


def integrated_loudness(wav: np.ndarray, sr: int) -> float:
    """Mono integrated loudness in LUFS (BS.1770-4 gating)."""
    x = np.asarray(wav, np.float64).reshape(-1)
    for design in (_high_shelf, _high_pass):
        b, a = design(sr)
        x = lfilter(b, a, x)
    block = int(0.4 * sr)
    step = int(0.1 * sr)
    if len(x) < block:
        ms = np.mean(x ** 2)
        return -0.691 + 10.0 * np.log10(max(ms, 1e-12))
    n_blocks = 1 + (len(x) - block) // step
    idx = np.arange(n_blocks)[:, None] * step + np.arange(block)[None, :]
    ms = np.mean(x[idx] ** 2, axis=1)
    lb = -0.691 + 10.0 * np.log10(np.maximum(ms, 1e-12))
    abs_gate = lb > -70.0
    if not abs_gate.any():
        return -np.inf
    rel_thresh = -0.691 + 10.0 * np.log10(np.mean(ms[abs_gate])) - 10.0
    gate = abs_gate & (lb > rel_thresh)
    if not gate.any():
        return -np.inf
    return -0.691 + 10.0 * np.log10(np.mean(ms[gate]))


def norm_loudness(wav: np.ndarray, sr: int, target_lufs: float = -27.0) -> np.ndarray:
    """`wav` scaled to target_lufs; left as it is when the gain is not a
    finite positive number."""
    try:
        loudness = integrated_loudness(wav, sr)
        gain_db = target_lufs - loudness
        gain = 10.0 ** (gain_db / 20.0)
        if math.isfinite(gain) and gain > 0.0:
            wav = wav * gain
    except Exception as e:
        print(f"Warning: Error in norm_loudness, skipping: {e}")
    return wav
