"""Inputs made from the run's seed: voice-like waveforms. Copied from
chip_smoke.py's `synthetic_voice` and made a function of a seed."""
from __future__ import annotations

import numpy as np


def synthetic_voice(seconds: float, sr: int, seed: int, f0: float = 140.0) -> np.ndarray:
    """A voice-like signal: eight harmonics of a wavering f0 under a slow
    envelope, plus noise (float32, peak about 0.5)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 3 * t))) / sr
    wav = sum(0.3 / h * np.sin(h * phase + rng.uniform(0, 2 * np.pi)) for h in range(1, 9))
    wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t) ** 2)
    return (0.5 * (wav + 0.01 * rng.standard_normal(len(t)))).astype(np.float32)
