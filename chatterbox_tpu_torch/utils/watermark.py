"""Output watermarking (the port's own copy of chatterbox_tpu/utils/watermark.py,
same scheme and same key, so either package detects the other's marks).

perth (resemble-perth) is used when it is installed; otherwise the built-in
`SpreadSpectrumWatermarker`: a keyed +-1 chip sequence (2 s period, 750
chips/s), band-limited to 1-6 kHz and shaped by the signal's local RMS
envelope (~-26 dB), with a 16-bit per-block BPSK payload; detection whitens,
clips, folds over the period and correlates each block's template. A CPU
numpy post-process, outside the device path.
"""
from __future__ import annotations

import hashlib
import logging

import numpy as np

from .profiling import span

logger = logging.getLogger(__name__)

CHIP_RATE = 750           # chips per second
PERIOD_S = 2.0            # chip-sequence period (integer samples at any sr)
N_CHIPS = int(CHIP_RATE * PERIOD_S)
BAND = (1000.0, 6000.0)   # embedding band, survives 16 kHz resampling
ALPHA = 0.05              # watermark level vs local RMS (~-26 dB)
ENV_WIN_S = 0.02          # envelope window (20 ms)
PAYLOAD_BITS = 16         # per-block BPSK payload riding the chip period
# Detection threshold on the summed-block correlation z-score. ROC-derived
# (160 unmarked + 160 wrong-key synthetic clips across
# noise/tones/AR-speech/burst material, 2–8 s): unmarked max 6.3,
# wrong-key max 8.3 → threshold 10 (false-max × 1.15). Embedded scores:
# p50 ≈ 27, ≥ 20 (= 2× threshold) for ≥4 s material of every class; the
# floor is ~11 on ≈2 s noise-like clips (≈1 chip period of fold gain).
DETECT_Z = 10.0


def _chips(key: str) -> np.ndarray:
    """Keyed ±1 chip sequence (deterministic across processes)."""
    seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, N_CHIPS).astype(np.float64) * 2.0 - 1.0


def _bandpass(x: np.ndarray, sr: int, lo: float, hi: float) -> np.ndarray:
    """Linear-phase FIR bandpass (windowed sinc), zero-delay via 'same' conv."""
    hi = min(hi, 0.45 * sr)
    numtaps = min(255, (len(x) // 2) * 2 - 1) if len(x) < 255 else 255
    if numtaps < 9:
        return x.astype(np.float64)
    t = np.arange(numtaps) - (numtaps - 1) / 2
    def sinc_lp(fc):
        h = np.sinc(2 * fc / sr * t)
        return h * np.hamming(numtaps)
    h = sinc_lp(hi) * 2 * hi / sr - sinc_lp(lo) * 2 * lo / sr
    return np.convolve(x.astype(np.float64), h, mode="same")


def _envelope(x: np.ndarray, sr: int) -> np.ndarray:
    """Local RMS over ~20 ms (moving average of x² via cumsum)."""
    w = max(int(ENV_WIN_S * sr), 8)
    c = np.cumsum(np.concatenate([[0.0], x.astype(np.float64) ** 2]))
    lo = np.maximum(np.arange(len(x)) - w // 2, 0)
    hi = np.minimum(np.arange(len(x)) + w // 2, len(x))
    return np.sqrt((c[hi] - c[lo]) / np.maximum(hi - lo, 1))


def _block_of_chip() -> np.ndarray:
    """Payload block index of every chip (16 contiguous blocks)."""
    return (np.arange(N_CHIPS) * PAYLOAD_BITS // N_CHIPS).astype(np.int64)


def _payload_signs(payload: int) -> np.ndarray:
    """(PAYLOAD_BITS,) ±1 — bit b set → +1. Payload of all ones is the
    unmodulated legacy sequence."""
    bits = (payload >> np.arange(PAYLOAD_BITS)) & 1
    return bits.astype(np.float64) * 2.0 - 1.0


def _template(key: str, n: int, sr: int, offset: int = 0,
              payload: int | None = None,
              block: int | None = None) -> np.ndarray:
    """The chip waveform sampled at sr for n samples, starting at `offset`
    samples into the (circular) 2 s period. payload: per-block BPSK signs;
    block: emit ONLY that block's chips (zeros elsewhere — the detector's
    per-block matched templates)."""
    idx = ((np.arange(n) + offset) % round(PERIOD_S * sr))
    chip_idx = (idx * CHIP_RATE // sr).astype(np.int64) % N_CHIPS
    w = _chips(key)[chip_idx]
    blk = _block_of_chip()[chip_idx]
    if payload is not None:
        w = w * _payload_signs(payload)[blk]
    if block is not None:
        w = np.where(blk == block, w, 0.0)
    return w


class SpreadSpectrumWatermarker:
    """Envelope-shaped DSSS watermark: embed + detect, any sample rate."""

    def __init__(self, key: str = "chatterbox-tpu"):
        self.key = key

    DEFAULT_PAYLOAD = (1 << PAYLOAD_BITS) - 1   # all-ones ≡ unmodulated

    # -- embed ----------------------------------------------------------
    def apply_watermark(self, wav: np.ndarray, watermark=None,
                        sample_rate: int = 24000,
                        offset: int = 0,
                        payload: int | None = None) -> np.ndarray:
        """offset: samples already emitted in this stream — keeps the chip
        sequence phase-continuous when watermarking chunk-by-chunk
        (generate_stream), so the concatenated stream detects like a
        one-shot embed.

        payload: optional 16-bit generator id carried via per-block BPSK
        (closer to perth's implicit data-carrying watermark, ref:
        README.md:178-198). Default (None) embeds the all-ones payload —
        the legacy presence-only sequence."""
        x = np.asarray(wav, np.float64).reshape(-1)
        if len(x) < sample_rate // 10:      # <100 ms: nothing to hide in
            return np.asarray(wav, np.float32)
        if payload is None:
            payload = self.DEFAULT_PAYLOAD
        if not 0 <= payload < (1 << PAYLOAD_BITS):
            raise ValueError(f"payload must fit {PAYLOAD_BITS} bits, "
                             f"got {payload}")
        pn = _template(self.key, len(x), sample_rate, offset=offset,
                       payload=payload)
        carrier = _bandpass(pn, sample_rate, *BAND)
        rms = np.sqrt(np.mean(carrier ** 2)) or 1.0
        carrier = carrier / rms
        env = _envelope(x, sample_rate)
        out = x + ALPHA * env * carrier
        peak = np.max(np.abs(out))
        if peak > 1.0:                       # preserve headroom
            out = out / peak
        return out.astype(np.float32)

    # -- detect ---------------------------------------------------------
    def get_watermark(self, wav: np.ndarray, sample_rate: int = 24000,
                      round_score: bool = True):
        """Returns 1.0/0.0 (perth-style) or the raw z-score with
        round_score=False."""
        z = self.detection_score(wav, sample_rate)
        if round_score:
            return 1.0 if z >= DETECT_Z else 0.0
        return z

    def detection_score(self, wav: np.ndarray, sample_rate: int) -> float:
        return self.detect(wav, sample_rate)[0]

    def get_payload(self, wav: np.ndarray, sample_rate: int = 24000) -> int:
        """The 16-bit payload at the detected lag (meaningful only when the
        presence score clears DETECT_Z)."""
        return self.detect(wav, sample_rate)[1]

    def detect(self, wav: np.ndarray, sample_rate: int) -> tuple:
        """(presence z-score, decoded payload).

        Folds the whitened received band over the chip period and computes
        PER-BLOCK circular correlations against the keyed block templates.
        Presence = z-score (over lags) of max_lag sum_b |corr_b(lag)| —
        invariant to the embedded payload; payload bits = the per-block
        correlation signs at the winning lag.

        Two whitening stages raise the worst-case margin (r3 verdict #6):
        * TIME: the envelope-normalized signal is clipped at 3 robust
          sigmas before folding — heavy-tailed program material (bursts,
          clicks) previously inflated wrong-key/unmarked peak scores (the
          z=9.6 wrong-key floor of r3);
        * FREQUENCY: the folded signal's spectrum is divided by its own
          smoothed magnitude (matched filtering under colored noise) —
          narrowband program energy (AR resonances, tones) no longer
          drowns the flat chip spectrum (was z≈5 on 2.5 s AR material,
          ≈19 after)."""
        x = np.asarray(wav, np.float64).reshape(-1)
        period = round(PERIOD_S * sample_rate)
        if len(x) < period // 2:
            return 0.0, 0
        bp = _bandpass(x, sample_rate, *BAND)
        env = _envelope(x, sample_rate)
        white = bp / (env + 1e-8)
        # robust 3-sigma clip (sigma from the median absolute deviation)
        sigma = 1.4826 * np.median(np.abs(white - np.median(white))) + 1e-12
        white = np.clip(white, -3 * sigma, 3 * sigma)
        # fold over the period (sum over full+partial periods)
        n_full = len(white) // period
        if n_full >= 1:
            folded = white[: n_full * period].reshape(n_full, period).sum(0)
            tail = white[n_full * period:]
            folded[: len(tail)] += tail
        else:
            folded = np.zeros(period)
            folded[: len(white)] = white
        F = np.fft.rfft(folded)
        # spectral whitening: flatten colored in-band interference
        smooth = np.convolve(np.abs(F), np.ones(65) / 65.0,
                             mode="same") + 1e-9
        F = F / smooth
        corr_b = np.empty((PAYLOAD_BITS, period))
        for b in range(PAYLOAD_BITS):
            tmpl = _bandpass(_template(self.key, period, sample_rate,
                                       block=b), sample_rate, *BAND)
            corr_b[b] = np.fft.irfft(F * np.conj(np.fft.rfft(tmpl)),
                                     n=period)
        score = np.abs(corr_b).sum(0)
        mu, sd = np.mean(score), np.std(score) + 1e-12
        lag = int(np.argmax(score))
        z = float((score[lag] - mu) / sd)
        payload = int(sum(1 << b for b in range(PAYLOAD_BITS)
                          if corr_b[b, lag] > 0))
        return z, payload


class Watermarker:
    """The pipelines' watermarker: perth when installed (reference parity),
    otherwise the built-in spread-spectrum pair. Never an identity."""

    def __init__(self, key: str = "chatterbox-tpu"):
        self._perth = None
        self._own = SpreadSpectrumWatermarker(key)
        try:
            import perth  # type: ignore
            self._perth = perth.PerthImplicitWatermarker()
        except ImportError:
            logger.debug("resemble-perth not installed — using built-in "
                         "spread-spectrum watermark")

    def apply_watermark(self, wav: np.ndarray, sample_rate: int,
                        offset: int = 0) -> np.ndarray:
        with span("watermark", samples=np.size(wav)):
            if self._perth is not None:
                return self._perth.apply_watermark(wav, sample_rate=sample_rate)
            return self._own.apply_watermark(wav, sample_rate=sample_rate,
                                             offset=offset)

    def get_watermark(self, wav: np.ndarray, sample_rate: int):
        if self._perth is not None:
            return self._perth.get_watermark(wav, sample_rate=sample_rate)
        return self._own.get_watermark(wav, sample_rate=sample_rate)

    def get_payload(self, wav: np.ndarray, sample_rate: int) -> int:
        """16-bit payload of the built-in scheme (perth's payload surface is
        not exposed by its public API; falls back to the own detector,
        which reads only marks IT embedded)."""
        return self._own.get_payload(wav, sample_rate=sample_rate)
