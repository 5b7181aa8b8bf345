"""GE2E-style voice encoder: 16 kHz audio -> 256-d L2-normalized speaker
embedding (the counterpart of chatterbox_tpu/models/ve/model.py): 40-mel
power spectrogram -> 3-layer LSTM(256) -> linear + ReLU -> L2 norm. An
utterance is cut into overlapping 160-frame partials (rate 1.3), which are
embedded as one batch, averaged and normalized again.

The LSTM is torch.lstm over the three layers (cuDNN on the card, with TF32
off), not explicit cells."""
from __future__ import annotations

import numpy as np
import torch

from ...audio.mels import melspectrogram_ve
from ...audio.resample import resample
from ...nn import core as nn

VE_SR = 16_000
NUM_MELS = 40
PARTIAL_FRAMES = 160
HIDDEN = 256
EMBED = 256
DEFAULT_RATE = 1.3


def ve_init(init: nn.Init) -> dict:
    return {"lstm": init.lstm(NUM_MELS, HIDDEN, num_layers=3),
            "proj": init.linear(HIDDEN, EMBED),
            "similarity_weight": init.const((1,), 10.0),
            "similarity_bias": init.const((1,), -5.0)}


def ve_forward(params: dict, mels: torch.Tensor) -> torch.Tensor:
    """(B, 160, 40) partial mels -> (B, 256) L2-normalized embeddings."""
    with nn.no_tf32_convs():
        _, (h, _) = nn.lstm(params["lstm"], mels)
    raw = torch.relu(nn.linear(params["proj"], h[-1]))
    return raw / torch.linalg.vector_norm(raw, dim=1, keepdim=True)


def _get_num_wins(n_frames: int, step: int, min_coverage: float):
    win = PARTIAL_FRAMES
    n_wins, remainder = divmod(max(n_frames - win + step, 0), step)
    if n_wins == 0 or (remainder + (win - step)) / win >= min_coverage:
        n_wins += 1
    return n_wins, win + step * (n_wins - 1)


def _frame_step(rate: float) -> int:
    return int(np.round((VE_SR / rate) / PARTIAL_FRAMES))


def embeds_from_mels(params: dict, mels: list, rate: float = DEFAULT_RATE,
                     min_coverage: float = 0.8) -> np.ndarray:
    """mels: (T_i, 40) tensors, unscaled -> (N, 256) utterance embeddings."""
    step = _frame_step(rate)
    partials, spans = [], []
    for mel in mels:
        n_wins, target = _get_num_wins(mel.shape[0], step, min_coverage)
        if target > mel.shape[0]:
            mel = torch.nn.functional.pad(mel, (0, 0, 0, target - mel.shape[0]))
        start = len(partials)
        partials += [mel[i * step: i * step + PARTIAL_FRAMES] for i in range(n_wins)]
        spans.append((start, len(partials)))
    partial_embeds = ve_forward(params, torch.stack(partials).float()).cpu().numpy()
    out = []
    for s, e in spans:
        raw = partial_embeds[s:e].mean(axis=0)
        out.append(raw / np.linalg.norm(raw))
    return np.stack(out)


def embeds_from_wavs(params: dict, wavs: list, sample_rate: int,
                     rate: float = DEFAULT_RATE, as_spk: bool = False) -> np.ndarray:
    """Waveforms (numpy or tensors) at sample_rate -> (N, 256) utterance
    embeddings, or their normalized mean with as_spk. Resampled to 16 kHz
    by the shared resampler; no silence trimming."""
    device = params["proj"]["w"].device
    wavs = [torch.as_tensor(np.asarray(w, np.float32) if not torch.is_tensor(w) else w,
                            device=device) for w in wavs]
    with nn.no_tf32_convs():
        if sample_rate != VE_SR:
            wavs = [resample(w, sample_rate, VE_SR) for w in wavs]
        mels = [melspectrogram_ve(w[None])[0].T for w in wavs]
    embeds = embeds_from_mels(params, mels, rate=rate)
    if as_spk:
        spk = embeds.mean(axis=0)
        return spk / np.linalg.norm(spk)
    return embeds
