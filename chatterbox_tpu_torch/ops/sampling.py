"""Logits processing and categorical sampling for the Turbo decode loop
(the counterpart of chatterbox_tpu/ops/sampling.py). Everything stays on the
device: the repetition history is a vocab-sized boolean "seen" mask and the
sample is a gumbel-max, argmax(logits + g)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

NEG_INF = torch.finfo(torch.float32).min


@dataclass(frozen=True)
class SamplerParams:
    temperature: float = 0.8
    top_p: float = 0.95
    repetition_penalty: float = 1.2


def apply_repetition_penalty(logits, seen, penalty):
    """HF RepetitionPenaltyLogitsProcessor: for every seen token,
    score > 0 -> score / penalty, else score * penalty."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def process_logits_turbo(logits, seen, sp: SamplerParams, top_k: int):
    """temperature -> top_k -> top_p -> repetition penalty, with ONE
    descending sort: sequential top_k-then-top_p keeps exactly
    {l >= max(kth value, top_p threshold)}, the top_p mass taken over the
    top_k-masked softmax. top_p >= 1 keeps everything (HF skips the warper
    there; the cumulative formula alone would drop a saturated tail)."""
    V = logits.shape[-1]
    l = logits / sp.temperature
    sorted_l = torch.sort(l, dim=-1, descending=True).values
    ranks = torch.arange(V, device=l.device)
    use_k = 0 < top_k < V
    masked = torch.where(ranks < top_k, sorted_l, NEG_INF) if use_k else sorted_l
    probs = torch.softmax(masked, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    if sp.top_p >= 1.0:
        keep = torch.ones_like(cum, dtype=torch.bool)
    else:
        keep = (cum - probs) < sp.top_p
    if use_k:
        keep = keep & (ranks < top_k)
    threshold = torch.where(keep, sorted_l, torch.inf).amin(dim=-1, keepdim=True)
    l = torch.where(l < threshold, NEG_INF, l)
    return apply_repetition_penalty(l, seen, sp.repetition_penalty)


def gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u in (0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def sample_categorical(logits, g: torch.Tensor) -> torch.Tensor:
    """Multinomial over softmax(logits) as gumbel-max with the draws g (same
    shape as logits). Entries at NEG_INF (or -inf) are never picked."""
    return torch.argmax(logits + g, dim=-1)
