"""Logits processing and categorical sampling for the decode loop (the
counterpart of chatterbox_tpu/ops/sampling.py). Everything stays on the
device: the repetition history is a vocab-sized boolean "seen" mask and the
sample is a gumbel-max, argmax(logits + g).

Two processor orders, as in the reference:
  * 520M CFG: cfg combine -> repetition penalty -> temperature -> min_p -> top_p
  * Turbo:    temperature -> top_k -> top_p -> repetition penalty

SamplerParams fields are floats (shared by every row) or, for the batched
engine, (B, 1) tensors (one value per row).
"""
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
    min_p: float = 0.05          # CFG pipeline only
    cfg_weight: float = 0.5      # CFG pipeline only


def apply_repetition_penalty(logits, seen, penalty):
    """HF RepetitionPenaltyLogitsProcessor: for every seen token,
    score > 0 -> score / penalty, else score * penalty."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _shared_keep_all(top_p) -> bool:
    return not torch.is_tensor(top_p) and top_p >= 1.0


def _top_p_threshold(sorted_l, probs, top_p, keep=None):
    """The smallest kept logit of a descending sort: a token is kept while
    the probability mass before it is below top_p. top_p >= 1 keeps every
    token (HF skips the warper there; the cumulative formula alone would
    drop a tail whose mass saturates to exactly 1.0 in f32)."""
    if not _shared_keep_all(top_p):
        cum = torch.cumsum(probs, dim=-1)
        in_p = (cum - probs) < top_p
        if torch.is_tensor(top_p):
            in_p = in_p | (top_p >= 1.0)
        keep = in_p if keep is None else keep & in_p
    if keep is None:
        return sorted_l[..., -1:]
    return torch.where(keep, sorted_l, torch.inf).amin(dim=-1, keepdim=True)


def apply_top_p(logits, top_p):
    """HF TopPLogitsWarper: keep the smallest prefix of the descending sort
    whose cumulative probability first reaches top_p."""
    if _shared_keep_all(top_p):
        return logits
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    threshold = _top_p_threshold(sorted_l, torch.softmax(sorted_l, dim=-1), top_p)
    return torch.where(logits < threshold, NEG_INF, logits)


def apply_min_p(logits, min_p: float):
    """HF MinPLogitsWarper: drop tokens with prob < min_p * max prob."""
    probs = torch.softmax(logits, dim=-1)
    top = probs.amax(dim=-1, keepdim=True)
    return torch.where(probs < min_p * top, NEG_INF, logits)


def cfg_combine(cond, uncond, w: float):
    """Classifier-free guidance on logits."""
    return cond + w * (cond - uncond)


def process_logits_cfg(logits_cond, logits_uncond, seen, sp: SamplerParams):
    """cfg combine -> repetition penalty -> temperature -> min_p -> top_p."""
    l = cfg_combine(logits_cond, logits_uncond, sp.cfg_weight)
    l = apply_repetition_penalty(l, seen, sp.repetition_penalty)
    l = l / sp.temperature
    l = apply_min_p(l, sp.min_p)
    return apply_top_p(l, sp.top_p)


def process_logits_turbo(logits, seen, sp: SamplerParams, top_k: int):
    """temperature -> top_k -> top_p -> repetition penalty, with ONE
    descending sort: sequential top_k-then-top_p keeps exactly
    {l >= max(kth value, top_p threshold)}, the top_p mass taken over the
    top_k-masked softmax."""
    V = logits.shape[-1]
    l = logits / sp.temperature
    sorted_l = torch.sort(l, dim=-1, descending=True).values
    use_k = 0 < top_k < V
    keep = None
    masked = sorted_l
    if use_k:
        keep = torch.arange(V, device=l.device) < top_k
        masked = torch.where(keep, sorted_l, NEG_INF)
    threshold = _top_p_threshold(sorted_l, torch.softmax(masked, dim=-1), sp.top_p,
                                 keep)
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
