"""T3 parameters, conditioning prefix, embeddings and heads (the counterpart
of chatterbox_tpu/models/t3/model.py).

The conditioning prefix is [spkr_enc(speaker_emb) (1 token) | the speech
prompt | emotion_adv_fc(exaggeration) (1 token)]:
  * Turbo/Nano: the 375 prompt tokens' speech embeddings, no emotion input,
    so Lc = 376;
  * 520M: the 150 prompt tokens' embeddings plus learned speech positions,
    resampled by the perceiver to 32 tokens, then the emotion token, so
    Lc = 34.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ...nn import core as nn
from . import backbone as bb
from .config import T3Config


class T3CondTensors(NamedTuple):
    speaker_emb: torch.Tensor                          # (B, 256)
    cond_prompt_speech_tokens: Optional[torch.Tensor]  # (B, plen) long or None
    emotion_adv: Optional[torch.Tensor] = None         # (B, 1, 1) or None


# ---------------------------------------------------------------------------
# perceiver resampler (520M only)
# ---------------------------------------------------------------------------

PERCEIVER_QUERIES = 32
PERCEIVER_HEADS = 4          # the reference perceiver always uses 4 heads


def perceiver_init(init: nn.Init, dim: int) -> dict:
    n = PERCEIVER_QUERIES
    qv = math.sqrt(3.0) * math.sqrt(2.0 / (n + n))
    return {"query": init.uniform((1, n, dim), qv),
            "norm": init.layer_norm(dim),
            "to_q": init.linear(dim, dim),
            "to_k": init.linear(dim, dim),
            "to_v": init.linear(dim, dim),
            "proj_out": init.linear(dim, dim)}


def _perceiver_attn_block(p: dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """One LayerNorm shared by both streams, q from x1, k and v from x2,
    attention, projection, residual."""
    x1n, x2n = nn.layer_norm(p["norm"], x1), nn.layer_norm(p["norm"], x2)
    q = nn.split_heads(nn.linear(p["to_q"], x1n), PERCEIVER_HEADS)
    k = nn.split_heads(nn.linear(p["to_k"], x2n), PERCEIVER_HEADS)
    v = nn.split_heads(nn.linear(p["to_v"], x2n), PERCEIVER_HEADS)
    return x1 + nn.linear(p["proj_out"], nn.merge_heads(nn.mha(q, k, v)))


def perceiver_apply(p: dict, h: torch.Tensor) -> torch.Tensor:
    """h (B, T, D) prompt embeddings -> (B, 32, D): cross-attend from the
    learned queries, then self-attend with the same block."""
    query = p["query"].expand(h.shape[0], -1, -1)
    pre = _perceiver_attn_block(p, query, h)
    return _perceiver_attn_block(p, pre, pre)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def t3_init(hp: T3Config, seed: int = 0, device="cuda") -> dict:
    """Random T3 parameters (float32) from a seeded torch.Generator."""
    if max(hp.start_speech_token, hp.stop_speech_token) >= hp.speech_tokens_dict_size:
        raise ValueError("speech special tokens outside the embedding table")
    init = nn.Init(seed, device)
    cfg = hp.backbone
    D = cfg.hidden_size
    params = {
        "backbone": bb.init_backbone(init, cfg),
        "text_emb": init.embedding(hp.text_tokens_dict_size, D),
        "speech_emb": init.embedding(hp.speech_tokens_dict_size, D),
        "text_head": init.linear(D, hp.text_tokens_dict_size, bias=False),
        # the speech head has a bias only in the GPT-2 family
        "speech_head": init.linear(D, hp.speech_tokens_dict_size, bias=cfg.is_gpt),
        "cond_enc": {"spkr_enc": init.linear(hp.speaker_embed_size, D)},
    }
    if hp.emotion_adv:
        params["cond_enc"]["emotion_adv_fc"] = init.linear(1, D, bias=False)
    if hp.use_perceiver_resampler:
        params["cond_enc"]["perceiver"] = perceiver_init(init, D)
    if hp.input_pos_emb == "learned":
        params["text_pos_emb"] = init.embedding(hp.max_text_tokens + 2, D)
        params["speech_pos_emb"] = init.embedding(hp.max_speech_tokens + 4, D)
    return params


def cond_len(hp: T3Config) -> int:
    n = 1
    if hp.speech_cond_prompt_len:
        n += PERCEIVER_QUERIES if hp.use_perceiver_resampler else hp.speech_cond_prompt_len
    return n + (1 if hp.emotion_adv else 0)


# ---------------------------------------------------------------------------
# embeddings and heads
# ---------------------------------------------------------------------------

def cond_embeds(params: dict, hp: T3Config, cond: T3CondTensors) -> list:
    """The conditioning prefix as a list of (B, n, D) parts (the caller
    casts them to the compute type before concatenating)."""
    ce = params["cond_enc"]
    spkr = nn.linear(ce["spkr_enc"], cond.speaker_emb.reshape(-1, hp.speaker_embed_size))
    parts = [spkr[:, None]]
    if cond.cond_prompt_speech_tokens is not None:
        emb = nn.embedding(params["speech_emb"], cond.cond_prompt_speech_tokens)
        if hp.input_pos_emb == "learned":
            T = cond.cond_prompt_speech_tokens.shape[1]
            emb = emb + nn.embedding(params["speech_pos_emb"],
                                     torch.arange(T, device=emb.device))
        if hp.use_perceiver_resampler:
            emb = perceiver_apply(ce["perceiver"], emb)
        parts.append(emb)
    if hp.emotion_adv:
        parts.append(nn.linear(ce["emotion_adv_fc"], cond.emotion_adv.reshape(-1, 1, 1)))
    return parts


def text_embeds(params: dict, hp: T3Config, text_tokens: torch.Tensor,
                row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Lt) -> (B, Lt, D), each row's token embeddings times row_scale
    (B,) when given (CFG zeroes the uncond row), plus the learned text
    positions when configured."""
    emb = nn.embedding(params["text_emb"], text_tokens)
    if row_scale is not None:
        emb = emb * row_scale.to(emb.dtype)[:, None, None]
    if hp.input_pos_emb == "learned":
        emb = emb + nn.embedding(params["text_pos_emb"],
                                 torch.arange(text_tokens.shape[1], device=emb.device))
    return emb


def speech_embed_token(params: dict, hp: T3Config, token: torch.Tensor,
                       speech_pos: int) -> torch.Tensor:
    """Embed one speech token per row, token (B,), at speech-stream position
    speech_pos -> (B, 1, D)."""
    emb = nn.embedding(params["speech_emb"], token)
    if hp.input_pos_emb == "learned":
        emb = emb + params["speech_pos_emb"]["w"][speech_pos]
    return emb[:, None]


def speech_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    return nn.linear(params["speech_head"], hidden)


def text_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    return nn.linear(params["text_head"], hidden)


# ---------------------------------------------------------------------------
# teacher-forced training forward and loss
# ---------------------------------------------------------------------------

def t3_forward(params: dict, hp: T3Config, cond: T3CondTensors,
               text_tokens: torch.Tensor, speech_tokens: torch.Tensor,
               remat: bool = False, attn=bb.train_attention):
    """The dense [cond | text | speech] forward (cond broadcast to the
    batch when it has one row) -> (text logits (B, Lt, V_text), speech
    logits (B, Ls, V_speech)) over the text and speech segments. Inputs
    are padded to fixed lengths; the loss masks the pad. `attn` is
    `backbone_train`'s."""
    B, Lt = text_tokens.shape
    Ls = speech_tokens.shape[1]
    ce = torch.cat(cond_embeds(params, hp, cond), dim=1)
    if ce.shape[0] != B:
        ce = ce.expand(B, -1, -1)
    te = text_embeds(params, hp, text_tokens)
    se = nn.embedding(params["speech_emb"], speech_tokens)
    if hp.input_pos_emb == "learned":
        se = se + nn.embedding(params["speech_pos_emb"],
                               torch.arange(Ls, device=se.device))
    x = torch.cat([ce, te, se], dim=1)
    hidden = bb.backbone_train(params["backbone"], hp.backbone, x, remat=remat, attn=attn)
    Lc = ce.shape[1]
    return (text_logits(params, hidden[:, Lc:Lc + Lt]),
            speech_logits(params, hidden[:, Lc + Lt:Lc + Lt + Ls]))


def masked_ce(logits: torch.Tensor, targets: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of logits (B, L, V) against the same-position targets
    (B, L), in float32, over each row's first lens[b] positions, divided
    by the number of those positions (at least 1)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets[..., None].long())[..., 0]
    mask = torch.arange(targets.shape[1], device=targets.device)[None] < lens[:, None]
    return -(ll * mask).sum() / mask.sum().clamp(min=1)


def t3_loss(params: dict, hp: T3Config, cond: T3CondTensors,
            text_tokens: torch.Tensor, text_lens: torch.Tensor,
            speech_tokens: torch.Tensor, speech_lens: torch.Tensor,
            remat: bool = False, attn=bb.train_attention):
    """(loss_text, loss_speech): the masked cross-entropies of the text and
    speech segments' logits against their own tokens, as the reference
    trains its heads."""
    tl, sl = t3_forward(params, hp, cond, text_tokens, speech_tokens, remat=remat,
                        attn=attn)
    return masked_ce(tl, text_tokens, text_lens), masked_ce(sl, speech_tokens, speech_lens)
