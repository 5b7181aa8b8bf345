"""T3 parameters, conditioning prefix, embeddings and heads (the Turbo/Nano
GPT-2 subset of chatterbox_tpu/models/t3/model.py).

For Turbo the conditioning prefix is [spkr_enc(speaker_emb) (1 token) |
speech_emb of the 375 prompt tokens]: no perceiver, no emotion input and
no learned positional embedding, so Lc = 376.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...nn import core as nn
from . import backbone as bb
from .config import T3Config


class T3CondTensors(NamedTuple):
    speaker_emb: torch.Tensor                          # (B, 256)
    cond_prompt_speech_tokens: Optional[torch.Tensor]  # (B, plen) long or None


def check_supported(hp: T3Config):
    if (hp.use_perceiver_resampler or hp.emotion_adv
            or hp.input_pos_emb == "learned" or not hp.backbone.is_gpt):
        raise NotImplementedError(
            "only the GPT-2 Turbo/Nano T3 is ported; the 520M CFG family "
            "(perceiver, emotion input, learned positions) comes later")


def t3_init(hp: T3Config, seed: int = 0, device="cuda") -> dict:
    """Random T3 parameters (float32) from a seeded torch.Generator."""
    check_supported(hp)
    if max(hp.start_speech_token, hp.stop_speech_token) >= hp.speech_tokens_dict_size:
        raise ValueError("speech special tokens outside the embedding table")
    init = nn.Init(seed, device)
    D = hp.backbone.hidden_size
    return {
        "backbone": bb.init_backbone(init, hp.backbone),
        "text_emb": init.embedding(hp.text_tokens_dict_size, D),
        "speech_emb": init.embedding(hp.speech_tokens_dict_size, D),
        "text_head": init.linear(D, hp.text_tokens_dict_size, bias=False),
        "speech_head": init.linear(D, hp.speech_tokens_dict_size, bias=True),
        "cond_enc": {"spkr_enc": init.linear(hp.speaker_embed_size, D)},
    }


def cond_len(hp: T3Config) -> int:
    return 1 + (hp.speech_cond_prompt_len or 0)


def cond_embeds(params: dict, hp: T3Config, cond: T3CondTensors) -> list:
    """The conditioning prefix as a list of (B, n, D) parts (the caller
    casts them to the compute type before concatenating)."""
    spkr = nn.linear(params["cond_enc"]["spkr_enc"],
                     cond.speaker_emb.reshape(-1, hp.speaker_embed_size))
    parts = [spkr[:, None]]
    if cond.cond_prompt_speech_tokens is not None:
        parts.append(nn.embedding(params["speech_emb"],
                                  cond.cond_prompt_speech_tokens))
    return parts


def speech_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    return nn.linear(params["speech_head"], hidden)
