"""Frozen reference copy of chatterbox_tpu_torch/models/s3gen/encoder.py at commit f7b8e4d,
plain PyTorch / numpy, importing nothing of the program under test.

Upsample conformer encoder: speech-token features -> 2x upsampled
mel-rate features (the counterpart of chatterbox_tpu/models/s3gen/encoder.py).

linear embed + LN -> espnet rel-pos -> PreLookahead(3) -> conformer blocks ->
nearest 2x upsample conv -> linear embed + LN -> conformer blocks -> LN.
Each block: pre-norm rel-pos MHA (Transformer-XL pos_bias_u/v + rel_shift)
and a pre-norm SiLU feed-forward. One utterance runs at its exact length
with no mask; a batch of rows of different lengths (the batched vocode)
passes `lens`, which masks each row's keys past its length and zeroes its
pad before the lookahead conv, so each row's frames are its exact-length
result up to rounding.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import nn


def espnet_rel_pos(T: int, d_model: int) -> np.ndarray:
    """(1, 2T-1, d) relative position encoding: positive positions reversed,
    then negative ones (the slice espnet produces for a length-T query)."""
    pos = np.arange(T, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe_pos = np.zeros((T, d_model))
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg = np.zeros((T, d_model))
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    pe = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)
    return pe[None].astype(np.float32)


_REL_POS: dict = {}        # (d, device, dtype) -> the longest table made so far


def rel_pos_table(T: int, d: int, device, dtype) -> torch.Tensor:
    """espnet_rel_pos(T, d) on `device`: the middle 2T-1 rows of one longer
    table per (d, device, dtype), made on the host and copied once (through
    pinned memory on the card, so a call never waits for the device)."""
    key = (d, str(device), dtype)
    tab = _REL_POS.get(key)
    if tab is None or (tab.shape[1] + 1) // 2 < T:
        t = torch.from_numpy(espnet_rel_pos(max(T, 1024), d))
        if torch.device(device).type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        _REL_POS[key] = tab = t.to(device, dtype)
    n = (tab.shape[1] + 1) // 2
    return tab[:, n - T:n - 1 + T]


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T) Transformer-XL shift."""
    B, H, T, L = x.shape
    x_padded = torch.cat([x.new_zeros((B, H, T, 1)), x], dim=-1)
    x_padded = x_padded.reshape(B, H, L + 1, T)
    return x_padded[:, :, 1:].reshape(B, H, T, L)[..., : L // 2 + 1]


def rel_attn_init(init: nn.Init, d: int, n_heads: int) -> dict:
    hd = d // n_heads
    bound = math.sqrt(6.0 / (n_heads + hd))
    return {"q": init.linear(d, d), "k": init.linear(d, d),
            "v": init.linear(d, d), "out": init.linear(d, d),
            "pos": init.linear(d, d, bias=False),
            "pos_bias_u": init.uniform((n_heads, hd), bound),
            "pos_bias_v": init.uniform((n_heads, hd), bound)}


def rel_attn_apply(p: dict, x: torch.Tensor, pos_emb: torch.Tensor,
                   n_heads: int, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, T, D); key_mask (B, T) bool or None (every key attends)."""
    B, T, D = x.shape
    hd = D // n_heads
    q = nn.split_heads(nn.linear(p["q"], x), n_heads)
    k = nn.split_heads(nn.linear(p["k"], x), n_heads)
    v = nn.split_heads(nn.linear(p["v"], x), n_heads)
    pe = nn.linear(p["pos"], pos_emb).reshape(1, -1, n_heads, hd).transpose(1, 2)
    ac = (q + p["pos_bias_u"][None, :, None, :]) @ k.transpose(-1, -2)
    bd = rel_shift((q + p["pos_bias_v"][None, :, None, :]) @ pe.transpose(-1, -2))
    scores = (ac + bd) / math.sqrt(hd)
    if key_mask is None:
        probs = torch.softmax(scores, dim=-1)
    else:
        m = key_mask[:, None, None, :]
        low = torch.finfo(scores.dtype).min
        probs = torch.where(m, torch.softmax(torch.where(m, scores, low), dim=-1), 0.0)
    return nn.linear(p["out"], nn.merge_heads(probs.to(v.dtype) @ v))


def conformer_layer_init(init: nn.Init, d: int, n_heads: int, ff: int) -> dict:
    return {"norm_mha": init.layer_norm(d), "attn": rel_attn_init(init, d, n_heads),
            "norm_ff": init.layer_norm(d), "ff_in": init.linear(d, ff),
            "ff_out": init.linear(ff, d)}


def conformer_layer_apply(p: dict, x, pos_emb, n_heads: int, key_mask=None):
    """Pre-norm attention + pre-norm SiLU FF, LN eps 1e-12."""
    x = x + rel_attn_apply(p["attn"], nn.layer_norm(p["norm_mha"], x, 1e-12),
                           pos_emb, n_heads, key_mask)
    h = nn.layer_norm(p["norm_ff"], x, 1e-12)
    return x + nn.linear(p["ff_out"], nn.silu(nn.linear(p["ff_in"], h)))


def upsample_encoder_init(init: nn.Init, d: int = 512, n_heads: int = 8,
                          ff: int = 2048, n_blocks: int = 6,
                          n_up_blocks: int = 4, lookahead: int = 3) -> dict:
    return {
        "embed": {"linear": init.linear(d, d), "norm": init.layer_norm(d)},
        "pre_lookahead": {"conv1": init.conv1d(d, d, lookahead + 1),
                          "conv2": init.conv1d(d, d, 3)},
        "blocks": [conformer_layer_init(init, d, n_heads, ff) for _ in range(n_blocks)],
        "up_conv": init.conv1d(d, d, 5),
        "up_embed": {"linear": init.linear(d, d), "norm": init.layer_norm(d)},
        "up_blocks": [conformer_layer_init(init, d, n_heads, ff)
                      for _ in range(n_up_blocks)],
        "after_norm": init.layer_norm(d),
    }


def _embed(p: dict, x: torch.Tensor, d: int):
    """Linear + LN(eps 1e-5), scaled by sqrt(d), plus the rel-pos table."""
    x = nn.layer_norm(p["norm"], nn.linear(p["linear"], x), 1e-5) * math.sqrt(d)
    pos = rel_pos_table(x.shape[1], d, x.device, x.dtype)
    return x, pos


def pre_lookahead_apply(p: dict, x: torch.Tensor, lookahead: int = 3):
    """Right-context conv + causal conv, residual."""
    h = nn.leaky_relu(nn.conv1d(p["conv1"], x, padding=(0, lookahead)), 0.01)
    return x + nn.conv1d(p["conv2"], h, padding=(2, 0))


def upsample_encoder_apply(params: dict, x: torch.Tensor, d: int = 512,
                           n_heads: int = 8, lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, T, d) token features -> (B, 2T, d). lens (B,) long: each row's
    valid tokens (None: every row is T long); frames past 2 * lens[b] of
    row b are rubbish for the caller to mask."""
    key_mask = key_mask2 = None
    if lens is not None:
        key_mask = torch.arange(x.shape[1], device=x.device)[None] < lens[:, None]
        key_mask2 = torch.arange(2 * x.shape[1], device=x.device)[None] < 2 * lens[:, None]
    x, pos = _embed(params["embed"], x, d)
    if key_mask is not None:
        # the lookahead conv then sees the zeros an exact-length run sees
        x = x * key_mask[..., None].to(x.dtype)
    x = pre_lookahead_apply(params["pre_lookahead"], x)
    for blk in params["blocks"]:
        x = conformer_layer_apply(blk, x, pos, n_heads, key_mask)
    # nearest x2, then a left-padded conv k=5
    x = nn.conv1d(params["up_conv"], torch.repeat_interleave(x, 2, dim=1),
                  padding=(4, 0))
    x, pos2 = _embed(params["up_embed"], x, d)
    for blk in params["up_blocks"]:
        x = conformer_layer_apply(blk, x, pos2, n_heads, key_mask2)
    return nn.layer_norm(params["after_norm"], x, 1e-5)
