"""T3's GPT-2 decoder backbone with a preallocated, in-place KV cache.

The counterpart of chatterbox_tpu/models/t3/backbone.py (GPT-2 branches of
`backbone_apply_unrolled`):
  * prefill runs the unfused layer over the dense prefix (int8 `linear`
    is a plain large matrix product);
  * a single-token decode step runs each layer as the two fused int8
    kernels (kernels/fused_layer.py) around plain attention;
  * the KV cache is one (L, B, H, T_max, head_dim) bf16 pair written in
    place; attention reads keys [0, cur] only, so no mask is needed at
    decode and prefill masks causally.
"""
from __future__ import annotations

import torch

from ...nn import core as nn
from ...kernels.fused_layer import (apply_fused_gpt2_mlp_int8,
                                    apply_fused_gpt2_qkv_int8)
from .config import BackboneConfig


def init_backbone(init: nn.Init, cfg: BackboneConfig) -> dict:
    if not cfg.is_gpt:
        raise NotImplementedError("only the GPT-2 backbone is ported")
    D, I = cfg.hidden_size, cfg.intermediate_size
    layers = [{
        "ln1": init.layer_norm(D),
        "qkv": init.linear(D, 3 * D),
        "attn_out": init.linear(D, D),
        "ln2": init.layer_norm(D),
        "fc_in": init.linear(D, I),
        "fc_out": init.linear(I, D),
    } for _ in range(cfg.num_layers)]
    return {"layers": layers,
            "wpe": init.embedding(cfg.max_positions, D, std=0.01),
            "ln_f": init.layer_norm(D)}


class KVCache:
    """Preallocated (L, B, H, T_max, head_dim) K and V, updated in place."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k, self.v = k, v

    @classmethod
    def zeros(cls, cfg: BackboneConfig, batch: int, max_len: int, device,
              dtype=torch.bfloat16) -> "KVCache":
        shape = (cfg.num_layers, batch, cfg.num_heads, max_len, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def backbone_apply(params: dict, cfg: BackboneConfig, embeds: torch.Tensor,
                   positions: torch.Tensor, cache: KVCache,
                   start: int) -> torch.Tensor:
    """Run the layers over embeds (B, t, D) at cache offset `start` (a host
    int: every row is at the same position), writing K/V into
    cache[:, :, :, start:start+t]. Query i attends to keys [0, start+i].
    Returns the final-norm hidden states (B, t, D)."""
    B, t, D = embeds.shape
    end = start + t
    if end > cache.max_len:
        raise ValueError(f"cache of {cache.max_len} positions cannot hold {end}")
    x = embeds + nn.embedding(params["wpe"], positions).to(embeds.dtype)
    mask = None
    if t > 1:
        q_pos = torch.arange(start, end, device=x.device)[:, None]
        mask = torch.arange(end, device=x.device)[None, :] <= q_pos
    eps = cfg.layer_norm_eps
    for i, lp in enumerate(params["layers"]):
        fused = "fused" in lp and t == 1
        if fused:
            qkv = apply_fused_gpt2_qkv_int8(lp["fused"], x[:, 0], eps)
            qkv = qkv.to(x.dtype)[:, None, :]
        else:
            qkv = nn.linear(lp["qkv"], nn.layer_norm(lp["ln1"], x, eps))
        q, k, v = qkv.split(D, dim=-1)
        q = nn.split_heads(q, cfg.num_heads)
        cache.k[i, :, :, start:end] = nn.split_heads(k, cfg.num_heads)
        cache.v[i, :, :, start:end] = nn.split_heads(v, cfg.num_heads)
        ck = cache.k[i, :, :, :end].to(q.dtype)
        cv = cache.v[i, :, :, :end].to(q.dtype)
        attn = nn.merge_heads(nn.mha(q, ck, cv, mask=mask))
        if fused:
            x = apply_fused_gpt2_mlp_int8(lp["fused"], attn[:, 0].to(x.dtype),
                                          x[:, 0], eps).to(x.dtype)[:, None, :]
        else:
            x = x + nn.linear(lp["attn_out"], attn)
            y = nn.layer_norm(lp["ln2"], x, eps)
            x = x + nn.linear(lp["fc_out"], nn.gelu_new(nn.linear(lp["fc_in"], y)))
    return nn.layer_norm(params["ln_f"], x, eps)
