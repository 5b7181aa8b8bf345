"""T3's decoder backbones (GPT-2 for Turbo/Nano, llama for the 520M CFG
family) with a preallocated, in-place KV cache.

The counterpart of chatterbox_tpu/models/t3/backbone.py
(`backbone_apply_unrolled`):
  * prefill runs the unfused layer over the dense prefix (int8 `linear`
    is a plain large matrix product);
  * a single-token decode step runs each layer as its family's two fused
    int8 kernels (kernels/fused_layer.py) around plain attention; llama
    applies RoPE to q and k between the two;
  * the KV cache is one (L, B, H_kv, T_max, head_dim) bf16 pair written in
    place; attention reads keys [0, cur] only, so no mask is needed at
    decode and prefill masks causally.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...nn import core as nn
from ...kernels.fused_layer import (apply_fused_gpt2_mlp_int8,
                                    apply_fused_gpt2_qkv_int8,
                                    apply_fused_llama_mlp_int8,
                                    apply_fused_llama_qkv_int8, llama_mlp_tile)
from .config import BackboneConfig


# ---------------------------------------------------------------------------
# RoPE (llama3 scaling)
# ---------------------------------------------------------------------------

def llama3_inv_freq(cfg: BackboneConfig) -> np.ndarray:
    """Llama-3 frequency scaling, computed in float64 and stored as f32."""
    d = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    low_wl = cfg.rope_original_max_pos / cfg.rope_low_freq_factor
    high_wl = cfg.rope_original_max_pos / cfg.rope_high_freq_factor
    wavelen = 2.0 * np.pi / inv_freq
    scaled = inv_freq / cfg.rope_scaling_factor
    smooth = (cfg.rope_original_max_pos / wavelen - cfg.rope_low_freq_factor) / (
        cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
    smoothed = (1 - smooth) * scaled + smooth * inv_freq
    out = np.where(wavelen < high_wl, inv_freq,
                   np.where(wavelen > low_wl, scaled, smoothed))
    return out.astype(np.float32)


@functools.lru_cache(maxsize=8)
def inv_freq_tensor(cfg: BackboneConfig, device: torch.device) -> torch.Tensor:
    """llama3_inv_freq on `device`, made once per (config, device) so the
    decode step copies nothing from the host."""
    return torch.from_numpy(llama3_inv_freq(cfg)).to(device)


def rope_cos_sin(inv_freq: torch.Tensor, positions: torch.Tensor):
    """positions (B, T) int -> cos, sin (B, T, head_dim) f32."""
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, T, D); HF rotate-half convention."""
    cos, sin = cos[:, None], sin[:, None]
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return x * cos + rot * sin


# ---------------------------------------------------------------------------
# parameters and cache
# ---------------------------------------------------------------------------

def init_backbone(init: nn.Init, cfg: BackboneConfig) -> dict:
    D, I = cfg.hidden_size, cfg.intermediate_size
    if cfg.is_gpt:
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
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    layers = [{
        "input_ln": init.rms_norm(D),
        "q": init.linear(D, H * hd, bias=False),
        "k": init.linear(D, KV * hd, bias=False),
        "v": init.linear(D, KV * hd, bias=False),
        "o": init.linear(H * hd, D, bias=False),
        "post_ln": init.rms_norm(D),
        "gate": init.linear(D, I, bias=False),
        "up": init.linear(D, I, bias=False),
        "down": init.linear(I, D, bias=False),
    } for _ in range(cfg.num_layers)]
    return {"layers": layers, "norm": init.rms_norm(D)}


def kv_heads(cfg: BackboneConfig) -> int:
    return cfg.num_heads if cfg.is_gpt else cfg.num_kv_heads


class KVCache:
    """Preallocated (L, B, H_kv, T_max, head_dim) K and V, updated in place."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k, self.v = k, v

    @classmethod
    def zeros(cls, cfg: BackboneConfig, batch: int, max_len: int, device,
              dtype=torch.bfloat16) -> "KVCache":
        shape = (cfg.num_layers, batch, kv_heads(cfg), max_len, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _qkv(lp: dict, cfg: BackboneConfig, x: torch.Tensor, fused: bool, rope):
    """q (B, H, t, hd) and k, v (B, H_kv, t, hd) of one layer."""
    D = cfg.hidden_size
    if cfg.is_gpt:
        if fused:
            qkv = apply_fused_gpt2_qkv_int8(lp["fused"], x[:, 0], cfg.layer_norm_eps)
            qkv = qkv.to(x.dtype)[:, None, :]
        else:
            qkv = nn.linear(lp["qkv"], nn.layer_norm(lp["ln1"], x, cfg.layer_norm_eps))
        q, k, v = qkv.split(D, dim=-1)
    else:
        if fused:
            qkv = apply_fused_llama_qkv_int8(lp["fused"], x[:, 0], cfg.rms_norm_eps)
            nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
            q, k, v = qkv.to(x.dtype)[:, None, :].split([nq, nkv, nkv], dim=-1)
        else:
            y = nn.rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)
            q, k, v = (nn.linear(lp[n], y) for n in ("q", "k", "v"))
    q = nn.split_heads(q, cfg.num_heads)
    k = nn.split_heads(k, kv_heads(cfg))
    v = nn.split_heads(v, kv_heads(cfg))
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    return q, k, v


def _after_attn(lp: dict, cfg: BackboneConfig, x: torch.Tensor, attn: torch.Tensor,
                fused: bool) -> torch.Tensor:
    """Attention output projection, residual and MLP: the new x (B, t, D)."""
    if fused:
        if cfg.is_gpt:
            out = apply_fused_gpt2_mlp_int8(lp["fused"], attn[:, 0].to(x.dtype),
                                            x[:, 0], cfg.layer_norm_eps)
        else:
            out = apply_fused_llama_mlp_int8(lp["fused"], attn[:, 0].to(x.dtype),
                                             x[:, 0], cfg.rms_norm_eps,
                                             llama_mlp_tile(cfg))
        return out.to(x.dtype)[:, None, :]
    if cfg.is_gpt:
        eps = cfg.layer_norm_eps
        x = x + nn.linear(lp["attn_out"], attn)
        y = nn.layer_norm(lp["ln2"], x, eps)
        return x + nn.linear(lp["fc_out"], nn.gelu_new(nn.linear(lp["fc_in"], y)))
    x = x + nn.linear(lp["o"], attn)
    y = nn.rms_norm(lp["post_ln"], x, cfg.rms_norm_eps)
    return x + nn.linear(lp["down"],
                         nn.silu(nn.linear(lp["gate"], y)) * nn.linear(lp["up"], y))


def backbone_apply(params: dict, cfg: BackboneConfig, embeds: torch.Tensor,
                   positions: torch.Tensor, cache: KVCache,
                   start: int) -> torch.Tensor:
    """Run the layers over embeds (B, t, D) at cache offset `start` (a host
    int: every row is at the same position), writing K/V into
    cache[:, :, :, start:start+t]. Query i attends to keys [0, start+i].
    positions (B, t) index the learned (GPT-2) or rotary (llama) positions.
    Returns the final-norm hidden states (B, t, D)."""
    B, t, D = embeds.shape
    end = start + t
    if end > cache.max_len:
        raise ValueError(f"cache of {cache.max_len} positions cannot hold {end}")
    x = embeds
    rope = None
    if cfg.is_gpt:
        x = x + nn.embedding(params["wpe"], positions).to(x.dtype)
    else:
        # cos and sin in the activation type, as the JAX package casts them
        rope = tuple(c.to(x.dtype) for c in
                     rope_cos_sin(inv_freq_tensor(cfg, x.device), positions))
    mask = None
    if t > 1:
        q_pos = torch.arange(start, end, device=x.device)[:, None]
        mask = torch.arange(end, device=x.device)[None, :] <= q_pos
    rep = cfg.num_heads // kv_heads(cfg)
    for i, lp in enumerate(params["layers"]):
        fused = "fused" in lp and t == 1
        q, k, v = _qkv(lp, cfg, x, fused, rope)
        cache.k[i, :, :, start:end] = k
        cache.v[i, :, :, start:end] = v
        ck = cache.k[i, :, :, :end].to(q.dtype)
        cv = cache.v[i, :, :, :end].to(q.dtype)
        if rep > 1:
            ck, cv = ck.repeat_interleave(rep, dim=1), cv.repeat_interleave(rep, dim=1)
        attn = nn.merge_heads(nn.mha(q, ck, cv, mask=mask))
        x = _after_attn(lp, cfg, x, attn, fused)
    if cfg.is_gpt:
        return nn.layer_norm(params["ln_f"], x, cfg.layer_norm_eps)
    return nn.rms_norm(params["norm"], x, cfg.rms_norm_eps)
