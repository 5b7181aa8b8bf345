"""T3's decoder backbones (GPT-2 for Turbo/Nano, llama for the 520M CFG
family) with a preallocated, in-place KV cache.

The counterpart of chatterbox_tpu/models/t3/backbone.py
(`backbone_apply_unrolled`):
  * prefill runs the unfused layer over the prefix (int8 `linear` is a
    plain large matrix product);
  * a single-token decode step runs each layer that carries "fused"
    operands as its family's two fused kernels (kernels/fused_layer.py)
    around attention: the int8 pair, or GPT-2's int4 pair where the
    operands are int4 ("qkv_wpt"); llama applies RoPE to q and k between
    the two. Unfused int4 layers reach B8 through `nn.linear`;
  * the KV cache is one (L, B, H_kv, T_max, head_dim) bf16 pair
    (`KVCache`), or int8 values with one bf16 scale per position
    (`KVCacheInt8`), written in place at one offset shared by every row;
  * attention over the cache: with `fused_attn` a single-token step takes
    the decode-attention kernels (kernels/decode_attention.py): B4 over the
    int8 cache (MHA heads, tile-aligned cache), B3 over a tile-aligned bf16
    cache, B7 over an unaligned one; otherwise plain attention (`nn.mha`)
    over keys [0, end), the int8 cache dequantized first;
  * `kv_lo` (B,) is the batched layout's per-row left pad: keys below it
    are masked (and skipped by B3 / B4), positions are given per row.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.utils.checkpoint

from ...nn import core as nn
from ...kernels.decode_attention import (TT, decode_attention,
                                         decode_attention_streamed,
                                         decode_attention_streamed_int8)
from ...kernels.fused_layer import (apply_fused_gpt2_mlp, apply_fused_gpt2_mlp_int8,
                                    apply_fused_gpt2_qkv, apply_fused_gpt2_qkv_int8,
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
              dtype=torch.bfloat16, heads: int = 0) -> "KVCache":
        """heads: the KV heads held (a tensor-parallel process's share;
        default all of them)."""
        shape = (cfg.num_layers, batch, heads or kv_heads(cfg), max_len, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


class KVCacheInt8:
    """Int8 KV cache: k_q, v_q (L, B, H_kv, T_max, head_dim) int8 and one
    scale per position, k_s, v_s (L, B, H_kv, T_max, 1) bf16; updated in
    place. Half the bytes a decode step reads from the bf16 cache."""

    def __init__(self, k_q: torch.Tensor, v_q: torch.Tensor, k_s: torch.Tensor,
                 v_s: torch.Tensor):
        self.k_q, self.v_q, self.k_s, self.v_s = k_q, v_q, k_s, v_s

    @classmethod
    def zeros(cls, cfg: BackboneConfig, batch: int, max_len: int, device,
              dtype=torch.bfloat16, heads: int = 0) -> "KVCacheInt8":
        shape = (cfg.num_layers, batch, heads or kv_heads(cfg), max_len, cfg.head_dim)
        z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
        return cls(z(shape, torch.int8), z(shape, torch.int8),
                   z(shape[:-1] + (1,), dtype), z(shape[:-1] + (1,), dtype))

    @property
    def max_len(self) -> int:
        return self.k_q.shape[3]


def quantize_kv(x: torch.Tensor):
    """x (..., D), e.g. (B, H, t, D) -> (int8 values, (..., 1) f32 scales): symmetric
    per-position max-abs scaling, s = max|x| / 127 in f32 and
    q = round(x / max(s, 1e-8)) clipped to +-127 (round half to even)."""
    xf = x.float()
    s = xf.abs().amax(-1, keepdim=True) / 127.0
    q = torch.round(xf / torch.clamp(s, min=1e-8))
    return q.clamp(-127, 127).to(torch.int8), s


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _qkv(lp: dict, cfg: BackboneConfig, x: torch.Tensor, fused: bool, rope, heads=None):
    """q (B, H, t, hd) and k, v (B, H_kv, t, hd) of one layer; with `heads`
    (parallel.mesh.HeadShards) this process's heads of each, as plain
    tensors, before RoPE."""
    D = cfg.hidden_size
    if cfg.is_gpt:
        if fused:
            f_qkv = (apply_fused_gpt2_qkv if "qkv_wpt" in lp["fused"]
                     else apply_fused_gpt2_qkv_int8)
            qkv = f_qkv(lp["fused"], x[:, 0], cfg.layer_norm_eps)
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
    if heads is not None:
        q, k, v = heads.local(q, k, v)
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    return q, k, v


def _after_attn(lp: dict, cfg: BackboneConfig, x: torch.Tensor, attn: torch.Tensor,
                fused: bool) -> torch.Tensor:
    """Attention output projection, residual and MLP: the new x (B, t, D)."""
    if fused:
        if cfg.is_gpt:
            f_mlp = (apply_fused_gpt2_mlp if "qkv_wpt" in lp["fused"]
                     else apply_fused_gpt2_mlp_int8)
            out = f_mlp(lp["fused"], attn[:, 0].to(x.dtype), x[:, 0], cfg.layer_norm_eps)
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


def _attn_core(q, ck, cv, cur, mask, end: int, fused: bool, kv_lo=None):
    """Attention of q (B, H, t, hd) over the cache ck, cv (B, H_kv, T, hd),
    whose heads repeat to H (GQA). Single-token steps with `fused` take a
    decode-attention kernel over the whole cache with cur (B,) int32: B3
    when T is tile-aligned, else B7 when no lower bound is given. Otherwise
    `nn.mha` over keys [0, end) in q's type, under `mask` (None: every one
    of those keys attends)."""
    rep = q.shape[1] // ck.shape[1]
    if rep > 1:
        ck, cv = ck.repeat_interleave(rep, dim=1), cv.repeat_interleave(rep, dim=1)
    if fused and q.shape[2] == 1:
        if ck.shape[2] % TT == 0:
            return decode_attention_streamed(q, ck, cv, cur, lo=kv_lo)
        if kv_lo is None:
            return decode_attention(q, ck, cv, cur)
    return nn.mha(q, ck[:, :, :end].to(q.dtype), cv[:, :, :end].to(q.dtype), mask=mask)


def _keep_mask(start: int, t: int, end: int, kv_lo, device):
    """Keep-mask of queries at slots [start, end) over keys [0, end):
    causal, and keys at or above each row's kv_lo. None when every key
    attends (a single-token step without a lower bound)."""
    k_pos = torch.arange(end, device=device)
    mask = None
    if t > 1:
        mask = k_pos[None, :] <= torch.arange(start, end, device=device)[:, None]
    if kv_lo is not None:
        lo_ok = (k_pos[None, :] >= kv_lo[:, None])[:, None, None]   # (B, 1, 1, end)
        mask = lo_ok if mask is None else mask & lo_ok
    return mask


def backbone_apply(params: dict, cfg: BackboneConfig, embeds: torch.Tensor,
                   positions: torch.Tensor, cache, start: int, kv_lo=None,
                   fused_attn: bool = False, heads=None) -> torch.Tensor:
    """Run the layers over embeds (B, t, D) at cache offset `start` (a host
    int shared by every row), writing K/V into cache[:, :, :, start:start+t]
    (`KVCache`, or `KVCacheInt8` quantized by `quantize_kv`). Query i
    attends to keys [kv_lo[b], start+i] (kv_lo (B,) device ints, default
    0). positions (B, t) index the learned (GPT-2) or rotary (llama)
    positions. fused_attn lets single-token steps take the decode-attention
    kernels (see `_attn_core`). Over params sharded on a mesh (DTensors),
    `heads` (parallel.mesh.HeadShards) hands each layer's q, k and v to the
    cache and the attention as this process's heads, on plain tensors, and
    the attention's output back to the row-parallel projection; the cache
    then holds those heads only. Returns the final-norm hidden states
    (B, t, D)."""
    B, t, D = embeds.shape
    end = start + t
    if end > cache.max_len:
        raise ValueError(f"cache of {cache.max_len} positions cannot hold {end}")
    x = embeds
    dev = x.device
    rope = None
    if cfg.is_gpt:
        x = x + nn.embedding(params["wpe"], positions).to(x.dtype)
    else:
        # cos and sin in the activation type, as the JAX package casts them
        rope = tuple(c.to(x.dtype) for c in
                     rope_cos_sin(inv_freq_tensor(cfg, dev), positions))
    int8 = isinstance(cache, KVCacheInt8)
    mha_heads = cfg.num_heads == kv_heads(cfg)
    fused_step = fused_attn and t == 1
    cur = torch.full((B,), start, dtype=torch.int32, device=dev) if fused_step else None
    mask = _keep_mask(start, t, end, kv_lo, dev)
    stop = cache.max_len if fused_step else end     # the kernels take the whole cache
    for i, lp in enumerate(params["layers"]):
        fused = "fused" in lp and t == 1
        q, k, v = _qkv(lp, cfg, x, fused, rope, heads)
        if fused_step:
            q = q.contiguous()     # the kernels take (B, H, 1, hd) packed
        if int8:
            kvq, kvs = quantize_kv(torch.stack((k, v)))     # K and V in one pass
            kvs = kvs.to(cache.k_s.dtype)
            cache.k_q[i, :, :, start:end] = kvq[0]
            cache.v_q[i, :, :, start:end] = kvq[1]
            cache.k_s[i, :, :, start:end] = kvs[0]
            cache.v_s[i, :, :, start:end] = kvs[1]
            if fused_step and mha_heads and cache.max_len % TT == 0:
                attn = decode_attention_streamed_int8(
                    q, cache.k_q[i], cache.k_s[i][..., 0], cache.v_q[i],
                    cache.v_s[i][..., 0], cur, lo=kv_lo)
            else:
                # dequantized and rounded in the activation type, as the
                # JAX package does
                deq = lambda c_q, c_s: (c_q[i, :, :, :stop].to(q.dtype)
                                        * c_s[i, :, :, :stop].to(q.dtype))
                attn = _attn_core(q, deq(cache.k_q, cache.k_s), deq(cache.v_q, cache.v_s),
                                  cur, mask, end, fused_step, kv_lo)
        else:
            cache.k[i, :, :, start:end] = k
            cache.v[i, :, :, start:end] = v
            attn = _attn_core(q, cache.k[i, :, :, :stop], cache.v[i, :, :, :stop], cur,
                              mask, end, fused_step, kv_lo)
        attn = nn.merge_heads(attn)
        if heads is not None:
            attn = heads.join(attn)
        x = _after_attn(lp, cfg, x, attn, fused)
    if cfg.is_gpt:
        return nn.layer_norm(params["ln_f"], x, cfg.layer_norm_eps)
    return nn.rms_norm(params["norm"], x, cfg.rms_norm_eps)


def backbone_step_rows(params: dict, cfg: BackboneConfig, embeds: torch.Tensor,
                       pos: torch.Tensor, cache, fused_attn: bool = False) -> torch.Tensor:
    """One single-token decode step whose cache offset differs per row (the
    slot engine's left-aligned rows, sampling/continuous.py): embeds
    (B, 1, D), pos (B,) long on the device, each row's position. K and V
    (and, for `KVCacheInt8`, their scales) are written at cache[:, b, :,
    pos[b]] by indexed writes, so nothing is read on the host; the learned
    (GPT-2) or rotary (llama) positions are each row's own pos, and row b
    attends to keys [0, pos[b]]. Layers with "fused" operands run their two
    fused kernels. With fused_attn the decode-attention kernels take pos as
    their per-row `cur` over the whole cache (B4 on the int8 cache with MHA
    heads, B3 / B7 on the bf16 cache); otherwise plain attention over the
    whole cache under the key mask. Returns the final-norm hidden states
    (B, 1, D)."""
    if embeds.shape[1] != 1:
        raise ValueError(f"a per-row step feeds one token a row, got {embeds.shape[1]}")
    return _rows_forward(params, cfg, embeds, pos, cache, fused_attn)


def backbone_slab_rows(params: dict, cfg: BackboneConfig, embeds: torch.Tensor,
                       pos0: torch.Tensor, cache) -> torch.Tensor:
    """A slab of s tokens a row at per-row cache offsets (the speculative
    slot path's verify, sampling/continuous.py `decode_chunk_multi_spec`;
    the JAX package's `backbone_apply_unrolled` with a (B,) start): embeds
    (B, s, D), pos0 (B,) long on the device, each row's base position.
    Per layer, K and V are written at cache[:, b, :, pos0[b] + j] first,
    then attended, so the slab overwrites what stood at its positions (the
    draft's int8-computed K / V); query j of row b attends to keys
    [0, pos0[b] + j] over the whole cache, at learned or rotary position
    pos0[b] + j. Plain layers and plain attention (the fused kernels take
    one query); the bf16 cache only. Returns the final-norm hidden states
    (B, s, D)."""
    if isinstance(cache, KVCacheInt8):
        raise ValueError("a multi-token slab verifies into the bf16 cache, not KVCacheInt8")
    return _rows_forward(params, cfg, embeds, pos0, cache, False)


def _rows_forward(params: dict, cfg: BackboneConfig, embeds: torch.Tensor,
                  pos0: torch.Tensor, cache, fused_attn: bool) -> torch.Tensor:
    """The layers over embeds (B, t, D) at per-row positions pos0[b] + j
    (see backbone_step_rows and backbone_slab_rows). Fused layers and the
    decode-attention kernels take single-token steps only."""
    B, t, D = embeds.shape
    x = embeds
    dev = x.device
    pos = pos0.reshape(B, 1).long() + torch.arange(t, device=dev)     # (B, t)
    rope = None
    if cfg.is_gpt:
        x = x + nn.embedding(params["wpe"], pos).to(x.dtype)
    else:
        rope = tuple(c.to(x.dtype) for c in
                     rope_cos_sin(inv_freq_tensor(cfg, dev), pos))
    int8 = isinstance(cache, KVCacheInt8)
    T = cache.max_len
    rows = torch.arange(B, device=dev)[:, None]
    step = t == 1
    fused_attn = fused_attn and step
    cur = pos[:, 0].to(torch.int32)
    mask = (torch.arange(T, device=dev) <= pos[:, :, None])[:, None]   # (B, 1, t, T)
    int8_kernel = (int8 and fused_attn and cfg.num_heads == kv_heads(cfg)
                   and T % TT == 0)
    for i, lp in enumerate(params["layers"]):
        fused = "fused" in lp and step
        q, k, v = _qkv(lp, cfg, x, fused, rope)
        if fused_attn:
            q = q.contiguous()     # the kernels take (B, H, 1, hd) packed
        # the writes index (row, position) pairs: values (B, t, H, hd)
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        if int8:
            kvq, kvs = quantize_kv(torch.stack((k, v)))
            kvs = kvs.to(cache.k_s.dtype)
            cache.k_q[i, rows, :, pos] = kvq[0]
            cache.v_q[i, rows, :, pos] = kvq[1]
            cache.k_s[i, rows, :, pos] = kvs[0]
            cache.v_s[i, rows, :, pos] = kvs[1]
            if int8_kernel:
                attn = decode_attention_streamed_int8(
                    q, cache.k_q[i], cache.k_s[i][..., 0], cache.v_q[i],
                    cache.v_s[i][..., 0], cur)
            else:
                deq = lambda c_q, c_s: c_q[i].to(q.dtype) * c_s[i].to(q.dtype)
                attn = _attn_core(q, deq(cache.k_q, cache.k_s), deq(cache.v_q, cache.v_s),
                                  cur, mask, T, fused_attn)
        else:
            cache.k[i, rows, :, pos] = k.to(cache.k.dtype)
            cache.v[i, rows, :, pos] = v.to(cache.v.dtype)
            attn = _attn_core(q, cache.k[i], cache.v[i], cur, mask, T, fused_attn)
        x = _after_attn(lp, cfg, x, nn.merge_heads(attn), fused)
    if cfg.is_gpt:
        return nn.layer_norm(params["ln_f"], x, cfg.layer_norm_eps)
    return nn.rms_norm(params["norm"], x, cfg.rms_norm_eps)


def _refuse_quantized(params: dict):
    """Training takes float layers only, as the JAX package trains them."""
    for i, lp in enumerate(params["layers"]):
        if "fused" in lp:
            raise ValueError(f"layer {i} carries fused decode operands: train float params")
        for name, p in lp.items():
            if isinstance(p, dict) and not ("w" in p or "g" in p):
                raise ValueError(f"layer {i}/{name} is quantized ({sorted(p)}): "
                                 f"train float params")


def train_attention(q, k, v, mask):
    """The training pass's attention: q (B, H, T, hd) over the same layer's
    k, v (B, H_kv, T, hd) under the causal keep-mask (T, T)."""
    return _attn_core(q, k, v, None, mask, q.shape[2], False)


def backbone_train(params: dict, cfg: BackboneConfig, embeds: torch.Tensor,
                   remat: bool = False, attn=train_attention) -> torch.Tensor:
    """The teacher-forced training forward over a whole sequence embeds
    (B, T, D): positions 0..T-1 (learned for GPT-2, rotary for llama), each
    layer's queries attending to that layer's own keys under the causal
    mask, no cache (what `backbone_apply` computes with a fresh cache and
    start 0, but without writes into a buffer that autograd would see
    change). remat=True recomputes each layer in the backward pass
    (torch.utils.checkpoint), trading compute for activation memory.
    `attn` computes each layer's attention (`train_attention`'s
    signature); a sharded step passes one that runs on local shards.
    Float parameters only. Returns the final-norm hidden states (B, T, D)."""
    _refuse_quantized(params)
    B, T, D = embeds.shape
    dev = embeds.device
    positions = torch.arange(T, device=dev)[None].expand(B, T)
    x = embeds
    rope = None
    if cfg.is_gpt:
        x = x + nn.embedding(params["wpe"], positions).to(x.dtype)
    else:
        rope = tuple(c.to(x.dtype) for c in
                     rope_cos_sin(inv_freq_tensor(cfg, dev), positions))
    mask = _keep_mask(0, T, T, None, dev)

    def layer(lp, x):
        q, k, v = _qkv(lp, cfg, x, False, rope)
        return _after_attn(lp, cfg, x, nn.merge_heads(attn(q, k, v, mask)), False)

    for lp in params["layers"]:
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, lp, x, use_reentrant=False)
        else:
            x = layer(lp, x)
    if cfg.is_gpt:
        return nn.layer_norm(params["ln_f"], x, cfg.layer_norm_eps)
    return nn.rms_norm(params["norm"], x, cfg.rms_norm_eps)
