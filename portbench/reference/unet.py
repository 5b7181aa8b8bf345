"""Frozen reference copy of chatterbox_tpu_torch/models/s3gen/unet.py at commit f7b8e4d,
plain PyTorch / numpy, importing nothing of the program under test.

Causal 1-D UNet, the flow-matching velocity estimator of S3Gen (the
counterpart of chatterbox_tpu/models/s3gen/unet.py).

Input 320 channels (x | mu | spks | cond, 80 each); one down, `mid` middle
and one up stage, each a causal resnet block plus transformer blocks; no
time-axis resampling. Meanflow mixes a second time embedding r through a
linear "time_mixer". Channels-last (B, T, C), float32. One utterance runs
at its exact length with no mask; a batch of rows of different lengths
passes `mask` (B, T), which zeroes each row's pad before every conv and
masks its keys, so each row's frames are its exact-length result up to
rounding.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import nn


def sinusoidal_time_emb(t: torch.Tensor, dim: int, scale: float = 1000.0):
    """(B,) -> (B, dim)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = scale * t[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _causal_block_init(init: nn.Init, c_in: int, c_out: int) -> dict:
    return {"conv": init.conv1d(c_in, c_out, 3), "norm": init.layer_norm(c_out)}


def _masked(x: torch.Tensor, mask_f: Optional[torch.Tensor]) -> torch.Tensor:
    return x if mask_f is None else x * mask_f


def _causal_block_apply(p: dict, x: torch.Tensor, mask_f=None) -> torch.Tensor:
    """Causal conv k3 -> LN -> Mish (the pad zeroed before and after)."""
    h = nn.causal_conv1d(p["conv"], _masked(x, mask_f), k=3)
    return _masked(nn.mish(nn.layer_norm(p["norm"], h)), mask_f)


def resnet_init(init: nn.Init, c_in: int, c_out: int, temb_dim: int) -> dict:
    return {"mlp": init.linear(temb_dim, c_out),
            "block1": _causal_block_init(init, c_in, c_out),
            "block2": _causal_block_init(init, c_out, c_out),
            "res_conv": init.conv1d(c_in, c_out, 1)}


def resnet_apply(p: dict, x, temb, mask_f=None):
    h = _causal_block_apply(p["block1"], x, mask_f)
    h = h + nn.linear(p["mlp"], nn.mish(temb))[:, None, :]
    h = _causal_block_apply(p["block2"], h, mask_f)
    return h + nn.conv1d(p["res_conv"], _masked(x, mask_f))


def tfmr_block_init(init: nn.Init, dim: int, n_heads: int, head_dim: int) -> dict:
    inner = n_heads * head_dim
    return {"norm1": init.layer_norm(dim),
            "to_q": init.linear(dim, inner, bias=False),
            "to_k": init.linear(dim, inner, bias=False),
            "to_v": init.linear(dim, inner, bias=False),
            "to_out": init.linear(inner, dim),
            "norm3": init.layer_norm(dim),
            "ff_in": init.linear(dim, dim * 4),
            "ff_out": init.linear(dim * 4, dim)}


def tfmr_block_apply(p: dict, x, n_heads: int, key_mask=None):
    """LN -> MHA (no qkv bias) -> +res; LN -> exact-GELU FF -> +res.
    key_mask (B, T) bool or None."""
    h = nn.layer_norm(p["norm1"], x)
    q = nn.split_heads(nn.linear(p["to_q"], h), n_heads)
    k = nn.split_heads(nn.linear(p["to_k"], h), n_heads)
    v = nn.split_heads(nn.linear(p["to_v"], h), n_heads)
    m = None if key_mask is None else key_mask[:, None, None, :]
    x = x + nn.linear(p["to_out"], nn.merge_heads(nn.mha(q, k, v, mask=m)))
    h = nn.layer_norm(p["norm3"], x)
    return x + nn.linear(p["ff_out"], nn.gelu_exact(nn.linear(p["ff_in"], h)))


def unet_init(init: nn.Init, in_channels: int = 320, out_channels: int = 80,
              channels: int = 256, n_blocks: int = 4, num_mid_blocks: int = 12,
              n_heads: int = 8, head_dim: int = 64, meanflow: bool = False) -> dict:
    temb_dim = channels * 4
    p = {"time_mlp": {"lin1": init.linear(in_channels, temb_dim),
                      "lin2": init.linear(temb_dim, temb_dim)}}
    if meanflow:
        # diagonal init: the mixed embedding equals e_t at init
        eye = torch.eye(temb_dim, device=init.device)
        p["time_mixer"] = {"w": torch.cat([eye, torch.zeros_like(eye)], dim=0)}

    def stage(c_in, c_out, with_updown):
        d = {"resnet": resnet_init(init, c_in, c_out, temb_dim),
             "tfmr": [tfmr_block_init(init, c_out, n_heads, head_dim)
                      for _ in range(n_blocks)]}
        if with_updown:
            d["updown"] = init.conv1d(c_out, c_out, 3)
        return d

    p["down"] = [stage(in_channels, channels, True)]
    p["mid"] = [stage(channels, channels, False) for _ in range(num_mid_blocks)]
    p["up"] = [stage(channels * 2, channels, True)]
    p["final_block"] = _causal_block_init(init, channels, channels)
    p["final_proj"] = init.conv1d(channels, out_channels, 1)
    return p


def unet_apply(params: dict, x, mu, t, spks, cond, r: Optional[torch.Tensor] = None,
               n_heads: int = 8, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x, mu, cond (B, T, 80); t, r (B,); spks (B, 80) -> velocity (B, T, 80).
    mask (B, T) bool: each row's valid frames (None: every frame). The
    inputs are cast to the parameters' type (bfloat16 for the batched
    vocode's bf16 flow) and the velocity comes back in it."""
    in_channels = params["time_mlp"]["lin1"]["w"].shape[0]
    pdt = params["time_mlp"]["lin1"]["w"].dtype
    if x.dtype != pdt:
        x, mu, t, spks, cond = (a.to(pdt) for a in (x, mu, t, spks, cond))
        r = None if r is None else r.to(pdt)
    mask_f = key_mask = None
    if mask is not None:
        key_mask = mask.bool()
        mask_f = key_mask.to(x.dtype)[..., None]

    def time_mlp(v):
        e = nn.linear(params["time_mlp"]["lin1"], sinusoidal_time_emb(v, in_channels).to(pdt))
        return nn.linear(params["time_mlp"]["lin2"], nn.silu(e))

    temb = time_mlp(t)
    if r is not None:
        temb = nn.linear(params["time_mixer"], torch.cat([temb, time_mlp(r)], dim=-1))

    h = torch.cat([x, mu, spks[:, None, :].expand_as(mu), cond], dim=-1)
    skips = []
    for st in params["down"]:
        h = resnet_apply(st["resnet"], h, temb, mask_f)
        for blk in st["tfmr"]:
            h = tfmr_block_apply(blk, h, n_heads, key_mask)
        skips.append(h)
        h = nn.causal_conv1d(st["updown"], _masked(h, mask_f), k=3)
    for st in params["mid"]:
        h = resnet_apply(st["resnet"], h, temb, mask_f)
        for blk in st["tfmr"]:
            h = tfmr_block_apply(blk, h, n_heads, key_mask)
    for st in params["up"]:
        h = resnet_apply(st["resnet"], torch.cat([h, skips.pop()], dim=-1), temb, mask_f)
        for blk in st["tfmr"]:
            h = tfmr_block_apply(blk, h, n_heads, key_mask)
        h = nn.causal_conv1d(st["updown"], _masked(h, mask_f), k=3)
    h = _causal_block_apply(params["final_block"], h, mask_f)
    return _masked(nn.conv1d(params["final_proj"], _masked(h, mask_f)), mask_f)
