"""Dtype casting and weight-only int8 quantization for serving.

The T3 decode step is weight-bandwidth bound at batch 1, so the backbone and
heads are served with int8 weights: per-output-channel symmetric scales
(amax/127, floored at 1e-12). Embeddings, norms, biases and the conditioning
encoder stay in float. The "int8_fused" mode also builds each layer's
operands for its family's two fused decode-layer kernels
(kernels/fused_layer.py).
"""
from __future__ import annotations

import torch

from ..kernels.fused_layer import (fused_llama_supported,
                                   prepare_fused_gpt2_layer_int8,
                                   prepare_fused_llama_layer_int8)


def cast_params(params, dtype=torch.bfloat16):
    """Cast floating-point leaves of a nested dict/list tree to `dtype`."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    if torch.is_tensor(params) and params.is_floating_point():
        return params.to(dtype)
    return params


def quantize_linear_weight(w: torch.Tensor):
    """(in, out) float -> (w_q int8 (in, out), scale (out,) f32)."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    w_q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_tree(params, min_size: int = 1 << 16):
    """Replace {"w": 2-D float} dicts holding at least `min_size` elements
    with {"w_q", "w_scale"} throughout a tree."""
    if isinstance(params, dict):
        w = params.get("w")
        if (torch.is_tensor(w) and w.dim() == 2 and w.numel() >= min_size
                and w.is_floating_point()):
            out = {k: quantize_tree(v, min_size) for k, v in params.items()
                   if k != "w"}
            out["w_q"], out["w_scale"] = quantize_linear_weight(w)
            return out
        return {k: quantize_tree(v, min_size) for k, v in params.items()}
    if isinstance(params, list):
        return [quantize_tree(v, min_size) for v in params]
    return params


def best_serving_mode(cfg) -> str:
    """The quantization mode the JAX package serves each backbone with:
    the fused int8 decode-layer kernels where the widths fit their tiles
    (Turbo, Llama-520M), plain int8 elsewhere (Nano, D=768)."""
    if (cfg.is_gpt and cfg.hidden_size % 512 == 0
            and (3 * cfg.hidden_size) % 512 == 0
            and cfg.intermediate_size % 1024 == 0):
        return "int8_fused"
    if fused_llama_supported(cfg):
        return "int8_fused"
    return "int8"


def quantize_t3_backbone(t3_params: dict, mode: str = "int8") -> dict:
    """Quantize the backbone layers and the output heads of a T3 tree.

    mode="int8_fused" also attaches each layer's fused-kernel operands
    ("fused"); their weights are stored out-major, and the layer's own
    (in, out) "w_q" becomes a transposed view of the same storage, so the
    weights are held once."""
    if mode not in ("int8", "int8_fused"):
        raise ValueError(f"unsupported quantization mode {mode!r}")
    out = dict(t3_params)
    backbone = dict(t3_params["backbone"])
    layers = quantize_tree(t3_params["backbone"]["layers"])
    if mode == "int8_fused":
        for lp in layers:
            lp["fused"] = (prepare_fused_gpt2_layer_int8(lp) if "qkv" in lp
                           else prepare_fused_llama_layer_int8(lp))
    backbone["layers"] = layers
    out["backbone"] = backbone
    out["speech_head"] = quantize_tree(t3_params["speech_head"])
    out["text_head"] = quantize_tree(t3_params["text_head"])
    return out
