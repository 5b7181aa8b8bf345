"""Dtype casting and weight-only quantization for serving.

The T3 decode step is weight-bandwidth bound at batch 1, so the backbone and
heads are served with quantized weights. Embeddings, norms, biases and the
conditioning encoder stay in float. Modes of `quantize_t3_backbone`:
  * "int8": per-output-channel symmetric scales (amax/127, floored at
    1e-12);
  * "int8_fused": int8, plus each layer's operands for its family's two
    fused decode-layer kernels (kernels/fused_layer.py);
  * "int4": nibble-packed int4 (row split) with a scale per 256 rows of
    each half and output column, where `int4_supported` takes the shape;
    other weights fall back to int8. Decode reaches B8 through
    `nn.linear`;
  * "int4_fused" (GPT-2 only): qkv, attn_out and fc_out row split, fc_in
    column split, plus the operands of the int4 fused kernel pair.
The heads stay int8 in every mode. The JAX package never picks an int4
mode by itself (`best_serving_mode`).
"""
from __future__ import annotations

import torch

from ..kernels.fused_layer import (GROUP, fused_llama_supported, gpt2_int4_widths_ok,
                                   prepare_fused_gpt2_layer,
                                   prepare_fused_gpt2_layer_int8,
                                   prepare_fused_llama_layer_int8)
from ..kernels.fused_layer import unpack_int4  # noqa: F401  (the JAX package's home of it)
from ..kernels.int4_matmul import int4_supported

INT4_GROUP = GROUP        # contraction rows per int4 scale (the kernels' group)
MODES = ("int8", "int8_fused", "int4", "int4_fused")


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


def _quantize_groups(w: torch.Tensor, group: int):
    """(rows, cols) float -> int4 values (rows, cols) int32 and scales
    (rows / group, cols) f32: amax / 7 per group of rows, floored at 1e-12;
    values rounded half to even and clipped to +-7."""
    rows, cols = w.shape
    wg = w.float().reshape(rows // group, group, cols)
    scale = torch.clamp(wg.abs().amax(dim=1) / 7.0, min=1e-12)
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -7, 7)
    return q.reshape(rows, cols).to(torch.int32), scale


def _pack(q_lo: torch.Tensor, q_hi: torch.Tensor) -> torch.Tensor:
    """Two int32 arrays of values in [-7, 7] -> int8 bytes, q_hi in the high
    nibble (int32 arithmetic: torch's int8 shifts wrap)."""
    return ((q_hi << 4) | (q_lo & 0x0F)).to(torch.int8)


def quantize_linear_weight_int4(w: torch.Tensor):
    """(in, out) float -> (w_q4 int8 (in/2, out), scale_lo, scale_hi
    (in/2/group, out) f32), row split: byte[r, n] holds W[r, n] in the low
    nibble and W[r + in/2, n] in the high one, each half with its own
    group scales (INT4_GROUP rows). One group per half when in/2 is not a
    multiple of INT4_GROUP."""
    in_dim, _ = w.shape
    if in_dim % 2:
        raise ValueError(f"int4 row split needs an even contraction, got {in_dim}")
    half = in_dim // 2
    group = INT4_GROUP if half % INT4_GROUP == 0 else half
    q_lo, s_lo = _quantize_groups(w[:half], group)
    q_hi, s_hi = _quantize_groups(w[half:], group)
    return _pack(q_lo, q_hi), s_lo, s_hi


def quantize_linear_weight_int4_colsplit(w: torch.Tensor):
    """(in, out) float -> (w_q4c int8 (in, out/2), scale_lo, scale_hi
    (in/group, out/2) f32), column split: byte[r, c] holds W[r, c] low and
    W[r, c + out/2] high; group scales along the rows. One group when `in`
    is not a multiple of INT4_GROUP."""
    in_dim, out_dim = w.shape
    if out_dim % 2:
        raise ValueError(f"int4 column split needs an even output, got {out_dim}")
    half = out_dim // 2
    group = INT4_GROUP if in_dim % INT4_GROUP == 0 else in_dim
    q_lo, s_lo = _quantize_groups(w[:, :half], group)
    q_hi, s_hi = _quantize_groups(w[:, half:], group)
    return _pack(q_lo, q_hi), s_lo, s_hi


def _out_major(t: torch.Tensor) -> torch.Tensor:
    """t with the same values, stored transposed (t.T contiguous): the
    layout the int4 kernels stream."""
    return t.T.contiguous().T


def quantize_tree(params, min_size: int = 1 << 16, mode: str = "int8"):
    """Replace {"w": 2-D float} dicts holding at least `min_size` elements
    with {"w_q", "w_scale"} (int8) or, in mode "int4" where
    `int4_supported` takes the shape, {"w_q4", "w_scale4_lo",
    "w_scale4_hi"} stored out-major, throughout a tree."""
    if isinstance(params, dict):
        w = params.get("w")
        if (torch.is_tensor(w) and w.dim() == 2 and w.numel() >= min_size
                and w.is_floating_point()):
            out = {k: quantize_tree(v, min_size, mode) for k, v in params.items()
                   if k != "w"}
            if mode == "int4" and int4_supported(*w.shape):
                packed = quantize_linear_weight_int4(w)
                for key, t in zip(("w_q4", "w_scale4_lo", "w_scale4_hi"), packed):
                    out[key] = _out_major(t)
            else:
                out["w_q"], out["w_scale"] = quantize_linear_weight(w)
            return out
        return {k: quantize_tree(v, min_size, mode) for k, v in params.items()}
    if isinstance(params, list):
        return [quantize_tree(v, min_size, mode) for v in params]
    return params


def _quantize_gpt2_layer_int4_fused(lp: dict) -> dict:
    """One GPT-2 layer for the int4 fused kernels: qkv, attn_out, fc_out row
    split, fc_in column split, plus the "fused" operands, which the layer's
    leaves view (the weights are held once)."""
    if "qkv" not in lp:
        raise ValueError("int4_fused needs a GPT-2 backbone (the llama family has "
                         "no int4 fused kernels)")
    D, I = lp["qkv"]["w"].shape[0], lp["fc_in"]["w"].shape[1]
    if not gpt2_int4_widths_ok(D, I):
        raise ValueError(f"int4_fused: widths D={D}, I={I} do not fit the kernels' tiles")
    out = {}
    for name in ("qkv", "attn_out", "fc_out"):
        w_q, s_lo, s_hi = quantize_linear_weight_int4(lp[name]["w"])
        out[name] = {"w_q4": w_q, "w_scale4_lo": s_lo, "w_scale4_hi": s_hi,
                     "b": lp[name]["b"]}
    w_q, s_lo, s_hi = quantize_linear_weight_int4_colsplit(lp["fc_in"]["w"])
    out["fc_in"] = {"w_q4c": w_q, "w_scale4c_lo": s_lo, "w_scale4c_hi": s_hi,
                    "b": lp["fc_in"]["b"]}
    out["ln1"], out["ln2"] = lp["ln1"], lp["ln2"]
    out["fused"] = prepare_fused_gpt2_layer(out)
    return out


def is_quantized(tree) -> bool:
    """Whether a parameter tree holds quantized weights or fused-kernel
    operands."""
    if isinstance(tree, dict):
        return any(k in ("w_q", "w_q4", "w_q4c", "fused") or is_quantized(v)
                   for k, v in tree.items())
    if isinstance(tree, list):
        return any(is_quantized(v) for v in tree)
    return False


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
    """Quantize the backbone layers and the output heads of a T3 tree (the
    heads int8 in every mode).

    The fused modes also attach each layer's fused-kernel operands
    ("fused"); their weights are stored out-major, and the layer's own
    leaves become transposed views of the same storage, so the weights are
    held once."""
    if mode not in MODES:
        raise ValueError(f"unsupported quantization mode {mode!r}")
    out = dict(t3_params)
    backbone = dict(t3_params["backbone"])
    if mode == "int4_fused":
        layers = [_quantize_gpt2_layer_int4_fused(lp) for lp in t3_params["backbone"]["layers"]]
    else:
        layers = quantize_tree(t3_params["backbone"]["layers"],
                               mode="int4" if mode == "int4" else "int8")
    if mode == "int8_fused":
        for lp in layers:
            lp["fused"] = (prepare_fused_gpt2_layer_int8(lp) if "qkv" in lp
                           else prepare_fused_llama_layer_int8(lp))
    backbone["layers"] = layers
    out["backbone"] = backbone
    out["speech_head"] = quantize_tree(t3_params["speech_head"])
    out["text_head"] = quantize_tree(t3_params["text_head"])
    return out
