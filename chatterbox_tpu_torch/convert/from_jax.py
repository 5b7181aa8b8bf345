"""Carry chatterbox_tpu parameter trees (leaves already converted to numpy)
into this package's trees of torch tensors.

Layouts that change on the way:
  * conv weights (K, Cin, Cout) -> torch's (Cout, Cin, K), and 2-D conv
    weights (KH, KW, Cin, Cout) -> (Cout, Cin, KH, KW);
  * transposed-conv weights, stored pre-flipped as an input-dilated conv
    (K, Cin, Cout) -> torch ConvTranspose1d's (Cin, Cout, K), un-flipped;
  * int4 leaves (`w_q4`, `w_q4c` and their `w_scale4*` scales) keep their
    shapes but are stored out-major (their .T contiguous), the layout the
    int4 kernels stream;
  * the fused decode-layer operands (GPT-2 int8, GPT-2 int4 or llama int8,
    told apart by their keys: "qkv_wp" is int4, "wg" llama): the 8-row
    broadcast vectors become (N,) and the weights and int4 scales move to
    out-major storage, which the layer's own leaves then view (llama's q,
    k and v view row slices of the fused q|k|v);
  * bfloat16 leaves stay bfloat16.
Every key is checked against the port's own schema (its init on the meta
device): a missing, unexpected or misshaped leaf raises. A packed int4
weight stands for the float weight it unpacks to ((K/2, N) row split and
(K, N/2) column split for (K, N)), and its two scales must agree with it.

`kv_cache_from_jax` carries a decode state's KV cache (a JAX KVCache or
KVCacheInt8 with numpy leaves) into the port's cache.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.fused_layer import INT4_FUSED_LAYOUT
from ..models.s3gen.flow import FlowDims, flow_init
from ..models.s3gen.model import s3gen_init
from ..models.s3tok.model import S3TokenizerConfig
from ..models.t3 import backbone as bb
from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..models.ve.model import ve_init
from ..nn import core as nn

_GPT2_FUSED_MAP = {  # JAX fused operand -> (port key, transform)
    "g1_8": ("g1", "row"), "b1_8": ("b1", "row"),
    "qkv_w": ("qkv_wt", "transpose"), "qkv_s8": ("qkv_s", "row"),
    "qkv_b8": ("qkv_b", "row"),
    "wo_w": ("wo_t", "transpose"), "wo_s8": ("wo_s", "row"),
    "wo_b8": ("wo_b", "row"),
    "g2_8": ("g2", "row"), "b2_8": ("b2", "row"),
    "w1": ("w1_t", "transpose"), "s1_8": ("s1", "row"),
    "fc1_b8": ("fc1_b", "row"),
    "w2": ("w2_t", "transpose"), "s2_8": ("s2", "row"),
    "fc2_b8": ("fc2_b", "row"),
}
_LLAMA_FUSED_MAP = {
    "g1_8": ("g1", "row"),
    "qkv_w": ("qkv_wt", "transpose"), "qkv_s8": ("qkv_s", "row"),
    "wo_w": ("wo_t", "transpose"), "wo_s8": ("wo_s", "row"),
    "g2_8": ("g2", "row"),
    "wg": ("wg_t", "transpose"), "sg_8": ("sg", "row"),
    "wu": ("wu_t", "transpose"), "su_8": ("su", "row"),
    "wd": ("wd_t", "transpose"), "sd_8": ("sd", "row"),
}
_INT4_FUSED_MAP = {
    "g1_8": ("g1", "row"), "b1_8": ("b1", "row"),
    "qkv_wp": ("qkv_wpt", "transpose"), "qkv_slo": ("qkv_slo", "transpose"),
    "qkv_shi": ("qkv_shi", "transpose"), "qkv_b8": ("qkv_b", "row"),
    "wo_wp": ("wo_wpt", "transpose"), "wo_slo": ("wo_slo", "transpose"),
    "wo_shi": ("wo_shi", "transpose"), "wo_b8": ("wo_b", "row"),
    "g2_8": ("g2", "row"), "b2_8": ("b2", "row"),
    "w1c": ("w1c_t", "transpose"), "s1_lo": ("s1_lo", "transpose"),
    "s1_hi": ("s1_hi", "transpose"), "fc1_b8": ("fc1_b", "row"),
    "w2p": ("w2p_t", "transpose"), "s2_lo": ("s2_lo", "transpose"),
    "s2_hi": ("s2_hi", "transpose"), "fc2_b8": ("fc2_b", "row"),
}
# packed int4 weight leaf -> (its scale leaves, the axis it halves)
_INT4_LEAVES = {"w_q4": (("w_scale4_lo", "w_scale4_hi"), 0),
                "w_q4c": (("w_scale4c_lo", "w_scale4c_hi"), 1)}
_INT4_SCALES = {k for scales, _ in _INT4_LEAVES.values() for k in scales}
# layer linear -> the fused out-major weight its "w_q" views
_GPT2_LINKS = {"qkv": "qkv_wt", "attn_out": "wo_t", "fc_in": "w1_t",
               "fc_out": "w2_t"}
_LLAMA_LINKS = {"o": "wo_t", "gate": "wg_t", "up": "wu_t", "down": "wd_t"}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _leaf(path: tuple, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if path[-1] in _INT4_LEAVES or path[-1] in _INT4_SCALES:
        return _tensor(a.T, device).T        # out-major storage
    if path[-1] == "w" and a.ndim == 4:      # 2-D conv
        a = a.transpose(3, 2, 0, 1)
    elif path[-1] == "w" and a.ndim == 3:
        if "ups" in path:                    # transposed conv, un-flip
            a = a[::-1].transpose(1, 2, 0)
        else:                                # conv
            a = a.transpose(2, 1, 0)
    return _tensor(a, device)


def _fused(path: tuple, fl: dict, device) -> dict:
    fmap = (_LLAMA_FUSED_MAP if "wg" in fl
            else _INT4_FUSED_MAP if "qkv_wp" in fl else _GPT2_FUSED_MAP)
    extra = set(fl) - set(fmap)
    missing = set(fmap) - set(fl)
    if extra or missing:
        raise KeyError(f"{'/'.join(map(str, path))}: fused operands "
                       f"unexpected {sorted(extra)}, missing {sorted(missing)}")
    out = {}
    for k, (name, how) in fmap.items():
        a = np.asarray(fl[k])
        a = a[0] if how == "row" else a.T
        out[name] = _tensor(a, device).float() if how == "row" else _tensor(a, device)
    return out


def _link_fused(layer: dict, where: str):
    """Point the layer's weight leaves at views of its fused operands (the
    JAX tree holds them as separate copies, which must be equal)."""
    fused = layer["fused"]
    if "qkv_wpt" in fused:
        links = [(name, leaf, fused[key], None)
                 for name, (leaves, keys) in INT4_FUSED_LAYOUT.items()
                 for leaf, key in zip(leaves, keys)]
    else:
        links = [(name, "w_q", fused[key], None) for name, key in
                 (_LLAMA_LINKS if "wg_t" in fused else _GPT2_LINKS).items()]
    if "wg_t" in fused:
        row = 0
        for name in ("q", "k", "v"):
            width = layer[name]["w_q"].shape[1]
            links.append((name, "w_q", fused["qkv_wt"], slice(row, row + width)))
            row += width
    for name, leaf, wt, rows in links:
        view = (wt if rows is None else wt[rows]).T
        if not torch.equal(layer[name][leaf], view):
            raise ValueError(f"{where}/{name}/{leaf}: fused operand differs from the layer's")
        layer[name][leaf] = view


def _convert(node, device, path=()):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k == "fused":
                out[k] = _fused(path + (k,), v, device)
            else:
                out[k] = _convert(v, device, path + (k,))
        if "fused" in out:
            _link_fused(out, "/".join(map(str, path)))
        return out
    if isinstance(node, (list, tuple)):
        return [_convert(v, device, path + (i,)) for i, v in enumerate(node)]
    if node is None:
        raise ValueError(f"{'/'.join(map(str, path))}: empty leaf")
    return _leaf(path, node, device)


def _unpacked(node: dict, key: str, where: str) -> torch.Tensor:
    """The float weight a packed int4 leaf stands for, as a meta tensor of
    its shape, after checking that its scales agree with it."""
    (k_lo, k_hi), axis = _INT4_LEAVES[key]
    w, lo, hi = node[key], node[k_lo], node[k_hi]
    if not (w.dim() == lo.dim() == hi.dim() == 2 and lo.shape == hi.shape
            and lo.shape[1] == w.shape[1] and lo.shape[0] > 0
            and w.shape[0] % lo.shape[0] == 0):
        raise ValueError(f"{where}: packed {key} {tuple(w.shape)} does not match its "
                         f"scales {tuple(lo.shape)}, {tuple(hi.shape)}")
    shape = list(w.shape)
    shape[axis] *= 2
    return torch.empty(shape, device="meta")


def _float_form(node, path=()):
    """Schema view of a (possibly quantized) tree: {"w_q","w_scale"} read
    as {"w"}, a packed int4 weight and its scales as the {"w"} it unpacks
    to, the fused operands dropped."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k in ("fused", "w_scale") or k in _INT4_SCALES:
                continue
            if k == "w_q":
                out["w"] = v
            elif k in _INT4_LEAVES:
                out["w"] = _unpacked(node, k, "/".join(map(str, path + (k,))))
            else:
                out[k] = _float_form(v, path + (k,))
        return out
    if isinstance(node, list):
        return [_float_form(v, path + (i,)) for i, v in enumerate(node)]
    return node


def _check_schema(tree, template, path=()):
    where = "/".join(map(str, path)) or "<root>"
    if isinstance(template, dict):
        if not isinstance(tree, dict):
            raise KeyError(f"{where}: expected a dict")
        extra, missing = set(tree) - set(template), set(template) - set(tree)
        if extra or missing:
            raise KeyError(f"{where}: unexpected keys {sorted(extra)}, "
                           f"missing keys {sorted(missing)}")
        for k in template:
            _check_schema(tree[k], template[k], path + (k,))
    elif isinstance(template, list):
        if not isinstance(tree, list) or len(tree) != len(template):
            raise KeyError(f"{where}: expected a list of {len(template)}")
        for i, (a, b) in enumerate(zip(tree, template)):
            _check_schema(a, b, path + (i,))
    elif tuple(tree.shape) != tuple(template.shape):
        raise ValueError(f"{where}: shape {tuple(tree.shape)}, expected "
                         f"{tuple(template.shape)}")


def t3_from_jax(tree: dict, hp: T3Config, device="cuda") -> dict:
    """A T3 tree (float, or quantized by `quantize_t3_backbone` in any mode,
    with optional "fused" operands) -> the port's T3 tree on `device`."""
    out = _convert(tree, device)
    _check_schema(_float_form(out), t3m.t3_init(hp, device="meta"))
    return out


def s3gen_from_jax(tree: dict, dims: FlowDims = FlowDims(), hift_base: int = 512,
                   meanflow: bool = True, tok_cfg: S3TokenizerConfig = S3TokenizerConfig(),
                   device="cuda") -> dict:
    """An S3Gen tree -> the port's S3Gen tree. The frontend subtrees
    (`tokenizer`, `speaker_encoder`) are carried when the tree has them (a
    tree of `flow` and `mel2wav` alone serves vocoding only)."""
    out = _convert(tree, device)
    template = s3gen_init(device="meta", meanflow=meanflow, dims=dims,
                          hift_base=hift_base, tok_cfg=tok_cfg)
    frontend = tuple(k for k in ("tokenizer", "speaker_encoder") if k in tree)
    _check_schema(out, {k: template[k] for k in ("flow", "mel2wav") + frontend})
    return out


def flow_from_jax(tree: dict, dims: FlowDims = FlowDims(), meanflow: bool = False,
                  device="cuda") -> dict:
    """A bare flow tree (the JAX package's `flow_init`, what its flow
    trainer holds and saves) -> the port's flow tree on `device`."""
    out = _convert(tree, device)
    _check_schema(out, flow_init(nn.Init(0, "meta"), meanflow=meanflow, dims=dims))
    return out


def flow_to_jax(params: dict) -> dict:
    """The inverse of `flow_from_jax`'s layouts: the port's flow tree ->
    the same tree of tensors (views) in the JAX package's layouts (conv
    weights (Cout, Cin, K) -> (K, Cin, Cout)), so either package reads the
    file it is saved to."""
    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return node.permute(2, 1, 0) if path[-1] == "w" and node.dim() == 3 else node

    return walk(params)


def ve_from_jax(tree: dict, device="cuda") -> dict:
    """A voice-encoder tree -> the port's (the same layouts)."""
    out = _convert(tree, device)
    _check_schema(out, ve_init(nn.Init(0, "meta")))
    return out


def kv_cache_from_jax(cache, device="cuda"):
    """A JAX KVCache or KVCacheInt8 with numpy leaves -> bb.KVCache or
    bb.KVCacheInt8 on `device`, in the same (L, B, H_kv, T, D) layout."""
    if hasattr(cache, "k_q"):
        return bb.KVCacheInt8(*(_tensor(a, device) for a in
                                (cache.k_q, cache.v_q, cache.k_s, cache.v_s)))
    return bb.KVCache(_tensor(cache.k, device), _tensor(cache.v, device))
