"""Checkpoint conversion: the reference's checkpoint files -> this package's
parameter trees (the counterpart of chatterbox_tpu/convert/weights.py).

    ve.safetensors (or ve.pt)       -> voice encoder
    t3_cfg / t3_turbo_v1 / t3_nano_v1 / t3_mtl23ls_v2 (v3).safetensors
                                    -> T3 (llama or GPT-2)
    s3gen{,_meanflow}.safetensors (or s3gen.pt)
                                    -> S3Gen (S3 tokenizer, CAMPPlus, flow,
                                       HiFT)
    conds.pt                        -> the built-in voice (optional)

`.safetensors` files are read by this module's own reader of the format (an
8-byte little-endian header length, a JSON header, the raw buffer), so the
`safetensors` package is not needed.

Layouts, from the reference's torch state dicts:
    torch Linear (out, in)             -> w (in, out), transposed
    GPT-2 Conv1D (in, out)             -> w as it is
    torch Conv1d / Conv2d              -> w as it is: (Cout, Cin, K),
                                          (Cout, Cin, KH, KW)
    torch ConvTranspose1d (in, out, k) -> w as it is
    weight norm (g, v)                 -> w = g * v / ||v|| per out channel
    LSTM weight_ih / hh (4H, in)       -> (in, 4H), transposed
The arithmetic is numpy's, as in the JAX package; each tree is moved to
`device` at the end and checked against the port's own schema (its init on
the meta device), so a missing, unexpected or misshaped leaf raises.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..models.s3gen import campplus
from ..models.s3gen import model as s3m
from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..models.ve.model import ve_init
from ..nn import core as nn
from .from_jax import _check_schema


# ---------------------------------------------------------------------------
# file readers
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": (np.float64, None), "F32": (np.float32, None),
              "F16": (np.float16, None), "BF16": (np.int16, torch.bfloat16),
              "I64": (np.int64, None), "I32": (np.int32, None),
              "I16": (np.int16, None), "I8": (np.int8, None), "U8": (np.uint8, None),
              "BOOL": (np.bool_, None)}


def read_safetensors(path) -> dict:
    """{name: CPU tensor in its stored type} of a .safetensors file."""
    raw = np.memmap(str(path), np.uint8, mode="r")
    n = int(raw[:8].view("<u8")[0])
    header = json.loads(bytes(raw[8:8 + n]))
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for name, meta in header.items():
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {meta['dtype']}")
        np_type, view = _ST_DTYPES[meta["dtype"]]
        lo, hi = meta["data_offsets"]
        a = raw[base + lo: base + hi].view(np.dtype(np_type).newbyteorder("<"))
        t = torch.from_numpy(a.astype(np_type).reshape(meta["shape"]))
        out[name] = t.view(view) if view is not None else t
    del raw
    return out


def load_safetensors(path) -> dict:
    """{name: numpy array} as the JAX loader returns it: each tensor in its
    stored type, or every tensor as float32 when the file holds bfloat16."""
    sd = read_safetensors(path)
    if any(v.dtype == torch.bfloat16 for v in sd.values()):
        return {k: v.float().numpy() for k, v in sd.items()}
    return {k: v.numpy() for k, v in sd.items()}


def load_torch_pt(path) -> dict:
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    return {k: v.float().numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}


def _unwrap_model(sd):
    """Some checkpoints wrap the state dict as {"model": [sd]}."""
    if "model" in sd and not any(k.startswith(("tfmr", "flow", "mel2wav")) for k in sd):
        inner = sd["model"]
        return inner[0] if isinstance(inner, (list, tuple)) else inner
    return sd


# ---------------------------------------------------------------------------
# primitives (numpy, in the port's layouts)
# ---------------------------------------------------------------------------

def _get(sd, key):
    if key not in sd:
        raise KeyError(f"missing checkpoint key: {key}")
    return np.asarray(sd[key])


def lin(sd, p, bias=True):
    out = {"w": _get(sd, f"{p}.weight").T}
    if bias and f"{p}.bias" in sd:
        out["b"] = _get(sd, f"{p}.bias")
    return out


def lin_conv1d_gpt2(sd, p):
    # HF GPT-2 Conv1D keeps the (in, out) orientation already
    return {"w": _get(sd, f"{p}.weight"), "b": _get(sd, f"{p}.bias")}


def ln(sd, p):
    return {"g": _get(sd, f"{p}.weight"), "b": _get(sd, f"{p}.bias")}


def rms(sd, p):
    return {"g": _get(sd, f"{p}.weight")}


def emb(sd, p):
    return {"w": _get(sd, f"{p}.weight")}


def bn(sd, p):
    out = {"mean": _get(sd, f"{p}.running_mean"), "var": _get(sd, f"{p}.running_var")}
    if f"{p}.weight" in sd:
        out["g"] = _get(sd, f"{p}.weight")
        out["b"] = _get(sd, f"{p}.bias")
    else:  # affine=False
        out["g"] = np.ones_like(out["mean"])
        out["b"] = np.zeros_like(out["mean"])
    return out


def _raw_conv_weight(sd, p):
    """A plain or weight-normed conv weight (both parametrization styles)."""
    if f"{p}.weight" in sd:
        return _get(sd, f"{p}.weight")
    if f"{p}.parametrizations.weight.original0" in sd:
        g = _get(sd, f"{p}.parametrizations.weight.original0")
        v = _get(sd, f"{p}.parametrizations.weight.original1")
    elif f"{p}.weight_g" in sd:
        g = _get(sd, f"{p}.weight_g")
        v = _get(sd, f"{p}.weight_v")
    else:
        raise KeyError(f"no conv weight found under {p}")
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def conv1d(sd, p, bias=True):
    out = {"w": _raw_conv_weight(sd, p)}
    if bias and f"{p}.bias" in sd:
        out["b"] = _get(sd, f"{p}.bias")
    return out


def conv_t1d(sd, p):
    return {"w": _raw_conv_weight(sd, p), "b": _get(sd, f"{p}.bias")}


def conv2d(sd, p, bias=True):
    out = {"w": _get(sd, f"{p}.weight")}
    if bias and f"{p}.bias" in sd:
        out["b"] = _get(sd, f"{p}.bias")
    return out


def lstm(sd, p, num_layers):
    return {"layers": [{
        "w_ih": _get(sd, f"{p}.weight_ih_l{i}").T,
        "w_hh": _get(sd, f"{p}.weight_hh_l{i}").T,
        "b_ih": _get(sd, f"{p}.bias_ih_l{i}"),
        "b_hh": _get(sd, f"{p}.bias_hh_l{i}"),
    } for i in range(num_layers)]}


def _count(sd, pattern_fn):
    n = 0
    while any(k.startswith(pattern_fn(n)) for k in sd):
        n += 1
    return n


def _tensors(tree, device):
    """A numpy tree -> the same tree of torch tensors on `device`."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v, device) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def _checked(tree: dict, template: dict, device) -> dict:
    _check_schema(tree, template)
    return _tensors(tree, device)


# ---------------------------------------------------------------------------
# voice encoder
# ---------------------------------------------------------------------------

def convert_voice_encoder(sd, device="cuda") -> dict:
    tree = {"lstm": lstm(sd, "lstm", 3), "proj": lin(sd, "proj"),
            "similarity_weight": _get(sd, "similarity_weight"),
            "similarity_bias": _get(sd, "similarity_bias")}
    return _checked(tree, ve_init(nn.Init(0, "meta")), device)


# ---------------------------------------------------------------------------
# T3
# ---------------------------------------------------------------------------

def convert_perceiver(sd, pv: str) -> dict:
    """The perceiver resampler: a learned 32-query bank and one shared
    attention block."""
    return {"query": _get(sd, f"{pv}.pre_attention_query"),
            "norm": ln(sd, f"{pv}.attn.norm"),
            "to_q": lin(sd, f"{pv}.attn.to_q"),
            "to_k": lin(sd, f"{pv}.attn.to_k"),
            "to_v": lin(sd, f"{pv}.attn.to_v"),
            "proj_out": lin(sd, f"{pv}.attn.proj_out")}


def _t3_tree(sd, hp: T3Config) -> dict:
    cfg = hp.backbone
    if cfg.is_gpt:
        layers = [{"ln1": ln(sd, f"{b}.ln_1"),
                   "qkv": lin_conv1d_gpt2(sd, f"{b}.attn.c_attn"),
                   "attn_out": lin_conv1d_gpt2(sd, f"{b}.attn.c_proj"),
                   "ln2": ln(sd, f"{b}.ln_2"),
                   "fc_in": lin_conv1d_gpt2(sd, f"{b}.mlp.c_fc"),
                   "fc_out": lin_conv1d_gpt2(sd, f"{b}.mlp.c_proj")}
                  for b in (f"tfmr.h.{i}" for i in range(cfg.num_layers))]
        backbone = {"layers": layers, "wpe": emb(sd, "tfmr.wpe"),
                    "ln_f": ln(sd, "tfmr.ln_f")}
    else:
        layers = [{"input_ln": rms(sd, f"{b}.input_layernorm"),
                   "q": lin(sd, f"{b}.self_attn.q_proj"),
                   "k": lin(sd, f"{b}.self_attn.k_proj"),
                   "v": lin(sd, f"{b}.self_attn.v_proj"),
                   "o": lin(sd, f"{b}.self_attn.o_proj"),
                   "post_ln": rms(sd, f"{b}.post_attention_layernorm"),
                   "gate": lin(sd, f"{b}.mlp.gate_proj"),
                   "up": lin(sd, f"{b}.mlp.up_proj"),
                   "down": lin(sd, f"{b}.mlp.down_proj")}
                  for b in (f"tfmr.layers.{i}" for i in range(cfg.num_layers))]
        backbone = {"layers": layers, "norm": rms(sd, "tfmr.norm")}
    params = {"backbone": backbone,
              "text_emb": emb(sd, "text_emb"),
              "speech_emb": emb(sd, "speech_emb"),
              "text_head": lin(sd, "text_head"),
              "speech_head": lin(sd, "speech_head"),
              "cond_enc": {"spkr_enc": lin(sd, "cond_enc.spkr_enc")}}
    if hp.emotion_adv:
        params["cond_enc"]["emotion_adv_fc"] = lin(sd, "cond_enc.emotion_adv_fc")
    if hp.use_perceiver_resampler:
        params["cond_enc"]["perceiver"] = convert_perceiver(sd, "cond_enc.perceiver")
    if hp.input_pos_emb == "learned":
        params["text_pos_emb"] = emb(sd, "text_pos_emb.emb")
        params["speech_pos_emb"] = emb(sd, "speech_pos_emb.emb")
    return params


def convert_t3(sd, hp: T3Config, device="cuda") -> dict:
    """A T3 state dict (either backbone) -> the port's float T3 tree."""
    return _checked(_t3_tree(sd, hp), t3m.t3_init(hp, device="meta"), device)


# ---------------------------------------------------------------------------
# S3Gen flow: upsample-conformer encoder and UNet
# ---------------------------------------------------------------------------

def _conformer_block(sd, b):
    return {
        "norm_mha": ln(sd, f"{b}.norm_mha"),
        "attn": {
            "q": lin(sd, f"{b}.self_attn.linear_q"),
            "k": lin(sd, f"{b}.self_attn.linear_k"),
            "v": lin(sd, f"{b}.self_attn.linear_v"),
            "out": lin(sd, f"{b}.self_attn.linear_out"),
            "pos": lin(sd, f"{b}.self_attn.linear_pos"),
            "pos_bias_u": _get(sd, f"{b}.self_attn.pos_bias_u"),
            "pos_bias_v": _get(sd, f"{b}.self_attn.pos_bias_v"),
        },
        "norm_ff": ln(sd, f"{b}.norm_ff"),
        "ff_in": lin(sd, f"{b}.feed_forward.w_1"),
        "ff_out": lin(sd, f"{b}.feed_forward.w_2"),
    }


def convert_upsample_encoder(sd, p="flow.encoder") -> dict:
    n_blocks = _count(sd, lambda i: f"{p}.encoders.{i}.")
    n_up = _count(sd, lambda i: f"{p}.up_encoders.{i}.")
    return {
        "embed": {"linear": lin(sd, f"{p}.embed.out.0"), "norm": ln(sd, f"{p}.embed.out.1")},
        "pre_lookahead": {"conv1": conv1d(sd, f"{p}.pre_lookahead_layer.conv1"),
                          "conv2": conv1d(sd, f"{p}.pre_lookahead_layer.conv2")},
        "blocks": [_conformer_block(sd, f"{p}.encoders.{i}") for i in range(n_blocks)],
        "up_conv": conv1d(sd, f"{p}.up_layer.conv"),
        "up_embed": {"linear": lin(sd, f"{p}.up_embed.out.0"),
                     "norm": ln(sd, f"{p}.up_embed.out.1")},
        "up_blocks": [_conformer_block(sd, f"{p}.up_encoders.{i}") for i in range(n_up)],
        "after_norm": ln(sd, f"{p}.after_norm"),
    }


def _causal_block(sd, p):
    return {"conv": conv1d(sd, f"{p}.block.0"), "norm": ln(sd, f"{p}.block.2")}


def _resnet(sd, p):
    return {"mlp": lin(sd, f"{p}.mlp.1"),
            "block1": _causal_block(sd, f"{p}.block1"),
            "block2": _causal_block(sd, f"{p}.block2"),
            "res_conv": conv1d(sd, f"{p}.res_conv")}


def _basic_tfmr(sd, p):
    return {"norm1": ln(sd, f"{p}.norm1"),
            "to_q": lin(sd, f"{p}.attn1.to_q"),
            "to_k": lin(sd, f"{p}.attn1.to_k"),
            "to_v": lin(sd, f"{p}.attn1.to_v"),
            "to_out": lin(sd, f"{p}.attn1.to_out.0"),
            "norm3": ln(sd, f"{p}.norm3"),
            "ff_in": lin(sd, f"{p}.ff.net.0.proj"),
            "ff_out": lin(sd, f"{p}.ff.net.2")}


def convert_unet(sd, p="flow.decoder.estimator") -> dict:
    def stage(b, with_updown):
        n_tf = _count(sd, lambda j: f"{b}.1.{j}.")
        d = {"resnet": _resnet(sd, f"{b}.0"),
             "tfmr": [_basic_tfmr(sd, f"{b}.1.{j}") for j in range(n_tf)]}
        if with_updown:
            d["updown"] = conv1d(sd, f"{b}.2")
        return d

    n_mid = _count(sd, lambda i: f"{p}.mid_blocks.{i}.")
    out = {
        "time_mlp": {"lin1": lin(sd, f"{p}.time_mlp.linear_1"),
                     "lin2": lin(sd, f"{p}.time_mlp.linear_2")},
        "down": [stage(f"{p}.down_blocks.0", True)],
        "mid": [stage(f"{p}.mid_blocks.{i}", False) for i in range(n_mid)],
        "up": [stage(f"{p}.up_blocks.0", True)],
        "final_block": _causal_block(sd, f"{p}.final_block"),
        "final_proj": conv1d(sd, f"{p}.final_proj"),
    }
    if f"{p}.time_embed_mixer.weight" in sd:
        out["time_mixer"] = lin(sd, f"{p}.time_embed_mixer")
    return out


def convert_flow(sd) -> dict:
    return {"input_embedding": emb(sd, "flow.input_embedding"),
            "spk_embed_affine": lin(sd, "flow.spk_embed_affine_layer"),
            "encoder": convert_upsample_encoder(sd),
            "encoder_proj": lin(sd, "flow.encoder_proj"),
            "decoder": convert_unet(sd)}


# ---------------------------------------------------------------------------
# HiFT
# ---------------------------------------------------------------------------

def _hift_resblock(sd, p):
    n = _count(sd, lambda i: f"{p}.convs1.{i}.")
    return {"convs1": [conv1d(sd, f"{p}.convs1.{i}") for i in range(n)],
            "convs2": [conv1d(sd, f"{p}.convs2.{i}") for i in range(n)],
            "alpha1": [_get(sd, f"{p}.activations1.{i}.alpha") for i in range(n)],
            "alpha2": [_get(sd, f"{p}.activations2.{i}.alpha") for i in range(n)]}


def convert_hift(sd, p="mel2wav") -> dict:
    f0p = f"{p}.f0_predictor"
    n_ups = _count(sd, lambda i: f"{p}.ups.{i}.")
    n_res = _count(sd, lambda i: f"{p}.resblocks.{i}.")
    n_src = _count(sd, lambda i: f"{p}.source_downs.{i}.")
    return {
        "f0_predictor": {
            "convs": [conv1d(sd, f"{f0p}.condnet.{i}") for i in (0, 2, 4, 6, 8)],
            "classifier": lin(sd, f"{f0p}.classifier"),
        },
        "m_source_linear": lin(sd, f"{p}.m_source.l_linear"),
        "conv_pre": conv1d(sd, f"{p}.conv_pre"),
        "ups": [conv_t1d(sd, f"{p}.ups.{i}") for i in range(n_ups)],
        "source_downs": [conv1d(sd, f"{p}.source_downs.{i}") for i in range(n_src)],
        "source_resblocks": [_hift_resblock(sd, f"{p}.source_resblocks.{i}")
                             for i in range(n_src)],
        "resblocks": [_hift_resblock(sd, f"{p}.resblocks.{i}") for i in range(n_res)],
        "conv_post": conv1d(sd, f"{p}.conv_post"),
    }


# ---------------------------------------------------------------------------
# CAMPPlus
# ---------------------------------------------------------------------------

def _res2d(sd, p):
    out = {"conv1": conv2d(sd, f"{p}.conv1"), "bn1": bn(sd, f"{p}.bn1"),
           "conv2": conv2d(sd, f"{p}.conv2"), "bn2": bn(sd, f"{p}.bn2")}
    if f"{p}.shortcut.0.weight" in sd:
        out["shortcut_conv"] = conv2d(sd, f"{p}.shortcut.0")
        out["shortcut_bn"] = bn(sd, f"{p}.shortcut.1")
    return out


def convert_campplus(sd, p="speaker_encoder") -> dict:
    out = {
        "fcm": {
            "conv1": conv2d(sd, f"{p}.head.conv1"),
            "bn1": bn(sd, f"{p}.head.bn1"),
            "layer1": [_res2d(sd, f"{p}.head.layer1.{i}") for i in range(2)],
            "layer2": [_res2d(sd, f"{p}.head.layer2.{i}") for i in range(2)],
            "conv2": conv2d(sd, f"{p}.head.conv2"),
            "bn2": bn(sd, f"{p}.head.bn2"),
        },
        "tdnn": {"conv": conv1d(sd, f"{p}.xvector.tdnn.linear"),
                 "bn": bn(sd, f"{p}.xvector.tdnn.nonlinear.batchnorm")},
        "blocks": [], "transits": [],
    }
    for bi, (num_layers, _, _) in enumerate(campplus.BLOCK_SPECS):
        layers = []
        for i in range(num_layers):
            lp = f"{p}.xvector.block{bi + 1}.tdnnd{i + 1}"
            layers.append({
                "bn1": bn(sd, f"{lp}.nonlinear1.batchnorm"),
                "lin1": conv1d(sd, f"{lp}.linear1"),
                "bn2": bn(sd, f"{lp}.nonlinear2.batchnorm"),
                "cam": {"local": conv1d(sd, f"{lp}.cam_layer.linear_local"),
                        "lin1": conv1d(sd, f"{lp}.cam_layer.linear1"),
                        "lin2": conv1d(sd, f"{lp}.cam_layer.linear2")},
            })
        out["blocks"].append(layers)
        tp = f"{p}.xvector.transit{bi + 1}"
        out["transits"].append({"bn": bn(sd, f"{tp}.nonlinear.batchnorm"),
                                "conv": conv1d(sd, f"{tp}.linear")})
    out["out_bn"] = bn(sd, f"{p}.xvector.out_nonlinear.batchnorm")
    out["dense"] = {"conv": conv1d(sd, f"{p}.xvector.dense.linear"),
                    "bn": bn(sd, f"{p}.xvector.dense.nonlinear.batchnorm")}
    return out


# ---------------------------------------------------------------------------
# S3 tokenizer (S3TokenizerV2's encoder and FSQ, the key names of the public
# xingchensong/S3Tokenizer package; shipped inside s3gen.safetensors under
# `tokenizer.*`). A missing key raises: a random tokenizer beside a converted
# S3Gen would make noise.
# ---------------------------------------------------------------------------

class S3TokenizerConversionError(RuntimeError):
    pass


def _lin_any(sd, prefixes, bias=True):
    """A linear whose checkpoint name has known spelling variants."""
    for q in prefixes:
        if f"{q}.weight" in sd:
            return lin(sd, q, bias=bias and f"{q}.bias" in sd)
    raise KeyError(f"none of {prefixes} present")


def dry_map_s3tokenizer(keys, p="tokenizer") -> dict:
    """How convert_s3tokenizer's name map lands on a checkpoint's keys,
    without converting: {"n_layers", "mapped" (keys it would read),
    "unmapped" (keys under `p.` it does not know), "missing" (keys it needs
    and the checkpoint lacks)}. The reference wrapper's buffers
    (`_mel_filters`, `window`) count as known."""
    keys = set(keys)
    present = {k for k in keys if k.startswith(p + ".")}
    n_layers = 0
    while any(k.startswith(f"{p}.encoder.blocks.{n_layers}.") for k in present):
        n_layers += 1

    def wb(prefix, bias=True):
        return [f"{prefix}.weight"] + ([f"{prefix}.bias"] if bias else [])

    expected = wb(f"{p}.encoder.conv1") + wb(f"{p}.encoder.conv2")
    for i in range(n_layers):
        b = f"{p}.encoder.blocks.{i}"
        expected += (wb(f"{b}.attn_ln") + wb(f"{b}.attn.query")
                     + wb(f"{b}.attn.key", bias=False)
                     + wb(f"{b}.attn.value") + wb(f"{b}.attn.out")
                     + wb(f"{b}.mlp_ln") + wb(f"{b}.mlp.0")
                     + wb(f"{b}.mlp.2"))
    expected += wb(f"{p}.encoder.ln_post")
    fsq_variants = (f"{p}.quantizer._codebook.project_down",
                    f"{p}.quantizer.codebook.project_down",
                    f"{p}.quantizer.project_down")
    fsq = next((v for v in fsq_variants if f"{v}.weight" in present), fsq_variants[0])
    expected = set(expected + wb(fsq))
    ignorable = {k for k in present
                 if k.endswith("_mel_filters") or k.endswith(".window")}
    return {"n_layers": n_layers,
            "mapped": sorted(present & expected),
            "unmapped": sorted(present - expected - ignorable),
            "missing": sorted(expected - present)}


def convert_s3tokenizer(sd, p="tokenizer") -> dict:
    try:
        n_layers = _count(sd, lambda i: f"{p}.encoder.blocks.{i}.")
        if n_layers == 0:
            raise KeyError(f"no '{p}.encoder.blocks.*' keys found")
        blocks = []
        for i in range(n_layers):
            b = f"{p}.encoder.blocks.{i}"
            blocks.append({"ln1": ln(sd, f"{b}.attn_ln"),
                           "q": lin(sd, f"{b}.attn.query"),
                           "k": lin(sd, f"{b}.attn.key", bias=False),
                           "v": lin(sd, f"{b}.attn.value"),
                           "out": lin(sd, f"{b}.attn.out"),
                           "ln2": ln(sd, f"{b}.mlp_ln"),
                           "fc1": lin(sd, f"{b}.mlp.0"),
                           "fc2": lin(sd, f"{b}.mlp.2")})
        out = {"conv1": conv1d(sd, f"{p}.encoder.conv1"),
               "conv2": conv1d(sd, f"{p}.encoder.conv2"),
               "blocks": blocks,
               "ln_post": ln(sd, f"{p}.encoder.ln_post"),
               "fsq_proj": _lin_any(sd, (f"{p}.quantizer._codebook.project_down",
                                         f"{p}.quantizer.codebook.project_down",
                                         f"{p}.quantizer.project_down"))}
    except KeyError as e:
        known = sorted(k for k in sd if k.startswith(f"{p}."))[:20]
        report = dry_map_s3tokenizer(sd.keys(), p)
        raise S3TokenizerConversionError(
            f"S3 tokenizer weight conversion failed on key {e}. The checkpoint "
            f"has {len([k for k in sd if k.startswith(p + '.')])} '{p}.*' "
            f"tensors; first keys: {known}. Refusing to fall back to random "
            f"init (it would produce noise audio). Dry-map diff "
            f"(extend the name map from these): "
            f"{len(report['mapped'])} mapped, "
            f"unmapped={report['unmapped'][:12]}, "
            f"missing={report['missing'][:12]}.") from e
    return out


# ---------------------------------------------------------------------------
# S3Gen and the loaders
# ---------------------------------------------------------------------------

def convert_s3gen(sd, meanflow: bool = False, device="cuda") -> dict:
    """A whole s3gen{,_meanflow}.safetensors state dict -> the port's S3Gen
    tree (tokenizer, speaker encoder, flow, HiFT), checked against
    `s3gen_init`'s schema at its default sizes."""
    tree = {"tokenizer": convert_s3tokenizer(sd),
            "speaker_encoder": convert_campplus(sd),
            "flow": convert_flow(sd),
            "mel2wav": convert_hift(sd)}
    return _checked(tree, s3m.s3gen_init(device="meta", meanflow=meanflow), device)


def load_english_tts(cls, ckpt_dir: Path, device="cuda"):
    """The 520M pipeline from t3_cfg.safetensors, ve.safetensors,
    s3gen.safetensors, tokenizer.json and, when present, conds.pt."""
    from ..api.pipelines import Conditionals
    from ..text.tokenizer import EnTokenizer
    hp = T3Config.english_only()
    t3_params = convert_t3(_unwrap_model(load_safetensors(ckpt_dir / "t3_cfg.safetensors")),
                           hp, device)
    ve_params = convert_voice_encoder(load_safetensors(ckpt_dir / "ve.safetensors"), device)
    engine = s3m.S3GenEngine(convert_s3gen(load_safetensors(ckpt_dir / "s3gen.safetensors"),
                                           device=device), meanflow=False)
    tok = EnTokenizer(str(ckpt_dir / "tokenizer.json"))
    conds = None
    if (ckpt_dir / "conds.pt").exists():
        conds = Conditionals.load(ckpt_dir / "conds.pt")
    return cls(t3_params, hp, engine, ve_params, tok, conds)


def load_turbo_tts(cls, ckpt_dir: Path, nano: bool = False, device="cuda"):
    """Turbo (or Nano) from t3_turbo_v1 (t3_nano_v1).safetensors,
    ve.safetensors, s3gen_meanflow.safetensors, the GPT-2 tokenizer files
    transformers' AutoTokenizer reads from the directory and, when present,
    conds.pt."""
    from ..api.pipelines import Conditionals
    from ..text.tokenizer import HFTokenizer
    hp = T3Config.nano() if nano else T3Config.turbo()
    ckpt = "t3_nano_v1.safetensors" if nano else "t3_turbo_v1.safetensors"
    t3_params = convert_t3(_unwrap_model(load_safetensors(ckpt_dir / ckpt)), hp, device)
    ve_params = convert_voice_encoder(load_safetensors(ckpt_dir / "ve.safetensors"), device)
    engine = s3m.S3GenEngine(
        convert_s3gen(load_safetensors(ckpt_dir / "s3gen_meanflow.safetensors"),
                      meanflow=True, device=device), meanflow=True)
    conds = None
    if (ckpt_dir / "conds.pt").exists():
        conds = Conditionals.load(ckpt_dir / "conds.pt")
    return cls(t3_params, hp, engine, ve_params, HFTokenizer(ckpt_dir), conds,
               model_label="Nano" if nano else "Turbo")


def load_mtl_tts(cls, ckpt_dir: Path, t3_model: str | None = None, device="cuda"):
    """The multilingual pipeline from the T3 file `t3_model` names
    (MULTILINGUAL_T3_MODELS; default t3_mtl23ls_v2.safetensors), ve.pt
    else ve.safetensors, s3gen.pt else s3gen.safetensors (the 520M
    family's CFM S3Gen), grapheme_mtl_merged_expanded_v1.json (with
    Cangjie5_TC.json beside it, when present) and, when present, conds.pt;
    T3 stays float32."""
    from ..api.pipelines import MULTILINGUAL_T3_MODELS, Conditionals
    from ..text.tokenizer import MTLTokenizer
    name = t3_model or "t3_mtl23ls_v2.safetensors"
    name = MULTILINGUAL_T3_MODELS.get(name, name)
    hp = T3Config.multilingual()
    t3_params = convert_t3(_unwrap_model(load_safetensors(ckpt_dir / name)), hp, device)

    def pt_or_safetensors(stem):
        pt = ckpt_dir / f"{stem}.pt"
        return load_torch_pt(pt) if pt.exists() else load_safetensors(
            ckpt_dir / f"{stem}.safetensors")

    ve_params = convert_voice_encoder(pt_or_safetensors("ve"), device)
    engine = s3m.S3GenEngine(convert_s3gen(pt_or_safetensors("s3gen"), device=device),
                             meanflow=False)
    tok = MTLTokenizer(str(ckpt_dir / "grapheme_mtl_merged_expanded_v1.json"))
    conds = None
    if (ckpt_dir / "conds.pt").exists():
        conds = Conditionals.load(ckpt_dir / "conds.pt")
    return cls(t3_params, hp, engine, ve_params, tok, conds)


def load_vc(cls, ckpt_dir: Path, device="cuda"):
    """Voice conversion from s3gen.safetensors (the 520M family's: 10-step
    CFM with CFG) and, when present, conds.pt's S3Gen voice."""
    from ..api.pipelines import Conditionals
    engine = s3m.S3GenEngine(convert_s3gen(load_safetensors(ckpt_dir / "s3gen.safetensors"),
                                           device=device), meanflow=False)
    ref_dict = None
    if (ckpt_dir / "conds.pt").exists():
        ref_dict = Conditionals.load(ckpt_dir / "conds.pt").gen
    return cls(engine, ref_dict=ref_dict)
