#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (chatterbox_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Two paths, each at full width with random weights from a seed, served as
bench.py serves them (T3 cast to bf16 and quantized int8_fused, S3Gen in
float32 with default FlowDims and HiFT base 512):
  * Turbo: GPT-2-medium T3 (24 layers), meanflow S3Gen; kernels B1, B2;
  * 520M CFG: T3Config.english_only() (Llama-520M, 30 layers, perceiver,
    emotion input, learned positions), batch-2 CFG decode, 10-step CFG
    S3Gen; kernels B5, B6.

Phases, in order; any failure exits non-zero without the final "ok" line:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA /
     nvcc versions; build every CUDA kernel from csrc/ (one nvcc each,
     started together);
  2. models: both pipelines;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     its path's shapes (Turbo B=1; CFG B=2, and B=1 for cfg_weight 0) and
     on the real layers' weights; kernel, plain and library (torch.matmul on
     pre-dequantized bf16 weights) times over all the layers (more weight
     bytes than the 50 MB L2), by CUDA-graph replay;
  4. reference: the CUDA path against the CPU path (plain kernel versions)
     on small models, same weights and noise: Turbo T3 teacher-forced
     logits and meanflow S3Gen waveform; 520M-family T3 teacher-forced CFG
     logits at batch 2 and 10-step CFG S3Gen waveform;
  5. main paths, each with the launch counts set to 0 just before and read
     just after its three timed runs (its own kernels launched layers x
     decode steps times, the other path's not at all):
     ChatterboxTurboTTS.generate with bench.py's Turbo settings (synthetic
     conditionals, P=125, 250 tokens with EOS ignored, top_k 1000,
     temperature 0.8, top_p 0.95, repetition penalty 1.2) and
     ChatterboxTTS.generate with bench.py's 520M settings (cfg_weight 0.5,
     temperature 0.8, top_p 1.0, min_p 0.05, repetition penalty 1.2,
     exaggeration 0.5, 30 text tokens, 250 tokens with EOS ignored); each
     once to warm up, three timed runs, one split run for T3 and S3Gen
     times, and a profile of the decode step.
The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
PEAK_INT8_OPS = 1.979e15       # dense int8 tensor-core rate, same source
N_TOKENS = 250
P_PROMPT = 125
SOS, EOS, S3_VOCAB = 6561, 6562, 6561


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nvcc_version(build) -> str:
    out = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


def _events_ms(fn, reps: int) -> float:
    import torch
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def eager_time_ms(fn, reps: int) -> float:
    """Mean ms of fn() called from Python, by CUDA events, after a warm-up:
    bounded by the host's launch rate when the work is small."""
    import torch
    fn()
    torch.cuda.synchronize()
    return _events_ms(fn, reps)


def device_time_ms(fn, reps: int) -> float:
    """Mean ms of fn()'s work on the card: fn is captured once into a CUDA
    graph and the graph replayed, so host launch costs drop out."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay, reps)
    del graph
    return ms


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions, timed over the real layers
# ---------------------------------------------------------------------------

class KernelSpec:
    """One kernel on its path's layers: call(i, f) runs f (the kernel's
    wrapper or its plain version) on layer i's operands at batch B;
    library(i) is one PyTorch call (or a few) computing the same products;
    bytes_ and ops are what the function must move and compute at this
    batch."""

    def __init__(self, name, replaces, call, library, bytes_, ops, tol, kernel, plain):
        self.name, self.replaces, self.call, self.library = name, replaces, call, library
        self.bytes_, self.ops, self.tol = bytes_, ops, tol
        self.kernel, self.plain = kernel, plain


def _inputs(L, B, D, I, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    return ([r(B, D).bfloat16() for _ in range(L)],
            [(0.5 * r(B, D)).bfloat16() for _ in range(L)],
            [r(B, I).bfloat16() for _ in range(L)])


def _deq(wt, s):
    return (wt.float().T * s).bfloat16()


# Tolerances: B1 / B5 sum the same exact f32 products in another order (f32
# rounding on outputs of order 10). B2 / B6 also round the norm output and
# the hidden units to bf16: a value that lands on the other side of a bf16
# rounding boundary moves the outputs by ~1e-4.
TOL_QKV, TOL_MLP = 1e-3, 1e-2
VEC = 4                          # bytes of an f32 scale, bias or norm entry


def gpt2_specs(tts, K, B=1):
    layers = [lp["fused"] for lp in tts.t3_params["backbone"]["layers"]]
    cfg = tts.hp.backbone
    D, I, N, eps = cfg.hidden_size, cfg.intermediate_size, 3 * cfg.hidden_size, \
        cfg.layer_norm_eps
    xs, as_, hs = _inputs(len(layers), B, D, I, seed=1)
    lib1 = [_deq(fl["qkv_wt"], fl["qkv_s"]) for fl in layers]
    lib2 = [(_deq(fl["wo_t"], fl["wo_s"]), _deq(fl["w1_t"], fl["s1"]),
             _deq(fl["w2_t"], fl["s2"])) for fl in layers]

    def b1(i, f):
        fl = layers[i]
        return f(xs[i], fl["g1"], fl["b1"], fl["qkv_wt"], fl["qkv_s"], fl["qkv_b"], eps)

    def b2(i, f):
        fl = layers[i]
        return f(as_[i], xs[i], fl["wo_t"], fl["wo_s"], fl["wo_b"], fl["g2"], fl["b2"],
                 fl["w1_t"], fl["s1"], fl["fc1_b"], fl["w2_t"], fl["s2"], fl["fc2_b"], eps)

    def lib_b2(i):
        import torch
        wo, w1, w2 = lib2[i]
        torch.matmul(as_[i], wo)
        torch.matmul(xs[i], w1)
        torch.matmul(hs[i], w2)

    import torch
    return [
        KernelSpec("ln_qkv_int8", "chatterbox_tpu/ops/fused_layer.py:328", b1,
                   lambda i: torch.matmul(xs[i], lib1[i]),
                   D * N + 2 * N * VEC + 2 * D * VEC + B * D * 2 + B * N * 4,
                   2 * B * D * N, TOL_QKV, K.ln_qkv_int8, K.ln_qkv_int8_plain),
        KernelSpec("attnout_ln_mlp_int8", "chatterbox_tpu/ops/fused_layer.py:401", b2,
                   lib_b2,
                   (D * D + 2 * D * I) + (6 * D + 2 * I) * VEC + 2 * B * D * 2 + B * D * 4,
                   2 * B * (D * D + 2 * D * I), TOL_MLP, K.attnout_ln_mlp_int8,
                   K.attnout_ln_mlp_int8_plain),
    ]


def llama_specs(tts, K, B=2):
    layers = [lp["fused"] for lp in tts.t3_params["backbone"]["layers"]]
    cfg = tts.hp.backbone
    D, I, eps, tw = cfg.hidden_size, cfg.intermediate_size, cfg.rms_norm_eps, \
        K.llama_mlp_tile(cfg)
    N = layers[0]["qkv_wt"].shape[0]
    xs, as_, hs = _inputs(len(layers), B, D, I, seed=2)
    lib5 = [_deq(fl["qkv_wt"], fl["qkv_s"]) for fl in layers]
    lib6 = [tuple(_deq(fl[w], fl[s]) for w, s in
                  (("wo_t", "wo_s"), ("wg_t", "sg"), ("wu_t", "su"), ("wd_t", "sd")))
            for fl in layers]

    def b5(i, f):
        fl = layers[i]
        return f(xs[i], fl["g1"], fl["qkv_wt"], fl["qkv_s"], eps)

    def b6(i, f):
        fl = layers[i]
        return f(as_[i], xs[i], fl["wo_t"], fl["wo_s"], fl["g2"], fl["wg_t"], fl["sg"],
                 fl["wu_t"], fl["su"], fl["wd_t"], fl["sd"], eps, tw)

    def lib_b6(i):
        import torch
        wo, wg, wu, wd = lib6[i]
        torch.matmul(as_[i], wo)
        torch.matmul(xs[i], wg)
        torch.matmul(xs[i], wu)
        torch.matmul(hs[i], wd)

    import torch
    return [
        KernelSpec("rms_qkv_int8", "chatterbox_tpu/ops/fused_layer.py:494", b5,
                   lambda i: torch.matmul(xs[i], lib5[i]),
                   D * N + N * VEC + D * VEC + B * D * 2 + B * N * 4,
                   2 * B * D * N, TOL_QKV, K.rms_qkv_int8, K.rms_qkv_int8_plain),
        KernelSpec("attnout_rms_glu_int8", "chatterbox_tpu/ops/fused_layer.py:564", b6,
                   lib_b6,
                   (D * D + 3 * D * I) + (3 * D + 2 * I) * VEC + 2 * B * D * 2 + B * D * 4,
                   2 * B * (D * D + 3 * D * I), TOL_MLP, K.attnout_rms_glu_int8,
                   K.attnout_rms_glu_int8_plain),
    ]


def check_specs(specs, L, label) -> dict:
    """Max abs error of each kernel against its plain version over L layers."""
    import torch
    errs = {}
    for sp in specs:
        e = 0.0
        for i in range(L):
            out, ref = sp.call(i, sp.kernel), sp.call(i, sp.plain)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError(f"{sp.name} layer {i}: non-finite output")
            e = max(e, (out - ref).abs().max().item())
        log(f"kernel check {sp.name} ({label}): max_abs_err {e:.3e} over {L} layers "
            f"(tol {sp.tol})")
        if not e <= sp.tol:
            raise AssertionError(f"{sp.name} disagrees with its plain version: {e}")
        errs[sp.name] = e
    return errs


def time_specs(specs, L, errs, source) -> list:
    rows = []
    reps = {"kernel": 50, "plain": 5, "library": 50}
    for sp in specs:
        def all_layers(f):
            return lambda: [f(i) for i in range(L)]

        eager_ms = eager_time_ms(all_layers(lambda i: sp.call(i, sp.kernel)), reps["kernel"]) / L
        ms = device_time_ms(all_layers(lambda i: sp.call(i, sp.kernel)), reps["kernel"]) / L
        plain_ms = device_time_ms(all_layers(lambda i: sp.call(i, sp.plain)),
                                  reps["plain"]) / L
        lib_ms = device_time_ms(all_layers(sp.library), reps["library"]) / L
        t_bytes = sp.bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = sp.ops / PEAK_INT8_OPS * 1e3
        rows.append({"name": sp.name, "route": "cuda", "source": source,
                     "replaces": sp.replaces, "launches": 0,
                     "max_abs_err": errs[sp.name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": lib_ms})
        log(f"kernel time {sp.name}: {ms * 1e3:.2f} us/call on the card (plain "
            f"{plain_ms * 1e3:.2f}, library {lib_ms * 1e3:.2f}, bound "
            f"{max(t_bytes, t_ops) * 1e3:.2f} us for {sp.bytes_ / 1e6:.3f} MB); "
            f"{eager_ms * 1e3:.2f} us/call launched from Python")
    return rows


def check_kernels(turbo, cfg520, K) -> list:
    source = "chatterbox_tpu_torch/csrc/fused_layer.cu"
    L1, L2 = turbo.hp.backbone.num_layers, cfg520.hp.backbone.num_layers
    g_specs = gpt2_specs(turbo, K, B=1)
    rows = time_specs(g_specs, L1, check_specs(g_specs, L1, "Turbo, B=1"), source)
    del g_specs
    check_specs(llama_specs(cfg520, K, B=1), L2, "520M, B=1 (cfg_weight 0)")
    l_specs = llama_specs(cfg520, K, B=2)
    rows += time_specs(l_specs, L2, check_specs(l_specs, L2, "520M, B=2 (CFG)"), source)
    return rows


# ---------------------------------------------------------------------------
# phase 4: the CUDA path against the CPU path on small models
# ---------------------------------------------------------------------------

def _to(tree, device):
    import torch
    if isinstance(tree, dict):
        out = {k: _to(v, device) for k, v in tree.items() if k != "fused"}
        if "fused" in tree:        # keep the layer's w_q views of the fused copies
            from chatterbox_tpu_torch.kernels import fused_layer as K
            out["fused"] = (K.prepare_fused_gpt2_layer_int8(out) if "qkv" in out
                            else K.prepare_fused_llama_layer_int8(out))
        return out
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def _teacher_forced(params, hp, cond, text, forced, batch, cfg_mode, dev):
    """Prefill the dense prefix, then one decode step per forced token:
    (steps, batch, V) logits on the host."""
    import torch
    from chatterbox_tpu_torch.models.t3 import backbone as bb
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.sampling.decode import build_prefix, decode_step
    x = build_prefix(params, hp, cond, text.to(dev), batch, cfg_mode)
    Pn = x.shape[1]
    cache = bb.KVCache.zeros(hp.backbone, batch, Pn + len(forced), dev)
    h = bb.backbone_apply(params["backbone"], hp.backbone, x,
                          torch.arange(Pn, device=dev)[None].expand(batch, -1), cache, 0)
    out = [t3m.speech_logits(params, h[:, -1]).float()]
    for i, tok in enumerate(forced[:-1]):
        out.append(decode_step(params, hp, torch.tensor(tok, device=dev), i, cache, Pn + i))
    return torch.stack(out).cpu()


def _t3_reference(hp, batch, cfg_mode, seed, label):
    import numpy as np
    import torch
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.utils.quantize import quantize_t3_backbone
    cpu = quantize_t3_backbone(t3m.t3_init(hp, seed=seed, device="cpu"), mode="int8_fused")
    rng = np.random.default_rng(seed)
    spk = torch.from_numpy(rng.standard_normal((1, 256)).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, 6561, (1, 8)))
    text = torch.from_numpy(rng.integers(0, 64, (1, 12)))
    forced = [int(t) for t in rng.integers(0, 6561, 12)]
    emo = torch.full((1, 1, 1), 0.5)

    def logits(params, dev):
        cond = t3m.T3CondTensors(spk.to(dev), prompt.to(dev), emo.to(dev))
        return _teacher_forced(params, hp, cond, text, forced, batch, cfg_mode, dev)

    with torch.no_grad():
        ref, out = logits(cpu, "cpu"), logits(_to(cpu, "cuda"), "cuda")
    err = (out - ref).abs().max().item() / ref.abs().max().item()
    log(f"reference T3 ({label}): teacher-forced logits cuda vs cpu, max err "
        f"{err:.3e} of scale")
    # bf16 roundings inside the kernels and the bf16 cache may land on the
    # other side for another summation order (same bound as the CPU tests)
    if not err <= 3e-3:
        raise AssertionError(f"T3 logits on the card disagree with the CPU path: {err}")


def _s3gen_reference(meanflow, seed, label, **tail):
    import numpy as np
    import torch
    from chatterbox_tpu_torch.models.s3gen.flow import FlowDims
    from chatterbox_tpu_torch.models.s3gen.hift import SourceNoise
    from chatterbox_tpu_torch.models.s3gen.model import (RefDict, S3GenEngine, S3GenNoise,
                                                         pack_tokens, s3gen_init)
    rng = np.random.default_rng(seed)
    dims = FlowDims.tiny_test()
    s3 = s3gen_init(seed=seed, device="cpu", meanflow=meanflow, dims=dims, hift_base=32)
    ref_d = RefDict(rng.integers(0, 6561, (1, 20)), np.array([20]),
                    (rng.standard_normal((1, 40, 80)) * 0.5).astype(np.float32),
                    rng.standard_normal((1, 192)).astype(np.float32))
    gen = torch.from_numpy(rng.integers(0, 6561, (30,)))
    n_tok = pack_tokens(gen, 30, torch.zeros((1, 20), dtype=torch.long), **tail).shape[1]
    g = torch.Generator().manual_seed(seed)
    noise = S3GenNoise(torch.randn((1, 2 * n_tok, 80), generator=g),
                       SourceNoise.draw(1, 2 * (n_tok - 20), g, "cpu"))
    noise_cuda = S3GenNoise(noise.z.cuda(), SourceNoise(*(t.cuda() for t in noise.source)))
    w_ref, _ = S3GenEngine(s3, dims=dims, meanflow=meanflow).inference_from_decode(
        gen, 30, ref_d, noise=noise, **tail)
    w_out, _ = S3GenEngine(_to(s3, "cuda"), dims=dims, meanflow=meanflow).inference_from_decode(
        gen.cuda(), 30, ref_d, noise=noise_cuda, **tail)
    err = float(np.abs(w_out - w_ref).max())
    log(f"reference S3Gen ({label}): waveform cuda vs cpu, max abs err {err:.3e} "
        f"(scale {np.abs(w_ref).max():.3f})")
    # float32 with cuDNN TF32 off: summation order only
    if not (w_out.shape == w_ref.shape and np.isfinite(w_out).all() and err <= 1e-4):
        raise AssertionError(f"S3Gen waveform on the card disagrees with the CPU path: {err}")


def check_reference():
    from chatterbox_tpu_torch.models.t3.config import T3Config
    _t3_reference(T3Config(text_tokens_dict_size=64, backbone_name="GPT2_fused_test",
                           speech_tokens_dict_size=6564, input_pos_emb=None,
                           speech_cond_prompt_len=8, use_perceiver_resampler=False,
                           emotion_adv=False),
                  batch=1, cfg_mode=False, seed=3, label="Turbo family, GPT2_fused_test")
    _s3gen_reference(True, 4, "meanflow, 2 steps", append_sil=3)
    _t3_reference(T3Config(text_tokens_dict_size=64, backbone_name="Llama_fused_test",
                           speech_tokens_dict_size=6564, speech_cond_prompt_len=8,
                           max_text_tokens=64, max_speech_tokens=128),
                  batch=2, cfg_mode=True, seed=5,
                  label="520M family, Llama_fused_test, CFG batch 2")
    _s3gen_reference(False, 6, "CFG, 10 steps", cfg_slice=True)


# ---------------------------------------------------------------------------
# phase 5: the main paths
# ---------------------------------------------------------------------------

class _Tokenizer:
    """Stand-in text tokenizer: n ids below `vocab` from the text's bytes."""

    def __init__(self, n: int, vocab: int):
        self.n, self.vocab = n, vocab

    def text_to_tokens(self, text):
        import numpy as np
        b = np.frombuffer(text.encode().ljust(self.n)[:self.n], np.uint8)
        return (b.astype(np.int32) * 97 % self.vocab)[None]


def synthetic_conds(hp, emotion_adv: float):
    import numpy as np
    from chatterbox_tpu_torch import Conditionals, RefDict, T3CondHost
    rng = np.random.default_rng(0)
    return Conditionals(
        T3CondHost(np.zeros((1, 256), np.float32),
                   np.zeros((1, hp.speech_cond_prompt_len), np.int32), emotion_adv),
        RefDict(rng.integers(0, 6561, (1, P_PROMPT)).astype(np.int32),
                np.asarray([P_PROMPT], np.int32),
                (rng.standard_normal((1, 2 * P_PROMPT, 80)) * 0.1).astype(np.float32),
                rng.standard_normal((1, 192)).astype(np.float32)))


def vocoded_tokens(res, cfg_slice: bool) -> int:
    """The count of tokens the S3Gen tail keeps, computed on the host from
    the decode result: Turbo drops ids >= 6561 and appends 3 silence tokens;
    the CFG tail keeps the ids strictly between the first SOS and the first
    EOS, drops ids >= 6561 and vocodes one silence token if none is left."""
    import numpy as np
    toks = res.tokens.cpu().numpy()[: int(res.n_tokens)]
    if not cfg_slice:
        return int((toks < S3_VOCAB).sum()) + 3
    sos, eos = np.nonzero(toks == SOS)[0], np.nonzero(toks == EOS)[0]
    toks = toks[(sos[0] + 1 if len(sos) else 0):(eos[0] if len(eos) else len(toks))]
    return max(int((toks < S3_VOCAB).sum()), 1)


def run_path(tts, K, label, kernels, other, gen_kw, decode_kw, cfg_slice):
    """Warm-up, three timed generate runs with the launch counts set to 0
    just before and read just after, then a split run and a decode-step
    profile. Returns the launch counts of the timed runs."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.sampling.decode import t3_generate
    text = "The quick brown fox jumps over the lazy dog near the river bank."
    tts.generate(text, **gen_kw)                               # warm-up
    torch.cuda.synchronize()
    for k in K.launches:
        K.launches[k] = 0
    totals, forwards, audio_s = [], 0, None
    for _ in range(3):
        t0 = time.perf_counter()
        wav = tts.generate(text, **gen_kw)
        totals.append(time.perf_counter() - t0)
        res = tts.last_decode
        forwards += res.n_forward
        n_voc = vocoded_tokens(res, cfg_slice)
        expect = (1, n_voc * 2 * 480)
        if wav.shape != expect or not np.isfinite(wav).all() or np.abs(wav).max() == 0:
            raise AssertionError(f"{label}: waveform {wav.shape} (expected {expect}), "
                                 f"finite={np.isfinite(wav).all()}")
        audio_s = n_voc / 25.0
    counts = dict(K.launches)
    L = tts.hp.backbone.num_layers
    for name in kernels:
        log(f"launches {name} ({label}): {counts[name]} (expected {L} x {forwards} "
            f"decode steps)")
        if counts[name] != L * forwards:
            raise AssertionError(f"{name} launched {counts[name]} times, "
                                 f"expected {L * forwards}")
    for name in other:
        if counts[name]:
            raise AssertionError(f"{name} launched {counts[name]} times on the "
                                 f"{label} path, which does not run it")
    best = min(totals)
    log(f"{label} generate: {[round(t, 4) for t in totals]} s for {audio_s:.2f} s of "
        f"audio ({n_voc} vocoded tokens of {N_TOKENS}) -> x-realtime "
        f"{audio_s / best:.3f} (best of 3)")

    # split run: T3 decode and S3Gen vocode timed apart
    ids = torch.as_tensor(decode_kw.pop("ids"), device="cuda").long()
    sp = decode_kw.pop("sp")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = t3_generate(tts.t3_params, tts.hp, tts.conds.t3.as_tensors("cuda"), ids, sp,
                      max_new_tokens=N_TOKENS, ignore_eos=True, generator=tts.generator,
                      **decode_kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tts.s3gen.inference_from_decode(res.tokens, res.n_tokens, tts.conds.gen,
                                    generator=tts.generator,
                                    **({"cfg_slice": True} if cfg_slice else {"append_sil": 3}))
    t2 = time.perf_counter()
    log(f"{label} T3 decode: {t1 - t0:.4f} s for {N_TOKENS} tokens -> "
        f"{N_TOKENS / (t1 - t0):.1f} tok/s ({(t1 - t0) / N_TOKENS * 1e3:.3f} ms/token); "
        f"S3Gen: {t2 - t1:.4f} s")
    profile_decode(tts, ids, sp, decode_kw, (t1 - t0) / N_TOKENS, label)
    return counts


def _profiled_decode(tts, ids, sp, decode_kw, n: int) -> dict:
    """{kernel name: (device us, calls)} of one decode of n tokens."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chatterbox_tpu_torch.sampling.decode import t3_generate
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t3_generate(tts.t3_params, tts.hp, tts.conds.t3.as_tensors("cuda"), ids, sp,
                    max_new_tokens=n, ignore_eos=True, generator=tts.generator,
                    **decode_kw)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        # device-side events only: the CPU operator rows carry their
        # kernels' time too and would count it twice
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = (e.self_device_time_total, e.count)
    return out


def profile_decode(tts, ids, sp, decode_kw, step_s: float, label: str,
                   n1: int = 9, n2: int = 41):
    """Device time of one decode step by kernel name (torch.profiler): the
    difference of a n2-token and a n1-token decode, so the prefill they
    share drops out; beside the unprofiled wall time of a step."""
    a = _profiled_decode(tts, ids, sp, decode_kw, n1)
    b = _profiled_decode(tts, ids, sp, decode_kw, n2)
    steps = n2 - n1
    rows = [((b[k][0] - a.get(k, (0.0, 0))[0]) / steps,
             (b[k][1] - a.get(k, (0.0, 0))[1]) / steps, k) for k in b]
    total = sum(r[0] for r in rows)
    if total <= 0:
        log(f"{label} decode profile: the profiler saw no device time (not measured)")
        return
    log(f"{label} decode profile: {total:.1f} us of device time per decode step "
        f"against {step_s * 1e6:.1f} us of wall per step -> device busy "
        f"{100 * total / (step_s * 1e6):.1f} %")
    for us, calls, key in sorted(rows, reverse=True)[:14]:
        log(f"  {us:9.2f} us/step {100 * us / total:5.1f} % {calls:7.1f} calls/step  {key[:80]}")


def main_paths(turbo, cfg520, K, rows):
    from chatterbox_tpu_torch.ops.sampling import SamplerParams
    gpt2 = ("ln_qkv_int8", "attnout_ln_mlp_int8")
    llama = ("rms_qkv_int8", "attnout_rms_glu_int8")
    text = "The quick brown fox jumps over the lazy dog near the river bank."
    counts = run_path(
        turbo, K, "Turbo", gpt2, llama,
        dict(max_new_tokens=N_TOKENS, top_k=1000, temperature=0.8, top_p=0.95,
             repetition_penalty=1.2, ignore_eos=True),
        dict(ids=turbo.tokenizer.text_to_tokens(text), sp=SamplerParams(0.8, 0.95, 1.2),
             top_k=1000), cfg_slice=False)
    kw = dict(temperature=0.8, top_p=1.0, min_p=0.05, repetition_penalty=1.2,
              cfg_weight=0.5)
    counts_cfg = run_path(
        cfg520, K, "520M CFG", llama, gpt2,
        dict(max_new_tokens=N_TOKENS, exaggeration=0.5, ignore_eos=True, **kw),
        dict(ids=cfg520.frame_text(text), sp=SamplerParams(**kw), cfg_mode=True),
        cfg_slice=True)
    for r in rows:
        r["launches"] = (counts if r["name"] in gpt2 else counts_cfg)[r["name"]]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    try:
        from chatterbox_tpu_torch import ChatterboxTTS, ChatterboxTurboTTS
        from chatterbox_tpu_torch.kernels import build
        from chatterbox_tpu_torch.kernels import fused_layer as K
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = smi()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {nvcc_version(build)}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = build.build_all(force=True)
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    turbo = ChatterboxTurboTTS.random_init(tokenizer=_Tokenizer(30, 50000), seed=0,
                                           device="cuda")
    turbo.conds = synthetic_conds(turbo.hp, 0.0)
    # 28 ids + SOT/EOT: the 30-token text of bench.py's 520M run
    cfg520 = ChatterboxTTS.random_init(tokenizer=_Tokenizer(28, 704), seed=10,
                                       device="cuda")
    cfg520.conds = synthetic_conds(cfg520.hp, 0.5)
    torch.cuda.synchronize()
    log(f"models built in {time.perf_counter() - t0:.1f} s (T3 {turbo.hp.backbone_name} "
        f"and {cfg520.hp.backbone_name} bf16 int8_fused, S3Gen float32)")

    rows = check_kernels(turbo, cfg520, K)
    check_reference()
    main_paths(turbo, cfg520, K, rows)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
