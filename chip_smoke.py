#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (chatterbox_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final "ok" line:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA /
     nvcc versions; build every CUDA kernel from csrc/ (one nvcc each,
     started together);
  2. model: the Turbo pipeline at full width with random weights from a
     seed: GPT-2-medium T3 cast to bf16 and quantized int8_fused, meanflow
     S3Gen (default FlowDims, HiFT base 512) in float32;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes and on its 24 real layers' weights; kernel,
     plain and library (torch.matmul on pre-dequantized bf16 weights) times
     over all 24 layers (75 MB / 227 MB of weights, more than the 50 MB L2);
  4. reference: the CUDA path against the CPU path (plain kernel versions)
     on a small model, same weights and noise: T3 teacher-forced logits and
     the S3Gen waveform;
  5. main path: ChatterboxTurboTTS.generate with the benchmark settings of
     bench.py (synthetic conditionals, P=125, 250 tokens with EOS ignored,
     top_k 1000, temperature 0.8, top_p 0.95, repetition penalty 1.2), once
     to warm up, then three timed runs with the launch counts set to 0 just
     before and read just after; then one split run for T3 and S3Gen times.
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

def check_kernels(tts, K):
    import torch
    dev = "cuda"
    layers = [lp["fused"] for lp in tts.t3_params["backbone"]["layers"]]
    cfg = tts.hp.backbone
    D, I, N, B, L = cfg.hidden_size, cfg.intermediate_size, 3 * cfg.hidden_size, 1, len(layers)
    eps = cfg.layer_norm_eps
    g = torch.Generator(device=dev).manual_seed(1)
    xs = [torch.randn((B, D), generator=g, device=dev).bfloat16() for _ in range(L)]
    as_ = [(0.5 * torch.randn((B, D), generator=g, device=dev)).bfloat16() for _ in range(L)]

    def b1(i, f=K.ln_qkv_int8):
        fl = layers[i]
        return f(xs[i], fl["g1"], fl["b1"], fl["qkv_wt"], fl["qkv_s"], fl["qkv_b"], eps)

    def b2(i, f=K.attnout_ln_mlp_int8):
        fl = layers[i]
        return f(as_[i], xs[i], fl["wo_t"], fl["wo_s"], fl["wo_b"], fl["g2"], fl["b2"],
                 fl["w1_t"], fl["s1"], fl["fc1_b"], fl["w2_t"], fl["s2"], fl["fc2_b"], eps)

    # Tolerances: B1 sums the same exact f32 products in another order
    # (f32 rounding on outputs of order 10). B2 also rounds LN2 and the
    # hidden units to bf16: a value that lands on the other side of a bf16
    # rounding boundary moves the outputs by ~1e-4.
    tol = {"ln_qkv_int8": 1e-3, "attnout_ln_mlp_int8": 1e-2}
    errs = {"ln_qkv_int8": 0.0, "attnout_ln_mlp_int8": 0.0}
    for i in range(L):
        for name, fn, plain in (("ln_qkv_int8", b1, K.ln_qkv_int8_plain),
                                ("attnout_ln_mlp_int8", b2, K.attnout_ln_mlp_int8_plain)):
            out, ref = fn(i), fn(i, plain)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError(f"{name} layer {i}: non-finite output")
            errs[name] = max(errs[name], (out - ref).abs().max().item())
    for name, e in errs.items():
        log(f"kernel check {name}: max_abs_err {e:.3e} over {L} layers (tol {tol[name]})")
        if not e <= tol[name]:
            raise AssertionError(f"{name} disagrees with its plain version: {e}")

    # library yardstick: torch.matmul on pre-dequantized bf16 weights
    deq = lambda wt, s: (wt.float().T * s).bfloat16()
    lib1 = [deq(fl["qkv_wt"], fl["qkv_s"]) for fl in layers]
    lib2 = [(deq(fl["wo_t"], fl["wo_s"]), deq(fl["w1_t"], fl["s1"]), deq(fl["w2_t"], fl["s2"]))
            for fl in layers]
    hs = [torch.randn((B, I), generator=g, device=dev).bfloat16() for _ in range(L)]

    def all_layers(f):
        return lambda: [f(i) for i in range(L)]

    def lib_b2(i):
        wo, w1, w2 = lib2[i]
        torch.matmul(as_[i], wo)
        torch.matmul(xs[i], w1)
        torch.matmul(hs[i], w2)

    reps = {"kernel": 50, "plain": 5, "library": 50}
    vec = 4
    bytes_ = {
        "ln_qkv_int8": D * N + 2 * N * vec + 2 * D * vec + B * D * 2 + B * N * 4,
        "attnout_ln_mlp_int8": (D * D + D * I + I * D) + (6 * D + 2 * I) * vec
                               + 2 * B * D * 2 + B * D * 4,
    }
    ops = {"ln_qkv_int8": 2 * B * D * N, "attnout_ln_mlp_int8": 2 * B * (D * D + 2 * D * I)}
    rows = []
    for name, fn, plain, lib, src_line in (
            ("ln_qkv_int8", b1, K.ln_qkv_int8_plain,
             lambda i: torch.matmul(xs[i], lib1[i]), "chatterbox_tpu/ops/fused_layer.py:328"),
            ("attnout_ln_mlp_int8", b2, K.attnout_ln_mlp_int8_plain, lib_b2,
             "chatterbox_tpu/ops/fused_layer.py:401")):
        eager_ms = eager_time_ms(all_layers(fn), reps["kernel"]) / L
        ms = device_time_ms(all_layers(fn), reps["kernel"]) / L
        plain_ms = device_time_ms(all_layers(lambda i: fn(i, plain)), reps["plain"]) / L
        lib_ms = device_time_ms(all_layers(lib), reps["library"]) / L
        t_bytes = bytes_[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[name] / PEAK_INT8_OPS * 1e3
        rows.append({"name": name, "route": "cuda",
                     "source": "chatterbox_tpu_torch/csrc/fused_layer.cu",
                     "replaces": src_line, "launches": 0,
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": lib_ms})
        log(f"kernel time {name}: {ms * 1e3:.2f} us/call on the card (plain "
            f"{plain_ms * 1e3:.2f}, library {lib_ms * 1e3:.2f}, bound "
            f"{max(t_bytes, t_ops) * 1e3:.2f} us for {bytes_[name] / 1e6:.3f} MB); "
            f"{eager_ms * 1e3:.2f} us/call launched from Python")
    del lib1, lib2
    return rows


# ---------------------------------------------------------------------------
# phase 4: the CUDA path against the CPU path on a small model
# ---------------------------------------------------------------------------

def _to(tree, device):
    import torch
    if isinstance(tree, dict):
        out = {k: _to(v, device) for k, v in tree.items()}
        if "fused" in out:            # keep the layer's w_q a view of the fused copy
            from chatterbox_tpu_torch.kernels.fused_layer import prepare_fused_gpt2_layer_int8
            del out["fused"]
            out["fused"] = prepare_fused_gpt2_layer_int8(out)
        return out
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def check_reference():
    import numpy as np
    import torch
    from chatterbox_tpu_torch.models.s3gen.flow import FlowDims
    from chatterbox_tpu_torch.models.s3gen.hift import SourceNoise
    from chatterbox_tpu_torch.models.s3gen.model import (RefDict, S3GenEngine, S3GenNoise,
                                                         s3gen_init)
    from chatterbox_tpu_torch.models.t3 import backbone as bb
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.models.t3.config import T3Config
    from chatterbox_tpu_torch.nn import core as nn
    from chatterbox_tpu_torch.utils.quantize import quantize_t3_backbone

    hp = T3Config(text_tokens_dict_size=64, backbone_name="GPT2_fused_test",
                  speech_tokens_dict_size=6564, input_pos_emb=None,
                  speech_cond_prompt_len=8, use_perceiver_resampler=False,
                  emotion_adv=False)
    cpu = quantize_t3_backbone(t3m.t3_init(hp, seed=3, device="cpu"), mode="int8_fused")
    rng = np.random.default_rng(3)
    spk = torch.from_numpy(rng.standard_normal((1, 256)).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, 6561, (1, 8)))
    text = torch.from_numpy(rng.integers(0, 64, (1, 12)))
    forced = [int(t) for t in rng.integers(0, 6561, 12)]

    def logits(params, dev):
        cond = t3m.T3CondTensors(spk.to(dev), prompt.to(dev))
        parts = t3m.cond_embeds(params, hp, cond)
        parts.append(nn.embedding(params["text_emb"], text.to(dev)))
        parts.append(nn.embedding(params["speech_emb"],
                                      torch.tensor([[hp.start_speech_token]], device=dev)))
        x = torch.cat(parts, dim=1)
        Pn = x.shape[1]
        cache = bb.KVCache.zeros(hp.backbone, 1, Pn + len(forced), dev)
        h = bb.backbone_apply(params["backbone"], hp.backbone, x,
                              torch.arange(Pn, device=dev)[None], cache, 0)
        out = [t3m.speech_logits(params, h[:, -1])]
        for i, tok in enumerate(forced[:-1]):
            e = nn.embedding(params["speech_emb"], torch.tensor([[tok]], device=dev))
            h = bb.backbone_apply(params["backbone"], hp.backbone, e,
                                  torch.tensor([[Pn + i]], device=dev), cache, Pn + i)
            out.append(t3m.speech_logits(params, h[:, 0]))
        return torch.cat(out).float().cpu()

    with torch.no_grad():
        ref, out = logits(cpu, "cpu"), logits(_to(cpu, "cuda"), "cuda")
    err = (out - ref).abs().max().item() / ref.abs().max().item()
    log(f"reference T3: teacher-forced logits cuda vs cpu, max err {err:.3e} of scale")
    # bf16 roundings inside the kernels and the bf16 cache may land on the
    # other side for another summation order (same bound as the CPU tests)
    if not err <= 3e-3:
        raise AssertionError(f"T3 logits on the card disagree with the CPU path: {err}")

    dims = FlowDims.tiny_test()
    s3 = s3gen_init(seed=4, device="cpu", dims=dims, hift_base=32)
    ref_d = RefDict(rng.integers(0, 6561, (1, 20)), np.array([20]),
                    (rng.standard_normal((1, 40, 80)) * 0.5).astype(np.float32),
                    rng.standard_normal((1, 192)).astype(np.float32))
    gen = torch.from_numpy(rng.integers(0, 6561, (30,)))
    g = torch.Generator().manual_seed(5)
    noise = S3GenNoise(torch.randn((1, 2 * 53, 80), generator=g),
                       SourceNoise.draw(1, 2 * 33, g, "cpu"))
    noise_cuda = S3GenNoise(noise.z.cuda(), SourceNoise(*(t.cuda() for t in noise.source)))
    w_ref, _ = S3GenEngine(s3, dims=dims).inference_from_decode(gen, 30, ref_d, noise=noise,
                                                                append_sil=3)
    w_out, _ = S3GenEngine(_to(s3, "cuda"), dims=dims).inference_from_decode(
        gen.cuda(), 30, ref_d, noise=noise_cuda, append_sil=3)
    err = float(np.abs(w_out - w_ref).max())
    log(f"reference S3Gen: waveform cuda vs cpu, max abs err {err:.3e} "
        f"(scale {np.abs(w_ref).max():.3f})")
    # float32 with cuDNN TF32 off: summation order only
    if not (w_out.shape == w_ref.shape and np.isfinite(w_out).all() and err <= 1e-4):
        raise AssertionError(f"S3Gen waveform on the card disagrees with the CPU path: {err}")


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

class _Tokenizer:
    """Stand-in text tokenizer: 30 GPT-2-range ids from the text's bytes."""

    def text_to_tokens(self, text):
        import numpy as np
        b = np.frombuffer(text.encode().ljust(30)[:30], np.uint8)
        return (b.astype(np.int32) * 97 % 50000)[None]


def synthetic_conds(hp):
    import numpy as np
    from chatterbox_tpu_torch import Conditionals, RefDict, T3CondHost
    rng = np.random.default_rng(0)
    return Conditionals(
        T3CondHost(np.zeros((1, 256), np.float32),
                   np.zeros((1, hp.speech_cond_prompt_len), np.int32), 0.0),
        RefDict(rng.integers(0, 6561, (1, P_PROMPT)).astype(np.int32),
                np.asarray([P_PROMPT], np.int32),
                (rng.standard_normal((1, 2 * P_PROMPT, 80)) * 0.1).astype(np.float32),
                rng.standard_normal((1, 192)).astype(np.float32)))


def main_path(tts, K, rows):
    import numpy as np
    import torch
    from chatterbox_tpu_torch.ops.sampling import SamplerParams
    from chatterbox_tpu_torch.sampling.decode import t3_generate

    text = "The quick brown fox jumps over the lazy dog near the river bank."
    kw = dict(max_new_tokens=N_TOKENS, top_k=1000, temperature=0.8, top_p=0.95,
              repetition_penalty=1.2, ignore_eos=True)
    tts.generate(text, **kw)                                  # warm-up
    torch.cuda.synchronize()
    for k in K.launches:
        K.launches[k] = 0
    totals, forwards, n_out = [], 0, None
    for _ in range(3):
        t0 = time.perf_counter()
        wav = tts.generate(text, **kw)
        totals.append(time.perf_counter() - t0)
        res = tts.last_decode
        forwards += res.n_forward
        n_valid = int((res.tokens[: int(res.n_tokens)] < 6561).sum())
        expect = (1, (n_valid + 3) * 2 * 480)
        if wav.shape != expect or not np.isfinite(wav).all() or np.abs(wav).max() == 0:
            raise AssertionError(f"waveform {wav.shape} (expected {expect}), "
                                 f"finite={np.isfinite(wav).all()}")
        n_out = n_valid + 3
    counts = dict(K.launches)
    L = tts.hp.backbone.num_layers
    for name, n in counts.items():
        log(f"launches {name}: {n} (expected {L} x {forwards} decode steps)")
        if n != L * forwards:
            raise AssertionError(f"{name} launched {n} times, expected {L * forwards}")
    for r in rows:
        r["launches"] = counts[r["name"]]
    audio_s = n_out / 25.0
    best = min(totals)
    log(f"turbo generate: {[round(t, 4) for t in totals]} s for {audio_s:.2f} s of audio "
        f"-> x-realtime {audio_s / best:.3f} (best of 3)")

    # split run: T3 decode and S3Gen vocode timed apart
    sp = SamplerParams(0.8, 0.95, 1.2)
    ids = torch.as_tensor(tts.tokenizer.text_to_tokens(text), device="cuda").long()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = t3_generate(tts.t3_params, tts.hp, tts.conds.t3.as_tensors("cuda"), ids, sp,
                      max_new_tokens=N_TOKENS, top_k=1000, ignore_eos=True,
                      generator=tts.generator)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tts.s3gen.inference_from_decode(res.tokens, res.n_tokens, tts.conds.gen,
                                    generator=tts.generator, append_sil=3)
    t2 = time.perf_counter()
    log(f"T3 decode: {t1 - t0:.4f} s for {N_TOKENS} tokens -> {N_TOKENS / (t1 - t0):.1f} "
        f"tok/s ({(t1 - t0) / N_TOKENS * 1e3:.3f} ms/token); S3Gen: {t2 - t1:.4f} s")
    profile_decode(tts, ids, sp, (t1 - t0) / N_TOKENS)


def _profiled_decode(tts, ids, sp, n: int) -> dict:
    """{kernel name: (device us, calls)} of one decode of n tokens."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chatterbox_tpu_torch.sampling.decode import t3_generate
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t3_generate(tts.t3_params, tts.hp, tts.conds.t3.as_tensors("cuda"), ids, sp,
                    max_new_tokens=n, top_k=1000, ignore_eos=True, generator=tts.generator)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        # device-side events only: the CPU operator rows carry their
        # kernels' time too and would count it twice
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = (e.self_device_time_total, e.count)
    return out


def profile_decode(tts, ids, sp, step_s: float, n1: int = 9, n2: int = 41):
    """Device time of one decode step by kernel name (torch.profiler): the
    difference of a n2-token and a n1-token decode, so the prefill they
    share drops out; beside the unprofiled wall time of a step."""
    a, b = _profiled_decode(tts, ids, sp, n1), _profiled_decode(tts, ids, sp, n2)
    steps = n2 - n1
    rows = [((b[k][0] - a.get(k, (0.0, 0))[0]) / steps,
             (b[k][1] - a.get(k, (0.0, 0))[1]) / steps, k) for k in b]
    total = sum(r[0] for r in rows)
    if total <= 0:
        log("decode profile: the profiler saw no device time (not measured)")
        return
    log(f"decode profile: {total:.1f} us of device time per decode step against "
        f"{step_s * 1e6:.1f} us of wall per step -> device busy "
        f"{100 * total / (step_s * 1e6):.1f} %")
    for us, calls, key in sorted(rows, reverse=True)[:14]:
        log(f"  {us:9.2f} us/step {100 * us / total:5.1f} % {calls:7.1f} calls/step  {key[:80]}")


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
        from chatterbox_tpu_torch import ChatterboxTurboTTS
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
    tts = ChatterboxTurboTTS.random_init(tokenizer=_Tokenizer(), seed=0, device="cuda")
    tts.conds = synthetic_conds(tts.hp)
    torch.cuda.synchronize()
    log(f"model built in {time.perf_counter() - t0:.1f} s "
        f"(T3 {tts.hp.backbone_name} bf16 int8_fused, S3Gen float32)")

    rows = check_kernels(tts, K)
    check_reference()
    main_path(tts, K, rows)
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
