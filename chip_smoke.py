#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (chatterbox_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab <other checkout>
    torchrun --nproc-per-node 4 chip_smoke.py --mesh

The second form runs phases 1 and 2, then times the fused decode-layer
kernels (B1, B2, B5, B6, and B9, B10 on the Turbo int4_fused weights) and
B11 of this checkout against those of the other at 1, 2, 8 and 16 rows, B8 on
the 520M int4 weights at 1, 2 and 8 rows (f32 result), and the
decode-attention kernels (B3, B4, B7) at phase 3's attention shapes, in
turns on the same operands, and stops. The third runs phase 12's two
decodes over all the world's cards (the 520M CFG T3 at dp 2 x tp N/2 in
bf16 and in float32, the Turbo T3 at data N with 8 rows), each process
holding the unsharded decodes on its own card; process 0 prints the
tokens' agreement, ms/token and ms/step, and the last line.

The port's paths, each at full width with random weights from a seed,
served as bench.py serves them (T3 cast to bf16 and quantized int8_fused,
S3Gen in float32 with default FlowDims and HiFT base 512), and the same T3
weights quantized to int4:
  * Turbo: GPT-2-medium T3 (24 layers), meanflow S3Gen; kernels B1, B2;
  * 520M CFG: T3Config.english_only() (Llama-520M, 30 layers, perceiver,
    emotion input, learned positions), batch-2 CFG decode, 10-step CFG
    S3Gen; kernels B5, B6;
  * both with kv_int8=True: the int8 KV cache read by B4;
  * t3_generate(fused_attn=True) on the bf16 cache: B3 (tile-aligned
    cache), B7 (a cache of another length);
  * the batched engine behind BatchDecoder with the int8 cache: 8 Turbo
    requests, 4 CFG requests (8 rows); B1 / B2 or B5 / B6 at 8 rows, B4
    with each row's left pad as its lower bound;
  * Turbo on an int4_fused T3: B9, B10 (one pair per layer and step);
  * 520M CFG on an int4 T3: B8 (the seven linears of every layer, 2 rows).
  * Turbo from a checkpoint directory and a prompt file: from_local, then
    generate(text, audio_prompt_path=wav) with the frontend (resampler,
    mels, S3 tokenizer, CAMPPlus, voice encoder) on the card; B1, B2.
  * both pipelines' generate_stream: the chunked decode (B1 / B2 or B5 /
    B6 a layer and step) and the streaming vocoder; and voice conversion
    (ChatterboxVC from a checkpoint directory), on no kernel.
  * the multilingual pipeline from a checkpoint directory
    (ChatterboxMultilingualTTS.from_local: Llama-520M with the 2454-token
    grapheme vocabulary, MTLTokenizer), requests in French, Korean and
    Chinese, and its generate_stream; kernels B5, B6;
  * speculative Turbo decode: a bf16 target verifying the drafts of its
    own int8_fused self-draft (generate(draft="int8")); kernels B1, B2 in
    the draft, none in the verify; and a Nano draft pipeline (plain int8,
    no kernel).
  * batched serving: the batched vocode (S3GenEngine.inference_batch, one
    masked flow call for rows of different voices; no kernel),
    TTSServer and ServingLoop over BatchDecoder (Turbo, int8 cache: B1,
    B2, B4), and the continuous slot engine ContinuousTTSServer behind
    ContinuousServingLoop (8 Turbo slots on the int8 cache: B1, B2, B4 with
    each row's position as its `cur`; 4 CFG slots, 8 rows: B5, B6).
  * the speculative slot path: ContinuousTTSServer(draft_int8=True) over a
    bf16 Turbo T3 (B1, B2 in the int8_fused draft steps; the verify slab
    unfused); the serving surfaces: the HTTP front over BatchDecoder and
    the continuous server (B1, B2, B4), the MCP server, and the command
    line (`cli.main(["synth", ...])` from phase 6's checkpoint directory).
B11 (fused_mlp_int8) is on no path: nothing in the JAX package calls it
outside its own test. Phase 3 holds it against its plain version. H1
(hift_source, HiFT's harmonic source) is on every path that vocodes on
the card, once a hift_inference call.

Phases, in order; any failure exits non-zero without the final "ok" line:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA /
     nvcc versions, whether safetensors, tokenizers and transformers
     import; build every CUDA kernel from csrc/ (one nvcc each, started
     together);
  2. models: both pipelines;
  3. kernels: each kernel against its plain PyTorch version on the card,
     timed (kernel, plain, library; the share of its bound) over all the
     layers by CUDA-graph replay: B1 / B2 on the real Turbo weights at 1,
     2, 8 and 16 rows, B5 / B6 on the real 520M weights at 2, 1, 8 and 16
     rows; B9 / B10 on the Turbo int4_fused weights at 1, 2, 8 and 16 rows;
     B8 on every linear of the 520M int4 weights at 2, 1 and 8 rows (bf16
     result, as nn.linear asks for it); B11 on the Turbo
     int8 layers' ln2 / fc_in / fc_out at 1, 2, 8 and 16 rows, float32
     input as the JAX package's own test of it (library: torch.matmul on
     pre-dequantized bf16 weights); B3 / B4 / B7 on every
     layer's own random cache at the paths' shapes: Turbo B=1, T=768 at
     positions in cache tiles 1-3, 520M B=2, T=512, the batched B=8 with
     distinct left pads (one past a whole tile), B7 at T=657, and a long
     window (B=1, T=1536, position 1400) (library:
     scaled_dot_product_attention on the valid window, on a dequantized
     bf16 copy for B4), each shape with the split count B3 / B4 / B7 take
     there; first, a sweep of B3's and B4's kernel at 1, 2, 4, 8 and 16
     blocks a window at the Turbo, 520M, batched and long-window shapes,
     and of the tilings of B8 (columns a block, split of the packed rows;
     at each 520M linear shape, 2 and 8 rows) and B10 (columns a block for
     each phase, fc_out's split, dependent launch; 1 and 8 rows), and B6's,
     B2's and B11's chosen tilings with dependent launch on and off; H1
     at B = 1, as the VC path vocodes, over 1, 257, 1000 and 2000 frames
     with and without a phase carry, against the plain float64 cumsum
     path and against hift_source_framewise_plain (1e-6), timed at a 30 s
     source (1500 frames; library: the same framewise form in PyTorch ops,
     a float64 cumsum over the frames);
  4. reference: the CUDA path against the CPU path (plain kernel versions)
     on small models, same weights and noise: Turbo T3 teacher-forced
     logits on the bf16 and the int8 cache and meanflow S3Gen waveform;
     520M-family T3 teacher-forced CFG logits at batch 2 on both caches,
     a batched int8-cache CFG decode of 3 requests of distinct text
     lengths, and 10-step CFG S3Gen waveform; Turbo int4_fused and
     520M-family int4 (CFG, batch 2) teacher-forced logits;
  5. main paths, each with the launch counts set to 0 just before and read
     just after it (its own kernels launched layers x decode steps times,
     B8 seven times that, H1 once for each hift_inference call on the card,
     counted by a wrapper of hift_inference where S3GenEngine and the
     streaming vocoder call it, every other kernel not at all; this holds
     in every later phase that counts): each pipeline's
     generate once to warm up (32 tokens), then TIMED_RUNS requests timed as
     bench.py times them, t3_generate with EOS ignored then S3Gen's
     inference_from_decode with the pipeline's own tail (Turbo: 3 silence
     tokens; 520M: the SOS..EOS slice), on the text ids its generate makes
     (punc_norm; SOT/EOT framing for 520M): Turbo with bench.py's Turbo
     settings (synthetic conditionals, P=125, 250 tokens, top_k 1000,
     temperature 0.8, top_p 0.95, repetition penalty 1.2) and 520M CFG
     with bench.py's 520M settings (cfg_weight 0.5, temperature 0.8, top_p
     1.0, min_p 0.05, repetition penalty 1.2, exaggeration 0.5, 30 text
     tokens, 250 tokens), on the bf16 cache, with kv_int8=True, and on the
     int4 T3s (Turbo int4_fused, 520M int4); each with a profile of its
     decode step (device time and kernel launches per step, by kernel). Then t3_generate(fused_attn=True) of each family with a
     profile of its decode step, a teacher-forced Turbo decode over an
     unaligned cache, and each BatchDecoder serving its batch once and
     then timed for 250 tokens with EOS ignored, with a profile of its
     decode step;
  6. frontend: a Turbo checkpoint directory in the reference's layout
     (t3_turbo_v1, s3gen_meanflow and ve .safetensors from random
     full-width weights, a BPE tokenizer trained here) written to a
     temporary directory; from_local on the card, the loaded trees equal
     to the written ones; prepare_conditionals on a 6 s synthetic voice
     against the same call on the cpu (embeddings and prompt mels to 1e-3,
     at least 99 % of the S3 tokens equal), timed with its split; T3
     quantized int8_fused; generate(text, audio_prompt_path=wav) to warm
     up, then TIMED_RUNS requests timed as phase 5 times them with
     prepare_conditionals inside the timed window (B1 and B2 launched
     layers x steps times), x-realtime with and without the frontend, and
     the device's share of one profiled request;
  7. streaming and voice conversion: the chunked decode (t3_prefill_decode,
     then t3_decode_chunk, chunks of 25, EOS ignored) against t3_generate
     on the same 250 gumbel rows, every token equal, for both families;
     full-width HiFT over growing windows (96, 168, 240 frames) with the
     source cache against the one-shot vocode (1e-4); the streaming
     vocoder on the card against the cpu on a small S3Gen with the same
     numbers, four feed_from_decode feeds (1e-4, lengths exact); each
     pipeline's generate_stream (32 tokens) once to warm up, then
     STREAM_RUNS timed streams of 250 tokens in chunks of 25 (time to first audio,
     gaps between chunks, tokens, x-realtime; B1 / B2 or B5 / B6
     launched layers x decode steps times) and the device's share of one
     profiled stream;
     a 520M-family s3gen.safetensors (10-step CFM, random full-width
     weights) and conds.pt written to a temporary directory,
     ChatterboxVC.from_local on the card (the loaded leaves equal the
     written ones), set_target_voice on a 6 s voice, generate on a 10 s
     source once to warm up, then TIMED_RUNS timed runs (H1 launched once
     a run, no other kernel);
  8. multilingual and speculative: a multilingual checkpoint directory
     (t3_mtl23ls_v2.safetensors from random full-width weights, ve.pt and
     s3gen.pt, conds.pt, a grapheme vocabulary trained here with the 23
     language tags and the Cangjie code tokens, a small Cangjie5_TC.json)
     loaded by from_local on the card, the loaded leaves equal to the
     written ones; T3 quantized int8_fused; generate from a prompt file to
     warm up, then one request each in fr, ko (Jamo) and zh (Cangjie
     codes) timed as phase 5 times them (250 tokens, the 40 ms trim; B5 /
     B6 launched 30 x steps); the chunked decode against t3_generate on the
     same 250 gumbel rows; one timed generate_stream (time to first
     audio); a greedy generate_stream whose samples equal generate's. Then
     speculative Turbo: the seed-0 Turbo T3 in bf16, unquantized, as the
     verify target, its int8_fused self-draft; the verify slab's K+1 logits
     against K+1 single steps on the same cache (within 5 % of the logits'
     scale); greedy speculative tokens (250, EOS ignored) against
     sequential t3_generate (equal, or parting only where the sequential
     top-2 gap is below that bound); TIMED_RUNS timed decodes of 250 tokens at
     n_draft 4 and 8 (ms/token, acceptance, rounds; B1 / B2 launched 24 x
     (K+1) x rounds, nothing else), the sequential bf16 target and phase
     5's int8_fused Turbo in the same call; generate(draft="int8") end to
     end; a Nano draft pipeline (acceptance, ms/token over 50 tokens, no
     kernel).
  9. batched serving: three voices made by embed_ref from synthetic 5.2,
     6.0 and 6.8 s prompts (130, 150, 170 prompt tokens); the batched
     vocode of eight Turbo rows of 60-250 tokens in those voices on the
     meanflow S3Gen, and of four on the 10-step CFM S3Gen, each row against
     `inference` of it alone on the same noise (1e-4), the batch's wall
     against the single calls'; inference_batch_dispatch under CUDA's
     sync debug mode (no synchronising call), then the fetch; the
     CFM S3Gen at 16 rows with batched_bf16_min_b at its default (the flow
     in bf16) against None (float32): max |dwav| (under 0.05) and both
     walls; TTSServer.synthesize_batch of eight Turbo requests (int8_fused,
     kv_int8, EOS honoured) and a ServingLoop fed 16 (two batches of eight,
     run two deep), every result a finite wav, audio seconds per wall
     second, B1 / B2 / B4 launched 24 x decode steps; ContinuousTTSServer
     at 8 Turbo slots (int8_fused, kv_int8) behind a ContinuousServingLoop,
     16 requests in 4 waves 1 s apart with caps of 50-250 tokens, four of
     them streams (first_chunk 12, stream_chunk 25), the rest vocoded in
     the loop: aggregate tokens/s, each request's latency, the streams'
     first audio and gaps, one host read a round, B1 / B2 / B4 launched 24
     x decode steps, two requests against their isolated runs (token for
     token), a round under sync debug mode (no synchronising call) and the
     device's share
     of a profiled round; ContinuousTTSServer at 4 CFG slots (8 rows) on
     the 520M int8_fused T3 and its CFM S3Gen, six requests staggered and
     vocoded, B5 / B6 launched 30 x decode steps, one request against
     BatchDecoder's tokens for it alone.
 10. speculative slots and serving surfaces: the seed-0 Turbo T3 in bf16
     (phase 8's verify target) behind ContinuousTTSServer(draft_int8=True,
     n_draft=8), tokens only, at 1 slot (250 tokens) and at 4 slots (caps
     100-250), against the same server with draft off: tokens equal, or,
     where a request parts (reruns of both runs, a step or a round at a
     time), draft-on's token the sample of the verify's logits under draft
     off's gumbel row and sampler, those logits within VERIFY_TOL of draft
     off's there, and draft off's margin reported against NEAR_TIE; B1 / B2
     launched 24 x 8 x spec rounds and nothing else; one
     host read a dispatch; ms per emitted token with draft on and off and
     the acceptance (a rerun a round at a time); a dispatch under sync
     debug mode. TTSHTTPServer on 127.0.0.1:0 over phase 5's Turbo: a
     BatchDecoder (kv_int8, 100 tokens) answering 4 concurrent POST /tts,
     each a 24 kHz PCM16 RIFF, the same seed alone twice byte-equal,
     /v1/audio/speech as pcm, /vc against a registered voice (seeded:
     the same bytes twice), /metrics
     counting the requests; a 4-slot continuous backend (kv_int8) with a
     streamed POST /tts (time to its first audio byte); B1 / B2 / B4
     launched alike. MCPTTSServer.handle tools/call generate_speech. The
     command line in process: `info`, and `synth` from phase 6's
     checkpoint directory and prompt file, its WAV read back.
 11. training, over a DTensor mesh of this one card (an NCCL world of
     one): the Turbo T3 (24 x 1024, float32) through
     build_sharded_train_step, 8 rows of the runner's synthetic batches
     (text 48, speech 96), 6 steps with layer remat (ms a step, the median
     of steps 2-6; tokens a second; peak memory), one forward and backward
     without remat (the same loss and gradient norm), 10 steps on one
     fixed batch (loss_speech falls); the CFM flow at FlowDims() (8 rows of
     64 tokens) alike; a tiny T3 and a tiny flow stepped twice on the card
     and on the CPU (the same losses and, to Adam's noise bound, the same
     parameters); both runners in process at full width with a checkpoint
     and --resume, and train_flow --data on WAVs written here, read by the
     native loader; and, beside the runners, the sharded steps in 4 gloo
     processes on the host's CPU under this host's torch (tests/test_torch_parallel_worker:
     T3 at dp 2 x tp 2 in both families, a sharded save and resume, the
     flow at data 4), held to the same steps in one process, with the
     decodes over a mesh (t3_generate at dp 2 x tp 2, tiny llama with CFG
     and tiny GPT-2, greedy and sampled; t3_generate_batched at data 4, 8
     rows) giving one process's tokens, and train_flow's real_batches
     giving every process one global batch. No kernel of the port is
     launched.
 12. serving under a mesh, over a DTensor mesh of this one card (an NCCL
     world of one): the 520M CFG T3 (30 x 1024, bf16 from the seed's f32)
     through shard_t3_params and t3_generate, 100 tokens with EOS ignored
     on a seeded generator, against the unsharded t3_generate (tokens
     equal; ms/token of both); the Turbo T3 (24 x 1024, bf16) through
     replicate / shard_batch and t3_generate_batched at 8 rows, 100
     tokens, against the plain call (tokens equal row for row, rows of one
     input and seed equal; ms/step of both). No kernel is launched.
The line before the last is {"kernels": [...]} (launches summed over
phases 5-10), the last {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
PEAK_INT8_OPS = 1.979e15       # dense int8 tensor-core rate, same source
N_TOKENS = 250
WARMUP_TOKENS = 32             # a warm-up generate's tokens (every kernel built already)
TIMED_RUNS = 1                 # timed runs of a request, a decode or a conversion (best of)
P_PROMPT = 125
PHASE5_TEXT = "The quick brown fox jumps over the lazy dog near the river bank."
SOS, EOS, S3_VOCAB = 6561, 6562, 6561


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _imports(module: str) -> str:
    try:
        return f"{importlib.import_module(module).__version__} imports"
    except ImportError:
        return "does not import"


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

FUSED_SRC = "chatterbox_tpu_torch/csrc/fused_layer.cu"
ATTN_SRC = "chatterbox_tpu_torch/csrc/decode_attention.cu"
INT4_SRC = "chatterbox_tpu_torch/csrc/int4.cu"
PEAK_BF16_OPS = 989e12         # dense bf16 tensor-core rate (data sheet)


class KernelSpec:
    """One kernel on its path's layers: call(i, f) runs f (the kernel's
    wrapper or its plain version) on layer i's operands at batch B;
    library(i) is one PyTorch call (or a few) computing the same function
    (None where there is none); bytes_ and ops are what the function must
    move and compute at this batch, ops at the `peak` rate. tol bounds the
    max abs error, times max|plain| when `relative`."""

    def __init__(self, name, replaces, call, library, bytes_, ops, tol, kernel, plain,
                 peak=None, source=FUSED_SRC, relative=False):
        self.name, self.replaces, self.call, self.library = name, replaces, call, library
        self.bytes_, self.ops, self.tol = bytes_, ops, tol
        self.kernel, self.plain = kernel, plain
        self.peak = peak or PEAK_INT8_OPS
        self.source, self.relative = source, relative


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
# A bf16 result (B8 as nn.linear calls it): one bf16 ulp of the output's
# magnitude, where the f32 sums of the two orders round apart.
TOL_BF16 = 2.0 ** -8
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


def _deq4(w, s_lo, s_hi, axis: int):
    """A packed int4 weight in the JAX layout and its two group scales ->
    the bf16 weight it stands for: row split (axis 0, (K/2, N) -> (K, N))
    or column split (axis 1, (K, N/2) -> (K, N))."""
    import torch
    from chatterbox_tpu_torch.utils.quantize import unpack_int4
    halves = []
    for v, s in zip(unpack_int4(w), (s_lo, s_hi)):
        R, C = v.shape
        G = s.shape[0]
        halves.append((v.reshape(G, R // G, C) * s[:, None, :]).reshape(R, C))
    return torch.cat(halves, dim=axis).bfloat16()


def _deq_leaf(p):
    if "w_q4c" in p:
        return _deq4(p["w_q4c"], p["w_scale4c_lo"], p["w_scale4c_hi"], 1)
    return _deq4(p["w_q4"], p["w_scale4_lo"], p["w_scale4_hi"], 0)


def _int4_bytes(K, N):
    """Bytes of a (K, N) int4 weight: packed values and both halves' group
    scales (one f32 per 256 contraction rows and output column)."""
    return K * N // 2 + K * N // 256 * VEC


def int4_gpt2_specs(tts, K, B=1):
    """B9 / B10 on the Turbo int4_fused layers."""
    layers = tts.t3_params["backbone"]["layers"]
    fls = [lp["fused"] for lp in layers]
    cfg = tts.hp.backbone
    D, I, N, eps = cfg.hidden_size, cfg.intermediate_size, 3 * cfg.hidden_size, \
        cfg.layer_norm_eps
    xs, as_, hs = _inputs(len(layers), B, D, I, seed=3)
    lib9 = [_deq_leaf(lp["qkv"]) for lp in layers]
    lib10 = [tuple(_deq_leaf(lp[n]) for n in ("attn_out", "fc_in", "fc_out")) for lp in layers]

    def b9(i, f):
        fl = fls[i]
        return f(xs[i], fl["g1"], fl["b1"], fl["qkv_wpt"], fl["qkv_slo"], fl["qkv_shi"],
                 fl["qkv_b"], eps)

    def b10(i, f):
        fl = fls[i]
        return f(as_[i], xs[i], fl["wo_wpt"], fl["wo_slo"], fl["wo_shi"], fl["wo_b"],
                 fl["g2"], fl["b2"], fl["w1c_t"], fl["s1_lo"], fl["s1_hi"], fl["fc1_b"],
                 fl["w2p_t"], fl["s2_lo"], fl["s2_hi"], fl["fc2_b"], eps)

    def lib_b10(i):
        import torch
        wo, w1, w2 = lib10[i]
        torch.matmul(as_[i], wo)
        torch.matmul(xs[i], w1)
        torch.matmul(hs[i], w2)

    import torch
    return [
        KernelSpec("ln_qkv_int4", "chatterbox_tpu/ops/fused_layer.py:111", b9,
                   lambda i: torch.matmul(xs[i], lib9[i]),
                   _int4_bytes(D, N) + (2 * D + N) * VEC + B * D * 2 + B * N * 4,
                   2 * B * D * N, TOL_QKV, K.ln_qkv_int4, K.ln_qkv_int4_plain,
                   PEAK_BF16_OPS, INT4_SRC),
        KernelSpec("attnout_ln_mlp_int4", "chatterbox_tpu/ops/fused_layer.py:228", b10,
                   lib_b10,
                   _int4_bytes(D, D) + 2 * _int4_bytes(D, I) + (4 * D + I) * VEC
                   + 2 * B * D * 2 + B * D * 4,
                   2 * B * (D * D + 2 * D * I), TOL_MLP, K.attnout_ln_mlp_int4,
                   K.attnout_ln_mlp_int4_plain, PEAK_BF16_OPS, INT4_SRC),
    ]


LLAMA_LINEARS = ("q", "k", "v", "o", "gate", "up", "down")


def b8_linears(tts):
    """The 520M int4 layers' linears, in the order a decode step calls them."""
    return [lp[n] for lp in tts.t3_params["backbone"]["layers"] for n in LLAMA_LINEARS]


def b8_specs(tts, M, B=2, out_bf16=True, ps=None, seed=4):
    """B8 on every linear of the 520M int4 layers (or on `ps`), in the order
    a decode step calls them, its result in bf16 as nn.linear asks for it
    (out_bf16=False: f32, the Pallas contract and the only type the first
    design of the kernel writes); returns ([spec], number of linears). Bytes and
    operations are the mean over the linears."""
    import torch
    ps = ps or b8_linears(tts)
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.randn((B, 2 * p["w_q4"].shape[0]), generator=g, device="cuda").bfloat16()
          for p in ps]
    lib = [_deq_leaf(p) for p in ps]
    shapes = [(2 * p["w_q4"].shape[0], p["w_q4"].shape[1]) for p in ps]
    n = len(shapes)
    out_b = 2 if out_bf16 else 4
    extra = (torch.bfloat16,) if out_bf16 else ()

    def b8(i, f):
        p = ps[i]
        return f(xs[i], p["w_q4"], p["w_scale4_lo"], p["w_scale4_hi"], *extra)

    spec = KernelSpec("matmul_int4", "chatterbox_tpu/ops/int4_matmul.py:77", b8,
                      lambda i: torch.matmul(xs[i], lib[i]),
                      sum(_int4_bytes(k, c) + B * k * 2 + B * c * out_b for k, c in shapes) / n,
                      sum(2 * B * k * c for k, c in shapes) / n,
                      TOL_BF16 if out_bf16 else TOL_QKV, M.matmul_int4, M.matmul_int4_plain,
                      PEAK_BF16_OPS, INT4_SRC, relative=out_bf16)
    return [spec], n


def b11_specs(tts, FM, B=1):
    """B11 on the Turbo int8 layers' ln2 / fc_in / fc_out, x in float32 (so
    its output, in x's type, is compared in f32)."""
    import torch
    layers = tts.t3_params["backbone"]["layers"]
    cfg = tts.hp.backbone
    D, I = cfg.hidden_size, cfg.intermediate_size
    f32 = lambda t: t.float().contiguous()
    ops = [(f32(lp["ln2"]["g"]), f32(lp["ln2"]["b"]), lp["fc_in"]["w_q"],
            f32(lp["fc_in"]["w_scale"]), f32(lp["fc_in"]["b"]), lp["fc_out"]["w_q"],
            f32(lp["fc_out"]["w_scale"]), f32(lp["fc_out"]["b"])) for lp in layers]
    xs, _, hs = _inputs(len(layers), B, D, I, seed=5)
    x32 = [x.float() for x in xs]
    lib = [(_deq(lp["fc_in"]["w_q"].T, f32(lp["fc_in"]["w_scale"])),
            _deq(lp["fc_out"]["w_q"].T, f32(lp["fc_out"]["w_scale"]))) for lp in layers]

    def lib_b11(i):
        torch.matmul(xs[i], lib[i][0])
        torch.matmul(hs[i], lib[i][1])

    return [KernelSpec("fused_mlp_int8", "chatterbox_tpu/ops/pallas_mlp.py:56",
                       lambda i, f: f(x32[i], *ops[i]), lib_b11,
                       2 * D * I + (2 * I + 4 * D) * VEC + 2 * B * D * 4, 4 * B * D * I,
                       TOL_MLP, FM.fused_mlp_int8, FM.fused_mlp_int8_plain)]


def check_specs(specs, L, label) -> dict:
    """Max abs error of each kernel against its plain version over L layers
    (compared in f32)."""
    import torch
    errs = {}
    for sp in specs:
        e, scale = 0.0, 0.0
        for i in range(L):
            out, ref = sp.call(i, sp.kernel), sp.call(i, sp.plain)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError(f"{sp.name} layer {i}: non-finite output")
            e = max(e, (out.float() - ref.float()).abs().max().item())
            scale = max(scale, ref.float().abs().max().item())
        tol = sp.tol * scale if sp.relative else sp.tol
        log(f"kernel check {sp.name} ({label}): max_abs_err {e:.3e} over {L} layers "
            f"(tol {tol:.3e}{f' = {sp.tol} of {scale:.3f}' if sp.relative else ''})")
        if not e <= tol:
            raise AssertionError(f"{sp.name} disagrees with its plain version: {e}")
        errs[sp.name] = e
    return errs


def time_specs(specs, L, errs, label="") -> list:
    rows = []
    reps = {"kernel": 50, "plain": 5, "library": 50}
    for sp in specs:
        def all_layers(f):
            return lambda: [f(i) for i in range(L)]

        eager_ms = eager_time_ms(all_layers(lambda i: sp.call(i, sp.kernel)), reps["kernel"]) / L
        ms = device_time_ms(all_layers(lambda i: sp.call(i, sp.kernel)), reps["kernel"]) / L
        plain_ms = device_time_ms(all_layers(lambda i: sp.call(i, sp.plain)),
                                  reps["plain"]) / L
        lib_ms = (None if sp.library is None else
                  device_time_ms(all_layers(sp.library), reps["library"]) / L)
        t_bytes = sp.bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = sp.ops / sp.peak * 1e3
        rows.append({"name": sp.name, "route": "cuda", "source": sp.source,
                     "replaces": sp.replaces, "launches": 0,
                     "max_abs_err": errs[sp.name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": lib_ms})
        lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.2f}"
        bound = max(t_bytes, t_ops)
        log(f"kernel time {sp.name}{f' ({label})' if label else ''}: {ms * 1e3:.2f} "
            f"us/call on the card (plain {plain_ms * 1e3:.2f}, library {lib}, bound "
            f"{bound * 1e3:.2f} us for {sp.bytes_ / 1e6:.3f} MB: {100 * bound / ms:.1f} % "
            f"of bound); {eager_ms * 1e3:.2f} us/call launched from Python")
    return rows


def check_kernels(turbo, cfg520, K) -> list:
    """B1, B2 at Turbo's B=1 and B5, B6 at CFG's B=2 give the rows of the
    kernels line; the other row counts are checked and timed for the
    record: B1 / B2 at 2, 8 and 16 rows, B5 / B6 at 1, 8 and 16 (8: eight
    Turbo requests or four CFG requests; 16: eight CFG requests)."""
    L1, L2 = turbo.hp.backbone.num_layers, cfg520.hp.backbone.num_layers
    rows = []
    for B in (1, 2, 8, 16):
        g_specs = gpt2_specs(turbo, K, B=B)
        r = time_specs(g_specs, L1, check_specs(g_specs, L1, f"Turbo family, B={B}"),
                       f"B={B}")
        rows += r if B == 1 else []
        del g_specs
    for B in (2, 1, 8, 16):
        l_specs = llama_specs(cfg520, K, B=B)
        r = time_specs(l_specs, L2, check_specs(l_specs, L2, f"520M family, B={B}"),
                       f"B={B}")
        rows += r if B == 2 else []
        del l_specs
    return rows


def check_int4_kernels(turbo4, cfg4, turbo, K, M, FM) -> list:
    """B9, B10 at Turbo's B=1, B8 at CFG's B=2 and B11 at B=1 give the rows
    of the kernels line; the other row counts are checked and timed for the
    record (B8 takes at most 8 rows: nn.linear sends it no more)."""
    L = turbo4.hp.backbone.num_layers
    rows = []
    for B in (1, 2, 8, 16):
        specs = int4_gpt2_specs(turbo4, K, B=B)
        r = time_specs(specs, L, check_specs(specs, L, f"Turbo int4_fused, B={B}"), f"B={B}")
        rows += r if B == 1 else []
        del specs
    for B in (2, 1, 8):
        specs, n = b8_specs(cfg4, M, B=B)
        r = time_specs(specs, n, check_specs(specs, n, f"520M int4, {n} linears, B={B}"),
                       f"B={B}")
        rows += r if B == 2 else []
        del specs
    for B in (1, 2, 8, 16):
        specs = b11_specs(turbo, FM, B=B)
        r = time_specs(specs, L, check_specs(specs, L, f"Turbo int8 MLP, f32 x, B={B}"),
                       f"B={B}")
        rows += r if B == 1 else []
    return rows


HIFT_SRC = "chatterbox_tpu_torch/csrc/hift_source.cu"
HIFT_FRAMES = (1, 257, 1000, 2000)      # a streaming window's least to a 40 s source
HIFT_TIMED_FRAMES = 1500                # a 30 s source, the VC cell's middle


def _plain_source(params, f0, noise, carry):
    from chatterbox_tpu_torch.models.s3gen import hift as H
    return H._source_from_phase(params, f0, H.harmonic_phase(f0, carry), noise)


def framewise_source_torch(params, f0, noise, carry):
    """The kernel's order in PyTorch ops: the frame starts by a float64
    cumsum over the frames (not kept mod 1, so not exact past 2^53 of its
    finest term's grid), the phase closed inside each frame, then the plain
    code's sines, noise, merge and tanh."""
    import torch
    from chatterbox_tpu_torch.models.s3gen import hift as H
    B, T = f0.shape
    x = H._harmonic_steps(f0).double()                                 # (B, T, 9)
    step = H.TOTAL_UPSAMPLE * x
    start = torch.cat([torch.zeros_like(step[:, :1]), torch.cumsum(step, dim=1)[:, :-1]], 1)
    if carry is not None:
        start = start + carry.double()[:, None, :]
    j = torch.arange(1, H.TOTAL_UPSAMPLE + 1, dtype=torch.float64, device=f0.device)
    cum = start[:, :, None, :] + j[None, None, :, None] * x[:, :, None, :]
    frac = torch.remainder(cum, 1.0).reshape(B, T * H.TOTAL_UPSAMPLE, -1)
    return H._source_from_phase(params, f0, frac, noise)


def hift_spec(T, seed, with_carry):
    """H1 on one B = 1 source of T frames: f0 60-460 Hz with a tenth of the
    frames low (0-10 Hz), the source linear, the noise and, if asked, a
    carry, on the card."""
    import torch
    from chatterbox_tpu_torch.models.s3gen import hift as H
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, **kw):
        return torch.rand(shape, generator=g, device=dev, **kw)
    f0 = torch.where(r(1, T) < 0.1, 10 * r(1, T), 60 + 400 * r(1, T))
    params = {"m_source_linear": {"w": torch.randn((9, 1), generator=g, device=dev),
                                  "b": torch.randn((1,), generator=g, device=dev)}}
    noise = H.SourceNoise.draw(1, T, g, dev)
    carry = r(1, 9, dtype=torch.float64) if with_carry else None
    n = T * H.TOTAL_UPSAMPLE
    return KernelSpec(
        "hift_source", "— (jnp.cumsum, chatterbox_tpu/models/s3gen/hift.py:127)",
        lambda i, f: f(params, f0, noise, carry),
        lambda i: framewise_source_torch(params, f0, noise, carry),
        # the noise (9 floats) and the source (1) a sample, f0, the carry,
        # the phases and the linear
        n * 40 + T * 4 + (72 if with_carry else 0) + 36 + 40, 0, 1e-6,
        H.hift_source, _plain_source, source=HIFT_SRC)


def check_hift_source() -> list:
    """H1 against the plain float64 cumsum path and against
    hift_source_framewise_plain (the kernel's order, frame by frame) at
    B = 1, the VC path's, over HIFT_FRAMES with and without a carry; then
    timed at a 30 s source as the VC path calls it (no carry), which gives
    the row of the kernels line; the library is the framewise form in
    PyTorch ops."""
    from chatterbox_tpu_torch.models.s3gen import hift as H
    for T in HIFT_FRAMES:
        for with_carry in (False, True):
            label = f"B=1, T_mel {T}, {'a' if with_carry else 'no'} carry"
            sp = hift_spec(T, 100 + T, with_carry)
            check_specs([sp], 1, label)
            sp.plain = lambda p, f0, noise, carry: H.hift_source_framewise_plain(
                p, f0, noise, carry)
            check_specs([sp], 1, f"{label}, against the framewise order")
    sp = hift_spec(HIFT_TIMED_FRAMES, 7, False)
    errs = check_specs([sp], 1, f"B=1, T_mel {HIFT_TIMED_FRAMES}, a 30 s source")
    ref = sp.call(0, sp.plain)
    lib_err = (sp.library(0) - ref).abs().max().item()
    log(f"hift_source library (framewise in PyTorch ops) against the plain path: max_abs_err "
        f"{lib_err:.3e}; the plain source's mean |s| {ref.abs().mean().item():.3e}")
    return time_specs([sp], 1, errs, "30 s source")


def _load_other_kernels(root: str):
    """Another checkout's kernels/fused_layer.py, decode_attention.py,
    int4_matmul.py and fused_mlp.py, imported as a package of their own (its
    csrc/ builds into its own _build/)."""
    import importlib
    import types
    from pathlib import Path
    pkg = types.ModuleType("other_kernels")
    pkg.__path__ = [str(Path(root).resolve() / "chatterbox_tpu_torch" / "kernels")]
    sys.modules["other_kernels"] = pkg
    return tuple(importlib.import_module(f"other_kernels.{m}")
                 for m in ("fused_layer", "decode_attention", "int4_matmul", "fused_mlp"))


def _ab(sp, L, other, label) -> None:
    """One kernel of this checkout against the other's on the same
    operands: each checked against this checkout's plain version, then
    timed by CUDA-graph replay in turns (other, this, this, other) after an
    untimed one."""
    fns = {"this": sp.kernel, "other": getattr(other, sp.name)}
    for who, f in fns.items():
        check_specs([KernelSpec(sp.name, sp.replaces, sp.call, None, 0, 0, sp.tol, f,
                                sp.plain, relative=sp.relative)], L, f"{who}, {label}")
    # an untimed replay first: without it the first timed sample of a group
    # read up to 7 % slow, whichever checkout it timed (PERF.md)
    device_time_ms(lambda: [sp.call(i, fns["other"]) for i in range(L)], 5)
    us = {"this": [], "other": []}
    for who in ("other", "this", "this", "other"):
        f = fns[who]
        us[who].append(device_time_ms(lambda: [sp.call(i, f) for i in range(L)], 50) / L * 1e3)
    a, b = sum(us["other"]) / 2, sum(us["this"]) / 2
    log(f"A/B {sp.name} {label}: other {us['other'][0]:.2f} / {us['other'][1]:.2f} us, "
        f"this {us['this'][0]:.2f} / {us['this'][1]:.2f} us per call -> this / other "
        f"{b / a:.3f}")


def ab_kernels(turbo, cfg520, turbo4, cfg4, K, A, M, FM, bb, root: str) -> None:
    """B1, B2 (Turbo weights), B5, B6 (520M weights), B9, B10 (Turbo
    int4_fused weights) and B11 (Turbo int8 MLP weights, f32 x) at 1, 2, 8
    and 16 rows, B8 (520M int4 weights, f32 result: the type both checkouts
    write) at 1, 2 and 8 rows, and B3 / B4 / B7 at phase 3's attention
    shapes, of this checkout against those of the checkout at `root`."""
    other_k, other_a, other_m, other_fm = _load_other_kernels(root)
    L1, L2 = turbo.hp.backbone.num_layers, cfg520.hp.backbone.num_layers
    for B in (1, 2, 8, 16):
        for L, specs in ((L1, gpt2_specs(turbo, K, B=B)), (L2, llama_specs(cfg520, K, B=B))):
            for sp in specs:
                _ab(sp, L, other_k, f"B={B}")
        for sp in int4_gpt2_specs(turbo4, K, B=B):
            _ab(sp, L1, other_k, f"B={B}")
        _ab(b11_specs(turbo, FM, B=B)[0], L1, other_fm, f"B={B}")
    for B in (1, 2, 8):
        (sp,), n = b8_specs(cfg4, M, B=B, out_bf16=False)
        _ab(sp, n, other_m, f"B={B}, {n} linears")
    for shape in attention_shapes(turbo, cfg520):
        specs, L = _specs_at(A, bb, shape)
        for sp in specs:
            _ab(sp, L, other_a, shape[0])


INT4_TILINGS = ((16, 1), (16, 2), (16, 4), (32, 1), (32, 2), (32, 4))
# B10's (attn-out columns, fc_in packed columns, fc_out columns, fc_out
# split, dependent launch): every fc_in and fc_out setting with and without
# dependent launch at 16 attn-out columns, then 32 attn-out columns at
# int4_mlp_tiling's other choices (the attn-out phase is the smallest)
MLP4_SWEEP = tuple((16, f, c, s, p) for f in (16, 32, 64) for c in (16, 32) for s in (1, 2, 4)
                   for p in (True, False))


def _sweep_time(sp, L, f, label) -> str:
    """f (a tiling of sp's kernel) checked against sp's plain version over
    L layers, then timed by CUDA-graph replay: 'x.xx us' per call."""
    try:
        check_specs([KernelSpec(sp.name, sp.replaces, sp.call, None, 0, 0, sp.tol, f,
                                sp.plain, relative=sp.relative)], L, label)
    except (RuntimeError, ValueError) as e:      # a tiling the card or the shape refuses
        return f"refused ({e})"
    return f"{device_time_ms(lambda: [sp.call(i, f) for i in range(L)], 50) / L * 1e3:.2f} us"


def sweep_tilings(turbo, cfg520, turbo4, cfg4, K, M, FM) -> None:
    """The knobs of B8, B6, B2, B11 and B10, each setting checked against
    the plain version and timed by CUDA-graph replay (the evidence for
    int4_tiling, glu_tiling, gelu_tiling and int4_mlp_tiling): B8's columns
    a block and split of the packed rows at each 520M linear shape, over
    that shape's linears of every layer, at 2 and 8 rows; B6's chosen tiling
    with programmatic dependent launch on and off over the 520M layers at 2
    and 8 rows, and B2's and B11's over the Turbo int8 layers at 1 and 8
    rows (their grids were swept in earlier runs, PERF.md); B10's columns a
    block for each phase, fc_out's split and dependent launch over the
    Turbo int4_fused layers at 1 and 8 rows (B9's columns, settled, are not
    swept)."""
    import functools
    ps = b8_linears(cfg4)
    shape = lambda p: (2 * p["w_q4"].shape[0], p["w_q4"].shape[1])
    for k, n in sorted({shape(p) for p in ps}):
        sel = [p for p in ps if shape(p) == (k, n)]
        for B in (2, 8):
            (sp,), L = b8_specs(cfg4, M, B=B, ps=sel)
            times = [_sweep_time(sp, L, functools.partial(M.matmul_int4_tiled, cols=c, splits=s),
                                 f"B8 K={k}, N={n}, B={B}, {c} columns, {s} splits")
                     for c, s in INT4_TILINGS]
            log(f"tiling sweep B8 (K={k}, N={n}, B={B}, {L} linears): "
                + ", ".join(f"{c}x{s} {t}" for (c, s), t in zip(INT4_TILINGS, times))
                + f" (int4_tiling: {M.int4_tiling(k // 2, n, B)})")
    cfg = cfg520.hp.backbone
    D, I, tw = cfg.hidden_size, cfg.intermediate_size, K.llama_mlp_tile(cfg)
    for B in (2, 8):
        sp, L = llama_specs(cfg520, K, B=B)[1], cfg.num_layers
        attn, units, down, _ = K.glu_tiling(B, D, I, tw)
        rows = []
        for pdl in (True, False):
            f = functools.partial(K.attnout_rms_glu_int8_tiled, attn_splits=attn,
                                  glu_units=units, down_splits=down, pdl=pdl)
            t = _sweep_time(sp, L, f, f"B6 B={B}, ({attn}, {units}, {down}, {pdl})")
            rows.append(f"({attn},{units},{down},{int(pdl)}) {t}")
        log(f"tiling sweep B6 (B={B}, D={D}, I={I}, tw={tw}; attn splits, units, down "
            f"splits, pdl): " + ", ".join(rows))
    cfg = turbo.hp.backbone
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    for B in (1, 8):
        sp, rows = gpt2_specs(turbo, K, B=B)[1], []
        attn, units, down, _ = K.gelu_tiling(B, D, I, 1024)
        for pdl in (True, False):
            f = functools.partial(K.attnout_ln_mlp_int8_tiled, tw=1024, attn_splits=attn,
                                  gelu_units=units, down_splits=down, pdl=pdl)
            t = _sweep_time(sp, L, f, f"B2 B={B}, ({attn}, {units}, {down}, {pdl})")
            rows.append(f"({attn},{units},{down},{int(pdl)}) {t}")
        log(f"tiling sweep B2 (B={B}, D={D}, I={I}, tw=1024; attn splits, units, down "
            f"splits, pdl): " + ", ".join(rows))
        sp, rows = b11_specs(turbo, FM, B=B)[0], []
        _, units, down, _ = K.gelu_tiling(B, D, I, None)
        for pdl in (True, False):
            f = functools.partial(FM.fused_mlp_int8_tiled, gelu_units=units, down_splits=down,
                                  pdl=pdl)
            t = _sweep_time(sp, L, f, f"B11 B={B}, ({units}, {down}, {pdl})")
            rows.append(f"({units},{down},{int(pdl)}) {t}")
        log(f"tiling sweep B11 (B={B}, D={D}, I={I}; units, down splits, pdl): "
            + ", ".join(rows))
        sp, rows = int4_gpt2_specs(turbo4, K, B=B)[1], []
        choice = K.int4_mlp_tiling(B, D, I)
        for tiling in MLP4_SWEEP + ((32,) + choice[1:],):
            f = functools.partial(K.attnout_ln_mlp_int4_tiled, attn_cols=tiling[0],
                                  fc_in_cols=tiling[1], down_cols=tiling[2],
                                  down_splits=tiling[3], pdl=tiling[4])
            t = _sweep_time(sp, L, f, f"B10 B={B}, {tiling}")
            rows.append(f"({','.join(str(int(v)) for v in tiling)}) {t}")
        log(f"tiling sweep B10 (B={B}, D={D}, I={I}; attn-out columns, fc_in packed "
            f"columns, fc_out columns, fc_out splits, pdl): " + ", ".join(rows)
            + f" (int4_mlp_tiling: {choice})")


# Attention tolerance: the outputs are bf16, compared in f32; the kernel and
# its plain version sum in another order and may round to neighbouring bf16
# values: one bf16 ulp of the output's magnitude.
TOL_ATTN = 2.0 ** -7
PEAK_F32_OPS = 67e12           # float32 outside the tensor cores (data sheet)


def attention_specs(A, bb, L, B, H, T, D, cur, lo, seed, which=("B3", "B4", "B7")):
    """The decode-attention kernels on L layers' own random caches (bf16,
    and int8 quantized from it by the engine's quantize_kv) at one shape;
    cur and lo are per-row host ints (lo None: windows from 0). The library
    call is scaled_dot_product_attention on the valid window where every
    row's window is the same (on a dequantized bf16 copy for B4)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").bfloat16()
    layers = []
    for _ in range(L):
        q, k, v = r(B, H, 1, D), r(B, H, T, D), r(B, H, T, D)
        (kq, ks), (vq, vs) = bb.quantize_kv(k), bb.quantize_kv(v)
        ks, vs = ks[..., 0].bfloat16().contiguous(), vs[..., 0].bfloat16().contiguous()
        layers.append((q, k, v, kq, ks, vq, vs,
                       (kq.bfloat16() * ks[..., None]), (vq.bfloat16() * vs[..., None])))
    cur_t = torch.tensor(cur, dtype=torch.int32, device="cuda")
    lo_h = lo or [0] * B
    lo_t = None if lo is None else torch.tensor(lo, dtype=torch.int32, device="cuda")
    keys = sum(min(c, T - 1) - l + 1 for c, l in zip(cur, lo_h))   # per head
    same = len(set(cur)) == 1 and len(set(lo_h)) == 1
    a, c = lo_h[0], min(cur[0], T - 1) + 1

    def sdpa(kk, vv):
        return lambda i: F.scaled_dot_product_attention(
            layers[i][0], layers[i][kk][:, :, a:c], layers[i][vv][:, :, a:c])

    qo = 2 * B * H * D * 2                     # q read and out written, bf16
    ops = 4 * H * D * keys                     # score and value products
    specs = {
        "B3": KernelSpec(
            "decode_attention_streamed", "chatterbox_tpu/ops/pallas_attention.py:133",
            lambda i, f: f(*layers[i][:3], cur_t, lo_t), sdpa(1, 2) if same else None,
            2 * H * D * 2 * keys + qo, ops, TOL_ATTN, A.decode_attention_streamed,
            A.decode_attention_streamed_plain, PEAK_F32_OPS, ATTN_SRC, True),
        "B4": KernelSpec(
            "decode_attention_streamed_int8", "chatterbox_tpu/ops/pallas_attention.py:255",
            lambda i, f: f(layers[i][0], *layers[i][3:7], cur_t, lo_t),
            sdpa(7, 8) if same else None, 2 * H * (D + 2) * keys + qo, ops, TOL_ATTN,
            A.decode_attention_streamed_int8, A.decode_attention_streamed_int8_plain,
            PEAK_F32_OPS, ATTN_SRC, True),
        "B7": KernelSpec(
            "decode_attention", "chatterbox_tpu/ops/pallas_attention.py:320",
            lambda i, f: f(*layers[i][:3], cur_t), sdpa(1, 2) if same else None,
            2 * H * D * 2 * keys + qo, ops, TOL_ATTN, A.decode_attention,
            A.decode_attention_plain, PEAK_F32_OPS, ATTN_SRC, True),
    }
    return [specs[w] for w in which]


def attention_shapes(turbo, cfg520) -> list:
    """(label, L, B, H, T, D, cur, lo, seed, kernels) of each shape phase 3
    times B3 / B4 / B7 at, the kernels-line rows first: Turbo's single
    stream (B3 / B4 at T=768, B7 at an unaligned 657, position 530), the
    520M CFG pair (prefix 66 + 250 tokens in 512), the batched engine's
    eight left-padded rows (one pad past a whole tile; B7 at T=657 with
    per-row positions and no pads), the windows of phase 5's batched Turbo
    decode (~430 keys, the pads of its 12-30 text tokens), and a long
    window (Turbo, 1400 keys)."""
    L1, L2 = turbo.hp.backbone.num_layers, cfg520.hp.backbone.num_layers
    H, D = turbo.hp.backbone.num_heads, turbo.hp.backbone.head_dim
    H2, D2 = cfg520.hp.backbone.num_heads, cfg520.hp.backbone.head_dim
    lo8 = [0, 3, 9, 17, 40, 100, 257, 300]
    pads = [0, 3, 5, 8, 10, 13, 15, 18]          # BatchDecoder's 12-30 text tokens
    return [
        ("Turbo B=1, T=768, cur 530", L1, 1, H, 768, D, [530], None, 1, ("B3", "B4")),
        ("B=1, T=657, cur 530", L1, 1, H, 657, D, [530], None, 2, ("B7",)),
        ("520M B=2, T=512, cur 190", L2, 2, H2, 512, D2, [190, 190], None, 3,
         ("B3", "B4", "B7")),
        (f"batched B=8, T=768, cur 540, lo {lo8}", L1, 8, H, 768, D, [540] * 8, lo8, 4,
         ("B3", "B4")),
        (f"batched decode B=8, T=768, cur 430, lo {pads}", L1, 8, H, 768, D, [430] * 8, pads,
         7, ("B3", "B4")),
        ("B=8, T=657", L1, 8, H, 657, D, [300 + 40 * i for i in range(8)], None, 5, ("B7",)),
        ("Turbo B=1, T=1536, cur 1400", L1, 1, H, 1536, D, [1400], None, 6,
         ("B3", "B4", "B7")),
    ]


def _specs_at(A, bb, shape):
    label, L, B, H, T, D, cur, lo, seed, which = shape
    return attention_specs(A, bb, L, B, H, T, D, cur, lo, seed, which), L


def check_attention(turbo, cfg520, A, bb) -> list:
    """B3, B4 and B7 against their plain versions over every layer at the
    paths' shapes (attention_shapes), each timed with the split count it
    takes there; the rows of the kernels line at Turbo's single stream."""
    L1 = turbo.hp.backbone.num_layers
    H, D = turbo.hp.backbone.num_heads, turbo.hp.backbone.head_dim
    for cur in (200, 400, 700):                     # cache tiles 1, 2 and 3
        check_specs(attention_specs(A, bb, L1, 1, H, 768, D, [cur], None, cur, ("B3", "B4")),
                    L1, f"Turbo B=1, T=768, cur {cur}")
    rows = []
    for n, shape in enumerate(attention_shapes(turbo, cfg520)):
        label, _, B, H_, T = shape[:5]
        specs, L = _specs_at(A, bb, shape)
        r = time_specs(specs, L, check_specs(specs, L, label),
                       f"{label}; B3 / B7 split over {A.split_count(B, H_, T)} blocks, B4 "
                       f"over {A.split_count_int8(B, H_, T)}")
        rows += r if n < 2 else []
    return rows


SWEEP_SPLITS = (1, 2, 4, 8, 16)


def sweep_splits(turbo, cfg520, A, bb) -> None:
    """B3's and B4's kernel at S = 1, 2, 4, 8 and 16 blocks a window at
    Turbo's single stream, the 520M pair, the batched rows and the long
    window: each checked against the plain version and timed by CUDA-graph
    replay (the evidence for split_count and split_count_int8)."""
    import functools
    split = {"B3": A.decode_attention_streamed_split, "B4": A.decode_attention_streamed_int8_split}
    count = {"B3": A.split_count, "B4": A.split_count_int8}
    for shape in attention_shapes(turbo, cfg520):
        for kern in ("B3", "B4"):
            if kern not in shape[-1]:
                continue
            label, L, B, H, T = shape[:5]
            (sp,), _ = _specs_at(A, bb, shape[:-1] + ((kern,),))
            times = []
            for S in SWEEP_SPLITS:
                f = functools.partial(split[kern], splits=S)
                try:
                    check_specs([KernelSpec(sp.name, sp.replaces, sp.call, None, 0, 0, sp.tol, f,
                                            sp.plain, relative=True)], L, f"{kern} S={S}")
                except RuntimeError as e:   # a cluster the card will not schedule
                    times.append(f"refused ({e})")
                    continue
                us = device_time_ms(lambda: [sp.call(i, f) for i in range(L)], 50) / L * 1e3
                times.append(f"{us:.2f} us")
            log(f"split sweep {kern} ({label}): "
                + ", ".join(f"S={S} {t}" for S, t in zip(SWEEP_SPLITS, times))
                + f" ({count[kern].__name__}: S={count[kern](B, H, T)})")


# ---------------------------------------------------------------------------
# phase 4: the CUDA path against the CPU path on small models
# ---------------------------------------------------------------------------

def _to(tree, device):
    import torch
    if isinstance(tree, dict):
        out = {k: _to(v, device) for k, v in tree.items() if k != "fused"}
        if "fused" in tree:        # keep the layer's weight views of the fused copies
            from chatterbox_tpu_torch.kernels import fused_layer as K
            out["fused"] = (K.prepare_fused_gpt2_layer(out) if "qkv_wpt" in tree["fused"]
                            else K.prepare_fused_gpt2_layer_int8(out) if "qkv" in out
                            else K.prepare_fused_llama_layer_int8(out))
        return out
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def _teacher_forced(params, hp, cond, text, forced, batch, cfg_mode, dev, kv_int8=False):
    """Prefill the dense prefix, then one decode step per forced token:
    (steps, batch, V) logits on the host. kv_int8: the int8 cache in a
    tile-aligned length, decode steps with fused attention (B4 on the card)."""
    import torch
    from chatterbox_tpu_torch.models.t3 import backbone as bb
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.sampling.decode import build_prefix, cache_len, decode_step
    x = build_prefix(params, hp, cond, text.to(dev), batch, cfg_mode)
    Pn = x.shape[1]
    cache_cls = bb.KVCacheInt8 if kv_int8 else bb.KVCache
    cache = cache_cls.zeros(hp.backbone, batch, cache_len(Pn + len(forced), kv_int8), dev)
    h = bb.backbone_apply(params["backbone"], hp.backbone, x,
                          torch.arange(Pn, device=dev)[None].expand(batch, -1), cache, 0)
    out = [t3m.speech_logits(params, h[:, -1]).float()]
    for i, tok in enumerate(forced[:-1]):
        out.append(decode_step(params, hp, torch.tensor(tok, device=dev), i, cache, Pn + i,
                               fused_attn=kv_int8))
    return torch.stack(out).cpu()


def _small_t3(hp, seed, mode="int8_fused"):
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.utils.quantize import quantize_t3_backbone
    return quantize_t3_backbone(t3m.t3_init(hp, seed=seed, device="cpu"), mode=mode)


def _compare_logits(ref, out, label):
    import torch
    err = (out - ref).abs().max().item() / ref.abs().max().item()
    log(f"reference T3 ({label}): teacher-forced logits cuda vs cpu, max err "
        f"{err:.3e} of scale")
    # bf16 roundings inside the kernels and the bf16 cache may land on the
    # other side for another summation order (same bound as the CPU tests);
    # so may an int8 code of the int8 cache
    if not (bool(torch.isfinite(out).all()) and err <= 3e-3):
        raise AssertionError(f"T3 logits on the card disagree with the CPU path: {err}")


def _t3_reference(hp, batch, cfg_mode, seed, label, kv_int8=False, mode="int8_fused"):
    import numpy as np
    import torch
    from chatterbox_tpu_torch.models.t3 import model as t3m
    cpu = _small_t3(hp, seed, mode)
    rng = np.random.default_rng(seed)
    spk = torch.from_numpy(rng.standard_normal((1, 256)).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, 6561, (1, 8)))
    text = torch.from_numpy(rng.integers(0, 64, (1, 12)))
    forced = [int(t) for t in rng.integers(0, 6561, 12)]
    emo = torch.full((1, 1, 1), 0.5)

    def logits(params, dev):
        cond = t3m.T3CondTensors(spk.to(dev), prompt.to(dev), emo.to(dev))
        return _teacher_forced(params, hp, cond, text, forced, batch, cfg_mode, dev,
                               kv_int8)

    with torch.no_grad():
        ref, out = logits(cpu, "cpu"), logits(_to(cpu, "cuda"), "cuda")
    _compare_logits(ref, out, label)


def _batched_reference(hp, seed, label):
    """The batched engine with the int8 cache, CFG, three requests of
    distinct text lengths (left pads 0, 3 and 7): its prefill, then
    teacher-forced decode steps through the engine's backbone call (B4 with
    lo = pad and the fused kernels at six rows on the card)."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.models.t3 import backbone as bb
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.sampling.batched import t3_prefill_batched
    from chatterbox_tpu_torch.sampling.decode import cache_len
    cpu = _small_t3(hp, seed)
    rng = np.random.default_rng(seed)
    lens = [12, 9, 5]
    text = np.zeros((3, 12), np.int64)
    for i, n in enumerate(lens):
        text[i, :n] = rng.integers(1, 64, n)
    spk = rng.standard_normal((3, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (3, 8))
    forced = rng.integers(0, 6561, (10, 3))

    def logits(params, dev):
        cond = t3m.T3CondTensors(torch.from_numpy(spk).to(dev),
                                 torch.from_numpy(prompt).to(dev),
                                 torch.full((3, 1, 1), 0.5, device=dev))
        P = t3m.cond_len(hp) + 12 + 2
        st = t3_prefill_batched(params, hp, cond, torch.from_numpy(text).to(dev), lens,
                                [torch.Generator(device=dev) for _ in lens],
                                t_cap=cache_len(P + len(forced), True),
                                max_new_tokens=len(forced), cfg_mode=True, kv_int8=True)
        out = [st.logits]
        for s, tok in enumerate(forced[:-1]):
            tok = torch.from_numpy(np.concatenate([tok, tok])).to(dev)
            emb = t3m.speech_embed_token(params, hp, tok, s + 1)
            h = bb.backbone_apply(params["backbone"], hp.backbone, emb,
                                  (st.prefix_lens + s)[:, None], st.cache, st.p_pad + s,
                                  kv_lo=st.pad, fused_attn=True)
            out.append(t3m.speech_logits(params, h[:, 0]).float())
        return torch.stack(out).cpu()

    with torch.no_grad():
        ref, out = logits(cpu, "cpu"), logits(_to(cpu, "cuda"), "cuda")
    _compare_logits(ref, out, label)


def _s3gen_reference(meanflow, seed, label, **tail):
    import numpy as np
    import torch
    from chatterbox_tpu_torch.models.s3gen.flow import FlowDims
    from chatterbox_tpu_torch.models.s3gen.hift import SourceNoise
    from chatterbox_tpu_torch.models.s3gen.model import (RefDict, S3GenEngine, S3GenNoise,
                                                         pack_tokens, s3gen_init)
    from chatterbox_tpu_torch.models.s3tok.model import S3TokenizerConfig
    rng = np.random.default_rng(seed)
    dims = FlowDims.tiny_test()
    s3 = s3gen_init(seed=seed, device="cpu", meanflow=meanflow, dims=dims, hift_base=32,
                    tok_cfg=S3TokenizerConfig.tiny_test())
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
    turbo_hp = T3Config(text_tokens_dict_size=64, backbone_name="GPT2_fused_test",
                        speech_tokens_dict_size=6564, input_pos_emb=None,
                        speech_cond_prompt_len=8, use_perceiver_resampler=False,
                        emotion_adv=False)
    cfg_hp = T3Config(text_tokens_dict_size=64, backbone_name="Llama_fused_test",
                      speech_tokens_dict_size=6564, speech_cond_prompt_len=8,
                      max_text_tokens=64, max_speech_tokens=128)
    _t3_reference(turbo_hp, batch=1, cfg_mode=False, seed=3,
                  label="Turbo family, GPT2_fused_test")
    _t3_reference(turbo_hp, batch=1, cfg_mode=False, seed=7,
                  label="Turbo family, GPT2_fused_test, int8 KV", kv_int8=True)
    _s3gen_reference(True, 4, "meanflow, 2 steps", append_sil=3)
    _t3_reference(cfg_hp, batch=2, cfg_mode=True, seed=5,
                  label="520M family, Llama_fused_test, CFG batch 2")
    _t3_reference(cfg_hp, batch=2, cfg_mode=True, seed=8,
                  label="520M family, Llama_fused_test, CFG batch 2, int8 KV", kv_int8=True)
    _batched_reference(cfg_hp, seed=9,
                       label="batched int8-KV CFG, Llama_fused_test, 3 requests")
    _s3gen_reference(False, 6, "CFG, 10 steps", cfg_slice=True)
    _t3_reference(turbo_hp, batch=1, cfg_mode=False, seed=11,
                  label="Turbo family, GPT2_fused_test, int4_fused", mode="int4_fused")
    _t3_reference(cfg_hp, batch=2, cfg_mode=True, seed=12,
                  label="520M family, Llama_fused_test, CFG batch 2, int4", mode="int4")


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


COUNTERS = []                  # the launch-count dicts of the kernel modules
VOCODES = "hift_inference on the card"   # the key of count_vocodes' calls
_vocodes = {VOCODES: 0}


def count_vocodes() -> None:
    """Wrap hift_inference where S3GenEngine and the streaming vocoder call
    it, counting the calls on CUDA tensors under VOCODES, so that
    check_counts holds H1 (hift_source) to one launch a call."""
    from chatterbox_tpu_torch.models.s3gen import model
    from chatterbox_tpu_torch.serve import streaming

    def wrap(inner):
        def counted(params, mel, *a, **kw):
            _vocodes[VOCODES] += mel.is_cuda
            return inner(params, mel, *a, **kw)
        return counted
    for mod in (model, streaming):
        mod.hift_inference = wrap(mod.hift_inference)


def reset_counts():
    for c in COUNTERS:
        for k in c:
            c[k] = 0


def read_counts() -> dict:
    return {k: v for c in COUNTERS for k, v in c.items()}


def check_counts(counts, label, expected: dict):
    """Each named kernel launched exactly as often as expected, H1
    (hift_source) once for each hift_inference call on the card (which an
    expected H1 count, where given, must equal); every other kernel not at
    all."""
    calls = counts.get(VOCODES, 0)
    if expected.get("hift_source", calls) != calls:
        raise AssertionError(f"{label}: {calls} hift_inference calls on the card, expected "
                             f"{expected['hift_source']}")
    expected = dict(expected, hift_source=calls)
    for name in counts:
        if name == VOCODES:
            continue
        want = expected.get(name, 0)
        log(f"launches {name} ({label}): {counts[name]} (expected {want})")
        if counts[name] != want:
            raise AssertionError(f"{name} launched {counts[name]} times on the {label} "
                                 f"path, expected {want}")


def run_path(tts, label, kernels, gen_kw, decode_kw, tail):
    """A short warm-up generate, then TIMED_RUNS timed runs of one request as
    bench.py times it: t3_generate with EOS ignored (decode_kw: the text
    ids, sampler and engine knobs the pipeline's generate passes), then
    S3Gen's inference_from_decode with the pipeline's tail (`tail`), with
    the launch counts set to 0 just before and read just after; then a
    decode-step profile. `kernels`: the kernels each layer launches once per
    decode step, or {name: launches per layer and step}. Returns the launch
    counts of the timed runs."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.sampling.decode import t3_generate
    tts.generate(PHASE5_TEXT, **dict(gen_kw, max_new_tokens=WARMUP_TOKENS))     # warm-up
    torch.cuda.synchronize()
    ids = torch.as_tensor(decode_kw["ids"], device="cuda").long()
    kw = {k: v for k, v in decode_kw.items() if k != "ids"}
    cond = tts.conds.t3.as_tensors("cuda")

    def decode(n):
        return t3_generate(tts.t3_params, tts.hp, cond, ids, max_new_tokens=n,
                           ignore_eos=True, generator=tts.generator, **kw)

    reset_counts()
    totals, t3s, s3s, forwards = [], [], [], 0
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        res = decode(N_TOKENS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wav, n_voc = tts.s3gen.inference_from_decode(res.tokens, res.n_tokens, tts.conds.gen,
                                                     generator=tts.generator, **tail)
        t2 = time.perf_counter()
        totals.append(t2 - t0)
        t3s.append(t1 - t0)
        s3s.append(t2 - t1)
        forwards += res.n_forward
        expect_n = vocoded_tokens(res, tail.get("cfg_slice", False))
        expect = (1, expect_n * 2 * 480)
        if (n_voc != expect_n or wav.shape != expect or not np.isfinite(wav).all()
                or np.abs(wav).max() == 0):
            raise AssertionError(f"{label}: waveform {wav.shape} of {n_voc} tokens (expected "
                                 f"{expect}), finite={np.isfinite(wav).all()}")
    counts = read_counts()
    L = tts.hp.backbone.num_layers
    per_layer = kernels if isinstance(kernels, dict) else dict.fromkeys(kernels, 1)
    check_counts(counts, f"{label}, {L} layers x {forwards} decode steps",
                 {**{name: n * L * forwards for name, n in per_layer.items()},
                  "hift_source": TIMED_RUNS})
    best, audio_s = min(totals), n_voc / 25.0
    t3 = min(t3s)
    log(f"{label} request (t3_generate + inference_from_decode): "
        f"{[round(t, 4) for t in totals]} s for {audio_s:.2f} s of audio ({n_voc} vocoded "
        f"tokens of {N_TOKENS}) -> x-realtime {audio_s / best:.3f} (best of {TIMED_RUNS}); "
        f"T3 decode {t3:.4f} s -> {N_TOKENS / t3:.1f} tok/s ({t3 / N_TOKENS * 1e3:.3f} "
        f"ms/token), S3Gen {min(s3s):.4f} s (best of {TIMED_RUNS})")
    profile_decode(decode, t3 / N_TOKENS, label)
    return counts


def _profiled_decode(decode, n: int) -> dict:
    """{kernel name: (device us, calls)} of decode(n), a decode of n tokens."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode(n)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        # device-side events only (the trace holds no CPU operators)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = (e.self_device_time_total, e.count)
    return out


def profile_decode(decode, step_s: float, label: str, n1: int = 9, n2: int = 25):
    """Device time of one decode step by kernel name (torch.profiler): the
    difference of decode(n2) and decode(n1), decodes of n2 and n1 tokens, so
    the prefill they share drops out; beside the unprofiled wall time of a
    step. A second try where the profiler saw no device time (it has missed
    a whole window on the card now and then)."""
    steps = n2 - n1
    for _ in range(2):
        a = _profiled_decode(decode, n1)
        b = _profiled_decode(decode, n2)
        rows = [((b[k][0] - a.get(k, (0.0, 0))[0]) / steps,
                 (b[k][1] - a.get(k, (0.0, 0))[1]) / steps, k) for k in b]
        total = sum(r[0] for r in rows)
        if total > 0:
            break
    if total <= 0:
        log(f"{label} decode profile: the profiler saw no device time (not measured)")
        return
    log(f"{label} decode profile: {total:.1f} us of device time per decode step "
        f"against {step_s * 1e6:.1f} us of wall per step -> device busy "
        f"{100 * total / (step_s * 1e6):.1f} %; {sum(r[1] for r in rows):.1f} kernel "
        f"launches per step")
    for us, calls, key in sorted(rows, reverse=True)[:14]:
        log(f"  {us:9.2f} us/step {100 * us / total:5.1f} % {calls:7.1f} calls/step  {key[:80]}")


GPT2 = ("ln_qkv_int8", "attnout_ln_mlp_int8")
LLAMA = ("rms_qkv_int8", "attnout_rms_glu_int8")
GPT2_INT4 = ("ln_qkv_int4", "attnout_ln_mlp_int4")
B3, B4, B7 = "decode_attention_streamed", "decode_attention_streamed_int8", "decode_attention"
B8 = "matmul_int4"
# kernels on no main path, with the reason
PHASE3_ONLY = {"fused_mlp_int8": "phase 3 only: a library kernel that nothing in the "
                                 "JAX package calls outside its own test"}


def turbo_ids(turbo, text):
    """Turbo's text ids as its generate makes them: punc_norm, then raw
    GPT-2 ids with no SOT/EOT framing."""
    from chatterbox_tpu_torch.text.tokenizer import punc_norm
    return turbo.tokenizer.text_to_tokens(punc_norm(text, variant="turbo"))


def main_paths(turbo, cfg520, turbo4, cfg4) -> dict:
    """Both pipelines on the bf16 cache (the default), with kv_int8=True,
    and on the int4 T3s (Turbo int4_fused: B9 and B10 per layer and step;
    520M int4: B8 for each of a layer's seven linears), each decoded and
    vocoded as its generate does it but with EOS ignored; returns the launch
    counts summed over the paths."""
    from chatterbox_tpu_torch.ops.sampling import SamplerParams
    turbo_gen = dict(top_k=1000, temperature=0.8, top_p=0.95, repetition_penalty=1.2)
    turbo_dec = dict(ids=turbo_ids(turbo, PHASE5_TEXT), sp=SamplerParams(0.8, 0.95, 1.2),
                     top_k=1000)
    kw = dict(temperature=0.8, top_p=1.0, min_p=0.05, repetition_penalty=1.2,
              cfg_weight=0.5)
    cfg_gen = dict(exaggeration=0.5, **kw)
    cfg_dec = dict(ids=cfg520.frame_text(PHASE5_TEXT), sp=SamplerParams(**kw), cfg_mode=True,
                   cfg_batch2=True)
    int8 = dict(kv_int8=True, fused_attn=True)
    turbo_tail, cfg_tail = dict(append_sil=3), dict(cfg_slice=True)   # as their _vocode
    paths = [
        (turbo, "Turbo", GPT2, turbo_gen, turbo_dec, turbo_tail),
        (cfg520, "520M CFG", LLAMA, cfg_gen, cfg_dec, cfg_tail),
        (turbo, "Turbo kv_int8", GPT2 + (B4,), dict(turbo_gen, kv_int8=True),
         dict(turbo_dec, **int8), turbo_tail),
        (cfg520, "520M CFG kv_int8", LLAMA + (B4,), dict(cfg_gen, kv_int8=True),
         dict(cfg_dec, **int8), cfg_tail),
        (turbo4, "Turbo int4_fused", GPT2_INT4, turbo_gen, turbo_dec, turbo_tail),
        (cfg4, "520M CFG int4", {B8: len(LLAMA_LINEARS)}, cfg_gen, cfg_dec, cfg_tail),
    ]
    totals = {}
    for tts, label, kernels, gen_kw, dec_kw, tail in paths:
        counts = run_path(tts, label, kernels, gen_kw, dec_kw, tail)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return totals


def fused_attention_paths(turbo, cfg520) -> dict:
    """t3_generate(fused_attn=True) on the bf16 cache of each family (B3 on
    the tile-aligned cache), each with a profile of its decode step (the
    unfused paths' profiles are main_paths'), and a teacher-forced Turbo
    decode through backbone_apply(fused_attn=True) over an unaligned cache
    (B7)."""
    import torch
    from chatterbox_tpu_torch.models.t3 import backbone as bb
    from chatterbox_tpu_torch.ops.sampling import SamplerParams
    from chatterbox_tpu_torch.sampling.decode import build_prefix, decode_step, t3_generate
    totals = {}
    for tts, label, kernels, ids, kw in (
            (turbo, "Turbo", GPT2, turbo_ids(turbo, PHASE5_TEXT),
             dict(sp=SamplerParams(0.8, 0.95, 1.2), top_k=1000)),
            (cfg520, "520M CFG", LLAMA, cfg520.frame_text(PHASE5_TEXT),
             dict(sp=SamplerParams(0.8, 1.0, 1.2, 0.05, 0.5), cfg_mode=True))):
        ids = torch.as_tensor(ids, device="cuda").long()
        cond = tts.conds.t3.as_tensors("cuda")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = t3_generate(tts.t3_params, tts.hp, cond, ids, max_new_tokens=N_TOKENS,
                          ignore_eos=True, generator=tts.generator, fused_attn=True, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        L = tts.hp.backbone.num_layers
        counts = read_counts()
        check_counts(counts, f"{label} t3_generate(fused_attn=True), {L} layers x "
                     f"{res.n_forward} decode steps",
                     {k: L * res.n_forward for k in kernels + (B3,)})
        log(f"{label} T3 decode, bf16 cache with fused attention: {dt:.4f} s for "
            f"{N_TOKENS} tokens ({dt / N_TOKENS * 1e3:.3f} ms/token)")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        profile_decode(lambda n: t3_generate(
            tts.t3_params, tts.hp, cond, ids, max_new_tokens=n, ignore_eos=True,
            generator=tts.generator, fused_attn=True, **kw), dt / N_TOKENS,
            f"{label} fused_attn")

    # teacher-forced Turbo over a cache whose length is not a multiple of 256
    hp, params = turbo.hp, turbo.t3_params
    cond = turbo.conds.t3.as_tensors("cuda")
    ids = torch.as_tensor(turbo_ids(turbo, PHASE5_TEXT), device="cuda").long()
    with torch.no_grad():
        x = build_prefix(params, hp, cond, ids, 1, False)
        P, n = x.shape[1], 40
        T = P + n + (1 if (P + n) % 256 == 0 else 0)
        cache = bb.KVCache.zeros(hp.backbone, 1, T, "cuda")
        bb.backbone_apply(params["backbone"], hp.backbone, x,
                          torch.arange(P, device="cuda")[None], cache, 0)
        reset_counts()
        tok = torch.tensor(100, device="cuda")
        for i in range(n):
            logits = decode_step(params, hp, tok, i, cache, P + i, fused_attn=True)
            tok = logits[0].argmax()
        torch.cuda.synchronize()
    L = hp.backbone.num_layers
    counts = read_counts()
    check_counts(counts, f"Turbo teacher-forced over an unaligned {T}-slot cache, "
                 f"{L} layers x {n} steps", {k: L * n for k in GPT2 + (B7,)})
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits over the unaligned cache")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    return totals


BATCH_TEXTS = ("The quick brown fox jumps over the lazy dog near the river bank.",
               "A stitch in time saves nine, or so the old saying goes.",
               "Please call Stella and ask her to bring these things.",
               "It was the best of times, it was the worst of times.",
               "Rain fell softly on the quiet harbour all night long.",
               "Numbers like 1999 and 2024 should read naturally too.",
               "She sells sea shells by the sea shore every summer.",
               "The meeting starts at nine; please do not be late.")


def batched_paths(turbo, cfg520) -> dict:
    """BatchDecoder with the int8 cache: eight Turbo requests of 12-30 text
    tokens, then four 520M CFG requests (eight rows). Each serves its batch
    once (EOS honoured, every result checked), then the same batch is timed
    for N_TOKENS tokens with EOS ignored, launch counts checked, and its
    decode step profiled."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.sampling.batched import t3_generate_batched
    from chatterbox_tpu_torch.serve.batching import BatchDecoder, TTSRequest
    texts = BATCH_TEXTS
    turbo_reqs = [TTSRequest(_Tokenizer(12 + 18 * i // 7, 50000).text_to_tokens(t)[0],
                             turbo.conds.t3, request_id=i, seed=100 + i)
                  for i, t in enumerate(texts)]
    hp = cfg520.hp           # SOT/EOT framing, as ChatterboxTTS.frame_text
    cfg_reqs = [TTSRequest(np.concatenate([[hp.start_text_token],
                                           _Tokenizer(10 + 6 * i, 704).text_to_tokens(t)[0],
                                           [hp.stop_text_token]]),
                           cfg520.conds.t3, request_id=i, seed=200 + i)
                for i, t in enumerate(texts[:4])]
    totals = {}
    for tts, label, kernels, reqs, dec in (
            (turbo, "Turbo BatchDecoder, 8 requests", GPT2, turbo_reqs,
             BatchDecoder(turbo.t3_params, turbo.hp, max_batch=8, max_new_tokens=N_TOKENS,
                          kv_int8=True)),
            (cfg520, "520M CFG BatchDecoder, 4 requests", LLAMA, cfg_reqs,
             BatchDecoder(cfg520.t3_params, cfg520.hp, cfg=True, max_batch=4,
                          max_new_tokens=N_TOKENS, kv_int8=True))):
        t0 = time.perf_counter()
        results = dec.decode_batch(reqs)
        served = time.perf_counter() - t0
        if [r.request_id for r in results] != [r.request_id for r in reqs]:
            raise AssertionError(f"{label}: results out of order")
        for r in results:
            t = r.speech_tokens
            if not (t.ndim == 1 and ((t >= 0) & (t < S3_VOCAB)).all()):
                raise AssertionError(f"{label}: request {r.request_id} has invalid tokens")
        log(f"{label}: served in {served:.3f} s, tokens per request "
            f"{[len(r.speech_tokens) for r in results]}")
        inputs = dec.batch_inputs(reqs)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = t3_generate_batched(tts.t3_params, tts.hp, *inputs, max_new_tokens=N_TOKENS,
                                  top_k=dec.top_k, cfg_mode=dec.cfg, kv_int8=True,
                                  ignore_eos=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        toks = res.tokens.cpu().numpy()
        if not ((toks >= 0) & (toks < tts.hp.speech_tokens_dict_size)).all():
            raise AssertionError(f"{label}: invalid token ids")
        L = tts.hp.backbone.num_layers
        counts = read_counts()
        check_counts(counts, f"{label}, {L} layers x {res.n_forward} decode steps",
                     {k: L * res.n_forward for k in kernels + (B4,)})
        B = toks.shape[0]
        log(f"{label} decode, {B} requests ({B * (2 if dec.cfg else 1)} rows), "
            f"{N_TOKENS} tokens each, EOS ignored: {dt:.4f} s -> {B * N_TOKENS / dt:.1f} "
            f"tok/s aggregate ({dt / N_TOKENS * 1e3:.3f} ms/step)")
        profile_decode(lambda n: t3_generate_batched(
            tts.t3_params, tts.hp, *inputs, max_new_tokens=n, top_k=dec.top_k,
            cfg_mode=dec.cfg, kv_int8=True, ignore_eos=True), dt / N_TOKENS, label)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return totals


# ---------------------------------------------------------------------------
# phase 6: the frontend, from a checkpoint directory in the reference's layout
# ---------------------------------------------------------------------------
# The writer is the inverse of the converters (chatterbox_tpu_torch/convert/
# weights.py): a port parameter tree -> {reference key: float32 numpy}. The
# tests hold it against both packages' converters, bit for bit.

def _np(t):
    return t.detach().float().cpu().numpy()


def _lin(out, k, p):
    out[f"{k}.weight"] = _np(p["w"]).T
    if "b" in p:
        out[f"{k}.bias"] = _np(p["b"])


def _wb(out, k, p, w="w", b="b"):
    """A leaf written as it is (GPT-2 Conv1D, conv weights, embeddings)."""
    out[f"{k}.weight"] = _np(p[w])
    if b in p:
        out[f"{k}.bias"] = _np(p[b])


def _ln(out, k, p):
    _wb(out, k, p, w="g")


def _bn(out, k, p):
    out.update({f"{k}.running_mean": _np(p["mean"]), f"{k}.running_var": _np(p["var"]),
                f"{k}.weight": _np(p["g"]), f"{k}.bias": _np(p["b"])})


def t3_state_dict(p, hp) -> dict:
    """A float T3 tree -> the reference's T3 state dict."""
    out = {}
    bbp = p["backbone"]
    if hp.backbone.is_gpt:
        for i, lp in enumerate(bbp["layers"]):
            b = f"tfmr.h.{i}"
            _ln(out, f"{b}.ln_1", lp["ln1"])
            _wb(out, f"{b}.attn.c_attn", lp["qkv"])
            _wb(out, f"{b}.attn.c_proj", lp["attn_out"])
            _ln(out, f"{b}.ln_2", lp["ln2"])
            _wb(out, f"{b}.mlp.c_fc", lp["fc_in"])
            _wb(out, f"{b}.mlp.c_proj", lp["fc_out"])
        _wb(out, "tfmr.wpe", bbp["wpe"])
        _ln(out, "tfmr.ln_f", bbp["ln_f"])
    else:
        names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                 "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
                 "down": "mlp.down_proj"}
        for i, lp in enumerate(bbp["layers"]):
            b = f"tfmr.layers.{i}"
            _wb(out, f"{b}.input_layernorm", lp["input_ln"], w="g")
            _wb(out, f"{b}.post_attention_layernorm", lp["post_ln"], w="g")
            for name, key in names.items():
                _lin(out, f"{b}.{key}", lp[name])
        _wb(out, "tfmr.norm", bbp["norm"], w="g")
    for name in ("text_emb", "speech_emb"):
        _wb(out, name, p[name])
    for name in ("text_head", "speech_head"):
        _lin(out, name, p[name])
    ce = p["cond_enc"]
    _lin(out, "cond_enc.spkr_enc", ce["spkr_enc"])
    if "emotion_adv_fc" in ce:
        _lin(out, "cond_enc.emotion_adv_fc", ce["emotion_adv_fc"])
    if "perceiver" in ce:
        pv = ce["perceiver"]
        out["cond_enc.perceiver.pre_attention_query"] = _np(pv["query"])
        _ln(out, "cond_enc.perceiver.attn.norm", pv["norm"])
        for name in ("to_q", "to_k", "to_v", "proj_out"):
            _lin(out, f"cond_enc.perceiver.attn.{name}", pv[name])
    for name in ("text_pos_emb", "speech_pos_emb"):
        if name in p:
            _wb(out, f"{name}.emb", p[name])
    return out


def ve_state_dict(p) -> dict:
    out = {}
    for i, lp in enumerate(p["lstm"]["layers"]):
        out.update({f"lstm.weight_ih_l{i}": _np(lp["w_ih"]).T,
                    f"lstm.weight_hh_l{i}": _np(lp["w_hh"]).T,
                    f"lstm.bias_ih_l{i}": _np(lp["b_ih"]), f"lstm.bias_hh_l{i}": _np(lp["b_hh"])})
    _lin(out, "proj", p["proj"])
    out["similarity_weight"] = _np(p["similarity_weight"])
    out["similarity_bias"] = _np(p["similarity_bias"])
    return out


def _s3tok_state_dict(out, p, k="tokenizer"):
    _wb(out, f"{k}.encoder.conv1", p["conv1"])
    _wb(out, f"{k}.encoder.conv2", p["conv2"])
    for i, blk in enumerate(p["blocks"]):
        b = f"{k}.encoder.blocks.{i}"
        _ln(out, f"{b}.attn_ln", blk["ln1"])
        for name, key in (("q", "query"), ("k", "key"), ("v", "value"), ("out", "out")):
            _lin(out, f"{b}.attn.{key}", blk[name])
        _ln(out, f"{b}.mlp_ln", blk["ln2"])
        _lin(out, f"{b}.mlp.0", blk["fc1"])
        _lin(out, f"{b}.mlp.2", blk["fc2"])
    _ln(out, f"{k}.encoder.ln_post", p["ln_post"])
    _lin(out, f"{k}.quantizer._codebook.project_down", p["fsq_proj"])


def _campplus_state_dict(out, p, k="speaker_encoder"):
    from chatterbox_tpu_torch.models.s3gen.campplus import BLOCK_SPECS
    f = p["fcm"]
    _wb(out, f"{k}.head.conv1", f["conv1"])
    _bn(out, f"{k}.head.bn1", f["bn1"])
    for layer in ("layer1", "layer2"):
        for i, r in enumerate(f[layer]):
            b = f"{k}.head.{layer}.{i}"
            for n in ("conv1", "conv2"):
                _wb(out, f"{b}.{n}", r[n])
            for n in ("bn1", "bn2"):
                _bn(out, f"{b}.{n}", r[n])
            if "shortcut_conv" in r:
                _wb(out, f"{b}.shortcut.0", r["shortcut_conv"])
                _bn(out, f"{b}.shortcut.1", r["shortcut_bn"])
    _wb(out, f"{k}.head.conv2", f["conv2"])
    _bn(out, f"{k}.head.bn2", f["bn2"])
    x = f"{k}.xvector"
    _wb(out, f"{x}.tdnn.linear", p["tdnn"]["conv"])
    _bn(out, f"{x}.tdnn.nonlinear.batchnorm", p["tdnn"]["bn"])
    for bi, (layers, transit) in enumerate(zip(p["blocks"], p["transits"])):
        assert len(layers) == BLOCK_SPECS[bi][0]
        for i, lp in enumerate(layers):
            b = f"{x}.block{bi + 1}.tdnnd{i + 1}"
            _bn(out, f"{b}.nonlinear1.batchnorm", lp["bn1"])
            _wb(out, f"{b}.linear1", lp["lin1"])
            _bn(out, f"{b}.nonlinear2.batchnorm", lp["bn2"])
            for n, key in (("local", "linear_local"), ("lin1", "linear1"), ("lin2", "linear2")):
                _wb(out, f"{b}.cam_layer.{key}", lp["cam"][n])
        _bn(out, f"{x}.transit{bi + 1}.nonlinear.batchnorm", transit["bn"])
        _wb(out, f"{x}.transit{bi + 1}.linear", transit["conv"])
    _bn(out, f"{x}.out_nonlinear.batchnorm", p["out_bn"])
    _wb(out, f"{x}.dense.linear", p["dense"]["conv"])
    _bn(out, f"{x}.dense.nonlinear.batchnorm", p["dense"]["bn"])


def _conformer_state_dict(out, b, p):
    _ln(out, f"{b}.norm_mha", p["norm_mha"])
    a = p["attn"]
    for n in ("q", "k", "v", "out", "pos"):
        _lin(out, f"{b}.self_attn.linear_{n}", a[n])
    out[f"{b}.self_attn.pos_bias_u"] = _np(a["pos_bias_u"])
    out[f"{b}.self_attn.pos_bias_v"] = _np(a["pos_bias_v"])
    _ln(out, f"{b}.norm_ff", p["norm_ff"])
    _lin(out, f"{b}.feed_forward.w_1", p["ff_in"])
    _lin(out, f"{b}.feed_forward.w_2", p["ff_out"])


def _flow_state_dict(out, p):
    _wb(out, "flow.input_embedding", p["input_embedding"])
    _lin(out, "flow.spk_embed_affine_layer", p["spk_embed_affine"])
    _lin(out, "flow.encoder_proj", p["encoder_proj"])
    e, k = p["encoder"], "flow.encoder"
    for emb_name, key in (("embed", "embed"), ("up_embed", "up_embed")):
        _lin(out, f"{k}.{key}.out.0", e[emb_name]["linear"])
        _ln(out, f"{k}.{key}.out.1", e[emb_name]["norm"])
    for n in ("conv1", "conv2"):
        _wb(out, f"{k}.pre_lookahead_layer.{n}", e["pre_lookahead"][n])
    for i, blk in enumerate(e["blocks"]):
        _conformer_state_dict(out, f"{k}.encoders.{i}", blk)
    _wb(out, f"{k}.up_layer.conv", e["up_conv"])
    for i, blk in enumerate(e["up_blocks"]):
        _conformer_state_dict(out, f"{k}.up_encoders.{i}", blk)
    _ln(out, f"{k}.after_norm", e["after_norm"])
    u, k = p["decoder"], "flow.decoder.estimator"
    _lin(out, f"{k}.time_mlp.linear_1", u["time_mlp"]["lin1"])
    _lin(out, f"{k}.time_mlp.linear_2", u["time_mlp"]["lin2"])
    if "time_mixer" in u:
        _lin(out, f"{k}.time_embed_mixer", u["time_mixer"])

    def causal(b, c):
        _wb(out, f"{b}.block.0", c["conv"])
        _ln(out, f"{b}.block.2", c["norm"])

    stages = ([("down_blocks.0", u["down"][0])]
              + [(f"mid_blocks.{i}", st) for i, st in enumerate(u["mid"])]
              + [("up_blocks.0", u["up"][0])])
    for name, st in stages:
        b = f"{k}.{name}"
        r = st["resnet"]
        _lin(out, f"{b}.0.mlp.1", r["mlp"])
        causal(f"{b}.0.block1", r["block1"])
        causal(f"{b}.0.block2", r["block2"])
        _wb(out, f"{b}.0.res_conv", r["res_conv"])
        for j, t in enumerate(st["tfmr"]):
            tb = f"{b}.1.{j}"
            _ln(out, f"{tb}.norm1", t["norm1"])
            for n in ("to_q", "to_k", "to_v"):
                _lin(out, f"{tb}.attn1.{n}", t[n])
            _lin(out, f"{tb}.attn1.to_out.0", t["to_out"])
            _ln(out, f"{tb}.norm3", t["norm3"])
            _lin(out, f"{tb}.ff.net.0.proj", t["ff_in"])
            _lin(out, f"{tb}.ff.net.2", t["ff_out"])
        if "updown" in st:
            _wb(out, f"{b}.2", st["updown"])
    causal(f"{k}.final_block", u["final_block"])
    _wb(out, f"{k}.final_proj", u["final_proj"])


def _hift_state_dict(out, p, k="mel2wav"):
    f0 = p["f0_predictor"]
    for i, c in zip((0, 2, 4, 6, 8), f0["convs"]):
        _wb(out, f"{k}.f0_predictor.condnet.{i}", c)
    _lin(out, f"{k}.f0_predictor.classifier", f0["classifier"])
    _lin(out, f"{k}.m_source.l_linear", p["m_source_linear"])
    _wb(out, f"{k}.conv_pre", p["conv_pre"])
    _wb(out, f"{k}.conv_post", p["conv_post"])
    for name in ("ups", "source_downs"):
        for i, c in enumerate(p[name]):
            _wb(out, f"{k}.{name}.{i}", c)
    for name in ("source_resblocks", "resblocks"):
        for i, r in enumerate(p[name]):
            b = f"{k}.{name}.{i}"
            for j in range(len(r["convs1"])):
                _wb(out, f"{b}.convs1.{j}", r["convs1"][j])
                _wb(out, f"{b}.convs2.{j}", r["convs2"][j])
                out[f"{b}.activations1.{j}.alpha"] = _np(r["alpha1"][j])
                out[f"{b}.activations2.{j}.alpha"] = _np(r["alpha2"][j])


def s3gen_state_dict(p) -> dict:
    """An S3Gen tree with its frontend -> the reference's s3gen state dict."""
    out = {}
    _s3tok_state_dict(out, p["tokenizer"])
    _campplus_state_dict(out, p["speaker_encoder"])
    _flow_state_dict(out, p["flow"])
    _hift_state_dict(out, p["mel2wav"])
    return out


def write_turbo_tokenizer(d, vocab_size: int, corpus):
    """A BPE `tokenizer.json` trained on `corpus` (the `tokenizers`
    package), with the tokenizer_config.json transformers' AutoTokenizer
    reads it by: the GPT-2 tokenizer files of a Turbo checkpoint."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    t = Tokenizer(models.BPE(unk_token="[UNK]"))
    t.pre_tokenizer = pre_tokenizers.Whitespace()
    t.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=["<|endoftext|>", "[UNK]"]))
    t.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<|endoftext|>",
        "unk_token": "[UNK]"}))


def write_checkpoint(d, t3_file: str, s3gen_file: str, t3_params, hp, s3gen_params,
                     ve_params):
    """t3_file, s3gen_file and ve.safetensors in the reference's layout,
    written by the port's own .safetensors writer."""
    from chatterbox_tpu_torch.convert.native_ckpt import save_safetensors
    save_safetensors(t3_state_dict(t3_params, hp), d / t3_file)
    save_safetensors(s3gen_state_dict(s3gen_params), d / s3gen_file)
    save_safetensors(ve_state_dict(ve_params), d / "ve.safetensors")


def synthetic_voice(seconds: float, sr: int, seed: int = 0, f0: float = 140.0):
    """A voice-like test signal from a seed: eight harmonics of a wavering
    f0 under a slow envelope, plus noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 3 * t))) / sr
    wav = sum(0.3 / h * np.sin(h * phase + rng.uniform(0, 2 * np.pi)) for h in range(1, 9))
    wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t) ** 2)
    return (wav + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def seeded_batch_stats(tree, seed: int):
    """The tree with every batch norm ({g, b, mean, var}) given seeded
    statistics (numpy leaves stay numpy, tensors stay on their device), so
    CAMPPlus's x-vector is of order 1 rather than its init's 1e-4."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def like(a, leaf):
        a = a.astype(np.float32)
        return torch.from_numpy(a).to(leaf.device) if torch.is_tensor(leaf) else a

    def f(node):
        if isinstance(node, dict):
            if set(node) == {"g", "b", "mean", "var"}:
                n = tuple(node["g"].shape)
                return {"g": like(rng.uniform(0.5, 1.5, n), node["g"]),
                        "b": like(0.1 * rng.standard_normal(n), node["b"]),
                        "mean": like(0.1 * rng.standard_normal(n), node["mean"]),
                        "var": like(rng.uniform(0.5, 1.5, n), node["var"])}
            return {k: f(v) for k, v in node.items()}
        if isinstance(node, list):
            return [f(v) for v in node]
        return node
    return f(tree)


def _equal_trees(a, b, where: str) -> int:
    """Assert two trees equal leaf for leaf (type, shape, bits); the count
    of leaves."""
    import torch
    if isinstance(b, dict):
        if set(a) != set(b):
            raise AssertionError(f"{where}: keys {sorted(a)} against {sorted(b)}")
        return sum(_equal_trees(a[k], b[k], f"{where}/{k}") for k in b)
    if isinstance(b, list):
        if len(a) != len(b):
            raise AssertionError(f"{where}: {len(a)} entries against {len(b)}")
        return sum(_equal_trees(x, y, f"{where}/{i}") for i, (x, y) in enumerate(zip(a, b)))
    if not (a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)):
        raise AssertionError(f"{where}: the loaded leaf differs from the written one")
    return 1


def _best_ms(fn, reps: int = 3) -> float:
    """Best wall ms of fn() over reps calls, synced (after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _compare_conds(out, ref) -> None:
    """The card's Conditionals against the CPU path's: embeddings and
    prompt mels to 1e-3, at least 99 % of the S3 tokens equal."""
    import numpy as np
    for label, a, b in (("voice-encoder embedding", out.t3.speaker_emb, ref.t3.speaker_emb),
                        ("CAMPPlus x-vector", out.gen.embedding, ref.gen.embedding),
                        ("prompt mels", out.gen.prompt_feat, ref.gen.prompt_feat)):
        err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
        log(f"frontend {label}: card vs cpu max abs err {err:.3e} (scale "
            f"{np.abs(b).max():.3f}, tolerance 1e-3)")
        if not (np.isfinite(a).all() and err <= 1e-3):
            raise AssertionError(f"frontend {label} on the card disagrees with the CPU path")
    for label, a, b in (("S3Gen prompt", out.gen.prompt_token, ref.gen.prompt_token),
                        ("T3 prompt", out.t3.cond_prompt_speech_tokens,
                         ref.t3.cond_prompt_speech_tokens)):
        same = int((a == b).sum()) if a.shape == b.shape else 0
        log(f"frontend {label} S3 tokens: {same} of {b.size} equal on the card and the cpu")
        if same < 0.99 * b.size:
            raise AssertionError(f"frontend {label} tokens: only {same} of {b.size} equal")


def frontend_path(d) -> dict:
    """Phase 6: a Turbo checkpoint directory in the reference's layout,
    written from random full-width weights (GPT-2-medium T3, the full S3
    tokenizer, CAMPPlus with seeded batch statistics, flow, HiFT base 512,
    the voice encoder) with a BPE trained here, loaded by from_local on the
    card (and on the cpu), the loaded trees held against the written ones;
    prepare_conditionals on a 6 s synthetic voice held against the cpu
    path and timed, with its split; T3 quantized int8_fused; a warm-up
    generate(text, audio_prompt_path=wav), then TIMED_RUNS requests timed as
    phase 5 times them with prepare_conditionals inside the timed window.
    d: an empty directory (a pathlib.Path), which keeps the checkpoint and
    the prompt WAV for phase 10's command line. Returns the launch counts of
    the timed requests."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch import ChatterboxTurboTTS
    from chatterbox_tpu_torch.audio.mels import mel_spectrogram_24k
    from chatterbox_tpu_torch.audio.resample import resample
    from chatterbox_tpu_torch.models.s3gen.campplus import campplus_embed_wav
    from chatterbox_tpu_torch.models.s3gen.model import s3gen_init
    from chatterbox_tpu_torch.models.s3tok.model import s3tokenizer_tokenize
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.models.t3.config import T3Config
    from chatterbox_tpu_torch.models.ve import model as ve
    from chatterbox_tpu_torch.nn import core as nn
    from chatterbox_tpu_torch.ops.sampling import SamplerParams
    from chatterbox_tpu_torch.sampling.decode import t3_generate
    from chatterbox_tpu_torch.utils.audio_io import load_audio, save_wav
    from chatterbox_tpu_torch.utils.loudness import norm_loudness
    from chatterbox_tpu_torch.utils.quantize import (best_serving_mode, cast_params,
                                                     quantize_t3_backbone)
    hp = T3Config.turbo()
    t3 = t3m.t3_init(hp, seed=20, device="cuda")
    s3 = s3gen_init(21, "cuda", meanflow=True)
    s3["speaker_encoder"] = seeded_batch_stats(s3["speaker_encoder"], 22)
    vep = ve.ve_init(nn.Init(23, "cuda"))
    counts = {}
    t0 = time.perf_counter()
    write_checkpoint(d, "t3_turbo_v1.safetensors", "s3gen_meanflow.safetensors", t3, hp, s3,
                     vep)
    write_turbo_tokenizer(d, 500, [PHASE5_TEXT * 4, "the river bank is near"])
    wav_path = d / "prompt.wav"
    save_wav(wav_path, 0.5 * synthetic_voice(6.0, 24000, seed=24), 24000)
    files = sorted(f.name for f in d.iterdir())
    mib = sum(f.stat().st_size for f in d.iterdir()) / 2**20
    log(f"frontend: wrote {files} ({mib:.1f} MiB) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tts = ChatterboxTurboTTS.from_local(d)
    torch.cuda.synchronize()
    log(f"frontend: from_local on {tts.device} in {time.perf_counter() - t0:.1f} s "
        f"(tokenizer {type(tts.tokenizer).__name__})")
    n = (_equal_trees(tts.t3_params, t3, "t3") + _equal_trees(tts.s3gen.params, s3, "s3gen")
         + _equal_trees(tts.ve_params, vep, "ve"))
    log(f"frontend: the {n} loaded leaves equal the written ones")
    del t3, s3, vep
    t0 = time.perf_counter()
    cpu = ChatterboxTurboTTS.from_local(d, device="cpu")
    cpu.prepare_conditionals(str(wav_path))
    log(f"frontend: from_local and prepare_conditionals on the cpu in "
        f"{time.perf_counter() - t0:.1f} s")
    ms = _best_ms(lambda: tts.prepare_conditionals(str(wav_path)))
    _compare_conds(tts.conds, cpu.conds)
    del cpu

    # the split of prepare_conditionals, each part on the card as it calls it
    ref_24k = np.asarray(norm_loudness(load_audio(wav_path, 24000), 24000), np.float32)
    dev = tts.s3gen.device
    params, cfg = tts.s3gen.params, tts.s3gen.tok_cfg
    w24 = torch.from_numpy(ref_24k).to(dev)
    w16 = resample(w24, 24000, 16000)
    n16 = 640 * -(-w16.shape[0] // 640)
    w16p = torch.nn.functional.pad(w16, (0, n16 - w16.shape[0]))
    w24p = torch.nn.functional.pad(w24, (0, max(0, n16 * 3 // 2 - w24.shape[0])))
    n_len = torch.tensor([n16], device=dev)
    ref_16k = w16.cpu().numpy()
    with torch.no_grad(), nn.no_tf32_convs():
        split = {
            "load + loudness (host)": _best_ms(
                lambda: norm_loudness(load_audio(wav_path, 24000), 24000)),
            "resample x2": _best_ms(
                lambda: (resample(w24, 24000, 16000), resample(w24, 24000, 16000))),
            "mel 24k": _best_ms(lambda: mel_spectrogram_24k(w24p[None])),
            "CAMPPlus": _best_ms(lambda: campplus_embed_wav(params["speaker_encoder"],
                                                            w16[None])),
            "S3 tokenizer x2": _best_ms(lambda: (
                s3tokenizer_tokenize(params["tokenizer"], cfg, w16p[None], n_len),
                s3tokenizer_tokenize(params["tokenizer"], cfg, w16p[None], n_len,
                                     hp.speech_cond_prompt_len))),
            "voice encoder": _best_ms(lambda: ve.embeds_from_wavs(
                tts.ve_params, [ref_16k], sample_rate=16000)),
        }
    log(f"frontend: prepare_conditionals of a 6 s prompt on the card {ms:.2f} ms (best of "
        f"3); parts (best of 3 each, synced): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f"; sum {sum(split.values()):.2f} ms")

    # T3 served as bench.py serves it, then requests from the prompt file
    t0 = time.perf_counter()
    tts.t3_params = quantize_t3_backbone(cast_params(tts.t3_params, torch.bfloat16),
                                         mode=best_serving_mode(hp.backbone))
    gen_kw = dict(top_k=1000, temperature=0.8, top_p=0.95, repetition_penalty=1.2)
    wav = tts.generate(PHASE5_TEXT, audio_prompt_path=str(wav_path),
                       max_new_tokens=WARMUP_TOKENS, **gen_kw)
    if not (wav.ndim == 2 and np.isfinite(wav).all()):
        raise AssertionError(f"frontend: generate from the prompt gave {wav.shape}")
    ids = torch.as_tensor(turbo_ids(tts, PHASE5_TEXT), device="cuda").long()
    sp = SamplerParams(0.8, 0.95, 1.2)

    def request():
        t0 = time.perf_counter()
        tts.prepare_conditionals(str(wav_path))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = t3_generate(tts.t3_params, hp, tts.conds.t3.as_tensors("cuda"), ids, sp,
                          max_new_tokens=N_TOKENS, top_k=1000, ignore_eos=True,
                          generator=tts.generator)
        wav, n_voc = tts.s3gen.inference_from_decode(
            res.tokens, res.n_tokens, tts.conds.gen, generator=tts.generator, append_sil=3)
        t2 = time.perf_counter()
        if (n_voc != vocoded_tokens(res, False) or wav.shape != (1, n_voc * 960)
                or not np.isfinite(wav).all()):
            raise AssertionError(f"frontend request: waveform {wav.shape}, {n_voc} tokens")
        return t2 - t0, t2 - t1, n_voc, res.n_forward

    log(f"frontend: T3 quantized and a warm-up generate from the prompt file in "
        f"{time.perf_counter() - t0:.1f} s")
    reset_counts()
    runs = [request() for _ in range(TIMED_RUNS)]
    counts = read_counts()
    L, forwards = hp.backbone.num_layers, sum(r[3] for r in runs)
    check_counts(counts, f"Turbo from a prompt file, {L} layers x {forwards} decode steps",
                 {**{k: L * forwards for k in GPT2}, "hift_source": TIMED_RUNS})
    full, bare = min(r[0] for r in runs), min(r[1] for r in runs)
    audio_s = runs[0][2] / 25.0
    log(f"Turbo request from a prompt file (prepare_conditionals + t3_generate + "
        f"inference_from_decode): {[round(r[0], 4) for r in runs]} s for {audio_s:.2f} s of "
        f"audio -> x-realtime {audio_s / full:.3f} with the frontend, {audio_s / bare:.3f} "
        f"without it (best of {TIMED_RUNS})")

    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        request()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"frontend: profiled request and its analysis {time.perf_counter() - t0:.1f} s")
    log(f"Turbo request from a prompt file: {dev_us / 1e3:.1f} ms of device time "
        f"(profiled run) against {full * 1e3:.1f} ms of wall (best unprofiled) -> device "
        f"busy {100 * dev_us / 1e3 / (full * 1e3):.1f} % of a whole request")
    return counts


# ---------------------------------------------------------------------------
# phase 7: streaming synthesis and voice conversion
# ---------------------------------------------------------------------------

STREAM_CHUNK = 25              # tokens a decode chunk of generate_stream
HIFT_WINDOWS = (96, 168, 240)  # growing HiFT windows (mel frames); 16 held back
STREAM_LA = 16                 # frames held back a window: past HiFT's receptive field
STREAM_RUNS = 1                # timed streams a pipeline


def stream_tokens_equal(tts, label, decode_kw):
    """The chunked decode (t3_prefill_decode, then t3_decode_chunk, chunks of
    25, EOS ignored) against t3_generate on the same 250 pre-drawn gumbel
    rows: every token equal."""
    import torch
    from chatterbox_tpu_torch.ops import sampling as S
    from chatterbox_tpu_torch.sampling.chunked import t3_decode_chunk, t3_prefill_decode
    from chatterbox_tpu_torch.sampling.decode import t3_generate
    kw = dict(decode_kw)
    ids = torch.as_tensor(kw.pop("ids"), device="cuda").long()
    cfg_mode = kw.pop("cfg_mode", False)
    kw.pop("cfg_batch2", None)
    g = S.gumbel((N_TOKENS, tts.hp.speech_tokens_dict_size),
                 torch.Generator(device="cuda").manual_seed(71), "cuda")
    cond = tts.conds.t3.as_tensors("cuda")
    state, toks, _ = t3_prefill_decode(tts.t3_params, tts.hp, cond, ids, gumbel=g,
                                       max_new_tokens=N_TOKENS, n_steps=STREAM_CHUNK,
                                       cfg_mode=cfg_mode, ignore_eos=True, **kw)
    chunks = [toks[:state.step]]
    while state.step < N_TOKENS:
        step = state.step
        state, toks, _ = t3_decode_chunk(tts.t3_params, tts.hp, state, kw["sp"],
                                         n_steps=STREAM_CHUNK, top_k=kw.get("top_k", 0),
                                         cfg_mode=cfg_mode, ignore_eos=True)
        chunks.append(toks[:state.step - step])
    res = t3_generate(tts.t3_params, tts.hp, cond, ids, max_new_tokens=N_TOKENS,
                      cfg_mode=cfg_mode, ignore_eos=True, gumbel=g, **kw)
    streamed = torch.cat(chunks)
    same = int((streamed == res.tokens).sum())
    log(f"stream tokens ({label}): {same} of {N_TOKENS} chunked tokens (chunks of "
        f"{STREAM_CHUNK}) equal t3_generate's on the same gumbel draws; "
        f"{len(set(streamed.tolist()))} distinct")
    if not torch.equal(streamed, res.tokens):
        raise AssertionError(f"{label}: the chunked decode's tokens differ from t3_generate's")


def hift_stream_check(eng):
    """Full-width HiFT on the card: windows of 96, 168 and 240 random mel
    frames, each taking the last one's source cache and emitting up to 16
    frames short of its end (all of the last), against the one-shot
    mel_to_wav_stream on the same noise: within 1e-4."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.models.s3gen.hift import SourceNoise
    T = HIFT_WINDOWS[-1]
    mel = (np.random.default_rng(72).standard_normal((1, T, 80)) * 0.5).astype(np.float32)
    noise = SourceNoise.draw(1, T, torch.Generator(device="cuda").manual_seed(73), "cuda")
    full = eng.mel_to_wav_stream(mel, noise=noise)[0][0]
    cache, clen, emitted, out = None, 0, 0, []
    for Tc in HIFT_WINDOWS:
        part = SourceNoise(noise.phase, noise.noise_u[:, :Tc * 480])
        wav, src, _ = eng.mel_to_wav_stream(mel[:, :Tc], cache_source=cache, cache_len=clen,
                                            noise=part)
        upto = (Tc if Tc == T else Tc - STREAM_LA) * 480
        out.append(wav[0, emitted:upto])
        emitted, cache, clen = upto, src, Tc * 480
    stream = np.concatenate(out)
    err = float(np.abs(stream - full).max()) if stream.shape == full.shape else float("inf")
    log(f"HiFT streaming (base {eng.params['mel2wav']['conv_pre']['b'].shape[0]}, windows "
        f"{HIFT_WINDOWS} frames): growing windows vs one-shot, max abs err "
        f"{err:.3e} (scale {np.abs(full).max():.3f}, tolerance 1e-4)")
    if not (np.isfinite(stream).all() and err <= 1e-4):
        raise AssertionError(f"HiFT streaming differs from the one-shot vocode: {err}")


class StreamDraws:
    """A stream's random numbers drawn once on the cpu (the flow buffer, the
    HiFT phases, source noise for `frames` mel frames) and served on
    `device` through an engine's draw_noise, so that the card's vocoder and
    the cpu's take the same numbers."""

    def __init__(self, seed: int, frames: int, device):
        import torch
        from chatterbox_tpu_torch.serve.streaming import StreamingVocoder
        g = torch.Generator().manual_seed(seed)
        self.buffer = torch.randn((1, StreamingVocoder.MAX_MEL_FRAMES, 80), generator=g)
        self.phase = (torch.rand((1, 1, 9), generator=g) * 2 - 1) * torch.pi
        self.noise_u = torch.randn((1, frames * 480, 9), generator=g)
        self.buffer, self.phase, self.noise_u = (t.to(device) for t in
                                                 (self.buffer, self.phase, self.noise_u))

    def __call__(self, n_mel, n_gen_mel, generator):
        import torch
        from chatterbox_tpu_torch.models.s3gen.hift import SourceNoise
        from chatterbox_tpu_torch.models.s3gen.model import S3GenNoise
        z = self.buffer if n_mel else torch.zeros((1, 0, 80), device=self.buffer.device)
        return S3GenNoise(z, SourceNoise(self.phase, self.noise_u[:, :n_gen_mel * 480]))


def vocoder_reference():
    """The streaming vocoder on the card against the cpu: a small S3Gen
    (tiny flow, HiFT base 32, meanflow) with the same weights and the same
    numbers, four chunks through feed_from_decode (device tensors), the last
    final with 3 silence tokens: every feed's audio within 1e-4 and its
    length exact."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.models.s3gen.flow import FlowDims
    from chatterbox_tpu_torch.models.s3gen.model import RefDict, S3GenEngine, s3gen_init
    from chatterbox_tpu_torch.models.s3tok.model import S3TokenizerConfig
    from chatterbox_tpu_torch.serve.streaming import StreamingVocoder
    rng = np.random.default_rng(74)
    dims = FlowDims.tiny_test()
    s3 = s3gen_init(seed=74, device="cpu", meanflow=True, dims=dims, hift_base=32,
                    tok_cfg=S3TokenizerConfig.tiny_test())
    ref = RefDict(rng.integers(0, 6561, (1, 20)), np.array([20]),
                  (rng.standard_normal((1, 40, 80)) * 0.5).astype(np.float32),
                  rng.standard_normal((1, 192)).astype(np.float32))
    chunks = [rng.integers(0, 6561, n) for n in (25, 25, 25, 13)]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = S3GenEngine(s3 if dev == "cpu" else _to(s3, "cuda"), dims=dims)
        eng.draw_noise = StreamDraws(75, 2 * 91, dev)
        voc = StreamingVocoder(eng, ref)
        out[dev] = []
        for i, c in enumerate(chunks):
            final = i == len(chunks) - 1
            wav, n, _ = voc.feed_from_decode(torch.as_tensor(c, device=dev), len(c),
                                             vocab=6561, final=final,
                                             append_sil=3 if final else 0)
            out[dev].append(wav)
    errs = []
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        if a.shape != b.shape or not np.isfinite(a).all() or len(a) == 0:
            raise AssertionError(f"streaming vocoder feed {i}: {a.shape} on the card, "
                                 f"{b.shape} on the cpu")
        errs.append(float(np.abs(a - b).max()))
    log(f"reference streaming vocoder (meanflow, feed_from_decode, 4 feeds of "
        f"{[len(c) for c in chunks]} tokens, the last final + 3 silence): samples "
        f"{[len(a) for a in out['cuda']]} on both, max abs err per feed "
        f"{[f'{e:.3e}' for e in errs]} (tolerance 1e-4)")
    if max(errs) > 1e-4:
        raise AssertionError(f"the streaming vocoder on the card disagrees: {errs}")


def _device_us(prof) -> float:
    """Device time (us) of a profile's kernels, copies and sets, summed over
    the raw trace events (key_averages builds an object for each of a
    stream's ~10^5 events and takes tens of seconds there)."""
    import torch
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e3


def timed_streams(tts, label, kernels, stream_kw, text=PHASE5_TEXT, runs=STREAM_RUNS,
                  profiled=True) -> dict:
    """A 32-token generate_stream to warm up, then `runs` streams of `text`
    (250 tokens, chunks of 25) with the launch counts set to 0 just before
    and read just after (each of `kernels` launched layers x decode steps
    times, nothing else); per stream the time to the first chunk, the gaps
    between chunks, tokens and audio seconds, x-realtime; then, when
    `profiled`, the device's share of one profiled stream. Returns the
    launch counts."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    kw = dict(stream_kw, chunk_tokens=STREAM_CHUNK)

    def stream(n=N_TOKENS):
        t0 = time.perf_counter()
        marks, n_samples = [], 0
        for chunk in tts.generate_stream(text, max_new_tokens=n, **kw):
            marks.append(time.perf_counter() - t0)
            if not (chunk.dtype == np.float32 and np.isfinite(chunk).all()):
                raise AssertionError(f"{label}: a streamed chunk is not finite float32")
            n_samples += len(chunk)
        st = tts.last_decode
        return marks, n_samples, st.step, st.n_forward, bool(st.done)

    stream(WARMUP_TOKENS)                                            # warm-up
    reset_counts()
    runs = [stream() for _ in range(runs)]
    counts = read_counts()
    L, forwards = tts.hp.backbone.num_layers, sum(r[3] for r in runs)
    check_counts(counts, f"{label} stream, {L} layers x {forwards} decode steps",
                 {k: L * forwards for k in kernels})
    for marks, n_samples, steps, _, done in runs:
        audio_s, wall = n_samples / 24000, marks[-1]
        # 960 samples a vocoded token: at most the decoded ones and 3 silence
        if not (0 < n_samples <= (steps + 3) * 960 and n_samples % 960 == 0):
            raise AssertionError(f"{label}: {n_samples} samples for {steps} tokens")
        gaps = np.diff(marks)
        log(f"{label} stream: first audio {marks[0] * 1e3:.1f} ms, {len(marks)} chunks, gaps "
            f"{np.min(gaps) * 1e3 if len(gaps) else 0:.1f}-"
            f"{np.max(gaps) * 1e3 if len(gaps) else 0:.1f} ms (mean "
            f"{np.mean(gaps) * 1e3 if len(gaps) else 0:.1f}), {steps} tokens"
            f"{' (EOS)' if done else ''}, {audio_s:.2f} s of audio in {wall:.3f} s -> "
            f"x-realtime {audio_s / wall:.3f}")
    best = min(r[0][-1] for r in runs)
    if not profiled:
        return counts
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stream()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    dev_us = _device_us(prof)
    log(f"{label} stream: {dev_us / 1e3:.1f} ms of device time (profiled stream) against "
        f"{best * 1e3:.1f} ms of wall (best unprofiled) -> device busy "
        f"{100 * dev_us / 1e3 / (best * 1e3):.1f} % of a whole stream (profiled stream and "
        f"its trace {t1 - t0:.1f} s, the sum {time.perf_counter() - t1:.1f} s)")
    return counts


def vc_path(conds) -> None:
    """A 520M-family s3gen.safetensors (10-step CFM, full width, random
    weights, CAMPPlus with seeded batch statistics) and conds.pt written to
    a temporary directory; ChatterboxVC.from_local on the card, the loaded
    leaves equal to the written ones; set_target_voice on a 6 s synthetic
    voice and generate on a 10 s synthetic source: a warm-up, then three
    timed runs. H1 alone is on this path, once a run."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from chatterbox_tpu_torch import ChatterboxVC
    from chatterbox_tpu_torch.convert.native_ckpt import save_safetensors
    from chatterbox_tpu_torch.models.s3gen.model import s3gen_init
    from chatterbox_tpu_torch.utils.audio_io import save_wav
    s3 = s3gen_init(31, "cuda", meanflow=False)
    s3["speaker_encoder"] = seeded_batch_stats(s3["speaker_encoder"], 32)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        t0 = time.perf_counter()
        save_safetensors(s3gen_state_dict(s3), d / "s3gen.safetensors")
        conds.save(str(d / "conds.pt"))
        save_wav(d / "target.wav", 0.5 * synthetic_voice(6.0, 24000, seed=33), 24000)
        save_wav(d / "source.wav", 0.5 * synthetic_voice(10.0, 16000, seed=34, f0=110.0),
                 16000)
        mib = (d / "s3gen.safetensors").stat().st_size / 2**20
        log(f"VC: wrote s3gen.safetensors ({mib:.1f} MiB), conds.pt and two WAVs in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        vc = ChatterboxVC.from_local(d)
        torch.cuda.synchronize()
        n = _equal_trees(vc.s3gen.params, s3, "s3gen")
        log(f"VC: from_local on {vc.device} in {time.perf_counter() - t0:.1f} s; the {n} "
            f"loaded leaves equal the written ones; meanflow={vc.s3gen.meanflow}, "
            f"{vc.s3gen.n_timesteps} CFG flow steps; conds.pt's voice "
            f"{'loaded' if vc.ref_dict is not None else 'missing'}")
        if vc.s3gen.meanflow or vc.ref_dict is None:
            raise AssertionError("VC: load_vc must build a CFM engine with conds.pt's voice")
        del s3
        t0 = time.perf_counter()
        vc.set_target_voice(str(d / "target.wav"))
        torch.cuda.synchronize()
        log(f"VC: set_target_voice (6 s) in {(time.perf_counter() - t0) * 1e3:.1f} ms "
            f"({int(vc.ref_dict.prompt_token_len[0])} prompt tokens)")
        src = str(d / "source.wav")
        vc.generate(src)                                             # warm-up
        reset_counts()
        walls = []
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            wav = vc.generate(src)
            walls.append(time.perf_counter() - t0)
            if not (wav.shape == (1, 250 * 960) and np.isfinite(wav).all()
                    and np.abs(wav).max() > 0):
                raise AssertionError(f"VC: converted {wav.shape}")
        check_counts(read_counts(), "VC (H1 alone on this path)", {"hift_source": TIMED_RUNS})
        log(f"VC generate (10 s source: tokenize, 10-step CFG flow, HiFT): "
            f"{[round(w * 1e3, 1) for w in walls]} ms -> x-realtime {10.0 / min(walls):.3f} "
            f"(best of {TIMED_RUNS}); H1 is the one kernel of the port on this path")


def streaming_path(turbo, cfg520) -> dict:
    """Phase 7: the chunked decode against t3_generate (both families, 250
    tokens), HiFT streaming at full width, the streaming vocoder card vs
    cpu, timed generate_streams of both pipelines, and VC. Returns the
    launch counts of the timed streams."""
    from chatterbox_tpu_torch.ops.sampling import SamplerParams
    t0 = time.perf_counter()
    cfg_kw = dict(temperature=0.8, top_p=1.0, min_p=0.05, repetition_penalty=1.2,
                  cfg_weight=0.5)
    stream_tokens_equal(turbo, "Turbo", dict(ids=turbo_ids(turbo, PHASE5_TEXT),
                                             sp=SamplerParams(0.8, 0.95, 1.2), top_k=1000))
    stream_tokens_equal(cfg520, "520M CFG", dict(ids=cfg520.frame_text(PHASE5_TEXT),
                                                 sp=SamplerParams(**cfg_kw), cfg_mode=True))
    hift_stream_check(turbo.s3gen)
    vocoder_reference()
    log(f"phase 7 checks {time.perf_counter() - t0:.1f} s")
    counts = {}
    for tts, label, kernels, kw in (
            (turbo, "Turbo", GPT2, dict(top_k=1000, temperature=0.8, top_p=0.95,
                                        repetition_penalty=1.2)),
            (cfg520, "520M CFG", LLAMA, dict(exaggeration=0.5, **cfg_kw))):
        t0 = time.perf_counter()
        for k, v in timed_streams(tts, label, kernels, kw).items():
            counts[k] = counts.get(k, 0) + v
        log(f"{label} streams {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vc_path(cfg520.conds)
    log(f"VC {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 8: the multilingual pipeline and speculative Turbo decode
# ---------------------------------------------------------------------------

# a sentence in each of the multilingual model's 23 languages
MTL_SAMPLES = {
    "ar": "مرحبا بالعالم، كيف حالك؟",
    "da": "Hej verden, hvordan går det?",
    "de": "Guten Tag! Schöne Grüße aus München.",
    "el": "Γειά σου κόσμε, τι κάνεις;",
    "en": "Hello world, how are you today?",
    "es": "¡Hola, señor! ¿Qué tal el día?",
    "fi": "Hyvää päivää, maailma.",
    "fr": "Bonjour, ça va très bien aujourd'hui, merci beaucoup.",
    "he": "שלום עולם, מה שלומך?",
    "hi": "नमस्ते दुनिया, आप कैसे हैं?",
    "it": "Ciao, come stai oggi?",
    "ja": "日本語のテキストです。",
    "ko": "안녕하세요, 세계! 만나서 반갑습니다.",
    "ms": "Selamat pagi, dunia.",
    "nl": "Goedemorgen, wereld. Hoe gaat het?",
    "no": "Hei, verden! Blåbærsyltetøy.",
    "pl": "Dzień dobry, świecie. Żółw.",
    "pt": "Olá, mundo! A ação começa.",
    "ru": "Привет, мир! Как дела?",
    "sv": "Hej världen, hur mår du?",
    "sw": "Habari ya dunia, rafiki.",
    "tr": "Merhaba dünya, nasılsın?",
    "zh": "你好，世界。妳好，中文。",
}
# Cangjie5_TC.json entries ("glyph\tcode"): 你 and 妳 share a code, so the
# second is written with the index suffix 1
CANGJIE_ENTRIES = ["你\tonf", "妳\tonf", "好\tvnd", "世\tpt", "界\twll", "中\tl", "文\tyk"]
CJ_TOKENS = [f"[cj_{c}]" for c in "abcdefghijklmnopqrstuvwxyz0123456789."]
MTL_VOCAB_FILE = "grapheme_mtl_merged_expanded_v1.json"
MTL_REQUESTS = ("fr", "ko", "zh")
SPEC_K = (4, 8)                # draft lengths timed
NANO_TOKENS = 50               # the Nano draft's timed decode (it accepts ~4 %)
VERIFY_TOL = 0.05              # verify slab against single steps, of the logits' scale


def write_mtl_tokenizer(d, vocab_size: int = 500):
    """A grapheme vocabulary (`tokenizers` BPE) trained on MTL_SAMPLES,
    lowercased and NFKD-normalized as MTLTokenizer feeds it, with the special
    tokens, the 23 `[lang]` tags and the `[cj_*]` code tokens; and
    Cangjie5_TC.json (CANGJIE_ENTRIES) beside it."""
    import unicodedata
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from chatterbox_tpu_torch.api.pipelines import SUPPORTED_LANGUAGES
    from chatterbox_tpu_torch.text.tokenizer import SPECIAL_TOKENS
    t = Tokenizer(models.BPE(unk_token="[UNK]"))
    t.pre_tokenizer = pre_tokenizers.Whitespace()
    corpus = [unicodedata.normalize("NFKD", s.lower()) for s in MTL_SAMPLES.values()] * 3
    specials = SPECIAL_TOKENS + [f"[{lang}]" for lang in SUPPORTED_LANGUAGES] + CJ_TOKENS
    t.train_from_iterator(corpus, trainers.BpeTrainer(vocab_size=vocab_size,
                                                      special_tokens=specials))
    t.save(str(d / MTL_VOCAB_FILE))
    (d / "Cangjie5_TC.json").write_text(json.dumps(CANGJIE_ENTRIES, ensure_ascii=False),
                                        encoding="utf-8")


def save_pt(state_dict: dict, path):
    """A {name: float32 numpy} state dict as a torch .pt file."""
    import numpy as np
    import torch
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state_dict.items()},
               str(path))


def write_mtl_checkpoint(d, t3_params, hp, s3gen_params, ve_params, pt: bool,
                         t3_file: str = "t3_mtl23ls_v2.safetensors"):
    """A multilingual checkpoint directory: t3_file, ve and s3gen as .pt
    (pt) or .safetensors, and the grapheme vocabulary with its Cangjie
    mapping."""
    from chatterbox_tpu_torch.convert.native_ckpt import save_safetensors
    save_safetensors(t3_state_dict(t3_params, hp), d / t3_file)
    save = save_pt if pt else save_safetensors
    ext = "pt" if pt else "safetensors"
    save(ve_state_dict(ve_params), d / f"ve.{ext}")
    save(s3gen_state_dict(s3gen_params), d / f"s3gen.{ext}")
    write_mtl_tokenizer(d)


def multilingual_path() -> dict:
    """Phase 8, multilingual: a checkpoint directory written from random
    full-width weights (Llama-520M T3 with the 2454-token text vocabulary,
    ve.pt and s3gen.pt, conds.pt, the grapheme vocabulary and its Cangjie
    mapping), loaded by from_local on the card, the loaded leaves equal to
    the written ones; T3 quantized int8_fused; a warm-up generate from a
    prompt file, then one request in each of MTL_REQUESTS timed as phase
    5 times them (B5 / B6 launched layers x steps); the chunked decode
    against t3_generate on the same gumbel rows; one timed generate_stream;
    a greedy generate_stream against generate: the same samples, the 40 ms
    trim included. Returns the launch counts of the timed runs."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from chatterbox_tpu_torch import ChatterboxMultilingualTTS
    from chatterbox_tpu_torch.models.s3gen.model import s3gen_init
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.models.t3.config import T3Config
    from chatterbox_tpu_torch.models.ve import model as ve
    from chatterbox_tpu_torch.nn import core as nn
    from chatterbox_tpu_torch.sampling.decode import t3_generate
    from chatterbox_tpu_torch.utils.audio_io import save_wav
    from chatterbox_tpu_torch.utils.quantize import (best_serving_mode, cast_params,
                                                     quantize_t3_backbone)
    hp = T3Config.multilingual()
    t3 = t3m.t3_init(hp, seed=40, device="cuda")
    s3 = s3gen_init(41, "cuda", meanflow=False)
    s3["speaker_encoder"] = seeded_batch_stats(s3["speaker_encoder"], 42)
    vep = ve.ve_init(nn.Init(43, "cuda"))
    sampler = dict(temperature=0.8, top_p=1.0, min_p=0.05, repetition_penalty=1.2,
                   cfg_weight=0.5)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        t0 = time.perf_counter()
        write_mtl_checkpoint(d, t3, hp, s3, vep, pt=True)
        synthetic_conds(hp, 0.5).save(str(d / "conds.pt"))
        wav_path = d / "prompt.wav"
        save_wav(wav_path, 0.5 * synthetic_voice(6.0, 24000, seed=44), 24000)
        mib = sum(f.stat().st_size for f in d.iterdir()) / 2**20
        log(f"multilingual: wrote {sorted(f.name for f in d.iterdir())} ({mib:.1f} MiB) in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tts = ChatterboxMultilingualTTS.from_local(d)
        torch.cuda.synchronize()
        n = (_equal_trees(tts.t3_params, t3, "t3") + _equal_trees(tts.s3gen.params, s3, "s3gen")
             + _equal_trees(tts.ve_params, vep, "ve"))
        vocab = tts.tokenizer.tokenizer.get_vocab()
        log(f"multilingual: from_local on {tts.device} in {time.perf_counter() - t0:.1f} s; "
            f"the {n} loaded leaves equal the written ones; {len(vocab)} graphemes (ids below "
            f"{max(vocab.values()) + 1}), {len(tts.tokenizer.cangjie_converter.word2cj)} "
            f"Cangjie glyphs, conds.pt {'loaded' if tts.conds is not None else 'missing'}")
        if (max(vocab.values()) >= hp.text_tokens_dict_size or tts.conds is None
                or tts.s3gen.meanflow or not tts.hp.is_multilingual):
            raise AssertionError("multilingual: the loaded pipeline is not the one written")
        del t3, s3, vep
        tts.t3_params = quantize_t3_backbone(cast_params(tts.t3_params, torch.bfloat16),
                                             mode=best_serving_mode(hp.backbone))
        t0 = time.perf_counter()
        wav = tts.generate(MTL_SAMPLES["fr"], language_id="fr", audio_prompt_path=str(wav_path),
                           max_new_tokens=WARMUP_TOKENS, exaggeration=0.5, **sampler)
        if not (wav.ndim == 2 and wav.shape[1] % 960 == 0 and np.isfinite(wav).all()):
            raise AssertionError(f"multilingual: generate from the prompt gave {wav.shape}")
        log(f"multilingual: T3 quantized {best_serving_mode(hp.backbone)}; a warm-up generate "
            f"from the prompt file in {time.perf_counter() - t0:.1f} s")

        L, forwards = hp.backbone.num_layers, 0
        reset_counts()
        for lang in MTL_REQUESTS:
            ids, sp = tts._request(MTL_SAMPLES[lang], lang, None, 0.5, **sampler)
            text = tts.tokenizer.decode(ids[0, 1:-1])
            if lang == "zh" and "[cj_" not in text:
                raise AssertionError(f"multilingual zh: no Cangjie codes in {text!r}")
            t0 = time.perf_counter()
            res = t3_generate(tts.t3_params, hp, tts.conds.t3.as_tensors("cuda"),
                              torch.as_tensor(ids, device="cuda"), sp, max_new_tokens=N_TOKENS,
                              cfg_mode=True, cfg_batch2=True, ignore_eos=True,
                              generator=tts.generator)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            wav, n_voc = tts.s3gen.inference_from_decode(res.tokens, res.n_tokens, tts.conds.gen,
                                                         generator=tts.generator, cfg_slice=True)
            wav = wav[:, : max(1, n_voc - 1) * 960]              # the 40 ms trim
            wall = time.perf_counter() - t0
            forwards += res.n_forward
            if (n_voc != vocoded_tokens(res, True) or wav.shape[1] != max(1, n_voc - 1) * 960
                    or not np.isfinite(wav).all()):
                raise AssertionError(f"multilingual {lang}: {wav.shape} of {n_voc} tokens")
            audio_s = wav.shape[1] / 24000
            log(f"multilingual {lang} request ({ids.shape[1]} text ids, {text[:40]!r}): "
                f"{wall:.4f} s for {audio_s:.2f} s of audio ({n_voc} vocoded tokens of "
                f"{N_TOKENS}, 40 ms trimmed) -> x-realtime {audio_s / wall:.3f}; T3 "
                f"{t1 - t0:.4f} s ({(t1 - t0) / N_TOKENS * 1e3:.3f} ms/token), S3Gen "
                f"{wall - (t1 - t0):.4f} s")
        counts = read_counts()
        check_counts(counts, f"multilingual, {L} layers x {forwards} decode steps",
                     {k: L * forwards for k in LLAMA})

        ids, sp = tts._request(MTL_SAMPLES["fr"], "fr", None, 0.5, **sampler)
        stream_tokens_equal(tts, "multilingual fr", dict(ids=ids, sp=sp, cfg_mode=True))
        stream_kw = dict(language_id="fr", exaggeration=0.5, **sampler)
        for k, v in timed_streams(tts, "multilingual fr", LLAMA, stream_kw,
                                  text=MTL_SAMPLES["fr"], runs=1, profiled=False).items():
            counts[k] = counts.get(k, 0) + v

        # greedy (min_p = 1): the stream decodes generate's tokens, so its
        # samples are generate's, both less the last token's 40 ms
        greedy = dict(sampler, min_p=1.0)
        tts.set_seed(45)
        one = tts.generate(MTL_SAMPLES["ko"], language_id="ko", max_new_tokens=N_TOKENS,
                           **greedy)
        toks = tts.last_decode.tokens[: int(tts.last_decode.n_tokens)].cpu().numpy()
        n_voc = vocoded_tokens(tts.last_decode, True)
        tts.set_seed(45)
        stream = sum(len(c) for c in tts.generate_stream(
            MTL_SAMPLES["ko"], language_id="ko", max_new_tokens=N_TOKENS,
            chunk_tokens=STREAM_CHUNK, **greedy))
        # the stream cannot take back audio before a stray start token
        stray_sos = bool((toks[:np.argmax(np.append(toks == EOS, True))] == SOS).any())
        log(f"multilingual ko greedy: generate {one.shape[1]} samples ({n_voc} vocoded tokens, "
            f"{max(1, n_voc - 1)} after the trim), generate_stream {stream} samples"
            f"{' (a start token mid-stream: the stream keeps the audio before it)' if stray_sos else ''}")
        if one.shape[1] != max(1, n_voc - 1) * 960 or (not stray_sos and stream != one.shape[1]):
            raise AssertionError("multilingual: the stream's samples differ from generate's")
    return counts


def verify_check(tts, cond, ids, K: int) -> float:
    """The target's verify forward over a (K+1)-token slab [BOS, K random
    speech tokens] against K+1 single-token steps from the same prefill:
    the max logit error, which must stay within VERIFY_TOL of the logits'
    scale. Returns that bound in logits."""
    import torch
    from chatterbox_tpu_torch.models.t3 import backbone as bb
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.nn import core as nn
    from chatterbox_tpu_torch.sampling.decode import prefill
    p, hp = tts.t3_params, tts.hp
    g = torch.Generator(device="cuda").manual_seed(46)
    slab = torch.cat([torch.tensor([hp.start_speech_token], device="cuda"),
                      torch.randint(0, S3_VOCAB, (K,), generator=g, device="cuda")])
    with torch.no_grad():
        cache, _, P = prefill(p, hp, cond, ids, 1, False, K + 1)
        steps_cache = bb.KVCache(cache.k.clone(), cache.v.clone())
        pos = P - 1 + torch.arange(K + 1, device="cuda")
        emb = nn.embedding(p["speech_emb"], slab[None]).to(p["speech_emb"]["w"].dtype)
        h = bb.backbone_apply(p["backbone"], hp.backbone, emb, pos[None], cache, P - 1)
        verify = t3m.speech_logits(p, h[0]).float()
        single = []
        for i in range(K + 1):
            emb = t3m.speech_embed_token(p, hp, slab[i].view(1), i)
            h = bb.backbone_apply(p["backbone"], hp.backbone, emb,
                                  torch.full((1, 1), P - 1 + i, device="cuda"), steps_cache,
                                  P - 1 + i)
            single.append(t3m.speech_logits(p, h[:, 0]).float()[0])
        single = torch.stack(single)
    err, scale = float((verify - single).abs().max()), float(single.abs().max())
    bound = VERIFY_TOL * scale
    log(f"speculative verify ({K + 1}-token slab, bf16 target) against {K + 1} single steps "
        f"on the same cache: max logit error {err:.4e} (scale {scale:.3f}, bound {bound:.4e} "
        f"= {VERIFY_TOL} of the scale)")
    if not err <= bound:
        raise AssertionError(f"speculative verify differs from single steps: {err} > {bound}")
    return bound


def greedy_check(tts, draft, cond, ids, bound: float) -> None:
    """top_k=1, 250 tokens, EOS ignored: the speculative tokens (int8 draft,
    K=4) against sequential t3_generate on the same bf16 target. Where they
    part, the sequential top-2 logit gap at that step must be below the
    verify bound (slab and step round apart there)."""
    import torch
    from chatterbox_tpu_torch.ops.sampling import SamplerParams
    from chatterbox_tpu_torch.sampling.decode import decode_step, prefill, t3_generate
    from chatterbox_tpu_torch.sampling.speculative import t3_generate_speculative
    sp = SamplerParams(0.8, 0.95, 1.2)
    seq = t3_generate(tts.t3_params, tts.hp, cond, ids, sp, max_new_tokens=N_TOKENS, top_k=1,
                      ignore_eos=True)
    res = t3_generate_speculative(tts.t3_params, draft.t3_params, tts.hp, draft.hp, cond, cond,
                                  ids, sp, max_new_tokens=N_TOKENS, n_draft=4, top_k=1,
                                  ignore_eos=True)
    differ = torch.nonzero(seq.tokens != res.tokens).flatten().tolist()
    msg = (f"greedy speculative (int8 draft, K=4): {N_TOKENS - len(differ)} of {N_TOKENS} "
           f"tokens equal sequential t3_generate's on the bf16 target; {res.n_rounds} rounds, "
           f"acceptance {res.n_accepted / res.n_drafted:.3f}")
    if not differ:
        log(msg)
        return
    j = differ[0]
    with torch.no_grad():
        cache, logits, P = prefill(tts.t3_params, tts.hp, cond, ids, 1, False, j + 1)
        for s in range(j):
            logits = decode_step(tts.t3_params, tts.hp, seq.tokens[s], s, cache, P + s)
    top2 = torch.topk(logits[0], 2).values
    gap = float(top2[0] - top2[1])
    log(f"{msg}; they part at step {j}, where the sequential top-2 logit gap is {gap:.4e} "
        f"(verify bound {bound:.4e})")
    if not gap <= bound:
        raise AssertionError(f"greedy speculative parts from sequential at step {j} with a "
                             f"top-2 gap {gap} above the verify bound {bound}")


def _time_decode(fn, runs: int = TIMED_RUNS):
    """fn() `runs` times, synced: (walls, the last result)."""
    import torch
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, res


def speculative_path(turbo) -> dict:
    """Phase 8, speculative Turbo: the seed-0 Turbo T3 in bf16, unquantized,
    as target (phase 5's S3Gen and conditionals); its int8_fused self-draft
    (B1 / B2). The verify slab against single steps; greedy tokens against
    sequential; TIMED_RUNS timed decodes of 250 tokens (EOS ignored, Turbo's
    sampler) at each of SPEC_K (B1 / B2 launched layers x (K+1) x rounds,
    nothing else), the sequential bf16 target (no kernel) and phase 5's
    int8_fused Turbo (B1 / B2 layers x steps) in the same call;
    generate(draft="int8") end to end; a Nano draft pipeline (plain int8,
    no kernel). Returns the launch counts of the timed runs."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch import ChatterboxTurboTTS
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.models.t3.config import T3Config
    from chatterbox_tpu_torch.ops.sampling import SamplerParams
    from chatterbox_tpu_torch.sampling.decode import t3_generate
    from chatterbox_tpu_torch.sampling.speculative import t3_generate_speculative
    from chatterbox_tpu_torch.utils.quantize import cast_params
    hp = turbo.hp
    target = ChatterboxTurboTTS(cast_params(t3m.t3_init(hp, seed=0, device="cuda"),
                                            torch.bfloat16),
                                hp, turbo.s3gen, turbo.ve_params, turbo.tokenizer, turbo.conds,
                                seed=0)
    draft = target._quantized_self_draft()
    cond = turbo.conds.t3.as_tensors("cuda")
    ids = torch.as_tensor(turbo_ids(turbo, PHASE5_TEXT), device="cuda").long()
    sp = SamplerParams(0.8, 0.95, 1.2)
    L = hp.backbone.num_layers
    t0 = time.perf_counter()
    bound = verify_check(target, cond, ids, max(SPEC_K))
    greedy_check(target, draft, cond, ids, bound)
    log(f"speculative checks {time.perf_counter() - t0:.1f} s")

    def spec(K, params=draft.t3_params, dhp=hp, n=N_TOKENS):
        return t3_generate_speculative(target.t3_params, params, hp, dhp, cond, cond, ids, sp,
                                       max_new_tokens=n, n_draft=K, top_k=1000, ignore_eos=True,
                                       generator=target.generator)

    counts = {}
    for K in SPEC_K:
        spec(K, n=WARMUP_TOKENS)                                         # warm-up
        reset_counts()
        walls, rounds, drafted, accepted = [], 0, 0, 0
        for _ in range(TIMED_RUNS):
            w, res = _time_decode(lambda: spec(K), runs=1)
            walls += w
            rounds, drafted, accepted = (rounds + res.n_rounds, drafted + res.n_drafted,
                                         accepted + res.n_accepted)
            if int(res.n_tokens) != N_TOKENS:
                raise AssertionError(f"speculative K={K}: {int(res.n_tokens)} tokens")
        part = read_counts()
        check_counts(part, f"speculative K={K}, {L} layers x {K + 1} draft steps x {rounds} "
                     f"rounds", {k: L * (K + 1) * rounds for k in GPT2})
        for k, v in part.items():
            counts[k] = counts.get(k, 0) + v
        log(f"speculative Turbo (bf16 target, int8_fused self-draft) K={K}: "
            f"{[round(w, 4) for w in walls]} s for {N_TOKENS} tokens -> "
            f"{min(walls) / N_TOKENS * 1e3:.3f} ms/token (best of {TIMED_RUNS}); acceptance "
            f"{accepted / drafted:.3f} ({accepted} of {drafted}); "
            f"{rounds / TIMED_RUNS:.1f} rounds a request "
            f"({N_TOKENS * TIMED_RUNS / rounds:.2f} tokens a round)")

    for label, tts, kernels in (("sequential bf16 target", target, ()),
                                ("sequential int8_fused (phase 5's Turbo)", turbo, GPT2)):
        def seq(tts=tts):
            return t3_generate(tts.t3_params, hp, cond, ids, sp, max_new_tokens=N_TOKENS,
                               top_k=1000, ignore_eos=True, generator=tts.generator)
        seq()                                                            # warm-up
        reset_counts()
        walls, res = _time_decode(seq)
        part = read_counts()
        check_counts(part, f"{label}, {L} layers x {TIMED_RUNS * res.n_forward} decode steps",
                     {k: L * TIMED_RUNS * res.n_forward for k in kernels})
        for k, v in part.items():
            counts[k] = counts.get(k, 0) + v
        log(f"{label}: {[round(w, 4) for w in walls]} s for {N_TOKENS} tokens -> "
            f"{min(walls) / N_TOKENS * 1e3:.3f} ms/token (best of {TIMED_RUNS})")

    reset_counts()
    t0 = time.perf_counter()
    wav = target.generate(PHASE5_TEXT, draft="int8", n_draft=4, top_k=1000,
                          max_new_tokens=N_TOKENS)
    wall = time.perf_counter() - t0
    res = target.last_decode
    part = read_counts()
    check_counts(part, f"generate(draft='int8'), {L} layers x 5 draft steps x "
                 f"{res.n_rounds} rounds", {k: L * 5 * res.n_rounds for k in GPT2})
    for k, v in part.items():
        counts[k] = counts.get(k, 0) + v
    if not (wav.ndim == 2 and wav.shape[1] > 0 and np.isfinite(wav).all()):
        raise AssertionError(f"generate(draft='int8') gave {wav.shape}")
    log(f"Turbo generate(draft='int8', n_draft=4): {int(res.n_tokens)} tokens "
        f"({res.n_rounds} rounds, acceptance {res.n_accepted / max(res.n_drafted, 1):.3f}), "
        f"{wav.shape[1] / 24000:.2f} s of audio in {wall:.3f} s -> x-realtime "
        f"{wav.shape[1] / 24000 / wall:.3f}")

    nano_hp = T3Config.nano()
    nano = ChatterboxTurboTTS(ChatterboxTurboTTS._random_t3(nano_hp, 50, "cuda"), nano_hp,
                              turbo.s3gen, turbo.ve_params, turbo.tokenizer, turbo.conds,
                              seed=50, model_label="Nano")
    wav = target.generate(PHASE5_TEXT, draft=nano, n_draft=4, max_new_tokens=WARMUP_TOKENS)
    if not (wav.ndim == 2 and np.isfinite(wav).all()):
        raise AssertionError(f"generate(draft=nano) gave {wav.shape}")
    reset_counts()
    walls, res = _time_decode(lambda: spec(4, nano.t3_params, nano_hp, n=NANO_TOKENS), runs=1)
    check_counts(read_counts(), "speculative with the Nano draft (plain int8, no kernel)", {})
    log(f"speculative Turbo with a Nano draft pipeline (GPT-2-small, int8), K=4: "
        f"{walls[0]:.4f} s for {NANO_TOKENS} tokens -> "
        f"{walls[0] / NANO_TOKENS * 1e3:.3f} ms/token; acceptance "
        f"{res.n_accepted / res.n_drafted:.3f}; {res.n_rounds} rounds")
    return counts


# ---------------------------------------------------------------------------
# phase 9: batched serving: the batched vocode, TTSServer / ServingLoop and
# the continuous slot engine
# ---------------------------------------------------------------------------

VOICE_SECONDS = (5.2, 6.0, 6.8)  # three voices: 130, 150 and 170 prompt tokens
BATCH_TOL = 1e-4                 # a batched row against its single-request vocode
BF16_TOL = 0.05                  # the bf16 flow's audio against float32's
WAVE_GAP_S = 1.0                 # between the continuous traffic's waves
SLOT_CHUNK = 16                  # decode steps a round of the slot engine
NEAR_TIE = 0.02                  # a token parting across engines: its margin, of the logits' scale


def serve_voices(eng):
    """Three voices from synthetic prompts of VOICE_SECONDS (embed_ref on the card)."""
    return [eng.embed_ref(synthetic_voice(s, 24000, seed=20 + i), 24000)
            for i, s in enumerate(VOICE_SECONDS)]


def _gens(seeds):
    import torch
    return [torch.Generator(device="cuda").manual_seed(int(s)) for s in seeds]


def _rows(n, lo, hi, seed):
    """n rows of random speech ids below 6561, lengths spread over [lo, hi]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, S3_VOCAB, int(g)).astype(np.int32)
            for g in rng.permutation(np.linspace(lo, hi, n).round())]


def _p(ref) -> int:
    return int(ref.prompt_token_len[0])


def batched_vocode_check(eng, label, rows, refs, seed, reps=2) -> None:
    """inference_batch against `inference` of each row on the same noise
    (each row's generator seeded alike), within BATCH_TOL; the batch's wall
    against the single calls'."""
    import numpy as np
    import torch
    seeds = [seed + i for i in range(len(rows))]

    def batch():
        return eng.inference_batch(rows, refs, _gens(seeds))

    def singles():
        return [eng.inference(r, v, generator=g)[0] for r, v, g in zip(rows, refs, _gens(seeds))]

    batch()                                                           # warm-up
    walls = {}
    for name, fn in (("batch", batch), ("singles", singles)):
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        walls[name] = (best, out)
    out, single = walls["batch"][1], walls["singles"][1]
    for w, s, r in zip(out, single, rows):
        if w.shape != s.shape or len(w) != len(r) * 960 or not np.isfinite(w).all():
            raise AssertionError(f"{label}: a row of {len(r)} tokens gave {w.shape} "
                                 f"(single {s.shape})")
    err = max(float(np.abs(w - s).max()) for w, s in zip(out, single))
    audio = sum(len(w) for w in out) / 24000
    tb, ts = walls["batch"][0], walls["singles"][0]
    log(f"{label}: {len(rows)} rows of {min(map(len, rows))}-{max(map(len, rows))} tokens, "
        f"prompts of {sorted({_p(r) for r in refs})} tokens, in one masked flow call: "
        f"{tb * 1e3:.1f} ms against {ts * 1e3:.1f} ms for {len(rows)} single calls "
        f"({ts / tb:.2f}x; best of {reps}); {audio:.2f} s of audio -> x-realtime "
        f"{audio / tb:.2f}; max |dwav| against the single calls {err:.3g} "
        f"(tolerance {BATCH_TOL})")
    if err > BATCH_TOL:
        raise AssertionError(f"{label}: batched rows differ from the single calls by {err}")


def run_without_sync(fn, label):
    """fn() under CUDA's sync debug mode "warn", its warnings recorded;
    raises, naming the line of every synchronising call, if fn made one.
    Returns fn()'s result."""
    import warnings
    import torch
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    where = sorted({f"{w.filename.rsplit('/repo/', 1)[-1]}:{w.lineno}" for w in caught
                    if "called a synchronizing" in str(w.message)})
    if where:
        raise AssertionError(f"{label}: synchronising calls at {where}")
    return out


def dispatch_check(eng, rows, refs) -> None:
    """inference_batch_dispatch with no synchronising call (run_without_sync),
    then the fetch reads the audio back."""
    import torch
    t0 = time.perf_counter()
    handle = run_without_sync(
        lambda: eng.inference_batch_dispatch(rows, refs, _gens(range(len(rows)))),
        "inference_batch_dispatch")
    t1 = time.perf_counter()
    ev = torch.cuda.Event()
    ev.record()
    queued = not ev.query()
    out = eng.inference_batch_fetch(handle)
    t2 = time.perf_counter()
    log(f"batched vocode dispatch: {(t1 - t0) * 1e3:.1f} ms with no synchronising call (sync "
        f"debug mode 'warn'), the device work {'still queued' if queued else 'already done'} "
        f"when it returned; fetch {(t2 - t1) * 1e3:.1f} ms for {len(out)} rows")


def bf16_flow_check(params, dims, rows, refs) -> None:
    """The CFM S3Gen at len(rows) rows: batched_bf16_min_b at its default (the
    flow in bf16 from 16 rows) against None (float32): max |dwav| and both
    walls."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.models.s3gen.model import S3GenEngine
    outs, walls = {}, {}
    for name, min_b in (("float32", None), ("bf16", 16)):
        eng = S3GenEngine(params, dims=dims, meanflow=False, batched_bf16_min_b=min_b)
        eng.inference_batch(rows, refs, _gens(range(len(rows))))     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = eng.inference_batch(rows, refs, _gens(range(len(rows))))
        walls[name] = time.perf_counter() - t0
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs["bf16"], outs["float32"]))
    scale = max(float(np.abs(b).max()) for b in outs["float32"])
    log(f"CFM S3Gen, {len(rows)} rows: flow in bf16 (batched_bf16_min_b=16) "
        f"{walls['bf16'] * 1e3:.1f} ms against float32 (None) {walls['float32'] * 1e3:.1f} ms; "
        f"max |dwav| {err:.3g} of a {scale:.3f} peak")
    if not all(np.isfinite(w).all() for w in outs["bf16"]) or err > BF16_TOL:
        raise AssertionError(f"bf16 batched flow: max |dwav| {err} (limit {BF16_TOL})")


def batched_vocode_path(turbo, cfg520, voices) -> None:
    """The batched vocode at full width: eight Turbo rows in three voices on
    the meanflow S3Gen, four on the 10-step CFM S3Gen, each against its
    single calls; dispatch without a sync; the bf16 flow at 16 rows."""
    refs8 = [voices[i % 3] for i in range(8)]
    batched_vocode_check(turbo.s3gen, "Turbo meanflow S3Gen", _rows(8, 60, 250, 1), refs8, 100)
    dispatch_check(turbo.s3gen, _rows(8, 60, 250, 1), refs8)
    batched_vocode_check(cfg520.s3gen, "520M CFM S3Gen", _rows(4, 60, 250, 2), refs8[:4], 200)
    bf16_flow_check(cfg520.s3gen.params, cfg520.s3gen.dims, _rows(16, 60, 250, 3),
                    [voices[i % 3] for i in range(16)])


def _turbo_requests(turbo, n, seed0, voices, **kw):
    from chatterbox_tpu_torch.serve.batching import TTSRequest
    texts = BATCH_TEXTS * (-(-n // len(BATCH_TEXTS)))
    return [TTSRequest(_Tokenizer(12 + 18 * (i % 8) // 7, 50000).text_to_tokens(t)[0],
                       turbo.conds.t3, request_id=i, seed=seed0 + i, ref=voices[i % 3], **kw)
            for i, t in enumerate(texts[:n])]


def _spied_decoder(dec, forwards: list):
    """The decoder with each batch's decode-step count appended to `forwards`."""
    orig = dec.decode_batch_dispatch

    def dispatch(requests):
        handle = orig(requests)
        forwards.append(handle[0].n_forward)
        return handle

    dec.decode_batch_dispatch = dispatch
    return dec


def _check_wavs(label, results) -> float:
    import numpy as np
    for r in results:
        if r.wav is None or not np.isfinite(r.wav).all() or len(r.wav) % 960:
            raise AssertionError(f"{label}: request {r.request_id} has no finite audio")
    return sum(len(r.wav) for r in results) / 24000


def serving_path(turbo, voices) -> dict:
    """TTSServer.synthesize_batch of eight Turbo requests (int8_fused,
    kv_int8) in three voices, then a ServingLoop fed 16 requests (two
    batches of eight, run two deep); B1 / B2 / B4 launched layers x decode
    steps. Returns the launch counts."""
    import threading
    import numpy as np
    import torch
    from chatterbox_tpu_torch.serve.batching import (BatchDecoder, ServingLoop, TTSResult,
                                                     TTSServer)
    L = turbo.hp.backbone.num_layers
    forwards: list = []
    dec = _spied_decoder(BatchDecoder(turbo.t3_params, turbo.hp, max_batch=8,
                                      max_new_tokens=N_TOKENS, kv_int8=True), forwards)
    reqs = _turbo_requests(turbo, 8, 300, voices)
    totals = {}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs = TTSServer(dec, turbo.s3gen).synthesize_batch(reqs, [r.ref for r in reqs])
    dt = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, f"TTSServer, 8 Turbo requests, {L} layers x {sum(forwards)} decode "
                 f"steps", {k: L * sum(forwards) for k in GPT2 + (B4,)})
    audio = _check_wavs("TTSServer", [TTSResult(r.request_id, None, w)
                                      for r, w in zip(reqs, wavs)])
    log(f"TTSServer.synthesize_batch, 8 Turbo requests (kv_int8, EOS honoured, "
        f"{forwards[0]} decode steps): {dt:.3f} s for {audio:.2f} s of audio -> "
        f"{audio / dt:.3f} audio s per wall s")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v

    got, ev = [], threading.Event()

    def on_result(res):
        got.append(res)
        if len(got) == 16:
            ev.set()

    loop = ServingLoop(dec, on_result, s3gen=turbo.s3gen)
    for r in _turbo_requests(turbo, 16, 400, voices):
        loop.submit(r)
    forwards.clear()
    reset_counts()
    t0 = time.perf_counter()
    try:
        loop.start()
        if not ev.wait(600):
            raise AssertionError(f"ServingLoop: {len(got)} of 16 results")
        dt = time.perf_counter() - t0
    finally:
        loop.stop()
    counts = read_counts()
    check_counts(counts, f"ServingLoop, 16 Turbo requests, {L} layers x {sum(forwards)} "
                 f"decode steps", {k: L * sum(forwards) for k in GPT2 + (B4,)})
    audio = _check_wavs("ServingLoop", got)
    log(f"ServingLoop, 16 Turbo requests in {len(forwards)} batches (decode steps "
        f"{forwards}): {dt:.3f} s for {audio:.2f} s of audio -> {audio / dt:.3f} audio s per "
        f"wall s; tokens per request {sorted(len(r.speech_tokens) for r in got)}")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    return totals


def _slot_requests(cond, ids_fn, n, seed0, caps, voices):
    from chatterbox_tpu_torch.serve.batching import TTSRequest
    return [TTSRequest(ids_fn(i), cond, request_id=i, seed=seed0 + i, max_new=int(caps[i]),
                       ref=voices[i % 3]) for i in range(n)]


def _isolated_tokens(make, req):
    srv = make()
    srv.submit(req)
    return srv.run_until_idle()[req.request_id]


def continuous_turbo_path(turbo, voices) -> dict:
    """ContinuousTTSServer at 8 Turbo slots (int8_fused, kv_int8) behind a
    ContinuousServingLoop: 16 requests in 4 waves with caps of 50-250
    tokens, four of them streams (first_chunk 12, stream_chunk 25), the
    rest vocoded in the loop; B1 / B2 / B4 launched layers x decode steps;
    per-request latency, the streams' first audio and gaps, aggregate
    tokens/s, host reads a round, a round without any synchronising call,
    the device's share of a profiled round; two requests against their
    isolated runs."""
    import threading
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chatterbox_tpu_torch.sampling import continuous as C
    from chatterbox_tpu_torch.serve.batching import ContinuousServingLoop
    hp, L = turbo.hp, turbo.hp.backbone.num_layers
    kw = dict(n_slots=8, text_bucket=64, max_new_tokens=N_TOKENS, chunk=SLOT_CHUNK,
              kv_int8=True)

    def make(**more):
        return C.ContinuousTTSServer(turbo.t3_params, hp, **dict(kw, **more))

    ids = lambda i: _Tokenizer(12 + 18 * (i % 8) // 7, 50000).text_to_tokens(
        BATCH_TEXTS[i % 8])[0]
    caps = np.random.default_rng(5).permutation(np.linspace(50, 250, 16).round())
    reqs = _slot_requests(turbo.conds.t3, ids, 16, 500, caps, voices)
    streams = {2, 5, 11, 12}          # one or two a wave
    srv = make(s3gen=turbo.s3gen, stream_chunk=25, first_chunk=12)
    srv.submit(_slot_requests(turbo.conds.t3, ids, 1, 900, [16], voices)[0])
    srv.run_until_idle()                                              # warm-up
    srv.results.clear()
    srv.wavs.clear()
    t_submit, t_done, chunks = {}, {}, {i: [] for i in streams}
    done_all = threading.Event()
    results = {}

    def on_result(res):
        results[res.request_id] = res
        t_done[res.request_id] = time.perf_counter()
        if len(results) == 16:
            done_all.set()

    def on_chunk(i):
        return lambda c, final: chunks[i].append((time.perf_counter(), c, final))

    reads = []
    orig_status = C.pack_status
    C.pack_status = lambda st: (reads.append(1), orig_status(st))[1]
    steps0, rounds0 = srv.decode_steps, srv.rounds
    loop = ContinuousServingLoop(srv, on_result)
    reset_counts()
    try:
        loop.start()
        t0 = time.perf_counter()
        for w in range(4):
            for r in reqs[4 * w:4 * w + 4]:
                t_submit[r.request_id] = time.perf_counter()
                if r.request_id in streams:
                    loop.submit_stream(r, on_chunk(r.request_id))
                else:
                    loop.submit(r)
            if w < 3:
                time.sleep(WAVE_GAP_S)
        if not done_all.wait(600):
            raise AssertionError(f"continuous Turbo: {len(results)} of 16 results")
        wall = max(t_done.values()) - t0
    finally:
        loop.stop()
        C.pack_status = orig_status
    steps, rounds = srv.decode_steps - steps0, srv.rounds - rounds0
    counts = read_counts()
    check_counts(counts, f"ContinuousTTSServer, 8 Turbo slots, {L} layers x {steps} decode "
                 f"steps", {k: L * steps for k in GPT2 + (B4,)})
    for i, r in results.items():
        if i in streams:
            audio = np.concatenate([c for _, c, _ in chunks[i]])
            if not (chunks[i][-1][2] and np.isfinite(audio).all()
                    and len(audio) == (len(r.speech_tokens) + 3) * 960):
                raise AssertionError(f"stream {i}: {len(audio)} samples for "
                                     f"{len(r.speech_tokens)} tokens")
        elif r.wav is None or not np.isfinite(r.wav).all() or \
                len(r.wav) != max(len(r.speech_tokens), 1) * 960:
            raise AssertionError(f"request {i}: no audio of its {len(r.speech_tokens)} tokens")
    n_tok = sum(len(r.speech_tokens) for r in results.values())
    lat = {i: t_done[i] - t_submit[i] for i in results}
    log(f"continuous Turbo, 8 slots, 16 requests in 4 waves {WAVE_GAP_S} s apart (caps "
        f"50-250): {n_tok} tokens in {wall:.3f} s -> {n_tok / wall:.1f} tok/s aggregate; "
        f"{steps} decode steps in {rounds} rounds ({steps / wall:.1f} steps/s); host reads "
        f"{len(reads)} for {rounds} rounds; cache {srv.state.cache.max_len} positions")
    log("  latency per request (s, cap, tokens): " + ", ".join(
        f"{i}: {lat[i]:.2f} ({int(caps[i])}, {len(results[i].speech_tokens)})"
        for i in sorted(lat)))
    for i in sorted(streams):
        times = [t for t, c, _ in chunks[i] if len(c)]
        gaps = np.diff(times) * 1e3
        log(f"  stream {i}: first audio {(times[0] - t_submit[i]) * 1e3:.1f} ms after submit, "
            f"{len(times)} chunks, gaps {gaps.min() if len(gaps) else 0:.1f}-"
            f"{gaps.max() if len(gaps) else 0:.1f} ms")
    if len(reads) != rounds:
        raise AssertionError(f"{len(reads)} status reads for {rounds} rounds")

    # two requests against their isolated runs (a server of the same slots)
    for i in (1, 9):
        alone = _isolated_tokens(make, reqs[i])
        if not np.array_equal(alone, results[i].speech_tokens):
            raise AssertionError(f"continuous Turbo request {i}: tokens differ from its "
                                 f"isolated run")
    log("continuous Turbo: requests 1 and 9 equal their isolated runs, token for token")

    # a round without a synchronising call, then the device's share of a profiled round
    prof_srv = make()
    for r in _slot_requests(turbo.conds.t3, ids, 8, 700, [N_TOKENS] * 8, voices):
        r.ref = None
        prof_srv.submit(r)
    prof_srv.serve_round()
    prof_srv.serve_round()
    run_without_sync(prof_srv._dispatch_round, "a continuous decode round")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof_srv.serve_round()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_srv.serve_round()
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    dev_us = _device_us(prof)
    log(f"continuous Turbo round ({SLOT_CHUNK} steps, 8 slots): a round ran with no "
        f"synchronising call (sync debug mode 'warn'); {dev_us / 1e3:.2f} ms of device time "
        f"against {plain * 1e3:.2f} ms of wall (unprofiled; {profiled * 1e3:.2f} profiled) "
        f"-> device busy {100 * dev_us / 1e3 / (plain * 1e3):.1f} % of a round")
    return counts


def continuous_cfg_path(cfg520, voices) -> dict:
    """ContinuousTTSServer at 4 CFG slots (8 rows) on the 520M int8_fused T3
    and its CFM S3Gen: six requests, staggered, vocoded in the loop; B5 / B6
    launched layers x decode steps; one request's tokens against
    BatchDecoder's for it alone."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.ops.sampling import SamplerParams
    from chatterbox_tpu_torch.sampling import continuous as C
    hp, L = cfg520.hp, cfg520.hp.backbone.num_layers

    def ids(i):
        return np.concatenate([[hp.start_text_token],
                               _Tokenizer(10 + 6 * (i % 4), 704).text_to_tokens(
                                   BATCH_TEXTS[i])[0], [hp.stop_text_token]])

    caps = [100, 180, 140, 200, 120, 160]
    reqs = _slot_requests(cfg520.conds.t3, ids, 6, 600, caps, voices)
    for r in reqs:       # the 520M pipeline's sampler (BatchDecoder's default top_p is 0.95)
        r.sampler = SamplerParams(temperature=0.8, top_p=1.0, repetition_penalty=1.2,
                                  min_p=0.05, cfg_weight=0.5)
    srv = C.ContinuousTTSServer(cfg520.t3_params, hp, n_slots=4, text_bucket=64,
                                max_new_tokens=N_TOKENS, chunk=SLOT_CHUNK, cfg=True,
                                s3gen=cfg520.s3gen)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs[:4]:
        srv.submit(r)
    srv.step()
    srv.step()
    for r in reqs[4:]:
        srv.submit(r)
    res = srv.run_until_idle()
    wall = time.perf_counter() - t0
    counts = read_counts()
    steps = srv.decode_steps
    check_counts(counts, f"ContinuousTTSServer, 4 CFG slots, {L} layers x {steps} decode "
                 f"steps", {k: L * steps for k in LLAMA})
    for i, r in enumerate(reqs):
        w = srv.wavs.get(i)
        if w is None or not np.isfinite(w).all() or len(w) != max(len(res[i]), 1) * 960:
            raise AssertionError(f"continuous CFG request {i}: no audio of its tokens")
    n_tok = sum(len(t) for t in res.values())
    log(f"continuous CFG, 4 slots (8 rows), 6 requests (caps {caps}): {n_tok} tokens "
        f"(SOS..EOS slices) in {wall:.3f} s, {steps} decode steps in "
        f"{srv.rounds} rounds -> {steps / wall:.1f} steps/s; tokens per request "
        f"{[len(res[i]) for i in range(6)]}")
    cfg_cross_engine(cfg520, reqs[3], res[3], lambda: C.ContinuousTTSServer(
        cfg520.t3_params, hp, n_slots=4, text_bucket=64, max_new_tokens=N_TOKENS,
        chunk=SLOT_CHUNK, cfg=True))
    return counts


def cfg_cross_engine(cfg520, r, in_batch, make_alone) -> None:
    """Request r's tokens on the slot engine beside five others (in_batch)
    against the slot engine alone (make_alone: a server of the same slots),
    which must be equal, and against BatchDecoder alone (the batched
    engine: left-padded rows, a cache of exactly prefix + budget): equal,
    or parting first at a step where the batched engine's token leads the
    slot engine's, under the same gumbel row, by less than NEAR_TIE of the
    logits' scale (bf16 sums in another order flipping a near-tie),
    reported with that margin."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.ops import sampling as S
    from chatterbox_tpu_torch.sampling.batched import (t3_decode_chunk_batched,
                                                       t3_generate_batched,
                                                       t3_prefill_batched)
    from chatterbox_tpu_torch.models.t3.model import cond_len
    from chatterbox_tpu_torch.sampling.decode import cache_len
    from chatterbox_tpu_torch.serve.batching import BatchDecoder, drop_invalid_tokens_sliced
    hp, params = cfg520.hp, cfg520.t3_params
    N = min(r.max_new, N_TOKENS)
    srv = make_alone()
    srv.submit(r)
    alone = srv.run_until_idle()[r.request_id]
    if not np.array_equal(alone, in_batch):
        raise AssertionError(f"continuous CFG request {r.request_id}: its tokens beside five "
                             f"others differ from its tokens alone")
    raw_s = srv.state.tokens[0, :int(srv.state.step[0])].cpu().numpy()
    dec = BatchDecoder(params, hp, cfg=True, max_batch=1, max_new_tokens=N)
    res = t3_generate_batched(params, hp, *dec.batch_inputs([r]), max_new_tokens=N,
                              cfg_mode=True)
    raw_b = res.tokens[0, :int(res.n_tokens[0])].cpu().numpy()
    sliced = drop_invalid_tokens_sliced(raw_b)
    if np.array_equal(sliced[sliced < S3_VOCAB], alone):
        log(f"continuous CFG: request {r.request_id}'s {len(alone)} tokens equal its tokens "
            f"beside five others and BatchDecoder's for it alone")
        return
    k = next(i for i in range(min(len(raw_s), len(raw_b)) + 1)
             if i == min(len(raw_s), len(raw_b)) or raw_s[i] != raw_b[i])
    if k == min(len(raw_s), len(raw_b)):
        raise AssertionError(f"continuous CFG request {r.request_id}: {len(raw_s)} raw tokens "
                             f"against BatchDecoder's {len(raw_b)}, equal where both run")
    # the batched engine replayed to step k: its processed logits and the
    # gumbel row both engines draw there
    cond, text, lens, _, gens = dec.batch_inputs([r])
    state = t3_prefill_batched(params, hp, cond, text, lens, gens,
                               t_cap=cache_len(text.shape[1] + cond_len(hp) + 2 + N, False),
                               max_new_tokens=N, cfg_mode=True)
    sp = r.sampler
    t3_decode_chunk_batched(params, hp, state, sp, n_steps=k, cfg_mode=True)
    if not np.array_equal(state.tokens[0, :k].cpu().numpy(), raw_b[:k]):
        raise AssertionError("the batched engine's replay parts from its own run")
    l = S.process_logits_cfg(state.logits[:1], state.logits[1:], state.seen, sp)[0]
    gen = torch.Generator(device=l.device)
    gen.set_state(state.generators[0].get_state())
    b = l + S.gumbel(l.shape, gen, l.device)
    margin = float(b[int(raw_b[k])] - b[int(raw_s[k])])
    scale = float(l[l > S.NEG_INF].abs().max())
    log(f"continuous CFG: request {r.request_id}'s tokens equal its tokens beside five others "
        f"({len(alone)}); against BatchDecoder's for it alone they part first at raw step "
        f"{k} of {len(raw_b)} (slot engine {int(raw_s[k])}, batched {int(raw_b[k])}, argmax "
        f"{int(b.argmax())}): the batched token leads by {margin:.4g} under the shared gumbel "
        f"row, {100 * margin / scale:.3f} % of the logits' scale {scale:.3f} (a near-tie "
        f"below {100 * NEAR_TIE:g} %)")
    if not 0 <= margin < NEAR_TIE * scale:
        raise AssertionError(f"continuous CFG request {r.request_id}: tokens part from "
                             f"BatchDecoder's at step {k} by a margin of {margin}")


def serving_phase(turbo, cfg520) -> dict:
    """Phase 9. Returns the launch counts of its counted runs."""
    totals = {}
    t0 = time.perf_counter()
    voices = serve_voices(turbo.s3gen)
    log(f"voices: prompts of {[_p(v) for v in voices]} tokens "
        f"({time.perf_counter() - t0:.2f} s)")
    batched_vocode_path(turbo, cfg520, voices)
    for part in (serving_path(turbo, voices), continuous_turbo_path(turbo, voices),
                 continuous_cfg_path(cfg520, voices)):
        for k, v in part.items():
            totals[k] = totals.get(k, 0) + v
    return totals


# ---------------------------------------------------------------------------
# phase 10: the speculative slot path and the serving surfaces (HTTP, MCP,
# the command line)
# ---------------------------------------------------------------------------

SPEC_SLOT_K = 8                 # n_draft of the speculative slot server
SPEC_CAPS = (100, 150, 200, 250)  # the 4-slot run's per-request caps
HTTP_TOKENS = 100               # the HTTP backends' max_new_tokens


def first_parting(on, off):
    """The first step where token lists on and off differ (None if equal)."""
    n = min(len(on), len(off))
    k = next((i for i in range(n) if on[i] != off[i]), None)
    if k is None and len(on) != len(off):
        raise AssertionError(f"{len(on)} tokens with draft on, {len(off)} with draft off, "
                             f"equal where both run")
    return k


def parting_check(make_off, reqs, partings: dict, top_k: int, verify_logits: dict) -> dict:
    """Why draft on parts from draft off, request by request: the draft-off
    run of reqs again, its rounds split into one-step calls (the same
    computation); at request rid's step k (partings[rid] = (k, on token,
    off token)) its raw logits L_off, its sampler and the gumbel row g it
    draws there. With the verify's raw logits at that position,
    verify_logits[rid] = L_on (from spec_rerun), returns {rid: dict}:
    follows, whether draft-on's token is the sample of L_on under the same
    sampler and the same row g (then only the logits differ); err, max
    |L_on - L_off| and scale, max |L_off|, against phase 8's VERIFY_TOL;
    kind and margin, how near a tie draft off was: "lead", (l + g)[off] -
    (l + g)[on] on its processed logits l, or "filter" where its top_k /
    top_p filter drops the on token, the on token's tempered logit below
    the least one kept, with lscale = max |l| over the kept tokens. Checks
    that the rerun samples the off token there."""
    import torch
    from chatterbox_tpu_torch.ops import sampling as S
    from chatterbox_tpu_torch.sampling import continuous as C
    real = C.decode_chunk_multi
    srv = make_off()
    out = {}

    def one_step_at_a_time(params, hp, state, *, n_steps, **kw):
        V = state.logits.shape[1]
        start = torch.arange(V, device=state.logits.device) == hp.start_speech_token
        for _ in range(n_steps):
            steps = state.step.tolist()
            running = (state.active & ~state.done).tolist()
            for slot, r in enumerate(srv._slot_req):
                if r is None or r.request_id not in partings or not running[slot]:
                    continue
                k, tok_on, tok_off = partings[r.request_id]
                if steps[slot] != k:
                    continue
                sp = S.SamplerParams(*[getattr(state, f)[:, None] for f in C._SAMPLER_FIELDS])
                pen = state.seen | (start[None] & (state.step == 0)[:, None])
                l = S.process_logits_turbo(state.logits, pen, sp, top_k)[slot]
                gen = torch.Generator(device=l.device)
                gen.set_state(state.generators[slot].get_state())
                g = S.gumbel((V,), gen, l.device)
                b = l + g
                if int(b.argmax()) != tok_off:
                    raise AssertionError(f"request {r.request_id}: the rerun samples "
                                         f"{int(b.argmax())} at step {k}, not {tok_off}")
                L_off, L_on = state.logits[slot], verify_logits[r.request_id]
                sp1 = S.SamplerParams(*[getattr(state, f)[slot:slot + 1, None]
                                        for f in C._SAMPLER_FIELDS])
                l_on = S.process_logits_turbo(L_on[None], pen[slot:slot + 1], sp1, top_k)[0]
                kept = l > S.NEG_INF
                d = dict(follows=int((l_on + g).argmax()) == tok_on,
                         err=float((L_on - L_off).abs().max()), scale=float(L_off.abs().max()),
                         lscale=float(l[kept].abs().max()))
                if kept[tok_on]:
                    d.update(kind="lead", margin=float(b[tok_off] - b[tok_on]))
                else:
                    lt = L_off / state.temperature[slot]
                    d.update(kind="filter", margin=float(lt[kept].min() - lt[tok_on]))
                out[r.request_id] = d
            real(params, hp, state, n_steps=1, **kw)
        return state

    C.decode_chunk_multi = one_step_at_a_time
    try:
        for r in reqs:
            srv.submit(r)
        srv.run_until_idle()
    finally:
        C.decode_chunk_multi = real
    return out


def _spec_run(srv, reqs):
    """reqs (no more than srv's slots) submitted at once to an idle srv, so
    reqs[i] takes slot i, run to the end: (results, wall s, each request's
    raw token row, specials included)."""
    import torch
    for r in reqs:
        srv.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = dict(srv.run_until_idle())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if set(res) != {r.request_id for r in reqs} or len(reqs) > srv.n_slots:
        raise AssertionError(f"{len(res)} of {len(reqs)} results")
    raw = {r.request_id: srv.state.tokens[i, :int(srv.state.step[i])].tolist()
           for i, r in enumerate(reqs)}
    return res, wall, raw


def spec_rerun(make_on, reqs, partings: dict):
    """The draft-on run of reqs again, its spec rounds split into one-round
    calls (the same computation), counted on the host a round at a time:
    (drafted, accepted, row rounds, tokens, verify logits), where verify
    logits[rid] are the verify's raw logits (V,) at the slab position of
    request rid's step k (partings[rid] = (k, ...)), taken from the same
    speech-head call over the whole slab."""
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.sampling import continuous as C
    real, real_slab = C.decode_chunk_multi_spec, C.bb.backbone_slab_rows
    tally = [0, 0]                         # running rows over rounds, tokens emitted
    hidden, logits, srv = [], {}, None

    def slab(*a, **kw):
        hidden[:] = [real_slab(*a, **kw)]
        return hidden[0]

    def one_round_at_a_time(params, qparams, hp, state, *, n_rounds, n_draft, step_bound,
                            **kw):
        for j in range(n_rounds):
            running = (state.active & ~state.done).cpu()
            step0 = state.step.cpu()
            real(params, qparams, hp, state, n_rounds=1, n_draft=n_draft,
                 step_bound=[b + j * (n_draft + 1) for b in step_bound], **kw)
            tally[0] += int(running.sum())
            tally[1] += int((state.step.cpu() - step0)[running].sum())
            for slot, r in enumerate(srv._slot_req):
                if r is None or r.request_id not in partings or not running[slot]:
                    continue
                pos = partings[r.request_id][0] - int(step0[slot])
                if 0 <= pos <= n_draft:
                    logits[r.request_id] = t3m.speech_logits(params, hidden[0]).float()[
                        slot, pos]
        return state

    C.decode_chunk_multi_spec, C.bb.backbone_slab_rows = one_round_at_a_time, slab
    try:
        srv = make_on()
        for r in reqs:
            srv.submit(r)
        srv.run_until_idle()
    finally:
        C.decode_chunk_multi_spec, C.bb.backbone_slab_rows = real, real_slab
    K = srv.n_draft
    # a round emits its accepted drafts and one token more (fewer only at EOS or the cap)
    return K * tally[0], tally[1] - tally[0], tally[0], tally[1], logits


def spec_slots_path(turbo) -> dict:
    """Phase 10 (a): the seed-0 GPT-2-medium Turbo T3 in bf16 (phase 8's
    verify target) behind ContinuousTTSServer(draft_int8=True,
    n_draft=SPEC_SLOT_K), tokens only, at 1 slot (one request of 250
    tokens) and at 4 slots (4 requests, caps SPEC_CAPS), against the same
    server with draft off: tokens equal, or, where a request parts,
    draft-on's token is the sample of the verify's own logits under draft
    off's gumbel row and sampler, those logits within VERIFY_TOL of draft
    off's there (phase 8's bound of a slab against single steps), and how
    near a tie draft off was reported against NEAR_TIE; B1 / B2
    launched layers x K x spec rounds and nothing else (none with draft
    off); one host read a dispatch; a dispatch under sync debug mode; ms
    per emitted token with draft on and off, acceptance. Returns the launch
    counts of the draft-on runs."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.sampling import continuous as C
    from chatterbox_tpu_torch.serve.batching import TTSRequest
    from chatterbox_tpu_torch.utils.quantize import cast_params
    hp, L, K = turbo.hp, turbo.hp.backbone.num_layers, SPEC_SLOT_K
    target = cast_params(t3m.t3_init(hp, seed=0, device=turbo.device), torch.bfloat16)
    cond = turbo.conds.t3
    top_k = 1000

    def requests(n, caps, seed0):
        return [TTSRequest(_Tokenizer(12 + 6 * i, 50000).text_to_tokens(BATCH_TEXTS[i])[0],
                           cond, request_id=i, seed=seed0 + i, max_new=int(caps[i]))
                for i in range(n)]

    counts = {}
    for n_slots, caps in ((1, (N_TOKENS,)), (4, SPEC_CAPS)):
        def make(draft, n_slots=n_slots):
            return C.ContinuousTTSServer(target, hp, n_slots=n_slots, text_bucket=64,
                                         max_new_tokens=N_TOKENS, chunk=SLOT_CHUNK,
                                         top_k=top_k, draft_int8=draft, n_draft=K)
        n = len(caps)
        _spec_run(make(True), requests(n, [16] * n, 1000))                 # warm-up
        _spec_run(make(False), requests(n, [16] * n, 1000))
        reset_counts()
        off, wall_off, raw_off = _spec_run(make(False), requests(n, caps, 1100))
        check_counts(read_counts(), f"draft off, {n_slots} slot(s) (bf16, no kernel)", {})
        reads = []
        orig_status = C.pack_status
        C.pack_status = lambda st: (reads.append(1), orig_status(st))[1]
        reset_counts()
        try:
            srv = make(True)
            on, wall_on, raw_on = _spec_run(srv, requests(n, caps, 1100))
        finally:
            C.pack_status = orig_status
        part = read_counts()
        check_counts(part, f"draft on, {n_slots} slot(s), {L} layers x {K} draft steps x "
                     f"{srv.spec_rounds} spec rounds",
                     {k: L * K * srv.spec_rounds for k in GPT2})
        if len(reads) != srv.rounds:
            raise AssertionError(f"{len(reads)} status reads for {srv.rounds} dispatches")
        for k, v in part.items():
            counts[k] = counts.get(k, 0) + v
        tok_on, tok_off = sum(map(len, on.values())), sum(map(len, off.values()))
        partings = {}
        for rid in raw_off:
            k = first_parting(raw_on[rid], raw_off[rid])
            if k is not None:
                partings[rid] = (k, raw_on[rid][k], raw_off[rid][k])
        drafted, accepted, row_rounds, emitted, verify_logits = spec_rerun(
            lambda: make(True), requests(n, caps, 1100), partings)
        checks = (parting_check(lambda: make(False), requests(n, caps, 1100), partings,
                                top_k, verify_logits) if partings else {})
        log(f"spec slots, {n_slots} slot(s), caps {list(caps)}: draft on {tok_on} tokens in "
            f"{wall_on:.3f} s -> {wall_on / tok_on * 1e3:.3f} ms/token ({srv.rounds} "
            f"dispatches, {srv.spec_rounds} spec rounds, a host read each dispatch); draft "
            f"off {tok_off} tokens in {wall_off:.3f} s -> {wall_off / tok_off * 1e3:.3f} "
            f"ms/token; {wall_off / tok_off / (wall_on / tok_on):.2f}x; acceptance "
            f"{accepted / drafted:.3f} ({accepted} of {drafted}), {emitted / row_rounds:.2f} "
            f"tokens a row and round; requests equal to draft off: "
            f"{n - len(partings)} of {n}")
        for rid, (k, t_on, t_off) in sorted(partings.items()):
            if rid not in checks or rid not in verify_logits:
                raise AssertionError(f"request {rid}: a rerun never reached step {k}")
            c = checks[rid]
            what = ("draft-off's token leads under the shared gumbel row by"
                    if c["kind"] == "lead" else "draft-off's top_k / top_p filter drops "
                    "draft-on's token, its tempered logit below the least one kept by")
            near = "under" if c["margin"] < NEAR_TIE * c["lscale"] else "over"
            log(f"spec slots, {n_slots} slot(s): request {rid} parts from draft off at step "
                f"{k} of {len(raw_off[rid])} (draft on {t_on}, off {t_off}): {what} "
                f"{c['margin']:.4g}, {100 * c['margin'] / c['lscale']:.3f} % of the processed "
                f"logits' scale {c['lscale']:.3f} ({near} {100 * NEAR_TIE:g} %); the "
                f"verify's logits there differ from draft off's "
                f"step by {c['err']:.4g} at most, {100 * c['err'] / c['scale']:.3f} % of their "
                f"scale {c['scale']:.3f} (VERIFY_TOL {100 * VERIFY_TOL:g} %), and draft-on's "
                f"token {'is' if c['follows'] else 'is NOT'} their sample under the same "
                f"gumbel row and sampler")
            if not (c["follows"] and c["margin"] >= 0 and c["err"] <= VERIFY_TOL * c["scale"]):
                raise AssertionError(f"request {rid}: draft on parts from draft off at step "
                                     f"{k}: {c}")

    # a dispatch with no synchronising call
    srv = make(True)
    for r in requests(4, SPEC_CAPS, 1200):
        srv.submit(r)
    srv.serve_round()
    srv.serve_round()
    run_without_sync(srv._dispatch_round, "a speculative dispatch")
    torch.cuda.synchronize()
    log(f"spec slots: a dispatch ({-(-SLOT_CHUNK // (K + 1))} spec rounds, 4 slots) ran with "
        f"no synchronising call (sync debug mode 'warn'); draw table "
        f"{tuple(srv.state.draw_table.shape)} float32, "
        f"{srv.state.draw_table.numel() * 4 / 2**20:.1f} MiB")
    del srv
    return counts


def _http(srv, path, payload=None, timeout=600):
    import urllib.request
    url = f"http://{srv.host}:{srv.port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=timeout) as r:
        return r.read()


def _check_riff(body: bytes, label: str) -> int:
    """A RIFF / PCM16 / 24 kHz mono body: its sample count."""
    import struct
    import numpy as np
    if body[:4] != b"RIFF" or body[8:12] != b"WAVE":
        raise AssertionError(f"{label}: not a RIFF/WAVE body")
    fmt, ch, sr, _, _, bits = struct.unpack("<HHIIHH", body[20:36])
    n = struct.unpack("<I", body[40:44])[0]
    pcm = np.frombuffer(body[44:], np.int16)
    if (fmt, ch, sr, bits) != (1, 1, 24000, 16) or n != 2 * len(pcm) or not len(pcm):
        raise AssertionError(f"{label}: format {(fmt, ch, sr, bits)}, {n} data bytes for "
                             f"{len(pcm)} samples")
    return len(pcm)


def _kernels_launched(counts, label, names, L) -> None:
    """names launched equally often, a multiple of L, H1 once a
    hift_inference call on the card, and no other kernel."""
    log(f"launches ({label}): " + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    counts = dict(counts)
    if counts.pop("hift_source", 0) != counts.pop(VOCODES, 0):
        raise AssertionError(f"{label}: launches {counts}, H1 not once a hift_inference call")
    got = {k for k, v in counts.items() if v}
    if got != set(names) or len({counts[k] for k in names}) != 1 or counts[names[0]] % L:
        raise AssertionError(f"{label}: launches {counts}, expected {names} alike")


def http_path(turbo) -> dict:
    """Phase 10 (b): TTSHTTPServer on 127.0.0.1:0 over phase 5's Turbo
    (int8_fused): a BatchDecoder (kv_int8, HTTP_TOKENS) answering 4
    concurrent POST /tts, the same seed alone twice (the same bytes),
    /v1/audio/speech as pcm and /vc against a registered voice (twice, the
    same bytes); then a
    4-slot continuous backend (kv_int8) streaming a POST /tts (time to first
    audio byte); /metrics counting the requests; B1 / B2 / B4 launched
    alike. Returns the launch counts."""
    import base64
    import threading
    import urllib.request
    import numpy as np
    from chatterbox_tpu_torch.sampling.continuous import ContinuousTTSServer
    from chatterbox_tpu_torch.serve.batching import BatchDecoder
    from chatterbox_tpu_torch.serve.http import (TTSHTTPServer, Voice, wav_bytes,
                                                 wav_stream_header)
    hp, L = turbo.hp, turbo.hp.backbone.num_layers
    tok = _Tokenizer(24, 50000)
    voices = {"default": Voice(turbo.conds.t3, turbo.s3gen.embed_ref(
        synthetic_voice(6.0, 24000, seed=30), 24000))}
    totals = {}
    dec = BatchDecoder(turbo.t3_params, hp, max_batch=4, max_new_tokens=HTTP_TOKENS,
                       kv_int8=True)
    srv = TTSHTTPServer(dec, turbo.s3gen, tok, voices, port=0, timeout_s=600)
    srv.start()
    reset_counts()
    try:
        _http(srv, "/tts", {"text": "warm up", "seed": 1})
        out, t0 = {}, time.perf_counter()

        def call(i):
            out[i] = _http(srv, "/tts", {"text": BATCH_TEXTS[i], "seed": 10 + i})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        [t.start() for t in threads]
        [t.join(timeout=600) for t in threads]
        wall = time.perf_counter() - t0
        if sorted(out) != [0, 1, 2, 3]:
            raise AssertionError(f"HTTP: {len(out)} of 4 concurrent replies")
        n = [_check_riff(out[i], f"POST /tts {i}") for i in range(4)]
        for i in range(4):
            if not np.isfinite(np.frombuffer(out[i][44:], np.int16)).all():
                raise AssertionError(f"POST /tts {i}: samples not finite")
        a = _http(srv, "/tts", {"text": BATCH_TEXTS[5], "seed": 77})
        b = _http(srv, "/tts", {"text": BATCH_TEXTS[5], "seed": 77})
        if a != b:
            raise AssertionError("HTTP: the same seed alone twice gave other bytes")
        pcm = _http(srv, "/v1/audio/speech", {"input": BATCH_TEXTS[5], "voice": "alloy",
                                               "seed": 77, "response_format": "pcm"})
        if pcm != a[44:]:
            raise AssertionError("/v1/audio/speech pcm differs from /tts's samples")
        src = 0.5 * synthetic_voice(4.0, 16000, seed=31, f0=180.0)
        t1 = time.perf_counter()
        vc_req = {"wav_b64": base64.b64encode(wav_bytes(src, 16000)).decode(),
                  "voice": "default", "seed": 3}
        vc = _http(srv, "/vc", vc_req)
        t_vc = time.perf_counter() - t1
        n_vc = _check_riff(vc, "POST /vc")
        if _http(srv, "/vc", vc_req) != vc:
            raise AssertionError("HTTP: a seeded /vc twice gave other bytes")
        metrics = json.loads(_http(srv, "/metrics.json"))
        if metrics.get("requests_total") != 8 or metrics.get("vc_requests_total") != 2:
            raise AssertionError(f"HTTP /metrics: {metrics}")
    finally:
        srv.stop()
    counts = read_counts()
    _kernels_launched(counts, "HTTP on BatchDecoder (kv_int8)", GPT2 + (B4,), L)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    log(f"HTTP (BatchDecoder, max_batch 4, kv_int8, {HTTP_TOKENS} tokens): 4 concurrent POST "
        f"/tts in {wall:.3f} s, {[round(x / 24000, 2) for x in n]} s of audio, each a 24 kHz "
        f"PCM16 RIFF; seed 77 alone twice the same {len(a)} bytes; /v1/audio/speech pcm = "
        f"those samples; /vc of 4 s in {t_vc:.3f} s -> {n_vc / 24000:.2f} s, the same bytes "
        f"again for its seed; /metrics "
        f"requests_total {metrics['requests_total']}, http_tts mean "
        f"{metrics['http_tts']['mean_s']} s")

    slots = ContinuousTTSServer(turbo.t3_params, hp, n_slots=4, text_bucket=64,
                                max_new_tokens=HTTP_TOKENS, chunk=SLOT_CHUNK, kv_int8=True,
                                s3gen=turbo.s3gen, stream_chunk=25, first_chunk=12)
    srv = TTSHTTPServer(None, turbo.s3gen, tok, voices, port=0, timeout_s=600,
                        continuous=slots)
    srv.start()
    reset_counts()
    try:
        _http(srv, "/tts", {"text": "warm up", "seed": 2, "stream": True})
        req = urllib.request.Request(f"http://{srv.host}:{srv.port}/tts", data=json.dumps(
            {"text": BATCH_TEXTS[2], "seed": 21, "stream": True}).encode())
        t0 = time.perf_counter()
        body, t_first = b"", None
        with urllib.request.urlopen(req, timeout=600) as r:
            while True:
                chunk = r.read1(1 << 16)
                if not chunk:
                    break
                body += chunk
                if t_first is None and len(body) > 44:
                    t_first = time.perf_counter() - t0
        wall = time.perf_counter() - t0
        plain = _http(srv, "/tts", {"text": BATCH_TEXTS[3], "seed": 22})
        metrics = json.loads(_http(srv, "/metrics.json"))
    finally:
        srv.stop()
    counts = read_counts()
    _kernels_launched(counts, "HTTP on the continuous backend (4 slots, kv_int8)",
                      GPT2 + (B4,), L)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    pcm = np.frombuffer(body[44:], np.int16)
    if body[:44] != wav_stream_header(24000) or not len(pcm) or t_first is None:
        raise AssertionError("streamed POST /tts: no RIFF header or no audio")
    _check_riff(plain, "continuous POST /tts")
    if metrics.get("stream_requests_total") != 2 or metrics.get("requests_total") != 1:
        raise AssertionError(f"continuous HTTP /metrics: {metrics}")
    log(f"HTTP stream (continuous, 4 slots, kv_int8, first_chunk 12): first audio byte after "
        f"{t_first * 1e3:.1f} ms, {len(pcm) / 24000:.2f} s of audio in {wall:.3f} s; "
        f"http_stream_ttfa {metrics['http_stream_ttfa']}")
    return totals


def mcp_path(turbo) -> None:
    """Phase 10 (c): tools/call generate_speech through MCPTTSServer.handle
    (Turbo's generate, HTTP_TOKENS tokens); its audio content a RIFF."""
    import base64
    import numpy as np
    from chatterbox_tpu_torch.serve.mcp import MCPTTSServer

    def synth(text, voice, seed, **kw):
        if seed is not None:
            turbo.set_seed(int(seed))
        return np.asarray(turbo.generate(text, max_new_tokens=HTTP_TOKENS, **kw))[0]

    srv = MCPTTSServer(synth, {"default": turbo.conds})
    t0 = time.perf_counter()
    r = srv.handle({"jsonrpc": "2.0", "id": 1, "method": "tools/call", "params": {
        "name": "generate_speech", "arguments": {"text": PHASE5_TEXT, "seed": 5,
                                                 "temperature": 0.7}}})
    dt = time.perf_counter() - t0
    content = r["result"]["content"]
    audio = next(c for c in content if c["type"] == "audio")
    n = _check_riff(base64.b64decode(audio["data"]), "MCP generate_speech")
    log(f"MCP tools/call generate_speech: {n / 24000:.2f} s of audio in {dt:.3f} s "
        f"({next(c for c in content if c['type'] == 'text')['text']})")


def cli_path(d) -> None:
    """Phase 10 (d): `cli.main(["info"])` and `synth` from phase 6's
    checkpoint directory d (the float T3 as from_local loads it, the prompt
    file, seed 1) in this process; the WAV it writes read back."""
    import contextlib
    import io
    import numpy as np
    from scipy.io import wavfile
    from chatterbox_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["info"])
    info = json.loads(buf.getvalue())
    log(f"cli info: torch {info['torch']}, CUDA {info['cuda_runtime']}, {info['devices']}")
    out, buf = d / "cli_out.wav", io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["synth", "--ckpt-dir", str(d), "--text", PHASE5_TEXT, "--audio-prompt",
                  str(d / "prompt.wav"), "--out", str(out), "--seed", "1"])
    dt = time.perf_counter() - t0
    sr, wav = wavfile.read(str(out))
    if sr != 24000 or wav.dtype != np.float32 or not len(wav) or not np.isfinite(wav).all():
        raise AssertionError(f"cli synth wrote {sr} Hz, {wav.dtype}, {wav.shape}")
    log(f"cli synth (from_local, float T3, prompt file, seed 1): '{buf.getvalue().strip()}' "
        f"-> {len(wav) / 24000:.2f} s of audio in {dt:.1f} s, the load included")


def serving_surfaces_phase(turbo, ckpt_dir) -> dict:
    """Phase 10. Returns the launch counts of its counted runs."""
    totals = {}
    for part in (spec_slots_path(turbo), http_path(turbo)):
        for k, v in part.items():
            totals[k] = totals.get(k, 0) + v
    mcp_path(turbo)
    cli_path(ckpt_dir)
    return totals


def int4_pipeline(tts, mode: str, seed: int):
    """The pipeline `tts` with its T3 weights drawn again from `seed` (as
    random_init draws them), cast to bf16 and quantized in `mode`; the S3Gen
    engine, tokenizer and conditionals shared."""
    import torch
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.utils.quantize import cast_params, quantize_t3_backbone
    params = quantize_t3_backbone(
        cast_params(t3m.t3_init(tts.hp, seed=seed, device="cuda"), torch.bfloat16), mode=mode)
    return type(tts)(params, tts.hp, tts.s3gen, tts.ve_params, tts.tokenizer, tts.conds,
                     seed=seed)


# ---------------------------------------------------------------------------
# phase 11: training (T3 and the CFM flow, their AdamW steps over a DTensor
# mesh of one card, the runners and the native WAV loader)
# ---------------------------------------------------------------------------

TRAIN_BATCH = 8                # rows a step, as the runners' default
TRAIN_TIMED = 6                # timed steps a model; the median of steps 2-6 is kept
TRAIN_FIXED = 10               # steps on one fixed batch, whose loss must fall
TRAIN_OPT = dict(lr=1e-4, warmup_steps=1, total_steps=100, clip_norm=1.0)


def _median_ms(times) -> float:
    import numpy as np
    return float(np.median(times[1:])) * 1e3


def _timed_steps(run_step, n: int, label: str) -> list:
    """n calls of run_step() -> metrics dict, each ended by reading its
    losses on the host; returns the seconds of each, every loss checked
    finite."""
    import numpy as np
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        metrics = run_step()
        vals = {k: float(v) for k, v in metrics.items()}
        times.append(time.perf_counter() - t0)
        if not all(np.isfinite(list(vals.values()))):
            raise AssertionError(f"{label}: non-finite losses {vals}")
    return times


def _remat_check(params, losses_fn, label: str):
    """The loss, the gradients' global norm and the peak memory of one
    forward and backward with remat and without: the same loss and norm."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from chatterbox_tpu_torch.utils.dtensor import full
    from chatterbox_tpu_torch.parallel.train import global_norm, leaves
    out = {}
    for remat in (True, False):
        for p in leaves(params):
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with implicit_replication():
            losses = losses_fn(remat)
            sum(losses).backward()
        norm = float(global_norm([full(p.grad) for p in leaves(params) if p.grad is not None]))
        out[remat] = ([float(full(v).detach()) for v in losses], norm,
                      torch.cuda.max_memory_allocated() / 2**30)
    for p in leaves(params):
        p.grad = None
    (l1, n1, m1), (l0, n0, m0) = out[True], out[False]
    log(f"{label}: loss {l1} with remat, {l0} without; grad norm {n1:.6g} / {n0:.6g}; "
        f"peak memory {m1:.2f} / {m0:.2f} GiB")
    if max(abs(a - b) / abs(b) for a, b in zip(l1, l0)) > 1e-6 or abs(n1 - n0) > 1e-5 * n0:
        raise AssertionError(f"{label}: remat changes the loss or the gradients")


def t3_training(card: str, mesh) -> None:
    """Turbo T3 (24 x 1024, float32) through build_sharded_train_step on
    the mesh: TRAIN_TIMED steps of the runner's synthetic batches with
    layer remat (ms a step, tokens a second, peak memory), one forward and
    backward without remat (the same loss), then TRAIN_FIXED steps on one
    fixed batch at a constant rate (loss_speech falls)."""
    import torch
    from chatterbox_tpu_torch.examples.train_t3 import _to as to_dev, synthetic_batches
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.models.t3.config import T3Config
    from chatterbox_tpu_torch.parallel.mesh import shard_batch
    from chatterbox_tpu_torch.parallel.train import build_sharded_train_step, local_attention
    hp = T3Config.turbo()
    step, init = build_sharded_train_step(hp, mesh, **TRAIN_OPT)
    state = init(0)
    batches = synthetic_batches(hp, TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = _timed_steps(lambda: step(state, *to_dev(next(batches), "cuda"))[1],
                         TRAIN_TIMED, "Turbo T3 step")
    peak = torch.cuda.max_memory_allocated() / 2**30
    T = t3m.cond_len(hp) + 48 + 96
    ms = _median_ms(times)
    log(f"Turbo T3 train step ({card}): batch {TRAIN_BATCH} x {T} tokens "
        f"(cond {t3m.cond_len(hp)} + text 48 + speech 96), float32, remat, AdamW: "
        f"{ms:.2f} ms/step (median of steps 2-{TRAIN_TIMED}; first {times[0]:.2f} s), "
        f"{TRAIN_BATCH * T / ms * 1e3:.0f} tokens/s, peak memory {peak:.2f} GiB")
    batch = shard_batch(to_dev(next(batches), "cuda"), mesh)
    _remat_check(state.params, lambda remat: t3m.t3_loss(state.params, hp, *batch, remat=remat,
                                                         attn=local_attention), "Turbo T3")
    del state
    torch.cuda.empty_cache()
    step, init = build_sharded_train_step(hp, mesh, lr=3e-4)
    state = init(1)
    fixed = to_dev(next(batches), "cuda")
    speech = []
    for _ in range(TRAIN_FIXED):
        speech.append(float(step(state, *fixed)[1]["loss_speech"]))
    log(f"Turbo T3, {TRAIN_FIXED} steps on one batch: loss_speech {speech[0]:.4f} -> "
        f"{speech[-1]:.4f}")
    if not speech[-1] < speech[0]:
        raise AssertionError(f"Turbo T3 loss_speech does not fall on a fixed batch: {speech}")
    del state
    torch.cuda.empty_cache()


def flow_training(card: str, mesh) -> None:
    """The CFM flow at FlowDims() through build_sharded_flow_train_step:
    TRAIN_TIMED steps of the runner's synthetic batches (8 rows of 64
    tokens, 128 mel frames) with remat, one forward and backward without
    remat, TRAIN_FIXED steps on one fixed batch and fixed draws."""
    import torch
    from chatterbox_tpu_torch.examples.train_flow import synthetic_batches
    from chatterbox_tpu_torch.models.s3gen.flow import (FlowDims, draw_flow_noise,
                                                        flow_compute_loss)
    from chatterbox_tpu_torch.parallel.mesh import local_replicas, local_rows
    from chatterbox_tpu_torch.parallel.train import build_sharded_flow_train_step
    dims, n_tok = FlowDims(), 64
    step, init = build_sharded_flow_train_step(dims, mesh, **TRAIN_OPT)
    state = init(0)
    batches = synthetic_batches(TRAIN_BATCH, n_tok)
    gen = torch.Generator("cuda").manual_seed(1000)

    def one():
        return step(state, gen, *(t.cuda() for t in next(batches)))[1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = _timed_steps(one, TRAIN_TIMED, "CFM flow step")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = _median_ms(times)
    log(f"CFM flow train step ({card}): batch {TRAIN_BATCH} x {n_tok} tokens "
        f"({2 * n_tok} mel frames), FlowDims(), float32, remat, AdamW: {ms:.2f} ms/step "
        f"(median of steps 2-{TRAIN_TIMED}; first {times[0]:.2f} s), "
        f"{TRAIN_BATCH * 2 * n_tok / ms * 1e3:.0f} mel frames/s, peak memory {peak:.2f} GiB")
    fixed = [t.cuda() for t in next(batches)]
    draws = draw_flow_noise(torch.Generator("cuda").manual_seed(7), TRAIN_BATCH, 2 * n_tok)
    *rows, row_draws = local_rows(tuple(fixed) + (draws,), mesh)
    _remat_check(state.params, lambda remat: [flow_compute_loss(
        local_replicas(state.params, mesh), None,
        **dict(zip(("token", "token_len", "feat", "feat_len", "embedding"), rows)),
        dims=dims, remat=remat, draws=row_draws)], "CFM flow")
    step, init = build_sharded_flow_train_step(dims, mesh, lr=3e-4)
    state = init(1)
    losses = [float(step(state, None, *fixed, draws=draws)[1]["loss_cfm"])
              for _ in range(TRAIN_FIXED)]
    log(f"CFM flow, {TRAIN_FIXED} steps on one batch: loss_cfm {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the flow loss does not fall on a fixed batch: {losses}")
    del state
    torch.cuda.empty_cache()


def _adam_close(a: dict, b: dict, lr: float, steps: int, label: str):
    """Parameters after Adam steps: within 2 lr x steps elementwise (a
    noise-level gradient's sign may differ), the 99th percentile of the
    difference under 1e-6."""
    import numpy as np
    d = np.concatenate([np.abs(a[k] - b[k]).ravel() for k in a])
    log(f"{label}: params max |diff| {d.max():.3g}, 99th percentile {np.percentile(d, 99):.3g}")
    if d.max() > 2 * lr * steps or np.percentile(d, 99) > 1e-6:
        raise AssertionError(f"{label}: parameters differ past Adam's noise bound")


def train_card_vs_cpu() -> None:
    """A tiny llama T3 and a tiny CFM flow, two AdamW steps each (clipping
    at 1.0, constant lr 1e-3) from the same weights and batches, on the
    card and on the CPU: losses within rtol 1e-5 (float32, another
    summation order), parameters as `_adam_close`."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.convert.native_ckpt import _flatten
    from chatterbox_tpu_torch.models.s3gen.flow import FlowDims, draw_flow_noise, flow_init
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.models.t3.config import T3Config
    from chatterbox_tpu_torch.nn import core as nn
    from chatterbox_tpu_torch.parallel import train as TR
    lr, steps = 1e-3, 2
    hp, dims = T3Config.tiny_test("llama"), FlowDims.tiny_test()
    rng = np.random.default_rng(0)
    B = 4
    t3_batches = [(t3m.T3CondTensors(
        torch.from_numpy(rng.standard_normal((B, 256)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 6561, (B, hp.speech_cond_prompt_len))),
        torch.full((B, 1, 1), 0.5)),
        torch.from_numpy(rng.integers(0, 64, (B, 16))), torch.tensor([16, 9, 5, 12]),
        torch.from_numpy(rng.integers(0, 6561, (B, 24))), torch.tensor([24, 20, 7, 15]))
        for _ in range(steps)]
    flow_batches = [(torch.from_numpy(rng.integers(0, 6561, (B, 16))), torch.tensor([16, 11, 8, 16]),
                     torch.from_numpy((0.3 * rng.standard_normal((B, 32, 80))).astype(np.float32)),
                     torch.tensor([32, 22, 16, 32]),
                     torch.from_numpy(rng.standard_normal((B, 192)).astype(np.float32)))
                    for _ in range(steps)]
    draws = [draw_flow_noise(torch.Generator().manual_seed(i), B, 32) for i in range(steps)]

    def to(x, dev):
        if isinstance(x, (tuple, list)):
            return type(x)(*(to(v, dev) for v in x)) if hasattr(x, "_fields") else \
                type(x)(to(v, dev) for v in x)
        return None if x is None else x.to(dev)

    results = {}
    for dev in ("cuda", "cpu"):
        opt = TR.make_optimizer(lr, clip_norm=1.0)
        st = opt.init(_to(t3m.t3_init(hp, seed=3, device="cpu"), dev))
        t3_losses = [[float(v) for v in TR.t3_train_step(st, hp, opt, *to(b, dev))[1].values()]
                     for b in t3_batches]
        fopt = TR.make_optimizer(lr, clip_norm=1.0)
        fst = fopt.init(_to(flow_init(nn.Init(3, "cpu"), meanflow=False, dims=dims), dev))
        flow_losses = [float(TR.flow_train_step(fst, fopt, None, *to(b, dev), dims,
                                                draws=d)[1]["loss_cfm"])
                       for b, d in zip(flow_batches, draws)]
        results[dev] = (t3_losses, flow_losses,
                        {k: p.detach().cpu().numpy() for k, p in _flatten(st.params)},
                        {k: p.detach().cpu().numpy() for k, p in _flatten(fst.params)})
    (tc, fc, tpc, fpc), (tk, fk, tpk, fpk) = results["cuda"], results["cpu"]
    log(f"train card vs cpu: T3 losses {tc} vs {tk}; flow losses {fc} vs {fk}")
    if not (np.allclose(tc, tk, rtol=1e-5, atol=0) and np.allclose(fc, fk, rtol=1e-5, atol=0)):
        raise AssertionError("training losses differ between the card and the CPU")
    _adam_close(tpc, tpk, lr, steps, "tiny T3 card vs cpu")
    _adam_close(fpc, fpk, lr, steps, "tiny flow card vs cpu")


def mesh_gloo_spawn() -> tuple:
    """The 4 gloo processes of `mesh_gloo_check` (they print nothing):
    (the flow's draws, process 0's results, every process's batches)."""
    import torch
    from chatterbox_tpu_torch.models.s3gen.flow import draw_flow_noise
    from tests import test_torch_parallel_worker as W
    draws = [draw_flow_noise(torch.Generator().manual_seed(100 + i), W.B, W.FLOW_T_MEL)
             for i in range(W.STEPS)]
    with tempfile.TemporaryDirectory() as d:
        return draws, W.spawn(Path(d), draws), W.read_batches(Path(d))


def mesh_gloo_check(spawned=None) -> None:
    """The sharded training steps in 4 gloo processes on the host's CPU
    (tests/test_torch_parallel_worker.py), under this host's torch: the
    tiny T3 at dp 2 x tp 2 in both families and the tiny flow at data 4
    (draws from a torch generator), held to the same steps in this process
    on plain tensors (losses rtol 1e-5, parameters as `_adam_close`); a
    sharded state saved after 2 steps and resumed makes the third step.
    The same run's decodes over the meshes (tensor-parallel t3_generate at
    dp 2 x tp 2, both tiny families, greedy and sampled; data-parallel
    t3_generate_batched at data 4) give this process's tokens exactly, and
    train_flow's real_batches gives every process one global batch.
    `spawned`: `mesh_gloo_spawn()`'s result, when it ran already."""
    import numpy as np
    from tests import test_torch_parallel_worker as W
    draws, res, batches = spawned or mesh_gloo_spawn()
    if tuple(res["mesh_shape"]) != (2, 2):
        raise AssertionError(f"a world of 4 made a mesh of {res['mesh_shape']}")
    runs = [(f"{fam} T3 dp 2 x tp 2", fam, W.single_t3(fam)) for fam in ("llama", "gpt2")]
    runs.append(("flow data 4", "flow", W.single_flow(draws)))
    for label, key, (losses, params) in runs:
        got = res[f"{key}_losses"]
        log(f"mesh of 4 gloo processes, {label}: losses {got.ravel().tolist()}, "
            f"one process {losses.ravel().tolist()}")
        if not np.allclose(got, losses, rtol=1e-5, atol=0):
            raise AssertionError(f"{label}: the sharded losses differ from one process's")
        _adam_close({k: res[f"{key}/{k}"] for k in params}, params, W.LR, W.STEPS, label)
    resumed = {k[len("resumed/"):]: v for k, v in res.items() if k.startswith("resumed/")}
    if (int(res["resumed_step_count"]) != 2
            or not np.allclose(res["resumed_losses"], res["llama_losses"][2], rtol=1e-6)
            or max(np.abs(v - res[f"llama/{k}"]).max() for k, v in resumed.items()) > 1e-7):
        raise AssertionError("a resumed sharded state does not make the same third step")
    decodes = [(f"tp_{fam}_{mode}", W.single_decode(fam, mode == "greedy"))
               for fam in ("llama", "gpt2") for mode in ("greedy", "sampled")]
    decodes += [(f"dp_{mode}", W.single_batched(mode == "greedy"))
                for mode in ("greedy", "sampled")]
    for key, want in decodes:
        log(f"mesh of 4 gloo processes, decode {key}: tokens "
            f"{'equal to' if np.array_equal(res[key], want) else 'DIFFER from'} one process's "
            f"{res[key].ravel()[:8].tolist()}")
        if not np.array_equal(res[key], want):
            raise AssertionError(f"{key}: the decode over the mesh differs from one process's")
        if key.startswith("dp") and not np.array_equal(res[key][0], res[key][3]):
            raise AssertionError(f"{key}: rows of one input and one generator differ")
    for step in range(2):
        names = [f"{step}/{j}" for j in range(5)]
        same = all(np.array_equal(b[k], batches[0][k]) for b in batches for k in names)
        parts = all(np.array_equal(np.concatenate([b[f"{k}/rows"] for b in batches]),
                                   batches[0][k]) for k in names)
        log(f"mesh of 4 gloo processes, train_flow real_batches step {step}: "
            f"one batch on every process {same}, local rows partition it {parts}")
        if not (same and parts):
            raise AssertionError("real_batches gave the processes different batches")


def _runner(main_fn, argv) -> str:
    """A runner's main in process, its standard output returned (and logged)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_fn(argv)
    out = buf.getvalue()
    log("  " + out.strip().replace("\n", "\n  "))
    return out


def runner_checks(d: Path) -> None:
    """Both runners at full width on the card (their defaults: Turbo T3,
    FlowDims(), batch 8), 2 steps with a checkpoint then --resume for 2
    more; train_flow --data on three 24 kHz WAVs written here, read by the
    native loader."""
    import re
    from chatterbox_tpu_torch.examples import train_flow, train_t3
    from chatterbox_tpu_torch.utils.audio_io import save_wav
    t3_dir, flow_dir = d / "t3", d / "flow"
    out = _runner(train_t3.main, ["--steps", "2", "--ckpt-every", "2", "--ckpt-dir", str(t3_dir)])
    if "done: 2 steps" not in out or not (t3_dir / "opt_state.safetensors").exists():
        raise AssertionError("train_t3 did not checkpoint")
    out = _runner(train_t3.main, ["--steps", "4", "--ckpt-every", "4", "--resume",
                                  "--ckpt-dir", str(t3_dir)])
    m = re.search(r"step +4  loss_text (\d+\.\d+)  loss_speech (\d+\.\d+)", out)
    if "resumed from step 2" not in out or "done: 2 steps" not in out or not m:
        raise AssertionError("train_t3 --resume did not go on from step 2")
    out = _runner(train_flow.main, ["--steps", "2", "--ckpt-dir", str(flow_dir)])
    out += _runner(train_flow.main, ["--steps", "2", "--resume", "--ckpt-dir", str(flow_dir)])
    if f"resumed from {flow_dir}" not in out or len(re.findall(r"loss_cfm \d+\.\d+", out)) != 4:
        raise AssertionError("train_flow did not save and resume")
    wavs = d / "wavs"
    wavs.mkdir()
    for i in range(3):
        save_wav(wavs / f"{i}.wav", synthetic_voice(3.0, 24000, seed=i, f0=120.0 + 30 * i), 24000)
    out = _runner(train_flow.main, ["--steps", "2", "--data", str(wavs),
                                    "--ckpt-dir", str(d / "flow_data")])
    if "data: 3 wavs (native loader: True)" not in out:
        raise AssertionError("the native WAV loader did not serve train_flow --data")
    if len(re.findall(r"loss_cfm \d+\.\d+", out)) != 2:
        raise AssertionError("train_flow --data did not train")


def training_phase(card: str) -> None:
    """Phase 11 (see the module docstring). No kernel of the port lies on
    the training path: every launch count stays 0."""
    import torch
    import torch.distributed as dist
    from chatterbox_tpu_torch.parallel.mesh import make_mesh
    reset_counts()
    mesh = make_mesh(device_type="cuda")          # an NCCL world of one
    try:
        t0 = time.perf_counter()
        t3_training(card, mesh)
        log(f"phase 11 T3 {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        flow_training(card, mesh)
        log(f"phase 11 flow {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train_card_vs_cpu()
        log(f"phase 11 card vs cpu {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        # the 4 gloo processes run on the host's CPU beside the runners,
        # which time nothing (the script's time limit)
        with ThreadPoolExecutor(1) as pool:
            spawned = pool.submit(mesh_gloo_spawn)
            with tempfile.TemporaryDirectory() as d:
                runner_checks(Path(d))
            log(f"phase 11 runners {time.perf_counter() - t0:.1f} s")
            spawned = spawned.result()
        mesh_gloo_check(spawned)
        log(f"phase 11 runners and the mesh of 4 gloo processes beside them "
            f"{time.perf_counter() - t0:.1f} s")
        check_counts(read_counts(), "training", {})
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: serving under a mesh (tensor-parallel CFG t3_generate over
# shard_t3_params, data-parallel t3_generate_batched over replicate /
# shard_batch)
# ---------------------------------------------------------------------------

MESH_TOKENS = 100              # tokens a mesh decode, EOS ignored
MESH_ROWS = 8                  # Turbo rows of the data-parallel decode
MESH_LENS = [30, 12, 25, 30, 7, 18, 22, 15]      # rows 0 and 3: one input, one seed


def tp_decode_check(mesh, dtype) -> dict:
    """The 520M CFG T3 (30 x 1024; params cast from the seed's f32 to
    `dtype`) through t3_generate, MESH_TOKENS tokens with EOS ignored on a
    seeded generator: unsharded, then over shard_t3_params(params, mesh)
    (each after an 8-token warm-up). Returns the tokens and ms/token of
    both; every process holds the unsharded run on its own card."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.models.t3.config import T3Config
    from chatterbox_tpu_torch.ops.sampling import SamplerParams
    from chatterbox_tpu_torch.parallel.mesh import shard_t3_params
    from chatterbox_tpu_torch.sampling.decode import t3_generate
    from chatterbox_tpu_torch.utils.quantize import cast_params
    hp = T3Config.english_only()
    params = cast_params(t3m.t3_init(hp, seed=10, device="cuda"), dtype)
    rng = np.random.default_rng(12)
    cond = t3m.T3CondTensors(
        torch.from_numpy(rng.standard_normal((1, 256)).astype(np.float32)).cuda(),
        torch.from_numpy(rng.integers(0, 6561, (1, hp.speech_cond_prompt_len))).cuda(),
        torch.full((1, 1, 1), 0.5, device="cuda"))
    text = torch.from_numpy(rng.integers(1, hp.text_tokens_dict_size, (1, 30))).cuda()
    sharded = shard_t3_params(params, mesh)
    out = {}
    for name, p in (("plain", params), ("mesh", sharded)):
        run = lambda n: t3_generate(p, hp, cond, text, SamplerParams(), max_new_tokens=n,
                                    cfg_mode=True, ignore_eos=True,
                                    generator=torch.Generator("cuda").manual_seed(7))
        run(8).tokens.cpu()
        (sec,), res = _time_decode(lambda: run(MESH_TOKENS), 1)
        out[name] = (res.tokens.cpu().numpy(), sec / MESH_TOKENS * 1e3)
    del params, sharded
    torch.cuda.empty_cache()
    return out


def dp_decode_check(mesh) -> dict:
    """The Turbo T3 (24 x 1024, bf16 from the seed's f32) through
    t3_generate_batched at MESH_ROWS rows of distinct text lengths (row 3 a
    copy of row 0, with its generator seed), MESH_TOKENS tokens with EOS
    ignored: unsharded, then over replicate(params) with the batch
    shard_batch'ed over "data" (each after an 8-token warm-up). Returns the
    tokens and ms/step of both and, over several data shards, of the
    unsharded calls on each shard's rows in turn ("slices": the batch
    shape each process decodes; a GEMM's kernel, and so its last bits,
    depends on its row count)."""
    import numpy as np
    import torch
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.models.t3.config import T3Config
    from chatterbox_tpu_torch.ops.sampling import SamplerParams
    from chatterbox_tpu_torch.parallel.mesh import replicate, shard_batch
    from chatterbox_tpu_torch.sampling.batched import t3_generate_batched
    from chatterbox_tpu_torch.utils.quantize import cast_params
    hp = T3Config.turbo()
    params = cast_params(t3m.t3_init(hp, seed=0, device="cuda"))
    rng = np.random.default_rng(13)
    spk = rng.standard_normal((MESH_ROWS, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (MESH_ROWS, hp.speech_cond_prompt_len))
    text = np.zeros((MESH_ROWS, max(MESH_LENS)), np.int64)
    for i, n in enumerate(MESH_LENS):
        text[i, :n] = rng.integers(1, hp.text_tokens_dict_size, n)
    for a in (spk, prompt, text):
        a[3] = a[0]
    cond = t3m.T3CondTensors(torch.from_numpy(spk).cuda(), torch.from_numpy(prompt).cuda(),
                             None)
    text = torch.from_numpy(text).cuda()
    seeds = [21, 22, 23, 21, 25, 26, 27, 28]
    inputs = {"plain": (params, cond, text),
              "mesh": (replicate(params, mesh), shard_batch(cond, mesh), shard_batch(text, mesh))}
    dp = mesh.size(0)
    if dp > 1:
        k = MESH_ROWS // dp
        inputs["slices"] = [(params, t3m.T3CondTensors(cond.speaker_emb[i:i + k],
                                                       cond.cond_prompt_speech_tokens[i:i + k],
                                                       None), text[i:i + k], slice(i, i + k))
                            for i in range(0, MESH_ROWS, k)]
    out = {}
    for name, parts in inputs.items():
        parts = parts if name == "slices" else [parts + (slice(None),)]
        toks, sec = [], 0.0
        for p, c, t, rows in parts:
            run = lambda n: t3_generate_batched(
                p, hp, c, t, MESH_LENS[rows], SamplerParams(),
                [torch.Generator("cuda").manual_seed(s) for s in seeds[rows]],
                max_new_tokens=n, ignore_eos=True)
            run(8).tokens.cpu()
            (wall,), res = _time_decode(lambda: run(MESH_TOKENS), 1)
            toks.append(res.tokens.cpu().numpy())
            sec += wall / len(parts)
        out[name] = (np.concatenate(toks), sec / MESH_TOKENS * 1e3)
    del params, inputs
    torch.cuda.empty_cache()
    return out


def _compare_tokens(out: dict, label: str, unit: str, ref: str = "plain",
                    run: str = "mesh") -> bool:
    """Log two runs' speed (the unsharded `ref`, by default, and the mesh
    run) and where their tokens part; True when they are equal."""
    import numpy as np
    (a, ms_a), (b, ms_b) = out[ref], out[run]
    same = np.array_equal(a, b)
    parted = [int(np.argmax(x != y)) for x, y in zip(np.atleast_2d(a), np.atleast_2d(b))
              if not np.array_equal(x, y)]
    log(f"{label}: {ref} {ms_a:.3f} {unit}, {run} {ms_b:.3f} {unit} ({ms_b / ms_a:.2f}x); "
        f"tokens {'equal' if same else 'DIFFER'} ({int((a == b).sum())} of {a.size} equal"
        f"{'' if same else f'; rows part at steps {parted}'})")
    return same


def mesh_serving_phase(card: str) -> None:
    """Phase 12 (see the module docstring) on a mesh of this one card: the
    520M CFG T3 tensor parallel and the Turbo T3 data parallel, each held
    to its unsharded run; no kernel of the port is launched."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from chatterbox_tpu_torch.parallel.mesh import make_mesh
    reset_counts()
    mesh = make_mesh(device_type="cuda")          # an NCCL world of one
    try:
        t0 = time.perf_counter()
        tp = tp_decode_check(mesh, torch.bfloat16)
        log(f"phase 12 tensor parallel {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dp = dp_decode_check(mesh)
        log(f"phase 12 data parallel {time.perf_counter() - t0:.1f} s")
        ok = _compare_tokens(tp, f"520M CFG bf16 t3_generate over shard_t3_params, mesh "
                                 f"{tuple(mesh.shape)} ({card})", "ms/token")
        ok &= _compare_tokens(dp, f"Turbo bf16 t3_generate_batched, {MESH_ROWS} rows over "
                                  f"replicate / shard_batch, mesh {tuple(mesh.shape)} ({card})",
                              "ms/step")
        if not ok:
            raise AssertionError("a decode over the mesh differs from the unsharded decode")
        if not np.array_equal(dp["mesh"][0][0], dp["mesh"][0][3]):
            raise AssertionError("rows of one input and one generator seed differ over the mesh")
        check_counts(read_counts(), "mesh serving", {})
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def mesh_main() -> int:
    """`torchrun --nproc-per-node N chip_smoke.py --mesh`: phase 12's two
    decodes over all N cards (the 520M at dp 2 x tp N/2 in bf16 and in
    float32, Turbo at data N), each process holding the unsharded decodes
    on its own card; process 0 compares and prints."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from chatterbox_tpu_torch.kernels import decode_attention as A
    from chatterbox_tpu_torch.kernels import fused_layer as K
    from chatterbox_tpu_torch.kernels import fused_mlp as FM
    from chatterbox_tpu_torch.kernels import hift_source as KS
    from chatterbox_tpu_torch.kernels import int4_matmul as M
    from chatterbox_tpu_torch.parallel.mesh import make_mesh
    COUNTERS[:] = [K.launches, A.launches, M.launches, FM.launches, KS.launches, _vocodes]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    tp_mesh = make_mesh(device_type="cuda")
    rank0 = dist.get_rank() == 0
    card = smi()
    if rank0:
        log(card)
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, world {dist.get_world_size()}, mesh {tuple(tp_mesh.shape)}")
    dp_mesh = make_mesh(dp=dist.get_world_size(), device_type="cuda")
    reset_counts()
    try:
        runs = [(tp_decode_check(tp_mesh, dt), f"520M CFG {name} t3_generate over "
                 f"shard_t3_params, mesh {tuple(tp_mesh.shape)}", "ms/token")
                for name, dt in (("bf16", torch.bfloat16), ("float32", torch.float32))]
        runs.append((dp_decode_check(dp_mesh), f"Turbo bf16 t3_generate_batched, {MESH_ROWS} rows "
                     f"over replicate / shard_batch, mesh {tuple(dp_mesh.shape)}", "ms/step"))
        if any(read_counts().values()):
            raise AssertionError(f"a kernel was launched over the mesh: {read_counts()}")
        if rank0:
            equal = [_compare_tokens(out, f"{label} ({card})", unit) for out, label, unit in runs]
            # each process decodes MESH_ROWS / N rows: its tokens are one
            # card's calls at that row count; the 8-row call may part from
            # them at a bf16 near-tie, which the log above shows
            dp, label, _ = runs[-1]
            equal[-1] = _compare_tokens(dp, f"{label}, against one card's calls of each "
                                            f"process's rows ({card})", "ms/step", ref="slices")
            _compare_tokens(dp, "one card: the same rows in one call and in the processes' "
                                "slices", "ms/step", run="slices")
            if not np.array_equal(dp["mesh"][0][0], dp["mesh"][0][3]):
                raise AssertionError("rows of one input and one generator seed differ")
            if not all(equal):
                raise AssertionError("a decode over the mesh differs from one card's")
            log(f"total {time.perf_counter() - t_start:.1f} s")
            print(card, flush=True)
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv) -> int:
    ab_root = None
    if argv and argv != ["--mesh"]:
        if len(argv) != 2 or argv[0] != "--ab":
            print(__doc__, file=sys.stderr)
            return 2
        ab_root = argv[1]
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
        import chatterbox_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    if argv == ["--mesh"]:
        return mesh_main()
    try:
        from chatterbox_tpu_torch import ChatterboxTTS, ChatterboxTurboTTS
        from chatterbox_tpu_torch.kernels import build
        from chatterbox_tpu_torch.kernels import decode_attention as A
        from chatterbox_tpu_torch.kernels import fused_layer as K
        from chatterbox_tpu_torch.kernels import fused_mlp as FM
        from chatterbox_tpu_torch.kernels import hift_source as KS
        from chatterbox_tpu_torch.kernels import int4_matmul as M
        from chatterbox_tpu_torch.models.t3 import backbone as bb
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    COUNTERS[:] = [K.launches, A.launches, M.launches, FM.launches, KS.launches, _vocodes]
    count_vocodes()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = smi()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {nvcc_version(build)}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log("packages: " + ", ".join(f"{m} {_imports(m)}"
                                 for m in ("safetensors", "tokenizers", "transformers")))
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
    t0 = time.perf_counter()
    turbo4, cfg4 = int4_pipeline(turbo, "int4_fused", 0), int4_pipeline(cfg520, "int4", 10)
    torch.cuda.synchronize()
    log(f"int4 T3s built in {time.perf_counter() - t0:.1f} s (the same seeds' weights, "
        f"{turbo.hp.backbone_name} int4_fused, {cfg520.hp.backbone_name} int4; "
        f"the S3Gen engines and conditionals shared)")
    if ab_root is not None:
        ab_kernels(turbo, cfg520, turbo4, cfg4, K, A, M, FM, bb, ab_root)
        return 0

    t0 = time.perf_counter()
    sweep_splits(turbo, cfg520, A, bb)
    sweep_tilings(turbo, cfg520, turbo4, cfg4, K, M, FM)
    rows = (check_kernels(turbo, cfg520, K) + check_attention(turbo, cfg520, A, bb)
            + check_int4_kernels(turbo4, cfg4, turbo, K, M, FM) + check_hift_source())
    log(f"phase 3 (kernels) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_reference()
    log(f"phase 4 (reference) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = {}
    for part in (main_paths(turbo, cfg520, turbo4, cfg4),
                 fused_attention_paths(turbo, cfg520), batched_paths(turbo, cfg520)):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    log(f"phase 5 (main paths) {time.perf_counter() - t0:.1f} s")
    del turbo4, cfg4
    torch.cuda.empty_cache()
    # phase 6's checkpoint directory stays for phase 10's command line
    ckpt_tmp = tempfile.TemporaryDirectory()
    ckpt_dir = Path(ckpt_tmp.name)
    t0 = time.perf_counter()
    for k, v in frontend_path(ckpt_dir).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 6 (frontend) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k, v in streaming_path(turbo, cfg520).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 7 (streaming and VC) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for part in (multilingual_path(), speculative_path(turbo)):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    log(f"phase 8 (multilingual and speculative) {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for k, v in serving_phase(turbo, cfg520).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 9 (batched serving) {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        for k, v in serving_surfaces_phase(turbo, ckpt_dir).items():
            launches[k] = launches.get(k, 0) + v
    finally:
        ckpt_tmp.cleanup()
    log(f"phase 10 (speculative slots and serving surfaces) {time.perf_counter() - t0:.1f} s")
    del turbo, cfg520
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    training_phase(card)
    log(f"phase 11 (training) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_serving_phase(card)
    log(f"phase 12 (serving under a mesh) {time.perf_counter() - t0:.1f} s")
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["name"] in PHASE3_ONLY:
            r["path"] = PHASE3_ONLY[r["name"]]
        elif not r["launches"]:
            raise AssertionError(f"{r['name']} was not launched on any main path")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
