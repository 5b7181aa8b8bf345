"""Batched T3 decode: N independent requests in one loop (the counterpart of
chatterbox_tpu/sampling/batched.py).

Each decode step reads every backbone weight once whatever the batch, so B
requests cost about as much weight traffic as one.

Layout: prefixes are RIGHT-ALIGNED in the cache (left-padded), so every row's
next token lands in the same cache slot and one shared offset writes the
cache. Row b's left pad is pad[b] = P_pad - prefix_len[b]; its positions
are max(slot - pad[b], 0), so learned positions and RoPE see the same dense
positions as an unpadded run, and keys below pad[b] are masked (`kv_lo`).
Decode step `step` sits at slot P_pad + step and row position
prefix_len[b] + step; the speech position step + 1 is shared.

Multi-tenant semantics, as in the JAX engine:
  * each row draws from its own torch.Generator, so a row's tokens depend on
    its own seed, prompt and sampler, not on its batchmates;
  * SamplerParams fields may be one value or one per row;
  * cfg_mode=True serves the 520M CFG family as 2B rows: cond rows [0, B),
    uncond rows [B, 2B) with the text embeddings zeroed.

Attention: the int8 cache (kv_int8) takes the int8 decode-attention kernel
(B4) with lo = pad; the bf16 cache takes plain attention under the left-pad
mask (`fused_attn` is refused, as in the JAX engine).

Structure: `t3_prefill_batched` and `t3_decode_chunk_batched` are the
engine, a host loop like sampling/decode.py; `t3_generate_batched` runs one
chunk over the whole budget.

Over a mesh, as the JAX package runs `t3_generate_batched` on `replicate`d
params with the request batch and its keys `shard_batch`ed over "data":
every process of the world calls it with the same arguments (the whole
batch's host lengths, generators and sampler fields), and it hands its own
rows (parallel.mesh.local_rows), their generators and sampler fields, and
plain copies of the params to the engine, so no op of a step goes through
DTensor's dispatch; the engine's `tokens` and `n_tokens` are all-gathered
over "data" at the end (`n_forward` is the process's own count, the same
everywhere when EOS is ignored). The prefill and chunk engines themselves
run on plain tensors only. A row's pads and window come from the text
tensor's width and its own length, so its tokens are the ones it gets in
the whole batch. kv_int8 and quantized params are refused there, as in
sampling/decode.py. The JAX package's bucketed variant
(`t3_generate_batched_bucketed`, `grow_cache_batched`) grows the cache in
doubling segments for XLA's static shapes and gives the one-chunk engine's
tokens: it has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from ..kernels.decode_attention import check_window
from ..models.t3 import backbone as bb
from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..ops import sampling as S
from ..parallel import mesh as M
from .decode import DONE_CHECK_EVERY, cache_len, refuse_under_mesh


class BatchGenResult(NamedTuple):
    tokens: torch.Tensor     # (B, max_new_tokens) long, stop-token padded
    n_tokens: torch.Tensor   # (B,) long: per-row counts including the EOS
    n_forward: int           # decode-step forward passes run (host int)


@dataclasses.dataclass
class BatchDecodeState:
    step: int                     # tokens generated so far
    logits: torch.Tensor          # (Bp, V) f32 at the current position
    cache: object                 # bb.KVCache or bb.KVCacheInt8, Bp rows
    seen: torch.Tensor            # (B, V) repetition history
    tokens: torch.Tensor          # (B, max_new) output buffer
    n: torch.Tensor               # (B,) per-row counts
    done: torch.Tensor            # (B,)
    generators: list              # B torch.Generators, one per row
    pad: torch.Tensor             # (Bp,) int32 left pad per physical row
    prefix_lens: torch.Tensor     # (Bp,) long dense prefix length per row
    pad_host: list                # pad as host ints
    p_pad: int                    # slots of the padded prefix
    n_forward: int = 0


def _check_fused_attn(fused_attn: bool):
    if fused_attn:
        raise ValueError(
            "fused_attn is not a knob of the batched decode loop (the bf16 "
            "cache takes plain attention under the left-pad mask); for the "
            "int8 decode-attention kernel pass kv_int8=True")


def _rows(v, B: int, device):
    """A sampler field as a float (one value for every row) or a (B, 1) f32
    tensor (one value per row)."""
    t = torch.as_tensor(v, dtype=torch.float32).reshape(-1)
    if t.numel() not in (1, B):
        raise ValueError(f"sampler field of {t.numel()} values for {B} rows")
    if bool((t == t[0]).all()):
        return float(t[0])
    return t.to(device).reshape(-1, 1)


@torch.no_grad()
def t3_prefill_batched(params: dict, hp: T3Config, cond: t3m.T3CondTensors,
                       text_tokens: torch.Tensor, text_lens: Sequence[int],
                       generators: list, *, t_cap: int, max_new_tokens: int,
                       cfg_mode: bool = False,
                       kv_int8: bool = False) -> BatchDecodeState:
    """Run the right-aligned batched prefix into a cache of t_cap slots.
    text_tokens (B, Lt) left-aligned; text_lens B host ints; cond fields
    batched (B, ...); generators one per row."""
    cfg = hp.backbone
    dev = params["speech_emb"]["w"].device
    dt = params["speech_emb"]["w"].dtype
    B, Ltp = text_tokens.shape
    lens = [int(n) for n in text_lens]
    if len(lens) != B or len(generators) != B:
        raise ValueError("one text length and one generator per row")
    Lc = t3m.cond_len(hp)
    n_bos = 2 if cfg_mode else 1
    P_pad = Lc + Ltp + n_bos
    V = hp.speech_tokens_dict_size

    ce = torch.cat([p.to(dt) for p in t3m.cond_embeds(params, hp, cond)], dim=1)
    te = t3m.text_embeds(params, hp, text_tokens.to(dev)).to(dt)
    if cfg_mode:
        # uncond half: the same conditioning, text embeddings zeroed
        ce = torch.cat([ce, ce])
        te = torch.cat([te, torch.zeros_like(te)])
        lens = lens + lens
    Bp = len(lens)
    bos = t3m.speech_embed_token(
        params, hp, torch.full((Bp,), hp.start_speech_token, device=dev), 0).to(dt)
    dense = torch.cat([ce, te, torch.zeros((Bp, n_bos, ce.shape[2]), dtype=dt,
                                           device=dev)], dim=1)
    prefix_lens = [Lc + n + n_bos for n in lens]
    pad = [P_pad - p for p in prefix_lens]
    rows = []
    for b in range(Bp):
        row = dense[b].clone()
        row[Lc + lens[b]:Lc + lens[b] + n_bos] = bos[b].expand(n_bos, -1)
        rows.append(torch.roll(row, pad[b], dims=0))   # BOS at slot P_pad - 1
    x = torch.stack(rows)
    pad_t = torch.tensor(pad, dtype=torch.int32, device=dev)
    positions = (torch.arange(P_pad, device=dev)[None] - pad_t[:, None].long()).clamp(min=0)

    cache_cls = bb.KVCacheInt8 if kv_int8 else bb.KVCache
    cache = cache_cls.zeros(cfg, Bp, t_cap, dev)
    hidden = bb.backbone_apply(params["backbone"], cfg, x, positions, cache, 0,
                               kv_lo=pad_t)
    logits = t3m.speech_logits(params, hidden[:, -1]).float()
    seen = torch.zeros((B, V), dtype=torch.bool, device=dev)
    if cfg_mode:
        seen[:, hp.start_speech_token] = True
    return BatchDecodeState(
        step=0, logits=logits, cache=cache, seen=seen,
        tokens=torch.full((B, max_new_tokens), hp.stop_speech_token, dtype=torch.long,
                          device=dev),
        n=torch.zeros((B,), dtype=torch.long, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        generators=list(generators), pad=pad_t,
        prefix_lens=torch.tensor(prefix_lens, dtype=torch.long, device=dev),
        pad_host=pad, p_pad=P_pad)


@torch.no_grad()
def t3_decode_chunk_batched(params: dict, hp: T3Config, state: BatchDecodeState,
                            sp: S.SamplerParams, *, n_steps: int, top_k: int = 1000,
                            cfg_mode: bool = False,
                            ignore_eos: bool = False) -> BatchDecodeState:
    """Advance the batch by up to n_steps tokens, in place (stops early,
    checked every DONE_CHECK_EVERY steps, once every row is done, and when
    the output buffer is full)."""
    cfg = hp.backbone
    B, max_new = state.tokens.shape
    V = hp.speech_tokens_dict_size
    dev = state.logits.device
    stop = hp.stop_speech_token
    int8_cache = isinstance(state.cache, bb.KVCacheInt8)
    sp = S.SamplerParams(*[_rows(getattr(sp, f.name), B, dev)
                           for f in dataclasses.fields(S.SamplerParams)])
    stop_t = torch.full((B,), stop, dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)
    # the kernels' window [pad, slot] is never empty (host values only)
    check_window(state.pad_host, state.p_pad + state.step)
    for i in range(n_steps):
        if state.step >= max_new:
            break
        if (not ignore_eos and i and i % DONE_CHECK_EVERY == 0
                and bool(state.done.all())):
            break
        s = state.step
        if cfg_mode:
            l = S.process_logits_cfg(state.logits[:B], state.logits[B:], state.seen, sp)
        else:
            pen = state.seen
            if s == 0:
                pen = pen.clone()
                pen[:, hp.start_speech_token] = True
            l = S.process_logits_turbo(state.logits, pen, sp, top_k)
        # each row's draws from its own generator
        g = torch.stack([S.gumbel((V,), gen, dev) for gen in state.generators])
        tok = S.sample_categorical(l, g)
        tok = torch.where((l <= S.NEG_INF).all(-1), stop_t, tok)
        active = ~state.done
        state.tokens[:, s] = torch.where(active, tok, stop_t)
        state.seen[rows, tok] = active | state.seen[rows, tok]
        state.n = torch.where(active, torch.full_like(state.n, s + 1), state.n)
        if not ignore_eos:
            state.done = state.done | (tok == stop)
        state.step = s + 1
        if state.step == max_new:
            break
        tok_p = torch.cat([tok, tok]) if cfg_mode else tok
        emb = t3m.speech_embed_token(params, hp, tok_p, s + 1)
        hidden = bb.backbone_apply(
            params["backbone"], cfg, emb, (state.prefix_lens + s)[:, None], state.cache,
            state.p_pad + s, kv_lo=state.pad, fused_attn=int8_cache)
        state.logits = t3m.speech_logits(params, hidden[:, 0]).float()
        state.n_forward += 1
    return state


def t3_generate_batched(params: dict, hp: T3Config, cond: t3m.T3CondTensors,
                        text_tokens: torch.Tensor, text_lens: Sequence[int],
                        sp: S.SamplerParams, generators: list, *,
                        max_new_tokens: int = 1000, top_k: int = 1000,
                        cfg_mode: bool = False, ignore_eos: bool = False,
                        fused_attn: bool = False,
                        kv_int8: bool = False) -> BatchGenResult:
    """text_tokens (B, Lt) left-aligned; text_lens B host ints; cond fields
    batched (B, ...); generators one torch.Generator per row; sp fields one
    value or B values. kv_int8: the int8 KV cache, read by the int8
    decode-attention kernel with the per-row left pad as its lower bound
    (the cache length rounds up to the kernel's tile). Over a mesh, data
    parallel (see the module docstring): every process returns the whole
    batch's tokens."""
    _check_fused_attn(fused_attn)
    mesh = M.tree_mesh(params)
    if mesh is not None:
        refuse_under_mesh(params, kv_int8, False)
        params, cond, text_tokens, text_lens, sp, generators = _local_batch(
            mesh, params, cond, text_tokens, text_lens, sp, generators)
    P_pad = t3m.cond_len(hp) + text_tokens.shape[1] + (2 if cfg_mode else 1)
    state = t3_prefill_batched(params, hp, cond, text_tokens, text_lens, generators,
                               t_cap=cache_len(P_pad + max_new_tokens, kv_int8),
                               max_new_tokens=max_new_tokens, cfg_mode=cfg_mode,
                               kv_int8=kv_int8)
    state = t3_decode_chunk_batched(params, hp, state, sp, n_steps=max_new_tokens,
                                    top_k=top_k, cfg_mode=cfg_mode,
                                    ignore_eos=ignore_eos)
    if mesh is None:
        return BatchGenResult(state.tokens, state.n, state.n_forward)
    return BatchGenResult(M.gather_rows(state.tokens, mesh), M.gather_rows(state.n, mesh),
                          state.n_forward)


def _local_batch(mesh, params, cond, text_tokens, text_lens, sp, generators):
    """This process's rows of a batch sharded over "data" (their text
    lengths, generators and per-row sampler fields) and plain copies of
    the replicated params."""
    n = text_tokens.shape[0]
    if len(text_lens) != n or len(generators) != n:
        raise ValueError("one text length and one generator per row")
    lo, hi = M.row_range(n, mesh)
    rows = lambda v: (torch.as_tensor(v).reshape(-1)[lo:hi]
                      if torch.as_tensor(v).numel() == n else v)
    sp = S.SamplerParams(*[rows(getattr(sp, f.name)) for f in dataclasses.fields(S.SamplerParams)])
    return (M.local_copies(params), M.local_rows(cond, mesh), M.local_rows(text_tokens, mesh),
            list(text_lens)[lo:hi], sp, list(generators)[lo:hi])
