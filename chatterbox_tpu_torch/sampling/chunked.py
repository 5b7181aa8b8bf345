"""Chunked T3 decode: prefill once, then decode in chunks of a few tokens
with the state kept on the device (the counterpart of
chatterbox_tpu/sampling/chunked.py `t3_prefill`, `t3_decode_chunk` and
`t3_prefill_decode`).

This is the time-to-first-audio path: the caller vocodes each chunk as it
lands (serve/streaming.py `StreamingVocoder`) instead of waiting for the
whole utterance. The prefill and the per-step sampler are t3_generate's own
(sampling/decode.py `prefill`, `sample_step`, `decode_step`), so under the
same random numbers the chunks concatenate to t3_generate's tokens.

A chunk runs without reading the device: the sampled token feeds the next
step's embedding on the device, and `done` and the chunk's count stay
device scalars for the caller to read once per chunk. A chunk stops at the
token budget (prefix + max_new_tokens cache positions) rather than running
past it, and the last step of the budget runs no forward pass, as in
t3_generate. The JAX package's bucketed growth schedule
(`segment_schedule`, `grow_cache`, `t3_generate_bucketed`) works around
XLA's static shapes and has no counterpart: the cache is allocated once at
the budget and attention reads only the filled positions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..ops import sampling as S
from .decode import decode_step, new_seen, prefill, sample_step


class DecodeState(NamedTuple):
    cache: object                  # bb.KVCache / bb.KVCacheInt8, filled in place
    logits: torch.Tensor           # (B, V) f32 logits at the current position
    seen: torch.Tensor             # (V,) bool repetition history, updated in place
    step: int                      # tokens sampled so far (the host's loop count)
    done: torch.Tensor             # () bool on the device: the stream hit EOS
    generator: Optional[torch.Generator]
    gumbel: Optional[torch.Tensor]  # (max_new_tokens, V) replayed draws, or None
    prefill_len: int               # P, the dense prefix length
    max_new_tokens: int            # the token budget the cache holds
    n_forward: int                 # decode-step forward passes run so far


@torch.no_grad()
def t3_prefill(params: dict, hp: T3Config, cond: t3m.T3CondTensors,
               text_tokens: torch.Tensor, *,
               generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None,
               max_new_tokens: int = 1000, cfg_mode: bool = True,
               kv_int8: bool = False, tile_align: bool = False) -> DecodeState:
    """Run the dense prefix (as t3_generate packs it: CFG at batch 2, the
    BOS fed twice) and return the decode state.

    text_tokens: (1, Lt) long, unpadded. generator draws the sampler's
    gumbel noise; gumbel (max_new_tokens, V) replays given draws instead.
    tile_align rounds the cache up to the decode-attention tile, so that
    chunks with fused_attn take the tile-aligned kernels."""
    B = 2 if cfg_mode else 1
    cache, logits, P = prefill(params, hp, cond, text_tokens, B, cfg_mode, max_new_tokens,
                               kv_int8, tile_align)
    dev = logits.device
    return DecodeState(cache, logits, new_seen(hp, cfg_mode, dev), 0,
                       torch.zeros((), dtype=torch.bool, device=dev), generator, gumbel,
                       P, max_new_tokens, 0)


@torch.no_grad()
def t3_decode_chunk(params: dict, hp: T3Config, state: DecodeState,
                    sp: S.SamplerParams, *, n_steps: int, top_k: int = 0,
                    cfg_mode: bool = True, ignore_eos: bool = False,
                    fused_attn: bool = False):
    """Decode up to n_steps tokens, fewer where the budget ends first.

    Returns (state, tokens (n_steps,) long, n_new () long), on the device:
    tokens past the first EOS or past the budget are the stop token, and
    n_new counts the steps taken while the stream was not yet done (its EOS
    included), as the JAX chunk counts its loop's iterations."""
    dev = state.logits.device
    stop = hp.stop_speech_token
    n = max(0, min(n_steps, state.max_new_tokens - state.step))
    out = torch.full((n_steps,), stop, dtype=torch.long, device=dev)
    n_new = torch.zeros((), dtype=torch.long, device=dev)
    logits, done, n_forward = state.logits, state.done, state.n_forward
    for i in range(n):
        step = state.step + i
        tok = sample_step(hp, logits, state.seen, step, sp, done, cfg_mode=cfg_mode,
                          top_k=top_k, generator=state.generator, gumbel=state.gumbel)
        out[i] = tok
        n_new += (~done).long()
        if not ignore_eos:
            done = done | (tok == stop)
        if step + 1 < state.max_new_tokens:   # the budget's last token needs no forward
            logits = decode_step(params, hp, tok, step, state.cache,
                                 state.prefill_len + step, fused_attn)
            n_forward += 1
    state = state._replace(logits=logits, step=state.step + n, done=done,
                           n_forward=n_forward)
    return state, out, n_new


def t3_prefill_decode(params: dict, hp: T3Config, cond: t3m.T3CondTensors,
                      text_tokens: torch.Tensor, sp: S.SamplerParams, *,
                      generator: Optional[torch.Generator] = None,
                      gumbel: Optional[torch.Tensor] = None,
                      max_new_tokens: int = 1000, n_steps: int = 25,
                      top_k: int = 0, cfg_mode: bool = True,
                      ignore_eos: bool = False, kv_int8: bool = False):
    """t3_prefill, then the first chunk, in one call: returns (state,
    tokens (n_steps,), n_new ()) as t3_decode_chunk does; go on with
    t3_decode_chunk."""
    state = t3_prefill(params, hp, cond, text_tokens, generator=generator, gumbel=gumbel,
                       max_new_tokens=max_new_tokens, cfg_mode=cfg_mode, kv_int8=kv_int8)
    return t3_decode_chunk(params, hp, state, sp, n_steps=n_steps, top_k=top_k,
                           cfg_mode=cfg_mode, ignore_eos=ignore_eos)
