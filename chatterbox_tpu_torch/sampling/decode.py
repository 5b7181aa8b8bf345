"""T3 decode engine: prefill over the dense prefix, then one token at a time
over the preallocated KV cache (the counterpart of
chatterbox_tpu/sampling/decode.py `t3_generate`).

Two modes, as in the JAX package:
  * Turbo (cfg_mode=False): batch 1, prefix [cond | text | BOS], sampler
    temp -> top_k -> top_p -> rep (the start token penalized on step 0 only);
  * 520M CFG (cfg_mode=True): batch 2, row 0 conditional and row 1
    unconditional (its text token embeddings zeroed, the learned text
    positions kept); prefix [cond | text | BOS | BOS], the speech BOS fed
    twice at speech position 0 as the reference's shipped loop does;
    sampler cfg -> rep -> temp -> min_p -> top_p with the start token in the
    history from the start; token `step` is embedded at speech position
    step + 1. cfg_batch2=False runs batch 1 (the reference's cfg_weight == 0
    path; the combine is then the identity).

The loop never waits on the device per step: the sampled token stays on the
device, is fed straight into the next step's embedding, and `done` is read
back only every DONE_CHECK_EVERY steps. Tokens sampled after the first EOS are
overwritten with the stop token, so the output equals the JAX engine's
(which stops its while-loop at EOS). One engine serves every budget: the
cache holds exactly prefix + max_new_tokens positions and attention reads
only the filled ones, so the JAX package's bucketed engine
(`t3_generate_bucketed`, a static-shape schedule for XLA) has no
counterpart here.

Decode-attention knobs, as in the JAX engine: kv_int8 keeps the cache in
int8 with a bf16 scale per position (`bb.KVCacheInt8`); fused_attn lets each
decode step take the decode-attention kernels and rounds the cache length up
to a multiple of their tile (256 keys). The pipelines pass
kv_int8=kv_int8, fused_attn=kv_int8.

Over a mesh, as the JAX package runs `t3_generate` under `with mesh:` on
params placed by `shard_t3_params`: every process of the world calls it
with the same inputs and the same generator seed (or `gumbel` draws). The
projections run tensor parallel over "model" as DTensor ops; each layer's
cache and attention hold this process's heads as plain tensors
(parallel.mesh.HeadShards); the CFG pair stays whole on every process
(replicated over "data"); the logits come back whole on every process, so
every process samples the same token from its own generator and no
collective runs for the sampler. The tokens are all-gathered once at the
end, and a process whose tokens differ raises. What the JAX package never
runs under a mesh is refused: kv_int8, fused_attn, quantized or "fused"
params.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor.experimental import implicit_replication

from ..kernels.decode_attention import TT
from ..models.t3 import backbone as bb
from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..ops import sampling as S
from ..parallel import mesh as M
from ..utils.dtensor import full
from ..utils.quantize import is_quantized

DONE_CHECK_EVERY = 32     # decode steps between host reads of `done`


class GenResult(NamedTuple):
    tokens: torch.Tensor     # (max_new_tokens,) long, stop-token padded
    n_tokens: torch.Tensor   # () long: generated tokens including the EOS
    n_forward: int           # decode-step forward passes run (host int)


def build_prefix(params: dict, hp: T3Config, cond: t3m.T3CondTensors,
                 text_tokens: torch.Tensor, batch: int,
                 cfg_mode: bool) -> torch.Tensor:
    """The dense prefix [cond | text | BOS (| BOS)] of `batch` rows in the
    compute type, (batch, P, D). With CFG at batch 2 row 1 is the
    unconditional row."""
    dev = params["speech_emb"]["w"].device
    dt = params["speech_emb"]["w"].dtype
    parts = [p.to(dt).expand(batch, -1, -1) for p in t3m.cond_embeds(params, hp, cond)]
    tokens = text_tokens.expand(batch, -1)
    row_scale = (torch.tensor([1.0, 0.0], device=dev)
                 if cfg_mode and batch == 2 else None)
    parts.append(t3m.text_embeds(params, hp, tokens, row_scale).to(dt))
    bos = t3m.speech_embed_token(
        params, hp, torch.full((batch,), hp.start_speech_token, device=dev), 0)
    parts += [bos.to(dt)] * (2 if cfg_mode else 1)
    return torch.cat(parts, dim=1)


def cache_len(n: int, fused_attn: bool) -> int:
    """Cache positions for n tokens: rounded up to the decode-attention
    tile when the kernels read it."""
    return -(-n // TT) * TT if fused_attn else n


def logits_of(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Speech logits (B, V) in f32, whole on every process over a mesh."""
    return full(t3m.speech_logits(params, hidden).float())


def decode_step(params: dict, hp: T3Config, token: torch.Tensor, step: int,
                cache, pos: int, fused_attn: bool = False, heads=None) -> torch.Tensor:
    """Feed `token` (a () or (B,) long) as generated token `step` at cache
    position `pos`; returns the next logits (B, V) f32. `heads`: see
    `bb.backbone_apply`."""
    B = (cache.k_q if isinstance(cache, bb.KVCacheInt8) else cache.k).shape[1]
    emb = t3m.speech_embed_token(params, hp, token.reshape(-1).expand(B), step + 1)
    hidden = bb.backbone_apply(params["backbone"], hp.backbone, emb,
                               torch.full((B, 1), pos, device=emb.device), cache, pos,
                               fused_attn=fused_attn, heads=heads)
    return logits_of(params, hidden[:, 0])


def prefill(params: dict, hp: T3Config, cond: t3m.T3CondTensors,
            text_tokens: torch.Tensor, batch: int, cfg_mode: bool,
            max_new_tokens: int, kv_int8: bool = False, tile_align: bool = False,
            heads=None):
    """The dense prefix through the backbone into a new cache of P +
    max_new_tokens positions (rounded up to the decode-attention tile when
    tile_align), of this process's KV heads under `heads`. Returns (cache,
    logits (batch, V) f32 at the prefix's last position, P)."""
    cfg = hp.backbone
    dev = params["speech_emb"]["w"].device
    x = build_prefix(params, hp, cond, text_tokens, batch, cfg_mode)   # (B, P, D)
    P = x.shape[1]
    cache_cls = bb.KVCacheInt8 if kv_int8 else bb.KVCache
    cache = cache_cls.zeros(cfg, batch, cache_len(P + max_new_tokens, tile_align), dev,
                            heads=heads.kv if heads is not None else 0)
    positions = torch.arange(P, device=dev)[None].expand(batch, -1)
    hidden = bb.backbone_apply(params["backbone"], cfg, x, positions, cache, 0, heads=heads)
    return cache, logits_of(params, hidden[:, -1]), P


def refuse_under_mesh(params: dict, kv_int8: bool, fused_attn: bool):
    """What the JAX package never runs over a mesh (its sharding rules
    place float `w` / `b` leaves only, and its decode keeps the Pallas
    attention off)."""
    if kv_int8:
        raise ValueError("kv_int8 is not a knob of the decode over a mesh: the bf16 cache only")
    if fused_attn:
        raise ValueError("fused_attn is not a knob of the decode over a mesh: plain attention "
                         "on each process's heads")
    if is_quantized(params):
        raise ValueError("a mesh decodes float params: these are quantized or carry fused "
                         "decode operands")


def new_seen(hp: T3Config, cfg_mode: bool, device) -> torch.Tensor:
    """The repetition history before the first token: the CFG family counts
    the start token as seen."""
    seen = torch.zeros(hp.speech_tokens_dict_size, dtype=torch.bool, device=device)
    if cfg_mode:
        seen[hp.start_speech_token] = True
    return seen


def sample_step(hp: T3Config, logits: torch.Tensor, seen: torch.Tensor, step: int,
                sp: S.SamplerParams, done: torch.Tensor, *, cfg_mode: bool,
                top_k: int = 0, generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sampler of decode step `step`, shared by t3_generate and the
    chunked decode: the family's logits processor (CFG: rows 0 and B-1
    combined; Turbo: the start token penalized on step 0 only, then the
    generated tokens), a gumbel-max draw (`gumbel[step]` when replayed,
    else from `generator`), and the stop token where every logit was
    filtered away or the stream is `done`. Marks the token seen, in place.
    Returns the token, a () long on the device."""
    stop = hp.stop_speech_token
    if cfg_mode:
        l = S.process_logits_cfg(logits[0], logits[-1], seen, sp)
    else:
        pen = seen
        if step == 0:
            pen = seen.clone()
            pen[hp.start_speech_token] = True
        l = S.process_logits_turbo(logits[0], pen, sp, top_k)
    g = (gumbel[step].to(l.device) if gumbel is not None
         else S.gumbel(l.shape, generator, l.device))
    tok = S.sample_categorical(l, g)
    # every logit filtered away: stop instead of sampling noise
    tok = torch.where((l <= S.NEG_INF).all() | done, stop, tok)
    seen.index_fill_(0, tok.view(1), True)
    return tok


@torch.no_grad()
def t3_generate(params: dict, hp: T3Config, cond: t3m.T3CondTensors,
                text_tokens: torch.Tensor, sp: S.SamplerParams, *,
                max_new_tokens: int = 1000, top_k: int = 0,
                cfg_mode: bool = False, cfg_batch2: bool = True,
                ignore_eos: bool = False,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None,
                fused_attn: Optional[bool] = None,
                kv_int8: bool = False) -> GenResult:
    """Generate speech tokens for one utterance.

    text_tokens: (1, Lt) long, the unpadded text ids (SOT/EOT framed for
    the CFG family).
    gumbel: optional (max_new_tokens, V) draws used instead of drawing from
    `generator` (lets a test replay another engine's random numbers).
    fused_attn (None means False): decode steps take the decode-attention
    kernels over a tile-aligned cache. kv_int8: the int8 KV cache.
    Over params placed on a mesh, tensor parallel (see the module
    docstring).
    """
    kw = dict(max_new_tokens=max_new_tokens, top_k=top_k, cfg_mode=cfg_mode,
              cfg_batch2=cfg_batch2, ignore_eos=ignore_eos, generator=generator,
              gumbel=gumbel, fused_attn=bool(fused_attn), kv_int8=kv_int8)
    mesh = M.tree_mesh(params)
    if mesh is None:
        return _generate(params, hp, cond, text_tokens, sp, **kw)
    refuse_under_mesh(params, kv_int8, bool(fused_attn))
    with implicit_replication():
        res = _generate(params, hp, cond, text_tokens, sp,
                        heads=M.HeadShards(hp.backbone, mesh), **kw)
    if not M.same_everywhere(res.tokens):
        raise RuntimeError("the processes of the mesh decoded different tokens")
    return res


def _generate(params: dict, hp: T3Config, cond: t3m.T3CondTensors,
              text_tokens: torch.Tensor, sp: S.SamplerParams, *, max_new_tokens: int,
              top_k: int, cfg_mode: bool, cfg_batch2: bool, ignore_eos: bool,
              generator: Optional[torch.Generator], gumbel: Optional[torch.Tensor],
              fused_attn: bool, kv_int8: bool, heads=None) -> GenResult:
    dev = params["speech_emb"]["w"].device
    stop = hp.stop_speech_token
    B = 2 if cfg_mode and cfg_batch2 else 1
    cache, logits, P = prefill(params, hp, cond, text_tokens, B, cfg_mode,
                               max_new_tokens, kv_int8, fused_attn, heads)

    # ---- token loop ---------------------------------------------------------
    tokens = torch.full((max_new_tokens,), stop, dtype=torch.long, device=dev)
    seen = new_seen(hp, cfg_mode, dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_tokens = torch.full((), max_new_tokens, dtype=torch.long, device=dev)
    n_forward = 0
    for step in range(max_new_tokens):
        tok = sample_step(hp, logits, seen, step, sp, done, cfg_mode=cfg_mode,
                          top_k=top_k, generator=generator, gumbel=gumbel)
        tokens[step] = tok
        if not ignore_eos:
            is_stop = tok == stop
            n_tokens = torch.where(is_stop & ~done,
                                   torch.full_like(n_tokens, step + 1), n_tokens)
            done = done | is_stop
        if step == max_new_tokens - 1:
            break
        if not ignore_eos and (step + 1) % DONE_CHECK_EVERY == 0 and bool(done):
            break
        logits = decode_step(params, hp, tok, step, cache, P + step, fused_attn, heads)
        n_forward += 1
    return GenResult(tokens, n_tokens, n_forward)
