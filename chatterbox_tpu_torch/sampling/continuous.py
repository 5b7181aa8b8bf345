"""Token-level continuous batching: a fixed pool of decode slots that
requests join and leave between decode rounds, without draining the batch
(the counterpart of chatterbox_tpu/sampling/continuous.py).

The decode state (`SlotStates`) holds S slots on the device:
  * every row is LEFT-aligned in its own cache rows and advances at its own
    position, so rows at different depths share one decode step: the
    backbone's per-row step (models/t3/backbone.py `backbone_step_rows`)
    writes each row's K/V at its own offset and masks its keys;
  * `admit` prefills ONE request (batch 1; batch 2 for CFG) at its exact
    length and splices its K/V rows into a free slot, leaving the other
    rows untouched;
  * `decode_chunk_multi` advances every running row n_steps together and
    reads nothing on the host: finished rows are frozen on the device, and
    `pack_status` gathers what the host scheduler needs into one tensor,
    read once a round;
  * each slot draws one gumbel row a step from its request's own
    torch.Generator (or replays given draws), and each slot has its own
    sampler settings and token cap, so a row's tokens are a function of its
    own request, whatever its slot-mates.

Turbo / Nano (GPT-2): one row a request. The 520M / multilingual CFG family
(cfg=True): slot i owns the cond row i and the uncond row S + i, the uncond
row with the same conditioning and zeroed text embeddings, both fed the same
sampled token; the history is BOS-seeded, as the batched engine's.

`ContinuousTTSServer` is the host loop over the slots: submit at any time;
pending requests are admitted at the next round, finished rows harvested
(their tokens, and one batched vocode of the finished rows, models/s3gen/
model.py `inference_batch_dispatch`) from the round's status snapshot, and
streaming requests fed to a StreamingVocoder at fixed token counts as their
row decodes. The slot cache starts small and doubles as rows advance
(`grow_slot_cache`); the default bf16 cache is read whole every step, so its
size bounds that read.

Speculative rounds (`decode_chunk_multi_spec`, `ContinuousTTSServer(
draft_int8=True)`, Turbo only): the model's own int8 weights draft K tokens
a row (B1 / B2 on int8_fused layers), one bf16 forward of the (K+1)-token
slab at each row's offset verifies them (`backbone_slab_rows`), and a
draft is accepted when it equals the token the target samples there, so
the tokens are draft-off's. JAX reaches that by splitting each row's key
chain once a token and advancing it by the tokens a round emits. A
torch.Generator cannot hand a draw back, and how many tokens a round emits
is known only on the device, so the port draws by absolute step instead:
before a dispatch the host draws each slot's rows, in order, one (V,) row a
draw as `_draws` draws them, up to its upper bound of the slot's step plus
the dispatch's tokens, into a per-slot table on the device
(`SlotStates.draw_table`, (S, cap, V) float32: 210 MB at 8 slots, a
1000-token cap and V = 6563); position j of a round reads the row at step
+ j, in the draft and the verify alike. Rows drawn and not yet used stay
for later rounds and are never drawn again, so the s-th draw of a request's
generator samples its token s, as in draft-off.

Not here: `warmup` (XLA's compile walk of the growth schedule).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels.decode_attention import TT
from ..kernels.fused_layer import MAX_B
from ..models.s3gen.model import SIL_TOKEN, SPEECH_VOCAB_SIZE
from ..models.t3 import backbone as bb
from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..nn import core as nn
from ..ops import sampling as S
from ..serve.batching import drop_invalid_tokens_sliced, vocode_seed
from ..serve.streaming import PRE_LOOKAHEAD_LEN, StreamingVocoder
from ..utils.quantize import best_serving_mode, is_quantized, quantize_t3_backbone

_SAMPLER_FIELDS = tuple(f.name for f in dataclasses.fields(S.SamplerParams))


@dataclasses.dataclass
class SlotStates:
    cache: object                # bb.KVCache / bb.KVCacheInt8, (L, Sp, H, T, hd); Sp = 2S for CFG
    logits: torch.Tensor         # (Sp, V) f32
    seen: torch.Tensor           # (S, V) bool repetition history
    step: torch.Tensor           # (S,) long tokens generated
    done: torch.Tensor           # (S,) bool: EOS or the row's cap reached
    active: torch.Tensor         # (S,) bool: slot occupied
    prefix_lens: torch.Tensor    # (S,) long dense prefix length
    max_new: torch.Tensor        # (S,) long per-row token cap
    tokens: torch.Tensor         # (S, cap) long generated tokens, stop-token filled
    temperature: torch.Tensor    # (S,) f32 per-row sampler settings
    top_p: torch.Tensor
    repetition_penalty: torch.Tensor
    min_p: torch.Tensor
    cfg_weight: torch.Tensor
    generators: list             # S torch.Generators (None: empty slot or replayed draws)
    gumbel: list                 # S replayed (cap, V) draws (None: drawn from the generator)
    n_drawn: list                # S host counts: rows of the slot in draw_table
    draw_table: Optional[torch.Tensor] = None   # (S, cap, V) f32, row s: the draw of step s

    @property
    def n_slots(self) -> int:
        return self.seen.shape[0]


def init_slots(hp: T3Config, n_slots: int, text_bucket: int, max_new_tokens: int,
               t_cap: Optional[int] = None, cfg: bool = False, kv_int8: bool = False,
               device="cuda") -> SlotStates:
    """Empty slots. t_cap: the cache's first capacity (rows are left-aligned
    at offset 0, so it can start small and grow: grow_slot_cache); default
    the longest prefix plus max_new_tokens. cfg lays out two rows a slot
    (cond [0, S), uncond [S, 2S)). kv_int8: the int8 cache, its time axis
    rounded up to the decode-attention tile so B4 takes it."""
    t_max = t_cap or (t3m.cond_len(hp) + text_bucket + (2 if cfg else 1) + max_new_tokens)
    cache_cls = bb.KVCache
    if kv_int8:
        t_max = -(-t_max // TT) * TT
        cache_cls = bb.KVCacheInt8
    V = hp.speech_tokens_dict_size
    Sp = 2 * n_slots if cfg else n_slots
    z = lambda dt, fill=0: torch.full((n_slots,), fill, dtype=dt, device=device)
    return SlotStates(
        cache=cache_cls.zeros(hp.backbone, Sp, t_max, device),
        logits=torch.zeros((Sp, V), device=device),
        seen=torch.zeros((n_slots, V), dtype=torch.bool, device=device),
        step=z(torch.long), done=z(torch.bool, True), active=z(torch.bool),
        prefix_lens=z(torch.long), max_new=z(torch.long),
        tokens=torch.zeros((n_slots, max_new_tokens), dtype=torch.long, device=device),
        temperature=z(torch.float32, 1.0), top_p=z(torch.float32, 1.0),
        repetition_penalty=z(torch.float32, 1.0), min_p=z(torch.float32),
        cfg_weight=z(torch.float32),
        generators=[None] * n_slots, gumbel=[None] * n_slots, n_drawn=[0] * n_slots)


def _cache_fields(cache) -> tuple:
    if isinstance(cache, bb.KVCacheInt8):
        return cache.k_q, cache.v_q, cache.k_s, cache.v_s
    return cache.k, cache.v


@torch.no_grad()
def admit(params: dict, hp: T3Config, state: SlotStates, slot: int,
          cond: t3m.T3CondTensors, text_tokens: torch.Tensor, *,
          generator: Optional[torch.Generator] = None,
          gumbel: Optional[torch.Tensor] = None, max_new: int,
          temperature: float, top_p: float, repetition_penalty: float,
          min_p: float = 0.0, cfg_weight: float = 0.0,
          cfg_mode: bool = False) -> SlotStates:
    """Prefill one request and install it in `slot` (CFG: rows slot and
    S + slot), in place. cond: batch-1 conditioning; text_tokens (1, n)
    long, unpadded (SOT/EOT-framed for CFG). The prefix is [cond | text |
    BOS], with the BOS twice for CFG and the uncond row's text embeddings
    zeroed, run at its exact length into a cache of the slot cache's type.
    generator draws the slot's gumbel rows; gumbel (cap, V) replays given
    draws instead, row s at the slot's step s."""
    cfg = hp.backbone
    dev = params["speech_emb"]["w"].device
    dt = params["speech_emb"]["w"].dtype
    Sn = state.n_slots
    B, n_bos = (2, 2) if cfg_mode else (1, 1)
    ce = torch.cat([p.to(dt) for p in t3m.cond_embeds(params, hp, cond)], dim=1)
    te = t3m.text_embeds(params, hp, text_tokens.to(dev)).to(dt)
    if cfg_mode:
        ce = torch.cat([ce, ce])
        te = torch.cat([te, torch.zeros_like(te)])
    bos = t3m.speech_embed_token(
        params, hp, torch.full((B,), hp.start_speech_token, device=dev), 0).to(dt)
    x = torch.cat([ce, te] + [bos] * n_bos, dim=1)
    P = x.shape[1]
    if P > state.cache.max_len:
        raise ValueError(f"a prefix of {P} positions exceeds the slot cache's "
                         f"{state.cache.max_len}")
    mini = type(state.cache).zeros(cfg, B, P, dev)
    hidden = bb.backbone_apply(params["backbone"], cfg, x,
                               torch.arange(P, device=dev)[None].expand(B, -1), mini, 0)
    logits0 = t3m.speech_logits(params, hidden[:, -1]).float()
    rows = [slot, Sn + slot] if cfg_mode else [slot]
    for f_all, f_mini in zip(_cache_fields(state.cache), _cache_fields(mini)):
        for j, r in enumerate(rows):
            f_all[:, r, :, :P] = f_mini[:, j]
    state.logits[rows] = logits0
    state.seen[slot] = False
    if cfg_mode:
        state.seen[slot, hp.start_speech_token] = True
    state.step[slot] = 0
    state.done[slot] = False
    state.active[slot] = True
    state.prefix_lens[slot] = P
    state.max_new[slot] = int(max_new)
    state.tokens[slot] = hp.stop_speech_token
    for name, v in zip(_SAMPLER_FIELDS, (temperature, top_p, repetition_penalty, min_p,
                                         cfg_weight)):
        getattr(state, name)[slot] = float(v)
    state.generators[slot] = generator
    state.gumbel[slot] = None if gumbel is None else gumbel.to(dev)
    state.n_drawn[slot] = 0
    return state


def _draws(state: SlotStates, V: int, wpos: torch.Tensor, dev) -> torch.Tensor:
    """This step's gumbel rows (S, V): a row from each slot's generator, or
    its replayed row at the slot's step; zeros for an empty slot."""
    rows = []
    for i, (gen, rep) in enumerate(zip(state.generators, state.gumbel)):
        if rep is not None:
            rows.append(rep.index_select(0, wpos[i:i + 1])[0])
        elif gen is not None:
            rows.append(S.gumbel((V,), gen, dev))
        else:
            rows.append(torch.zeros((V,), device=dev))
    return torch.stack(rows)


@torch.no_grad()
def decode_chunk_multi(params: dict, hp: T3Config, state: SlotStates, *, n_steps: int,
                       top_k: int = 1000, fused_attn: bool = False,
                       cfg_mode: bool = False) -> SlotStates:
    """Advance every running slot by n_steps tokens (fewer where a row hits
    EOS or its cap: it is then frozen), in place, reading nothing on the
    host. cfg_mode: the CFG chain (combine -> rep -> temp -> min_p ->
    top_p) over the row pairs; otherwise Turbo's (temp -> top_k -> top_p ->
    rep, the start token penalized at step 0). The int8 slot cache is read
    by B4 (MHA heads) with each row's position as its `cur`."""
    cfg = hp.backbone
    Sn = state.n_slots
    V = hp.speech_tokens_dict_size
    dev = state.logits.device
    cap = state.tokens.shape[1]
    T = state.cache.max_len
    stop = hp.stop_speech_token
    fused_attn = fused_attn or isinstance(state.cache, bb.KVCacheInt8)
    sp = S.SamplerParams(*[getattr(state, f)[:, None] for f in _SAMPLER_FIELDS])
    tile2 = (lambda a: torch.cat([a, a])) if cfg_mode else (lambda a: a)
    rows = torch.arange(Sn, device=dev)
    start_col = torch.arange(V, device=dev) == hp.start_speech_token
    n_spos = params["speech_pos_emb"]["w"].shape[0] if hp.input_pos_emb == "learned" else 0
    for _ in range(n_steps):
        running = state.active & ~state.done
        if cfg_mode:
            l = S.process_logits_cfg(state.logits[:Sn], state.logits[Sn:], state.seen, sp)
        else:
            pen = state.seen | (start_col[None] & (state.step == 0)[:, None])
            l = S.process_logits_turbo(state.logits, pen, sp, top_k)
        wpos = state.step.clamp(max=cap - 1)
        tok = S.sample_categorical(l, _draws(state, V, wpos, dev))
        tok = torch.where((l <= S.NEG_INF).all(-1) | ~running, stop, tok)
        state.tokens[rows, wpos] = torch.where(running, tok, state.tokens[rows, wpos])
        state.seen[rows, tok] = running | state.seen[rows, tok]
        step = torch.where(running, state.step + 1, state.step)
        state.done = state.done | (running & ((tok == stop) | (step >= state.max_new)))
        # a frozen row still runs (fixed shapes); its writes stay in its own
        # rows, clamped in bounds, and its logits are kept
        spos = step.clamp(max=n_spos - 1) if n_spos else step
        emb = t3m.speech_embed_token(params, hp, tile2(tok), tile2(spos))
        pos = tile2((state.prefix_lens + state.step).clamp(max=T - 1))
        hidden = bb.backbone_step_rows(params["backbone"], cfg, emb, pos, state.cache,
                                       fused_attn=fused_attn)
        logits = t3m.speech_logits(params, hidden[:, 0]).float()
        state.logits = torch.where(tile2(running)[:, None], logits, state.logits)
        state.step = step
    return state


def fill_draws(state: SlotStates, upto) -> None:
    """Extend each occupied slot's rows in `state.draw_table` to its first
    min(upto[i], cap) steps (made on first use): the next rows of its
    generator, one (V,) row a draw in order as `_draws` draws them, or its
    replayed rows. Rows already there stay."""
    Sn, cap = state.tokens.shape
    V = state.logits.shape[1]
    dev = state.logits.device
    if state.draw_table is None:
        state.draw_table = torch.zeros((Sn, cap, V), device=dev)
    for i, (gen, rep) in enumerate(zip(state.generators, state.gumbel)):
        have, n = state.n_drawn[i], min(int(upto[i]), cap)
        if n <= have or (gen is None and rep is None):
            continue
        if rep is not None:
            state.draw_table[i, have:n] = rep[have:n]
        else:
            state.draw_table[i, have:n] = torch.stack(
                [S.gumbel((V,), gen, dev) for _ in range(have, n)])
        state.n_drawn[i] = n


def nn_embed_slab(params: dict, hp: T3Config, slab: torch.Tensor,
                  step: torch.Tensor) -> torch.Tensor:
    """Embed a (S, s) slab of speech tokens whose row r, position j sits at
    speech index step[r] + j (token t is embedded at index t + 1, and slab
    position j holds token step - 1 + j); learned indices past the table's
    last clamp to it, as the decode's do. Returns (S, s, D) in the
    embedding's type."""
    emb = nn.embedding(params["speech_emb"], slab)
    if hp.input_pos_emb == "learned":
        w = params["speech_pos_emb"]["w"]
        idx = (step[:, None] + torch.arange(slab.shape[1], device=slab.device)
               ).clamp(max=w.shape[0] - 1)
        emb = emb + w[idx]
    return emb.to(params["speech_emb"]["w"].dtype)


@torch.no_grad()
def decode_chunk_multi_spec(params: dict, qparams: dict, hp: T3Config, state: SlotStates,
                            *, n_rounds: int, n_draft: int = 8, top_k: int = 1000,
                            step_bound=None) -> SlotStates:
    """n_rounds speculative rounds over every running row (Turbo's chain),
    in place, reading nothing on the host. A round: slab position 0
    re-feeds the row's last token (BOS at step 0, which rewrites its
    prefill position); K = n_draft single-token draft steps on `qparams`
    (the int8 self-draft: B1 / B2 on int8_fused layers); one forward of
    the (K+1)-token slab on `params` (`backbone_slab_rows`), writing its
    K / V over the draft's; then position j's token y_j is sampled from the
    verify logits with the row's draw of step + j, the same draw the draft
    used there. Drafts are accepted while they equal y; the row emits y up
    to the first mismatch (at least one token), its first EOS or its cap.
    Penalties: position j sees the row's history and drafts 0..j-1, and at
    step 0 the start token. The draws come from `state.draw_table`, filled
    here up to step_bound[i] + n_rounds * (K+1) for each slot (step_bound:
    host upper bounds of the slots' steps; default the cap). The bf16
    cache only, whose rows the host sizes for prefix + step + K."""
    if isinstance(state.cache, bb.KVCacheInt8):
        raise ValueError("speculative rounds verify into the bf16 slot cache")
    cfg = hp.backbone
    Sn = state.n_slots
    V = hp.speech_tokens_dict_size
    K = n_draft
    dev = state.logits.device
    cap = state.tokens.shape[1]
    T = state.cache.max_len
    stop = hp.stop_speech_token
    adv = n_rounds * (K + 1)
    fill_draws(state, [cap] * Sn if step_bound is None else [b + adv for b in step_bound])
    sp = S.SamplerParams(*[getattr(state, f)[:, None] for f in _SAMPLER_FIELDS])
    sp3 = S.SamplerParams(*[getattr(state, f)[:, None, None] for f in _SAMPLER_FIELDS])
    rows = torch.arange(Sn, device=dev)
    j_all = torch.arange(K + 1, device=dev)
    start_col = torch.arange(V, device=dev) == hp.start_speech_token
    n_spos = qparams["speech_pos_emb"]["w"].shape[0] if hp.input_pos_emb == "learned" else 0
    for _ in range(n_rounds):
        step = state.step
        running = state.active & ~state.done
        g = state.draw_table[rows[:, None], (step[:, None] + j_all).clamp(max=cap - 1)]
        prev = state.tokens[rows, (step - 1).clamp(0, cap - 1)]
        tok = torch.where(step == 0, hp.start_speech_token, prev)
        # the slab's base position; an empty slot's (-1) clamps to 0
        pos0 = (state.prefix_lens + step - 1).clamp(0, T - 1 - K)
        slab, pens = [tok], []
        seen = state.seen.clone()
        for j in range(K):
            spos = step + j
            emb = t3m.speech_embed_token(qparams, hp, tok,
                                         spos.clamp(max=n_spos - 1) if n_spos else spos)
            hidden = bb.backbone_step_rows(qparams["backbone"], cfg, emb, pos0 + j,
                                           state.cache)
            pen = seen | (start_col[None] & (spos == 0)[:, None])
            l = S.process_logits_turbo(t3m.speech_logits(qparams, hidden[:, 0]).float(),
                                       pen, sp, top_k)
            tok = S.sample_categorical(l, g[:, j])
            tok = torch.where((l <= S.NEG_INF).all(-1), stop, tok)
            # scatter_ takes True as an argument; an indexed write of it would
            # copy it from the host, a synchronising call
            seen.scatter_(1, tok[:, None], True)
            slab.append(tok)
            pens.append(pen)
        pens.append(seen)
        slab = torch.stack(slab, 1)                                   # (S, K+1)
        hidden = bb.backbone_slab_rows(params["backbone"], cfg,
                                       nn_embed_slab(params, hp, slab, step), pos0,
                                       state.cache)
        l = S.process_logits_turbo(t3m.speech_logits(params, hidden).float(),
                                   torch.stack(pens, 1), sp3, top_k)  # (S, K+1, V)
        y = S.sample_categorical(l, g)
        y = torch.where((l <= S.NEG_INF).all(-1), stop, y)
        # accept by token match; stop at the first EOS or the row's cap
        match = y[:, :K] == slab[:, 1:]
        n_match = torch.where(match.all(1), K, (~match).int().argmax(1))
        is_stop = (y == stop) & (j_all[None] <= n_match[:, None])
        n_s = torch.where(is_stop.any(1), is_stop.int().argmax(1) + 1, n_match + 1)
        n_emit = torch.where(running, torch.minimum(n_s, (state.max_new - step).clamp(min=1)),
                             0)
        emitted = j_all[None] < n_emit[:, None]                       # (S, K+1)
        state.done = state.done | (running & ((is_stop & emitted).any(1)
                                              | (step + n_emit >= state.max_new)))
        for j in range(K + 1):
            wpos = (step + j).clamp(max=cap - 1)
            state.tokens[rows, wpos] = torch.where(emitted[:, j], y[:, j],
                                                   state.tokens[rows, wpos])
        hits = torch.zeros((Sn, V), dtype=torch.int32, device=dev)
        hits.scatter_add_(1, y, emitted.int())
        state.seen = state.seen | (hits > 0)
        state.step = step + n_emit
    return state


def pack_status(state: SlotStates) -> torch.Tensor:
    """Everything the host scheduler reads, as one long tensor on the
    device: [done (S) | active (S) | step (S) | tokens (S * cap)]."""
    return torch.cat([state.done.long(), state.active.long(), state.step,
                      state.tokens.reshape(-1)])


def grow_slot_cache(state: SlotStates, *, new_t_cap: int) -> SlotStates:
    """The slot cache's time axis padded to new_t_cap (rounded up to the
    decode-attention tile for the int8 cache); rows are left-aligned, so
    their K/V stay where they are."""
    if isinstance(state.cache, bb.KVCacheInt8):
        new_t_cap = -(-new_t_cap // TT) * TT
    pad = new_t_cap - state.cache.max_len
    if pad < 0:
        raise ValueError(f"cannot shrink the slot cache to {new_t_cap}")
    grown = [torch.nn.functional.pad(f, (0, 0, 0, pad)) for f in _cache_fields(state.cache)]
    state.cache = type(state.cache)(*grown)
    return state


class _SlotStream:
    """A streaming slot's state: a StreamingVocoder fed at fixed counts of
    valid tokens (the first feed at `first_chunk`, then every
    `stream_chunk`; the final feed the remainder and, for Turbo, 3 silence
    tokens), so its audio is a function of the row's tokens alone."""

    __slots__ = ("voc", "cb", "fed_raw", "buf", "next_feed", "n_valid", "first_fed")

    def __init__(self, voc, cb, first_chunk: int):
        self.voc = voc
        self.cb = cb                   # cb(chunk: np.ndarray, final: bool)
        self.fed_raw = 0               # raw tokens taken from the slot's row
        self.buf = np.zeros((0,), np.int32)   # valid tokens awaiting a feed
        self.next_feed = first_chunk   # the next feed's size
        self.n_valid = 0               # valid tokens seen
        self.first_fed = False         # the first audio delivered


class ContinuousTTSServer:
    """The host loop over the slots: submit at any time; requests join at
    the next round and are harvested as soon as their row finishes.

    Streaming requests (`submit(req, on_chunk=...)`) get their audio pushed
    while their slot decodes: each round's status snapshot carries every
    row's tokens, so new tokens feed the request's StreamingVocoder with no
    further read of the decode."""

    def __init__(self, t3_params, hp: T3Config, n_slots: int = 8, text_bucket: int = 64,
                 max_new_tokens: int = 1000, chunk: int = 16, top_k: int = 1000,
                 seed: int = 0, s3gen=None, cfg: bool = False, kv_int8: bool = False,
                 stream_chunk: int = 25, first_chunk: Optional[int] = None,
                 draft_int8: bool = False, n_draft: int = 8):
        """cfg serves the 520M / multilingual CFG family (two rows a slot;
        text arrives SOT/EOT-framed). stream_chunk: tokens a streaming feed
        (25: a second of audio). first_chunk (default stream_chunk): the
        size of a stream's first feed; while a stream has delivered no
        audio yet, rounds shorten to first_chunk steps. The token content
        never depends on round lengths, only when the host sees it. A full
        slot set on fused int8 layers must fit the kernels' MAX_B rows.

        draft_int8: speculative rounds (`decode_chunk_multi_spec`): the
        float T3's own weights quantized with `best_serving_mode` draft
        n_draft tokens a row and round, one forward of the float T3
        verifies them; the tokens stay draft-off's. Turbo on the bf16
        cache only. It pays at low occupancy; a full slot set already
        shares each weight read among its rows."""
        self.t3_params = t3_params
        self.hp = hp
        self.n_slots = n_slots
        self.text_bucket = text_bucket
        self.max_new_tokens = max_new_tokens
        self.chunk = chunk
        self.top_k = top_k
        self.s3gen = s3gen
        self.cfg = cfg
        self.kv_int8 = kv_int8
        self.stream_chunk = stream_chunk
        self.first_chunk = first_chunk or stream_chunk
        if not PRE_LOOKAHEAD_LEN < self.first_chunk <= stream_chunk:
            # a first feed within the vocoder's lookahead yields no audio
            raise ValueError(f"first_chunk {self.first_chunk} must lie in "
                             f"({PRE_LOOKAHEAD_LEN}, stream_chunk={stream_chunk}]")
        rows = 2 * n_slots if cfg else n_slots
        if "fused" in t3_params["backbone"]["layers"][0] and rows > MAX_B:
            raise ValueError(f"{n_slots} slots are {rows} rows; the fused decode-layer "
                             f"kernels take at most {MAX_B}")
        self.draft = draft_int8
        self.n_draft = n_draft
        self._qparams = None
        if draft_int8:
            if cfg:
                raise ValueError("speculative rounds cover the Turbo chain only, not cfg")
            if kv_int8:
                raise ValueError("speculative rounds verify into the bf16 slot cache, "
                                 "not kv_int8")
            if is_quantized(t3_params):
                raise ValueError("draft_int8 needs the float T3 as the verify target; "
                                 "these params are already quantized")
            self._qparams = quantize_t3_backbone(t3_params,
                                                 mode=best_serving_mode(hp.backbone))
        self.device = t3_params["speech_emb"]["w"].device
        self._cap_base = t3m.cond_len(hp) + text_bucket + (2 if cfg else 1)
        # a spec round's slab may overhang the last emitted token by K positions
        self._t_full = self._cap_base + max_new_tokens + (n_draft + 1 if draft_int8 else 0)
        self._t_cap = min(self._t_full, self._cap_base + max(4 * chunk, 16))
        self.state = init_slots(hp, n_slots, text_bucket, max_new_tokens, t_cap=self._t_cap,
                                cfg=cfg, kv_int8=kv_int8, device=self.device)
        self._slot_bound = [0] * n_slots   # host upper bound of prefix + step a slot
        self._slot_prefix = [0] * n_slots  # each slot's prefix length
        self._fresh: set = set()           # slots admitted after the lagged snapshot
        self._seeds = np.random.default_rng(seed)   # seeds of unseeded requests
        self._pending: list = []           # (request, on_chunk) first in, first out
        self._slot_req: list = [None] * n_slots
        self._slot_stream: list = [None] * n_slots
        self.results: dict = {}            # request_id -> token array
        self.wavs: dict = {}               # request_id -> waveform (when vocoding)
        self._voc_pending = None           # (request ids, vocode handle)
        self._await_wav: set = set()       # harvested, audio not read back yet
        self._lagged = None                # serve_round's snapshot of the last round
        self.rounds = 0                    # decode rounds dispatched (a host read each)
        self.decode_steps = 0              # their steps (each runs every slot's row);
                                           # with draft_int8 the draft steps
        self.tokens_emitted = 0            # tokens of the finished requests' results
        self.spec_rounds = 0               # speculative rounds (a verify each)

    # ------------------------------------------------------------------
    def submit(self, req, on_chunk=None) -> None:
        """req: serve.batching.TTSRequest. on_chunk makes it a streaming
        request: on_chunk(chunk float32 numpy, final) is called as its audio
        is made, every stream_chunk tokens (the first after first_chunk);
        the last call has final=True (its chunk may be empty). A stream
        needs an s3gen engine and req.ref. For the CFG family a token is
        final as soon as it exists (the row stops at its first EOS and
        specials are dropped), so a stream's tokens and audio keep tokens
        before a stray mid-stream SOS that the sliced tail would drop."""
        if on_chunk is not None:
            if self.s3gen is None:
                raise ValueError("streaming requests need an s3gen engine")
            if getattr(req, "ref", None) is None:
                raise ValueError("streaming requests need req.ref (the voice's RefDict)")
        self._pending.append((req, on_chunk))

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        if seed is None:
            seed = int(self._seeds.integers(2**62))
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _admit_pending(self):
        for slot in range(self.n_slots):
            if not self._pending:
                break
            if self._slot_req[slot] is not None:
                continue
            req, on_chunk = self._pending.pop(0)
            ids = np.asarray(req.text_tokens).reshape(-1)[:self.text_bucket]
            spr = req.sampler
            # the pipelines' defaults: CFG top_p 1.0, min_p 0.05, w 0.5; Turbo 0.95, 0, 0
            top_p, min_p, cfg_w = (1.0, 0.05, 0.5) if self.cfg else (0.95, 0.0, 0.0)
            admit(self.t3_params, self.hp, self.state, slot,
                  req.cond.as_tensors(self.device),
                  torch.as_tensor(ids[None], dtype=torch.long, device=self.device),
                  generator=self._generator(req.seed),
                  max_new=min(req.max_new or self.max_new_tokens, self.max_new_tokens),
                  temperature=spr.temperature if spr else 0.8,
                  top_p=spr.top_p if spr else top_p,
                  repetition_penalty=spr.repetition_penalty if spr else 1.2,
                  min_p=spr.min_p if spr else min_p,
                  cfg_weight=spr.cfg_weight if spr else cfg_w, cfg_mode=self.cfg)
            self._slot_req[slot] = req
            self._fresh.add(slot)
            self._slot_prefix[slot] = t3m.cond_len(self.hp) + len(ids) + (2 if self.cfg else 1)
            self._slot_bound[slot] = self._slot_prefix[slot]
            if on_chunk is not None:
                # the vocoder's generator: from the request's seed, apart from
                # its decode's, as the batched vocode derives it
                gen = self._generator(None if req.seed is None else vocode_seed(req.seed))
                self._slot_stream[slot] = _SlotStream(
                    StreamingVocoder(self.s3gen, req.ref, gen), on_chunk, self.first_chunk)

    def _flush_vocode(self):
        """Read back the previous round's batched vocode."""
        if self._voc_pending is None:
            return
        rids, handle = self._voc_pending
        self._voc_pending = None
        for rid, w in zip(rids, self.s3gen.inference_batch_fetch(handle)):
            self.wavs[rid] = w

    def _pop_blocks(self, st: _SlotStream) -> list:
        """The whole feed blocks buffered now (first_chunk, then stream_chunk)."""
        blocks = []
        while len(st.buf) >= st.next_feed:
            blocks.append(st.buf[:st.next_feed])
            st.buf = st.buf[st.next_feed:]
            st.next_feed = self.stream_chunk
        return blocks

    def _stream_feed(self, done, steps, tokens, skip=()) -> list:
        """Take each stream's new tokens from the round's snapshot and
        collect its due feed blocks; a done row's blocks are collected by
        _finish_feeds in the same harvest. Returns (stream, block, final)
        feeds for _run_feeds."""
        feeds = []
        for i in range(self.n_slots):
            st = self._slot_stream[i]
            if st is None or self._slot_req[i] is None or i in skip:
                continue
            avail = int(steps[i])
            if avail > st.fed_raw:
                raw = tokens[i, st.fed_raw:avail]
                st.fed_raw = avail
                valid = raw[raw < SPEECH_VOCAB_SIZE].astype(np.int32)
                st.n_valid += len(valid)
                st.buf = np.concatenate([st.buf, valid])
            if done[i]:
                continue
            feeds += [(st, blk, False) for blk in self._pop_blocks(st)]
        return feeds

    def _finish_feeds(self, st: _SlotStream) -> list:
        """The feeds that retire a finished stream: its whole blocks, then the
        final feed: the remainder and 3 silence tokens for Turbo; for CFG the
        remainder alone, or one silence token when the stream had no valid
        token (the CFG tail's fallback)."""
        feeds = [(st, blk, False) for blk in self._pop_blocks(st)]
        if self.cfg:
            tail = st.buf if st.n_valid else np.full(1, SIL_TOKEN, np.int32)
        else:
            tail = np.concatenate([st.buf, np.full(3, SIL_TOKEN, np.int32)])
        feeds.append((st, tail, True))
        return feeds

    def _run_feeds(self, feeds):
        """Queue every feed's vocode (a stream's blocks in order), then read
        the audio back: one read for all of them, or, while a stream in
        the batch still waits for its first audio, one read a feed in
        order, so each callback fires as soon as its own audio is back."""
        if not feeds:
            return
        handles = [st.voc.feed_dispatch(blk, final=final) for st, blk, final in feeds]

        def deliver(st, final, audio):
            if len(audio) or final:
                if len(audio):
                    st.first_fed = True
                st.cb(audio, final)

        if any(not st.first_fed for st, _, _ in feeds):
            for (st, _, final), h in zip(feeds, handles):
                deliver(st, final, st.voc.feed_fetch(h))
            return
        dev = [h[0].reshape(-1).float() for h in handles if isinstance(h, tuple)]
        host = iter(torch.cat(dev).cpu().split([t.numel() for t in dev]) if dev else ())
        for (st, _, final), h in zip(feeds, handles):
            if isinstance(h, tuple):
                h = (next(host), h[1])
            deliver(st, final, st.voc.feed_fetch(h))

    def _harvest(self, status: Optional[np.ndarray] = None, skip=()) -> list:
        """Retire the finished rows of a pack_status snapshot (fetched here
        when None; a snapshot one round old harvests the same, since a done
        row's step and tokens no longer change). skip: slots admitted after
        the snapshot was taken, whose entries still show the slot's previous
        request."""
        if status is None:
            status = pack_status(self.state).cpu().numpy()
        Sn = self.n_slots
        done = status[:Sn].astype(bool)
        active = status[Sn:2 * Sn].astype(bool)
        steps = status[2 * Sn:3 * Sn]
        tokens = status[3 * Sn:].reshape(Sn, -1)
        finished = [i for i in range(Sn) if active[i] and done[i] and i not in skip
                    and self._slot_req[i] is not None]
        self._flush_vocode()
        feeds = self._stream_feed(done, steps, tokens, skip=skip)
        if not finished:
            self._run_feeds(feeds)
            return []
        out, voc_rows, voc_refs, voc_gens, voc_rids = [], [], [], [], []
        for i in finished:
            req = self._slot_req[i]
            t = tokens[i, :steps[i]]
            st = self._slot_stream[i]
            if self.cfg and st is None:
                # the CFG tail: between SOS and EOS; a stream keeps the tokens
                # its audio was made from (see submit)
                t = drop_invalid_tokens_sliced(t)
            t = t[t < SPEECH_VOCAB_SIZE]
            self.results[req.request_id] = t
            self.tokens_emitted += len(t)
            if st is not None:
                feeds += self._finish_feeds(st)
                self._slot_stream[i] = None
            elif self.s3gen is not None and getattr(req, "ref", None) is not None:
                voc_rows.append(t if len(t) else np.zeros((1,), np.int64))
                voc_refs.append(req.ref)
                voc_gens.append(self._generator(
                    None if req.seed is None else vocode_seed(req.seed)))
                voc_rids.append(req.request_id)
            out.append(req.request_id)
            self._slot_req[i] = None
            self._slot_bound[i] = 0
            self.state.active[i] = False
            self.state.generators[i] = self.state.gumbel[i] = None
        if voc_rows:
            # one batched vocode of the rows finished this round, read back
            # next round so the next decode round is not held up
            self._voc_pending = (voc_rids, self.s3gen.inference_batch_dispatch(
                voc_rows, voc_refs, voc_gens))
            self._await_wav.update(voc_rids)
        self._run_feeds(feeds)
        return out

    def _dispatch_round(self) -> bool:
        """Admit pending requests and launch one decode round; False when no
        slot is occupied (nothing launched). While a stream has delivered
        no audio yet, the round is first_chunk steps long, so its first feed
        comes in one round."""
        self._admit_pending()
        if all(r is None for r in self._slot_req):
            return False
        n_steps = self.chunk
        if self.first_chunk < self.chunk and any(
                st is not None and not st.first_fed for st in self._slot_stream):
            n_steps = self.first_chunk
        # speculative rounds emit up to K+1 tokens each: as many rounds as
        # cover the round's steps. The slab's overhang of K positions past
        # the last emitted token is rewritten next round, so it enters the
        # capacity needed but not the slots' bounds.
        K1 = self.n_draft + 1
        n_rounds = -(-n_steps // K1) if self.draft else 0
        adv = n_rounds * K1 if self.draft else n_steps
        over = self.n_draft if self.draft else 0
        # grow the cache to cover every slot's next round, doubling; a done
        # but unharvested slot's bound may pass the full capacity
        needed = min(max(self._slot_bound) + adv + over, self._t_full)
        if needed > self._t_cap:
            new_cap = self._t_cap
            while new_cap < needed:
                new_cap = min(self._t_full, self._cap_base + 2 * (new_cap - self._cap_base))
            grow_slot_cache(self.state, new_t_cap=new_cap)
            self._t_cap = new_cap
        if self.draft:
            decode_chunk_multi_spec(
                self.t3_params, self._qparams, self.hp, self.state, n_rounds=n_rounds,
                n_draft=self.n_draft, top_k=self.top_k,
                step_bound=[b - p for b, p in zip(self._slot_bound, self._slot_prefix)])
            self.spec_rounds += n_rounds
            self.decode_steps += n_rounds * self.n_draft
        else:
            decode_chunk_multi(self.t3_params, self.hp, self.state, n_steps=n_steps,
                               top_k=self.top_k, cfg_mode=self.cfg)
            self.decode_steps += n_steps
        self.rounds += 1
        for i in range(self.n_slots):
            if self._slot_req[i] is not None:
                self._slot_bound[i] += adv
        return True

    def step(self) -> list:
        """One scheduling round: admit, decode a round, harvest from a fresh
        snapshot. Returns the request ids finished this round."""
        if not self._dispatch_round():
            return []
        out = self._harvest()
        self._fresh.clear()
        return out

    def _snapshot(self):
        """pack_status with its copy to the host started now, behind this
        round's work: (host tensor, event); read it with _read."""
        dev = pack_status(self.state)
        if dev.device.type != "cuda":
            return dev.clone(), None
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _read(snap) -> np.ndarray:
        host, ev = snap
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    def serve_round(self) -> bool:
        """One overlapped round for a driver thread (ContinuousServingLoop):
        launch a decode round (admitting first), then harvest the PREVIOUS
        round from its snapshot, whose copy to the host was queued behind
        that round; the only cost is that a finished slot is re-admitted a
        round later. Returns True while work is in flight; on False the
        server is idle and every result (and wav) is on the host."""
        status = self._snapshot() if self._dispatch_round() else None
        if self._lagged is not None:
            # the lagged snapshot still shows the previous occupant of a slot
            # admitted since: skip those slots
            self._harvest(self._read(self._lagged), skip=self._fresh)
        self._lagged = status
        self._fresh = set()
        idle = status is None and not self._pending and all(
            r is None for r in self._slot_req)
        if idle:
            self.flush_vocode()
        return not idle

    def run_until_idle(self, max_rounds: int = 10_000) -> dict:
        """Drive serve_round until every submitted request has finished."""
        for _ in range(max_rounds):
            if not self.serve_round():
                break
        self.flush_vocode()
        return self.results

    def flush_vocode(self) -> None:
        """Read back any deferred vocode batch."""
        if self.s3gen is not None:
            self._flush_vocode()

    def pop_ready(self) -> list:
        """Pop the finished requests whose outputs are on the host, as
        (request_id, tokens, wav or None); a vocoded request is ready once
        its audio has been read back (a round after its tokens)."""
        out = []
        for rid in list(self.results):
            if rid in self._await_wav and rid not in self.wavs:
                continue
            out.append((rid, self.results.pop(rid), self.wavs.pop(rid, None)))
            self._await_wav.discard(rid)
        return out
