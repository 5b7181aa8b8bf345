"""Speculative T3 decode: a draft model proposes K tokens, the target
verifies them in one forward (the counterpart of
chatterbox_tpu/sampling/speculative.py `t3_generate_speculative`).

A weight-bound decode step costs about the same for 1 token as for K+1, so
verifying a draft of K tokens costs about one target step and emits up to
K+1 tokens. Turbo and Nano share the speech-token space and the GPT-2 text
tokenizer; Turbo's own weights quantized int8 are the other draft
(`ChatterboxTurboTTS.generate(draft="int8")`).

Standard speculative sampling: accept draft token d_i with probability
min(1, p(d_i) / q(d_i)), on the first rejection resample from
max(p - q, 0) (from p where rounding leaves that empty), and on full
acceptance sample a bonus token from the target's last row. p and q are
the Turbo sampler chain's processed distributions (temperature, top_k,
top_p, repetition penalty), with the repetition history each position
would have in the sequential loop, so the output distribution is exactly
the target's; greedy (top_k=1) gives the sequential decode's tokens.

A round, as in the JAX package:
  * K+1 single-token draft steps: step i feeds token i of
    [pending, d_1..d_K] and samples d_{i+1}; step K only writes d_K's KV
    (without it the next round's first draft would attend over an empty
    slot and be rejected once a round);
  * one target forward over the (K+1)-token slab at the pending token's
    position (the backbone's causal mask over the slab);
  * accept / resample, EOS truncation, the bonus token.
Round one feeds the BOS again at its prefill slot, which rewrites the same
KV.

The backbone takes a host cache offset, so each round reads (tokens
emitted, accepted, EOS hit) once on the host; the JAX loop stays on the
device. The random numbers of a round are K draft gumbel rows, K uniforms
and one residual gumbel row, drawn from `generator` or taken from `draws`.
Scope: the Turbo sampler chain (no CFG), as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.t3 import backbone as bb
from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..nn import core as nn
from ..ops import sampling as S
from .decode import prefill


class SpecResult(NamedTuple):
    tokens: torch.Tensor     # (max_new_tokens,) long, stop-token padded
    n_tokens: torch.Tensor   # () long: generated tokens including the EOS
    n_rounds: int            # draft / verify rounds run
    n_drafted: int           # draft tokens proposed (K x rounds)
    n_accepted: int          # draft tokens accepted and emitted


def probs_or_stop(logits: torch.Tensor, stop_token: int) -> torch.Tensor:
    """Softmax of processed logits (..., V); a row with every logit
    filtered away becomes one-hot(stop), as the decode loops stop there."""
    ok = (logits > S.NEG_INF).any(dim=-1, keepdim=True)
    probs = torch.softmax(torch.where(ok, logits, 0.0), dim=-1)
    stop = torch.zeros_like(probs)
    stop[..., stop_token] = 1.0
    return torch.where(ok, probs, stop)


def accept_resample(p: torch.Tensor, q: torch.Tensor, d: torch.Tensor,
                    u: torch.Tensor, g_res: torch.Tensor, stop_token: int):
    """One round's acceptance. p (K+1, V) target and q (K, V) draft
    probabilities, d (K,) the draft tokens, u (K,) uniforms, g_res (V,) the
    residual draw. Returns (row (K+1,) long: the accepted drafts, then the
    resampled or bonus token at n_acc, then stop tokens; n_acc () long),
    on the device."""
    K = d.shape[0]
    idx = torch.arange(K, device=d.device)
    acc = u < p[idx, d] / q[idx, d].clamp(min=1e-30)
    n_acc = torch.where(acc.all(), K, (~acc).to(torch.uint8).argmax())
    q_pad = torch.cat([q, torch.zeros_like(q[:1])])
    resid = (p[n_acc] - q_pad[n_acc]).clamp(min=0.0)
    # a residual that rounding left empty: fall back to the target row
    resid = torch.where(resid.sum() > 0, resid, p[n_acc])
    t_next = S.sample_categorical(torch.log(resid.clamp(min=1e-38)), g_res)
    row = torch.cat([torch.where(idx < n_acc, d, stop_token), d.new_full((1,), stop_token)])
    row = row.index_put((n_acc.view(1),), t_next.view(1))
    return row, n_acc


def _round_draws(draws, r: int, K: int, V: int, generator, device):
    """(draft gumbels (K, V), uniforms (K,), residual gumbel (V,)) of round r."""
    if draws is not None:
        return tuple(x[r].to(device) for x in draws)
    return (S.gumbel((K, V), generator, device),
            torch.rand((K,), generator=generator, device=device),
            S.gumbel((V,), generator, device))


@torch.no_grad()
def t3_generate_speculative(
        params: dict, draft_params: dict, hp: T3Config, hp_draft: T3Config,
        cond: t3m.T3CondTensors, cond_draft: t3m.T3CondTensors,
        text_tokens: torch.Tensor, sp: S.SamplerParams, *,
        max_new_tokens: int = 1000, n_draft: int = 4, top_k: int = 0,
        ignore_eos: bool = False, generator: Optional[torch.Generator] = None,
        draws=None) -> SpecResult:
    """Speculative generation with the Turbo sampler chain (one stream).

    Both models read the same text tokens (1, Lt) (one tokenizer) and build
    their own conditioning prefixes and KV caches, each of prefix +
    max_new_tokens + n_draft + 1 positions (the last slab may run n_draft
    past the budget). The speech vocabulary and its start / stop tokens
    must agree. draws: optional (draft gumbels (R, K, V), uniforms (R, K),
    residual gumbels (R, V)) replayed instead of drawing from `generator`,
    row r for round r (at most max_new_tokens rounds)."""
    if ((hp.speech_tokens_dict_size, hp.start_speech_token, hp.stop_speech_token)
            != (hp_draft.speech_tokens_dict_size, hp_draft.start_speech_token,
                hp_draft.stop_speech_token)):
        raise ValueError("the draft and the target must share the speech vocabulary")
    K, V, stop = n_draft, hp.speech_tokens_dict_size, hp.stop_speech_token
    dev = params["speech_emb"]["w"].device
    budget = max_new_tokens + K + 1
    cache_t, _, P_t = prefill(params, hp, cond, text_tokens, 1, False, budget)
    cache_d, _, P_d = prefill(draft_params, hp_draft, cond_draft, text_tokens, 1, False,
                              budget)
    cfg_t, cfg_d = hp.backbone, hp_draft.backbone
    tokens = torch.full((budget,), stop, dtype=torch.long, device=dev)
    seen = torch.zeros(V, dtype=torch.bool, device=dev)
    pending = torch.tensor(hp.start_speech_token, device=dev)
    steps = torch.arange(K + 1, device=dev)
    step = rounds = accepted = 0
    while step < max_new_tokens:
        g_draft, u, g_res = _round_draws(draws, rounds, K, V, generator, dev)

        # draft: K+1 single-token steps; pens[i] is the history at step i
        tok, seen_loc, pens, drafts, q_rows = pending, seen, [], [], []
        for i in range(K + 1):
            pen = seen_loc
            if step + i == 0:            # the start token, penalized on step 0 only
                pen = seen_loc.clone()
                pen[hp.start_speech_token] = True
            pens.append(pen)
            pos = P_d - 1 + step + i
            emb = t3m.speech_embed_token(draft_params, hp_draft, tok.view(1), step + i)
            hidden = bb.backbone_apply(draft_params["backbone"], cfg_d, emb,
                                       torch.full((1, 1), pos, device=dev), cache_d, pos)
            if i == K:                   # d_K's KV written; no sample
                break
            logits = t3m.speech_logits(draft_params, hidden[:, 0]).float()[0]
            q = probs_or_stop(S.process_logits_turbo(logits, pen, sp, top_k), stop)
            tok = S.sample_categorical(torch.log(q.clamp(min=1e-38)), g_draft[i])
            seen_loc = seen_loc.index_fill(0, tok.view(1), True)
            drafts.append(tok)
            q_rows.append(q)
        d = torch.stack(drafts)

        # verify: one target forward over [pending, d_1..d_K]
        slab = torch.cat([pending.view(1), d])
        emb = nn.embedding(params["speech_emb"], slab[None])
        if hp.input_pos_emb == "learned":
            emb = emb + params["speech_pos_emb"]["w"][step:step + K + 1]
        emb = emb.to(params["speech_emb"]["w"].dtype)
        pos0 = P_t - 1 + step
        hidden = bb.backbone_apply(params["backbone"], cfg_t, emb, (pos0 + steps)[None],
                                   cache_t, pos0)
        logits = t3m.speech_logits(params, hidden[0]).float()                # (K+1, V)
        p = probs_or_stop(S.process_logits_turbo(logits, torch.stack(pens), sp, top_k),
                          stop)

        row, n_acc = accept_resample(p, torch.stack(q_rows), d, u, g_res, stop)
        is_stop = (row == stop) & (steps <= n_acc)
        if ignore_eos:
            hit = torch.zeros((), dtype=torch.bool, device=dev)
            n_emit = n_acc + 1
        else:
            hit = is_stop.any()
            n_emit = torch.where(hit, is_stop.to(torch.uint8).argmax() + 1, n_acc + 1)
        tokens[step:step + K + 1] = row
        n_emit, n_acc, hit = torch.stack([n_emit, n_acc, hit.long()]).tolist()   # one read
        seen = seen.index_fill(0, row[:n_emit], True)
        pending = row[n_emit - 1]
        step += n_emit
        rounds += 1
        accepted += min(n_acc, n_emit)
        if hit:
            break
    n = min(step, max_new_tokens)
    out = tokens[:max_new_tokens].clone()
    out[n:] = stop
    return SpecResult(out, torch.tensor(n, device=dev), rounds, rounds * K, accepted)
