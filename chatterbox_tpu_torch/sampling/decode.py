"""T3 Turbo decode engine: prefill over the dense prefix, then one token at a
time over the preallocated KV cache (the counterpart of
chatterbox_tpu/sampling/decode.py `t3_generate` with cfg_mode=False).

The loop never waits on the device per step: the sampled token stays on the
device, is fed straight into the next step's embedding, and `done` is read
back only every DONE_CHECK_EVERY steps. Tokens sampled after the first EOS are
overwritten with the stop token, so the output equals the JAX engine's
(which stops its while-loop at EOS). One engine serves every budget: the
cache holds exactly prefix + max_new_tokens positions and attention reads
only the filled ones.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.t3 import backbone as bb
from ..nn import core as nn
from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..ops import sampling as S

DONE_CHECK_EVERY = 32     # decode steps between host reads of `done`


class GenResult(NamedTuple):
    tokens: torch.Tensor     # (max_new_tokens,) long, stop-token padded
    n_tokens: torch.Tensor   # () long: generated tokens including the EOS
    n_forward: int           # decode-step forward passes run (host int)


@torch.no_grad()
def t3_generate(params: dict, hp: T3Config, cond: t3m.T3CondTensors,
                text_tokens: torch.Tensor, sp: S.SamplerParams, *,
                max_new_tokens: int = 1000, top_k: int = 0,
                ignore_eos: bool = False,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> GenResult:
    """Generate speech tokens for one utterance (batch 1, no CFG).

    text_tokens: (1, Lt) long, the unpadded text ids.
    gumbel: optional (max_new_tokens, V) draws used instead of drawing from
    `generator` (lets a test replay another engine's random numbers).
    """
    t3m.check_supported(hp)
    cfg = hp.backbone
    dev = params["speech_emb"]["w"].device
    dt = params["speech_emb"]["w"].dtype                      # compute type
    V = hp.speech_tokens_dict_size
    stop = hp.stop_speech_token

    # ---- dense prefix [cond | text | BOS] ---------------------------------
    parts = t3m.cond_embeds(params, hp, cond)
    parts.append(nn.embedding(params["text_emb"], text_tokens))
    bos = torch.full((1, 1), hp.start_speech_token, dtype=torch.long, device=dev)
    parts.append(nn.embedding(params["speech_emb"], bos))
    x = torch.cat([p.to(dt) for p in parts], dim=1)           # (1, P, D)
    P = x.shape[1]

    cache = bb.KVCache.zeros(cfg, 1, P + max_new_tokens, dev)
    positions = torch.arange(P, device=dev)[None]
    hidden = bb.backbone_apply(params["backbone"], cfg, x, positions, cache, 0)
    logits = t3m.speech_logits(params, hidden[:, -1]).float()  # (1, V)

    # ---- token loop ---------------------------------------------------------
    tokens = torch.full((max_new_tokens,), stop, dtype=torch.long, device=dev)
    seen = torch.zeros(V, dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_tokens = torch.full((), max_new_tokens, dtype=torch.long, device=dev)
    stop_t = torch.full((), stop, dtype=torch.long, device=dev)
    n_forward = 0
    for step in range(max_new_tokens):
        pen = seen
        if step == 0:
            # Turbo penalizes the start token on step 0 only, then the
            # generated tokens
            pen = seen.clone()
            pen[hp.start_speech_token] = True
        l = S.process_logits_turbo(logits[0], pen, sp, top_k)
        g = (gumbel[step].to(dev) if gumbel is not None
             else S.gumbel((V,), generator, dev))
        tok = S.sample_categorical(l, g)
        # every logit filtered away: stop instead of sampling noise
        tok = torch.where((l <= S.NEG_INF).all(), stop_t, tok)
        tok = torch.where(done, stop_t, tok)
        tokens[step] = tok
        seen.index_fill_(0, tok.view(1), True)
        if not ignore_eos:
            is_stop = tok == stop
            n_tokens = torch.where(is_stop & ~done,
                                   torch.full_like(n_tokens, step + 1), n_tokens)
            done = done | is_stop
        if step == max_new_tokens - 1:
            break
        if not ignore_eos and (step + 1) % DONE_CHECK_EVERY == 0 and bool(done):
            break
        emb = nn.embedding(params["speech_emb"], tok.view(1, 1)).to(dt)
        pos = P + step
        hidden = bb.backbone_apply(params["backbone"], cfg, emb,
                                   torch.full((1, 1), pos, device=dev),
                                   cache, pos)
        logits = t3m.speech_logits(params, hidden[:, 0]).float()
        n_forward += 1
    return GenResult(tokens, n_tokens, n_forward)
