"""Batched serving: requests grouped into one batched T3 decode (the
counterpart of BatchDecoder and its request types in
chatterbox_tpu/serve/batching.py).

A batch is padded to a power of two by repeating its last request with that
request's seed, so a pad row samples the same tokens as the row it copies
and finishes with it. Each request's tokens depend on its own seed, prompt
and sampler only (sampling/batched.py).

Not here yet: `warmup` (the JAX package's compile grid of batch and text
buckets, which eager PyTorch does not need), and the serving loops
(`ServingLoop`, `TTSServer`, `ContinuousServingLoop`), which need the
batched S3Gen or the continuous engine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels.fused_layer import MAX_B
from ..models.s3gen.model import EOS, SOS, SPEECH_VOCAB_SIZE
from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..ops.sampling import SamplerParams
from ..sampling.batched import t3_generate_batched


def pow2_sizes(n: int) -> list:
    """Powers of two up to and including next_pow2(n): the batch sizes a
    pow2-padding dispatch produces for batches of 1..n."""
    sizes, b = [], 1
    while b < n:
        sizes.append(b)
        b *= 2
    sizes.append(b)
    return sizes


def drop_invalid_tokens_sliced(tokens: np.ndarray, sos: int = SOS,
                               eos: int = EOS) -> np.ndarray:
    """The tokens strictly between the first SOS (or the start) and the
    first EOS (or the end)."""
    tokens = np.asarray(tokens).reshape(-1)
    sos_idx = np.nonzero(tokens == sos)[0]
    start = int(sos_idx[0]) + 1 if len(sos_idx) else 0
    eos_idx = np.nonzero(tokens == eos)[0]
    end = int(eos_idx[0]) if len(eos_idx) else len(tokens)
    return tokens[start:end]


@dataclasses.dataclass
class TTSRequest:
    text_tokens: np.ndarray            # (Lt,) ids: raw BPE (Turbo) or
                                       # SOT/EOT-framed (CFG family)
    cond: object                       # api.pipelines.T3CondHost
    sampler: Optional[SamplerParams] = None
    request_id: int = 0
    seed: Optional[int] = None         # per-request seed (reproducible rows)


@dataclasses.dataclass
class TTSResult:
    request_id: int
    speech_tokens: np.ndarray          # filtered (< 6561), no EOS


class BatchDecoder:
    """Groups requests and runs the batched T3 decode.

    cfg=True serves the 520M CFG family as 2B rows (cond and uncond). Each
    request's SamplerParams apply to its row; kv_int8 keeps the cache in
    int8, read by the int8 decode-attention kernel. A batch holds at most
    max_batch requests; on fused int8 layers the rows of a padded full batch
    (twice the requests for CFG) must fit the fused kernels' MAX_B."""

    def __init__(self, t3_params, hp: T3Config, max_batch: int = 8,
                 max_new_tokens: int = 1000, top_k: int = 1000, seed: int = 0,
                 cfg: bool = False, kv_int8: bool = False):
        self.t3_params = t3_params
        self.hp = hp
        self.max_batch = max_batch
        self.max_new_tokens = max_new_tokens
        self.top_k = top_k
        self.cfg = cfg
        self.kv_int8 = kv_int8
        self.device = t3_params["speech_emb"]["w"].device
        rows = pow2_sizes(max_batch)[-1] * (2 if cfg else 1)
        if "fused" in t3_params["backbone"]["layers"][0] and rows > MAX_B:
            raise ValueError(f"max_batch {max_batch} pads to {rows} rows; the fused "
                             f"decode-layer kernels take at most {MAX_B}")
        self._seeds = np.random.default_rng(seed)   # seeds of unseeded requests

    def _stack_samplers(self, requests: list) -> SamplerParams:
        default = SamplerParams(cfg_weight=0.5 if self.cfg else 0.0)
        rows = [r.sampler if r.sampler is not None else default for r in requests]
        return SamplerParams(*[[float(getattr(r, f.name)) for r in rows]
                               for f in dataclasses.fields(SamplerParams)])

    def _row_seeds(self, requests: list) -> list:
        return [r.seed if r.seed is not None else int(self._seeds.integers(2**62))
                for r in requests]

    def decode_batch(self, requests: list) -> list:
        return self.decode_batch_fetch(self.decode_batch_dispatch(requests))

    def batch_inputs(self, requests: list) -> tuple:
        """The batched engine's inputs for `requests`, padded to a power of
        two by repeating the last request and its seed: (cond, text,
        text_lens, sampler, generators)."""
        if not 1 <= len(requests) <= self.max_batch:
            raise ValueError(f"{len(requests)} requests; a batch holds 1..{self.max_batch}")
        seeds = self._row_seeds(requests)
        B = pow2_sizes(len(requests))[-1]
        requests = list(requests) + [requests[-1]] * (B - len(requests))
        seeds = seeds + [seeds[-1]] * (B - len(seeds))
        lens = [len(r.text_tokens) for r in requests]
        text = np.zeros((B, max(lens)), np.int64)
        for i, r in enumerate(requests):
            text[i, :lens[i]] = r.text_tokens
        dev = self.device
        cond = t3m.T3CondTensors(
            torch.as_tensor(np.concatenate([r.cond.speaker_emb for r in requests]),
                            dtype=torch.float32, device=dev),
            torch.as_tensor(np.concatenate([r.cond.cond_prompt_speech_tokens
                                            for r in requests]),
                            dtype=torch.long, device=dev),
            (torch.tensor([[[float(r.cond.emotion_adv)]] for r in requests], device=dev)
             if self.hp.emotion_adv else None))
        gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
        return (cond, torch.as_tensor(text, device=dev), lens,
                self._stack_samplers(requests), gens)

    def decode_batch_dispatch(self, requests: list):
        """Run the batched decode of `requests`; returns a handle for
        `decode_batch_fetch`, which reads the tokens back."""
        res = t3_generate_batched(
            self.t3_params, self.hp, *self.batch_inputs(requests),
            max_new_tokens=self.max_new_tokens, top_k=self.top_k, cfg_mode=self.cfg,
            kv_int8=self.kv_int8)
        return res, requests

    def decode_batch_fetch(self, handle) -> list:
        """Per-request results: each row's tokens up to its count, the CFG
        family's sliced between SOS and EOS, then ids below 6561."""
        res, requests = handle
        tokens, counts = res.tokens.cpu().numpy(), res.n_tokens.cpu().numpy()
        out = []
        for i, r in enumerate(requests):
            t = tokens[i, :counts[i]]
            if self.cfg:
                t = drop_invalid_tokens_sliced(t)
            out.append(TTSResult(request_id=r.request_id,
                                 speech_tokens=t[t < SPEECH_VOCAB_SIZE]))
        return out
