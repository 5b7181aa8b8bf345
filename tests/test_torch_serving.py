"""The port's batch serving layer (chatterbox_tpu_torch/serve/batching.py):
TTSServer (the batched decode, then one batched vocode) and the threaded
ServingLoop with its two-deep pipeline, with and without voices, on the
2-layer GPT2_fused_test T3 (int8_fused, its kernels as their plain
versions) and a tiny meanflow S3Gen; the request and result fields the
loops read, and the lingering-thread record. Every test that starts a loop
stops and joins it in a `finally`."""
import threading

import numpy as np
import pytest
import torch

from chatterbox_tpu_torch.api.pipelines import T3CondHost
from chatterbox_tpu_torch.models.s3gen.model import RefDict, S3GenEngine
from chatterbox_tpu_torch.serve import batching
from chatterbox_tpu_torch.serve.batching import (BatchDecoder, ServingLoop, TTSRequest,
                                                 TTSResult, TTSServer, register_lingering,
                                                 vocode_seed)

from tests import test_torch_t3 as G  # noqa: E402   Turbo family fixtures
from tests.test_torch_convert import few_threads  # noqa: F401
from tests.test_torch_s3gen import DIMS, params


def _voice(seed, P):
    rng = np.random.default_rng(seed)
    return RefDict(rng.integers(0, 6561, (1, P)).astype(np.int32), np.array([P], np.int32),
                   (rng.standard_normal((1, 2 * P, 80)) * 0.5).astype(np.float32),
                   rng.standard_normal((1, 192)).astype(np.float32))


def _requests(n, seeds=None, refs=None, base=0):
    rng = np.random.default_rng(17 + base)
    out = []
    for i in range(n):
        cond = T3CondHost(rng.standard_normal((1, 256)).astype(np.float32),
                          rng.integers(0, 6561, (1, G.HP.speech_cond_prompt_len)), 0.6)
        out.append(TTSRequest(rng.integers(1, 60, 4 + 3 * i), cond, request_id=base + i,
                              seed=None if seeds is None else seeds[i],
                              ref=None if refs is None else refs[i]))
    return out


def _decoder(max_batch=4):
    return BatchDecoder(G.models("f32")[1], G.HP, max_batch=max_batch, max_new_tokens=8,
                        top_k=40)


def _engine():
    return S3GenEngine(params()[1], dims=DIMS)


VOICES = [_voice(1, 6), _voice(2, 10), _voice(3, 8)]


def test_request_and_result_fields():
    r = TTSRequest(np.array([1, 2]), None)
    assert r.max_new is None and r.ref is None and r.seed is None
    assert TTSResult(3, np.zeros(0)).wav is None
    assert vocode_seed(5) == vocode_seed(5) != vocode_seed(6)
    assert vocode_seed(5) not in (5, 6) and 0 <= vocode_seed(5) < 2**63


def test_tts_server_decodes_then_vocodes_the_batch():
    """Three seeded requests in three voices: the batch's decode, then one
    batched vocode; each wav equals the vocode of that request's tokens
    alone with its seed-derived generator, and is G * 960 samples."""
    dec, eng = _decoder(), _engine()
    reqs = _requests(3, seeds=[11, 12, 13])
    wavs = TTSServer(dec, eng).synthesize_batch(reqs, VOICES)
    tokens = [r.speech_tokens for r in dec.decode_batch(reqs)]
    for w, t, r, v in zip(wavs, tokens, reqs, VOICES):
        assert len(t) and len(w) == len(t) * 960 and np.isfinite(w).all()
        alone = eng.inference_batch([t], [v], [torch.Generator().manual_seed(
            vocode_seed(r.seed))])[0]
        np.testing.assert_allclose(w, alone, rtol=0, atol=1e-5)


def _serve(loop_kw, reqs, n_wait):
    got, ev = {}, threading.Event()

    def on_result(res):
        got[res.request_id] = res
        if len(got) == n_wait:
            ev.set()

    loop = ServingLoop(on_result=on_result, **loop_kw)
    try:
        for r in reqs:
            loop.submit(r)
        loop.start()
        assert loop._thread.name.startswith("chatterbox-")
        assert ev.wait(120), f"only {sorted(got)} completed"
    finally:
        loop.stop()
    assert not loop._thread.is_alive()
    return got


def test_serving_loop_with_voices_matches_tts_server():
    """Seeded requests with voices through the loop (batches of two, so the
    loop pipelines two batches): tokens equal the decoder's, audio equals
    TTSServer's for the same requests."""
    reqs = _requests(3, seeds=[21, 22, 23], refs=VOICES)
    expect = TTSServer(_decoder(), _engine()).synthesize_batch(reqs, VOICES)
    tokens = [r.speech_tokens for r in _decoder().decode_batch(reqs)]
    got = _serve(dict(decoder=_decoder(max_batch=2), s3gen=_engine()), reqs, 3)
    for r, w, t in zip(reqs, expect, tokens):
        np.testing.assert_array_equal(got[r.request_id].speech_tokens, t)
        np.testing.assert_allclose(got[r.request_id].wav, w, rtol=0, atol=1e-5)


def test_serving_loop_without_voices_returns_tokens_only():
    """No ref (or no engine): the loop decodes and delivers tokens, no wav."""
    reqs = _requests(3, seeds=[31, 32, 33])
    tokens = [r.speech_tokens for r in _decoder().decode_batch(reqs)]
    for kw in (dict(s3gen=_engine()), {}):
        got = _serve(dict(decoder=_decoder(), **kw), reqs, 3)
        for r, t in zip(reqs, tokens):
            assert got[r.request_id].wav is None
            np.testing.assert_array_equal(got[r.request_id].speech_tokens, t)


def test_serving_loop_runs_two_deep():
    """Batch N's audio is read back only after batch N+1's decode has been
    launched (four queued requests, batches of two)."""
    events = []

    class Decoder(BatchDecoder):
        def decode_batch_dispatch(self, requests):
            events.append(("decode", requests[0].request_id))
            return super().decode_batch_dispatch(requests)

    class Engine(S3GenEngine):
        def inference_batch_fetch(self, handle):
            events.append(("fetch", len(events)))
            return super().inference_batch_fetch(handle)

    dec = Decoder(G.models("f32")[1], G.HP, max_batch=2, max_new_tokens=6, top_k=40)
    voices = VOICES + VOICES[:1]
    got = _serve(dict(decoder=dec, s3gen=Engine(params()[1], dims=DIMS)),
                 _requests(4, seeds=[41, 42, 43, 44], refs=voices), 4)
    assert all(np.isfinite(r.wav).all() for r in got.values())
    kinds = [k for k, _ in events]
    assert kinds == ["decode", "decode", "fetch", "fetch"], events


def test_stop_joins_and_lingering_threads_are_pruned():
    loop = ServingLoop(_decoder(), on_result=lambda r: None)
    try:
        loop.start()
    finally:
        loop.stop()
    assert not loop._thread.is_alive()
    dead = threading.Thread(target=lambda: None)
    dead.start()
    dead.join()
    stop = threading.Event()
    alive = threading.Thread(target=stop.wait, daemon=True)
    alive.start()
    saved = list(batching.LINGERING_THREADS)
    try:
        batching.LINGERING_THREADS[:] = [dead]
        register_lingering(alive)
        assert batching.LINGERING_THREADS == [alive]
    finally:
        stop.set()
        alive.join()
        batching.LINGERING_THREADS[:] = saved


@pytest.mark.parametrize("n", [1, 2])
def test_tts_server_rows_do_not_depend_on_batchmates(n):
    """A seeded request's audio is the same in a batch of one and beside a
    batchmate in another voice."""
    dec, eng = _decoder(), _engine()
    reqs = _requests(2, seeds=[51, 52])
    both = TTSServer(dec, eng).synthesize_batch(reqs, VOICES[:2])
    one = TTSServer(dec, eng, seed=9).synthesize_batch(reqs[n - 1:n], VOICES[n - 1:n])
    np.testing.assert_allclose(one[0], both[n - 1], rtol=0, atol=1e-5)
