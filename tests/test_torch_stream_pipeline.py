"""Both pipelines' generate_stream on the CPU against chatterbox_tpu's, on
the models of tests/test_torch_pipeline.py (Turbo: a 2-layer
GPT2_fused_test T3, tiny meanflow S3Gen; 520M: a 2-layer Llama_fused_test
T3 with CFG, tiny 10-step CFG S3Gen), greedy, so that both decode the same
tokens whatever their random numbers; the JAX vocoder's buckets pinned to
every length and its stream noise handed to the port's engine."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tests.test_torch_pipeline import _cfg_pipelines, _pipelines  # noqa: E402
from tests.test_torch_streaming import JaxStreamDraws, pin_buckets  # noqa: E402
from tests.test_torch_convert import few_threads  # noqa: E402,F401

TEXT = "hello world, this is a test"


def _stream_key(seed=7):
    """The key of the JAX pipeline's second _next_key() (the first feeds
    the decode): its StreamingVocoder's."""
    key, _ = jax.random.split(jax.random.key(seed))
    return jax.random.split(key)[1]


def _family(family):
    """(JAX pipeline, the port's, generate_stream's greedy knobs, silence
    tokens of the tail)."""
    if family == "turbo":
        return _pipelines() + (dict(top_k=1), 3)
    return _cfg_pipelines() + (dict(min_p=1.0, exaggeration=0.6), 0)


@pytest.mark.parametrize("family", ["turbo", "cfg"])
def test_generate_stream_matches_jax_pipeline(family, monkeypatch):
    """A budget of 24 in chunks of 12, so that every chunk's tokens are
    valid and JAX's vocoded length is the stream's tip: the chunk lengths
    equal, the audio within 1e-5 (float32 end to end; the watermark, the
    same numpy code, on near-equal chunks). One exception: JAX's Turbo tail
    feeds an empty decode chunk, which its upper bound counts as a token,
    so its last vocode runs one token past the tip, two MEL_FLOOR frames
    that HiFT's receptive field carries into the last 5 tokens' audio; the
    port vocodes to the tip (C7). There the two stay within 0.1."""
    pin_buckets(monkeypatch)
    jtts, tts, kw, n_sil = _family(family)
    kw = dict(kw, max_new_tokens=24, chunk_tokens=12)
    ref = [np.asarray(c) for c in jtts.generate_stream(TEXT, **kw)]
    monkeypatch.setattr(tts.s3gen, "draw_noise", JaxStreamDraws(_stream_key()))
    out = list(tts.generate_stream(TEXT, **kw))
    assert [len(c) for c in out] == [len(c) for c in ref] == [9 * 960, (15 + n_sil) * 960]
    assert all(c.dtype == np.float32 for c in out)
    stream, ref = np.concatenate(out), np.concatenate(ref)
    assert np.isfinite(stream).all() and np.abs(stream).max() > 1e-3
    exact = len(stream) - (5 * 960 if n_sil else 0)
    np.testing.assert_allclose(stream[:exact], ref[:exact], rtol=0, atol=1e-5)
    np.testing.assert_allclose(stream[exact:], ref[exact:], rtol=0, atol=0.1)


@pytest.mark.parametrize("family", ["turbo", "cfg"])
def test_stream_budget_not_a_multiple_of_the_chunk(family):
    """A budget of 30 in chunks of 12: the last chunk decodes 6 tokens (no
    step past the budget), and the stream holds every token's audio: the
    first chunk less the 3 lookahead tokens, then 12, then the last 6 with
    the held-back 3 and the tail."""
    _, tts, kw, n_sil = _family(family)
    out = list(tts.generate_stream(TEXT, max_new_tokens=30, chunk_tokens=12, **kw))
    assert [len(c) for c in out] == [9 * 960, 12 * 960, (9 + n_sil) * 960]
    assert tts.last_decode.step == 30 and tts.last_decode.n_forward == 29
    assert bool(tts.last_decode.done) is False
def test_stream_tokens_equal_generate_tokens(monkeypatch):
    """Greedy, the streamed audio's token count is generate's: the same 30
    tokens then 3 silence tokens vocoded (Turbo)."""
    _, tts = _pipelines()
    wav = tts.generate(TEXT, top_k=1, max_new_tokens=30)
    one_shot = tts.last_decode.tokens.numpy()
    stream = list(tts.generate_stream(TEXT, top_k=1, max_new_tokens=30, chunk_tokens=7))
    assert sum(len(c) for c in stream) == wav.shape[1]
    # the chunked decode's last state holds the same history
    seen = tts.last_decode.seen.numpy()
    assert seen[one_shot].all() and seen.sum() == len(set(one_shot.tolist()))


@pytest.mark.parametrize("family", ["turbo", "cfg"])
def test_stream_of_an_immediate_eos(family, monkeypatch):
    """EOS as the first token: the stream is its tail alone, as generate's
    is: Turbo's 3 silence tokens, the CFG family's one silence token for an
    empty slice; one chunk, one decode step."""
    from chatterbox_tpu_torch.sampling import chunked
    _, tts, kw, n_sil = _family(family)
    stop = tts.hp.stop_speech_token
    monkeypatch.setattr(chunked, "sample_step",
                        lambda *a, **k: torch.tensor(stop))
    out = list(tts.generate_stream(TEXT, max_new_tokens=20, chunk_tokens=8, **kw))
    assert [len(c) for c in out] == [(n_sil or 1) * 960]
    assert tts.last_decode.step == 8 and bool(tts.last_decode.done)


def test_synthesize_long_form_yields_a_wav_per_chunk():
    """One generate per sentence chunk (chunk_text), in order."""
    from chatterbox_tpu_torch.serve.streaming import chunk_text, synthesize_long_form
    _, tts = _pipelines()
    text = "First sentence here. Second one! And a third?"
    tts.set_seed(1)
    wavs = list(synthesize_long_form(tts, text, max_chars=20, top_k=1, max_new_tokens=6))
    tts.set_seed(1)
    ref = [tts.generate(c, top_k=1, max_new_tokens=6)[0]
           for c in chunk_text(text, max_chars=20)]
    assert len(wavs) == len(ref) == 3
    for a, b in zip(wavs, ref):
        np.testing.assert_array_equal(a, b)
