"""The port's streaming path held against chatterbox_tpu on the JAX CPU
backend, at small widths: the chunked T3 decode (sampling/chunked.py) for
both families on the bf16 and the int8 cache and with fused_attn, the HiFT
streaming hooks (phase carry, source cache), S3Gen's host-token calls and
the StreamingVocoder (serve/streaming.py) in its exact and windowed modes,
feed by feed; and chunk_text and the watermark's stream offset.

JAX's vocoder picks token and mel buckets; the tests pin both to every
length (a bucket per length), so that it runs at the exact lengths the
port runs at. Its random numbers are handed to the port: JAX's gumbel
draws to the sampler, its noise buffer, HiFT phases and source noise to the
engine's `draw_noise`. JAX's normal draws agree on their common prefix
whatever the shape (threefry is partitionable), so one source-noise draw
at the longest length serves every feed."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.models.s3gen import flow as jflow  # noqa: E402
from chatterbox_tpu.models.s3gen import hift as jhift  # noqa: E402
from chatterbox_tpu.models.s3gen import model as jmodel  # noqa: E402
from chatterbox_tpu.models.s3gen.model import RefDict as JRefDict  # noqa: E402
from chatterbox_tpu.models.s3gen.model import S3GenEngine as JEngine  # noqa: E402
from chatterbox_tpu.ops import sampling as JS  # noqa: E402
from chatterbox_tpu.sampling import chunked as jchunked  # noqa: E402
from chatterbox_tpu.serve import streaming as jstreaming  # noqa: E402
from chatterbox_tpu.utils.watermark import Watermarker as JWatermarker  # noqa: E402

from chatterbox_tpu_torch.convert.from_jax import s3gen_from_jax  # noqa: E402
from chatterbox_tpu_torch.kernels import decode_attention as A  # noqa: E402
from chatterbox_tpu_torch.models.s3gen import hift  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.flow import FlowDims  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.model import (RefDict, S3GenEngine,  # noqa: E402
                                                     S3GenNoise)
from chatterbox_tpu_torch.ops import sampling as S  # noqa: E402
from chatterbox_tpu_torch.sampling.chunked import (t3_decode_chunk, t3_prefill,  # noqa: E402
                                                   t3_prefill_decode)
from chatterbox_tpu_torch.sampling.decode import t3_generate  # noqa: E402
from chatterbox_tpu_torch.serve import streaming  # noqa: E402
from chatterbox_tpu_torch.utils.watermark import Watermarker  # noqa: E402

from tests import test_torch_t3 as G  # noqa: E402   Turbo family fixtures
from tests import test_torch_t3_llama as L  # noqa: E402   520M family fixtures
from tests.test_torch_convert import few_threads  # noqa: E402,F401

FAMILIES = {"gpt2": (G, False), "llama": (L, True)}      # fixtures module, CFG
TOKEN_EXACT = tuple(range(1, 2049))     # a JAX bucket for every length
MEL_EXACT = tuple(range(1, 4097))


def pin_buckets(mp):
    mp.setattr(jmodel, "TOKEN_BUCKETS", TOKEN_EXACT)
    mp.setattr(jmodel, "GEN_MEL_BUCKETS", MEL_EXACT)


# ---------------------------------------------------------------------------
# chunked decode
# ---------------------------------------------------------------------------

def _sampler(cfg_mode):
    """(JAX SamplerParams, the port's, top_k): sampled, not greedy."""
    if cfg_mode:
        kw = dict(temperature=0.8, top_p=1.0, min_p=0.02, repetition_penalty=1.2,
                  cfg_weight=0.5)
        return JS.SamplerParams.make(**kw), S.SamplerParams(**kw), 0
    return (JS.SamplerParams.make(temperature=0.8, top_p=0.95, repetition_penalty=1.2),
            S.SamplerParams(0.8, 0.95, 1.2), 1000)


def _jax_draws(key, n, V):
    """The gumbel draws of the JAX chunk loop: key, sub = split(key) a step,
    categorical(sub) = argmax(logits + gumbel(sub))."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (V,), jnp.float32)))
    return torch.from_numpy(np.stack(out))


def _jax_text(mod):
    text = np.zeros((1, 32), np.int32)
    text[0, :mod.TEXT.shape[1]] = mod.TEXT[0]
    return jnp.asarray(text), jnp.asarray(mod.TEXT.shape[1])


def _jax_chunks(mod, cfg_mode, cache, budget, chunks, key, ignore_eos=True):
    """JAX's t3_prefill (+ the first chunk, fused, on the plain caches) and
    t3_decode_chunk: the concatenated tokens and each chunk's n_new."""
    qp, _ = mod.models("f32")
    jcond, _ = mod._cond(np.random.default_rng(31))
    jsp, _, top_k = _sampler(cfg_mode)
    text, n_text = _jax_text(mod)
    kw = dict(top_k=top_k, cfg_mode=cfg_mode, ignore_eos=ignore_eos)
    if cache == "fused":
        state = jchunked.t3_prefill(qp, mod.JHP, jcond, text, n_text, key,
                                    max_new_tokens=budget, cfg_mode=cfg_mode,
                                    tile_align=True)
        out = [jchunked.t3_decode_chunk(qp, mod.JHP, state, jsp, n_steps=chunks[0],
                                        fused_attn=True, **kw)]
    else:
        out = [jchunked.t3_prefill_decode(qp, mod.JHP, jcond, text, n_text, jsp, key,
                                          max_new_tokens=budget, n_steps=chunks[0],
                                          kv_int8=cache == "int8", **kw)]
    for n in chunks[1:]:
        out.append(jchunked.t3_decode_chunk(qp, mod.JHP, out[-1][0], jsp, n_steps=n,
                                            fused_attn=cache == "fused", **kw))
    return (np.concatenate([np.asarray(t) for _, t, _ in out]),
            [int(n) for _, _, n in out])


def _port_chunks(mod, cfg_mode, cache, budget, chunks, generator=None, gumbel=None,
                 ignore_eos=True):
    _, tp = mod.models("f32")
    _, tcond = mod._cond(np.random.default_rng(31))
    _, sp, top_k = _sampler(cfg_mode)
    kw = dict(top_k=top_k, cfg_mode=cfg_mode, ignore_eos=ignore_eos)
    text = torch.from_numpy(mod.TEXT)
    if cache == "fused":
        state = t3_prefill(tp, mod.HP, tcond, text, generator=generator, gumbel=gumbel,
                           max_new_tokens=budget, cfg_mode=cfg_mode, tile_align=True)
        out = [t3_decode_chunk(tp, mod.HP, state, sp, n_steps=chunks[0], fused_attn=True,
                               **kw)]
    else:
        out = [t3_prefill_decode(tp, mod.HP, tcond, text, sp, generator=generator,
                                 gumbel=gumbel, max_new_tokens=budget, n_steps=chunks[0],
                                 kv_int8=cache == "int8", **kw)]
    for n in chunks[1:]:
        out.append(t3_decode_chunk(tp, mod.HP, out[-1][0], sp, n_steps=n,
                                   fused_attn=cache == "fused", **kw))
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("cache", ["bf16", "int8", "fused"])
def test_chunked_decode_matches_jax_chunks(family, cache):
    """Three chunks of 4 against JAX's t3_prefill_decode / t3_decode_chunk
    (t3_prefill(tile_align) for fused_attn), JAX's gumbel draws replayed:
    every token and every chunk's count equal; on CPU tensors the
    decode-attention kernels take their plain versions."""
    mod, cfg_mode = FAMILIES[family]
    key = jax.random.key(11)
    ref, ref_n = _jax_chunks(mod, cfg_mode, cache, 12, (4, 4, 4), key)
    before = dict(A.launches)
    out = _port_chunks(mod, cfg_mode, cache, 12, (4, 4, 4),
                       gumbel=_jax_draws(key, 12, mod.HP.speech_tokens_dict_size))
    assert A.launches == before
    toks = np.concatenate([t.numpy() for _, t, _ in out])
    np.testing.assert_array_equal(toks, ref)
    assert [int(n) for _, _, n in out] == ref_n == [4, 4, 4]
    assert len(set(toks.tolist())) > 1                  # really sampled
    state = out[-1][0]
    assert state.step == 12 and state.n_forward == 11
    if cache == "int8":
        assert type(state.cache).__name__ == "KVCacheInt8"
    if cache == "fused":
        assert state.cache.k.shape[3] % A.TT == 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_budget_not_a_multiple_of_the_chunk(family):
    """A budget of 10 in chunks of 4: JAX decodes 4 + 4 + 4 (its last chunk
    writes past the cache into clamped slots) and its pipelines drop what
    passes the budget; the port's last chunk takes 2 steps. The 10 tokens
    equal JAX's first 10 and t3_generate's; a chunk past the budget takes
    no step."""
    mod, cfg_mode = FAMILIES[family]
    key = jax.random.key(12)
    ref, _ = _jax_chunks(mod, cfg_mode, "bf16", 10, (4, 4, 4), key)
    draws = _jax_draws(key, 10, mod.HP.speech_tokens_dict_size)
    out = _port_chunks(mod, cfg_mode, "bf16", 10, (4, 4, 4, 4), gumbel=draws)
    counts = [int(n) for _, _, n in out]
    assert counts == [4, 4, 2, 0]
    toks = np.concatenate([t.numpy()[:n] for (_, t, _), n in zip(out, counts)])
    np.testing.assert_array_equal(toks, ref[:10])
    stop = mod.HP.stop_speech_token
    assert (out[2][1].numpy()[2:] == stop).all() and (out[3][1].numpy() == stop).all()
    assert out[-1][0].step == 10 and out[-1][0].n_forward == 9
    _, tp = mod.models("f32")
    _, tcond = mod._cond(np.random.default_rng(31))
    _, sp, top_k = _sampler(cfg_mode)
    res = t3_generate(tp, mod.HP, tcond, torch.from_numpy(mod.TEXT), sp, max_new_tokens=10,
                      top_k=top_k, cfg_mode=cfg_mode, ignore_eos=True, gumbel=draws)
    np.testing.assert_array_equal(res.tokens.numpy(), toks)
    assert res.n_forward == 9


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_chunked_equals_t3_generate_under_one_seed(family):
    """Chunks of 3, 5, 4 against the port's own t3_generate, both drawing
    from a generator of the same seed: the per-step sampler is shared."""
    mod, cfg_mode = FAMILIES[family]
    out = _port_chunks(mod, cfg_mode, "bf16", 12, (3, 5, 4),
                       generator=torch.Generator().manual_seed(3))
    toks = np.concatenate([t.numpy() for _, t, _ in out])
    _, tp = mod.models("f32")
    _, tcond = mod._cond(np.random.default_rng(31))
    _, sp, top_k = _sampler(cfg_mode)
    res = t3_generate(tp, mod.HP, tcond, torch.from_numpy(mod.TEXT), sp, max_new_tokens=12,
                      top_k=top_k, cfg_mode=cfg_mode, ignore_eos=True,
                      generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(toks, res.tokens.numpy())
    assert len(set(toks.tolist())) > 2


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_eos_inside_a_chunk(family):
    """Draws that force EOS at step 5, inside the second chunk of 4: that
    chunk counts 2 (the EOS included, as JAX's loop counts), the rest of
    it is the stop token, `done` is set, and a later chunk counts 0; the
    tokens equal t3_generate's under the same draws."""
    mod, cfg_mode = FAMILIES[family]
    V, stop = mod.HP.speech_tokens_dict_size, mod.HP.stop_speech_token
    draws = _jax_draws(jax.random.key(13), 12, V)
    draws[5] = -torch.inf              # every token but the stop token out of reach,
    draws[5, stop] = 0.0               # even where the sampler filtered it away
    out = _port_chunks(mod, cfg_mode, "bf16", 12, (4, 4, 4), gumbel=draws,
                       ignore_eos=False)
    assert [int(n) for _, _, n in out] == [4, 2, 0]
    assert [bool(s.done) for s, _, _ in out] == [False, True, True]
    second = out[1][1].numpy()
    assert second[1] == stop and (second[2:] == stop).all() and second[0] != stop
    assert (out[2][1].numpy() == stop).all()
    _, tp = mod.models("f32")
    _, tcond = mod._cond(np.random.default_rng(31))
    _, sp, top_k = _sampler(cfg_mode)
    res = t3_generate(tp, mod.HP, tcond, torch.from_numpy(mod.TEXT), sp, max_new_tokens=12,
                      top_k=top_k, cfg_mode=cfg_mode, gumbel=draws)
    np.testing.assert_array_equal(np.concatenate([t.numpy() for _, t, _ in out]),
                                  res.tokens.numpy())
    assert int(res.n_tokens) == 6


# ---------------------------------------------------------------------------
# HiFT streaming hooks and S3Gen's host-token calls
# ---------------------------------------------------------------------------

JDIMS, DIMS = jflow.FlowDims.tiny_test(), FlowDims.tiny_test()
P_REF = 10        # prompt tokens of the test voice


def _engines(meanflow):
    k1, k2 = jax.random.split(jax.random.key(21 + meanflow))
    sp = {"flow": jflow.flow_init(k1, meanflow=meanflow, dims=JDIMS),
          "mel2wav": jhift.hift_init(k2, base_channels=32)}
    jeng = JEngine(sp, meanflow=meanflow, dims=JDIMS)
    jeng.pcm16_fetch = False
    eng = S3GenEngine(s3gen_from_jax(jax.tree.map(np.asarray, sp), dims=DIMS, hift_base=32,
                                     meanflow=meanflow, device="cpu"),
                      dims=DIMS, meanflow=meanflow)
    return jeng, eng


_ENGINES = {}


def engines(meanflow):
    if meanflow not in _ENGINES:
        _ENGINES[meanflow] = _engines(meanflow)
    return _ENGINES[meanflow]


def _refs(seed=41):
    rng = np.random.default_rng(seed)
    arrs = (rng.integers(0, 6561, (1, P_REF)).astype(np.int32), np.array([P_REF], np.int32),
            (rng.standard_normal((1, 2 * P_REF, 80)) * 0.5).astype(np.float32),
            rng.standard_normal((1, 192)).astype(np.float32))
    return JRefDict(*arrs), RefDict(*arrs)


def _mels(T, seed=42):
    return (np.random.default_rng(seed).standard_normal((1, T, 80)) * 0.5).astype(np.float32)


class JaxStreamDraws:
    """A JAX StreamingVocoder's random numbers from its key: the flow buffer
    (k_noise), the HiFT phases (k_hift's first half) and the source noise
    (its second half), served through the port engine's draw_noise."""

    def __init__(self, key, max_frames=400):
        _, k_noise, k_hift = jax.random.split(key, 3)
        self.buffer = torch.from_numpy(np.asarray(jax.random.normal(
            k_noise, (1, streaming.StreamingVocoder.MAX_MEL_FRAMES, 80))))
        k_phase, k_src = jax.random.split(k_hift)
        self.phase = torch.from_numpy(np.asarray(jax.random.uniform(
            k_phase, (1, 1, 9), minval=-jnp.pi, maxval=jnp.pi)))
        self.noise_u = torch.from_numpy(np.asarray(jax.random.normal(
            k_src, (1, max_frames * 480, 9))))

    def __call__(self, n_mel, n_gen_mel, generator):
        z = self.buffer if n_mel else torch.zeros((1, 0, 80))
        assert n_mel in (0, self.buffer.shape[1])
        return S3GenNoise(z, hift.SourceNoise(self.phase, self.noise_u[:, :n_gen_mel * 480]))


def _jax_source_noise(key, T):
    k_phase, k_src = jax.random.split(key)
    return hift.SourceNoise(
        torch.from_numpy(np.asarray(jax.random.uniform(k_phase, (1, 1, 9), minval=-jnp.pi,
                                                       maxval=jnp.pi))),
        torch.from_numpy(np.asarray(jax.random.normal(k_src, (1, T * 480, 9)))))


def test_hift_source_phase_carry_matches_jax():
    """The carry (1, 9) is added to the phase sum before `% 1`: JAX sums in
    float32, the port in float64 (2e-5, as the carry-less source)."""
    jeng, eng = engines(True)
    rng = np.random.default_rng(43)
    f0 = (120 + 80 * rng.random((1, 12))).astype(np.float32)
    f0[0, 3] = 0.0                                       # one unvoiced frame
    carry = rng.random((1, 9)).astype(np.float32)
    key = jax.random.key(44)
    ref = np.asarray(jhift.hift_source(jeng.params["mel2wav"], key, jnp.asarray(f0),
                                       phase_carry=jnp.asarray(carry)))
    out = hift.hift_source(eng.params["mel2wav"], torch.from_numpy(f0),
                           _jax_source_noise(key, 12), torch.from_numpy(carry))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5)
    plain = hift.hift_source(eng.params["mel2wav"], torch.from_numpy(f0),
                             _jax_source_noise(key, 12))
    assert np.abs(plain.numpy() - ref).max() > 1e-3     # the carry matters


@pytest.mark.parametrize("form", ["prefix", "buffer"])
def test_hift_inference_source_cache_matches_jax(form):
    """cache_source as the exact prefix (cache_len None) or as a longer
    buffer with cache_len, with a phase carry, against JAX's hift_inference
    on its own draws."""
    jeng, eng = engines(True)
    T, n = 24, 10 * 480
    mel = _mels(T)
    cache = (np.random.default_rng(45).standard_normal((1, 40 * 480, 1)) * 0.1
             ).astype(np.float32)
    carry = np.full((1, 9), 0.25, np.float32)
    key = jax.random.key(46)
    if form == "prefix":
        jargs, targs = (jnp.asarray(cache[:, :n]), None), (torch.from_numpy(cache[:, :n]), None)
    else:
        jargs = (jnp.asarray(cache[:, :T * 480]), jnp.asarray(n, jnp.int32))
        targs = (torch.from_numpy(cache), n)
    wav, s, f0 = jhift.hift_inference(jeng.params["mel2wav"], key, jnp.asarray(mel),
                                      cache_source=jargs[0], cache_len=jargs[1],
                                      phase_carry=jnp.asarray(carry))
    out = hift.hift_inference(eng.params["mel2wav"], torch.from_numpy(mel),
                              _jax_source_noise(key, T), cache_source=targs[0],
                              cache_len=targs[1], phase_carry=torch.from_numpy(carry))
    np.testing.assert_array_equal(out[1].numpy()[:, :n], cache[:, :n])
    np.testing.assert_allclose(out[1].numpy(), np.asarray(s), rtol=0, atol=2e-5)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(f0), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(wav), rtol=0, atol=1e-4)


def test_mel_to_wav_stream_growing_window_equals_one_shot(monkeypatch):
    """JAX's own invariant on the port: windows of 32, 56, 80 frames, each
    taking the source cache of the last, emitting up to 16 frames short of
    the window (past HiFT's receptive field) but the last, concatenate to
    the one-shot vocode within 1e-4; the one-shot is JAX's within 1e-4."""
    pin_buckets(monkeypatch)
    jeng, eng = engines(True)
    T, LA = 80, 16
    mel = _mels(T, 47)
    key = jax.random.key(48)
    noise = _jax_source_noise(jax.random.split(key)[0], T)
    full = eng.mel_to_wav_stream(mel, noise=noise)[0][0]
    ref = np.asarray(jeng.mel_to_wav_stream(mel, jax.random.split(key)[0])[0][0])
    np.testing.assert_allclose(full, ref, rtol=0, atol=1e-4)
    cache, clen, emitted, out = None, 0, 0, []
    for Tc in (32, 56, 80):
        part = hift.SourceNoise(noise.phase, noise.noise_u[:, :Tc * 480])
        wav, src, _ = eng.mel_to_wav_stream(mel[:, :Tc], cache_source=cache, cache_len=clen,
                                            noise=part)
        upto = (Tc if Tc == T else Tc - LA) * 480
        out.append(wav[0, emitted:upto])
        emitted, cache, clen = upto, src, Tc * 480
    stream = np.concatenate(out)
    assert len(stream) == len(full) == T * 480
    np.testing.assert_allclose(stream, full, rtol=0, atol=1e-4)


@pytest.mark.parametrize("meanflow", [True, False])
def test_host_token_calls_match_jax(meanflow, monkeypatch):
    """inference (VC's call), flow_to_mel with an aligned noise buffer and
    mel_to_wav against the JAX engine's, its buckets pinned to the exact
    lengths, on its own draws (float32; the CFG flow's ten steps of
    summation-order differences)."""
    pin_buckets(monkeypatch)
    from tests.test_torch_s3gen import jax_vocode_noise
    jeng, eng = engines(meanflow)
    jref, ref = _refs()
    toks = np.random.default_rng(49).integers(0, 6561, 14).astype(np.int32)
    key = jax.random.key(50)
    wav = eng.inference(toks, ref, noise=jax_vocode_noise(key, 2 * (P_REF + 14), 28,
                                                          meanflow=meanflow))
    jwav = np.asarray(jeng.inference(toks, jref, key))
    assert wav.shape == jwav.shape == (1, 28 * 480)
    np.testing.assert_allclose(wav, jwav, rtol=0, atol=1e-5)
    buf = np.asarray(jax.random.normal(jax.random.key(51), (1, 100, 80)))
    mels, n = eng.flow_to_mel(toks, ref, noise=buf)
    jmels, jn = jeng.flow_to_mel(toks, jref, key, noise=buf)
    assert n == jn == 28 and mels.shape == (1, 28, 80)
    np.testing.assert_allclose(mels, np.asarray(jmels), rtol=0, atol=1e-4)
    k_phase = jax.random.key(52)
    out = eng.mel_to_wav(mels, noise=_jax_source_noise(k_phase, 28))
    np.testing.assert_allclose(out, np.asarray(jeng.mel_to_wav(mels, k_phase)), rtol=0,
                               atol=1e-4)


def test_device_ref_uploads_a_voice_once():
    _, eng = engines(True)
    _, ref = _refs()
    a, b = eng.device_ref(ref), eng.device_ref(ref)
    assert all(x is y for x, y in zip(a[:3], b[:3])) and a[3] == P_REF
    assert a[0].dtype == torch.long and a[0].shape == (1, P_REF)
    _, other = _refs()                                   # equal arrays, another object
    assert eng.device_ref(other)[1] is not a[1]


# ---------------------------------------------------------------------------
# the streaming vocoder, feed by feed
# ---------------------------------------------------------------------------

def _vocoders(meanflow, monkeypatch, **kw):
    """(JAX's StreamingVocoder, the port's) on the same voice, the port's
    engine drawing JAX's numbers."""
    jeng, eng = engines(meanflow)
    jref, ref = _refs()
    key = jax.random.key(60 + meanflow)
    monkeypatch.setattr(eng, "draw_noise", JaxStreamDraws(key))
    return (jstreaming.StreamingVocoder(jeng, jref, key, **kw),
            streaming.StreamingVocoder(eng, ref, **kw))


CHUNKS = (np.arange(5) * 97 % 6561, np.arange(5, 12) * 89 % 6561,
          np.arange(12, 18) * 83 % 6561, np.arange(18, 22) * 79 % 6561)


@pytest.mark.parametrize("meanflow", [True, False])
def test_exact_feed_matches_jax(meanflow, monkeypatch):
    """Four host feeds (the last final) through feed(): every feed's audio
    against JAX's within 1e-4, lengths exact; the first non-final feed of
    at most the lookahead's tokens emits nothing in both."""
    pin_buckets(monkeypatch)
    jvoc, voc = _vocoders(meanflow, monkeypatch)
    assert len(voc.feed(CHUNKS[0][:3])) == len(jvoc.feed(CHUNKS[0][:3])) == 0
    chunks = (CHUNKS[0][3:],) + CHUNKS[1:]
    for i, c in enumerate(chunks):
        final = i == len(chunks) - 1
        ref = np.asarray(jvoc.feed(c, final=final))
        out = voc.feed(c, final=final)
        assert out.shape == ref.shape and len(out) > 0, i
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4, err_msg=f"feed {i}")
    assert voc._emitted_samples == 22 * 960


@pytest.mark.parametrize("meanflow", [True, False])
def test_feed_from_decode_matches_jax(meanflow, monkeypatch):
    """Four chunks straight from device tensors, the last final with
    append_sil=3, against JAX's feed_from_decode: audio per feed within
    1e-4, the counts and the extras equal."""
    pin_buckets(monkeypatch)
    jvoc, voc = _vocoders(meanflow, monkeypatch)
    for i, c in enumerate(CHUNKS):
        final = i == len(CHUNKS) - 1
        kw = dict(vocab=6561, final=final, append_sil=3 if final else 0)
        ref, jn, jx = jvoc.feed_from_decode(jnp.asarray(c, jnp.int32), jnp.asarray(len(c)),
                                            extra_fetch=(jnp.asarray(len(c) + 1),), **kw)
        out, n, x = voc.feed_from_decode(torch.as_tensor(c), torch.tensor(len(c)),
                                         extra_fetch=(torch.tensor(len(c) + 1),), **kw)
        assert n == jn == len(c) and x == (int(jx[0]),) == (len(c) + 1,)
        assert out.shape == np.asarray(ref).shape and len(out) > 0, i
        np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-4,
                                   err_msg=f"feed {i}")
    np.testing.assert_array_equal(voc._tokens, jvoc._tokens)


def test_feed_from_decode_filters_as_feed_does(monkeypatch):
    """A chunk's ids past its count and ids >= vocab are dropped on the
    device: the audio equals host feeds of the kept ids, and a host feed
    between device feeds rebuilds the device row."""
    _, a = _vocoders(True, monkeypatch)
    _, b = _vocoders(True, monkeypatch)
    c0 = torch.tensor([5, 6600, 7, 8, 9, 10, 6562, 11])
    out_a = [a.feed_from_decode(c0, torch.tensor(7), vocab=6561)[0],
             a.feed(np.array([12, 13, 14])),
             a.feed_from_decode(torch.tensor([15, 16, 17, 18]), 4, vocab=6561,
                                final=True)[0]]
    out_b = [b.feed(np.array([5, 7, 8, 9, 10])), b.feed(np.array([12, 13, 14])),
             b.feed(np.array([15, 16, 17, 18]), final=True)]
    for x, y in zip(out_a, out_b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a._tokens, b._tokens)


def test_windowed_matches_jax(monkeypatch):
    """window_tokens=9: feeds of 5, 20 (larger than a window: several passes),
    7 and a final 4, against JAX's windowed vocoder feed by feed (its float32
    phase carry against the port's float64: 1e-4), no audio lost: the stream
    holds every token's 960 samples."""
    pin_buckets(monkeypatch)
    jvoc, voc = _vocoders(True, monkeypatch, window_tokens=9)
    toks = np.arange(36) * 37 % 6561
    total = 0
    for i, (a, b) in enumerate(((0, 5), (5, 25), (25, 32), (32, 36))):
        final = b == 36
        ref = np.asarray(jvoc.feed(toks[a:b], final=final))
        out = voc.feed(toks[a:b], final=final)
        assert out.shape == ref.shape, i
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4, err_msg=f"feed {i}")
        total += len(out)
    assert total == 36 * 960


def test_window_must_exceed_lookahead():
    _, eng = engines(True)
    _, ref = _refs()
    with pytest.raises(ValueError, match="must exceed"):
        streaming.StreamingVocoder(eng, ref, window_tokens=4)


# ---------------------------------------------------------------------------
# text chunking and the watermark across chunks
# ---------------------------------------------------------------------------

TEXTS = [
    "Hello world.",
    "One. Two! Three? Four.",
    "A sentence that runs on " * 20 + "and ends.",
    "x" * 700,
    "First sentence here. " + "y" * 320 + ". Last one!",
    "   ",
    "句子一。句子二？好！",
]


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("max_chars", [40, 300])
def test_chunk_text_matches_jax(text, max_chars):
    assert streaming.chunk_text(text, max_chars) == jstreaming.chunk_text(text, max_chars)


@pytest.mark.parametrize("cuts", [(2400, 9000), (5000, 7400, 12000), (30000,)])
def test_watermark_offset_continues_across_chunks(cuts):
    """Chunks watermarked with offset= carry the one-shot's chip sequence
    from where the last chunk stopped (the template at the offset is the
    whole's, sample for sample), so the concatenated stream detects; each
    chunk's mark equals the JAX package's. The chunks' envelopes and band
    levels are their own, so the samples are not the one-shot's."""
    from chatterbox_tpu_torch.utils import watermark as W
    rng = np.random.default_rng(70)
    t = np.arange(48000) / 24000
    wav = (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
           + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
    edges = (0,) + cuts + (len(wav),)
    whole = W._template("chatterbox-tpu", len(wav), 24000)
    parts = []
    for a, b in zip(edges[:-1], edges[1:]):
        np.testing.assert_array_equal(W._template("chatterbox-tpu", b - a, 24000, offset=a),
                                      whole[a:b])
        out = Watermarker().apply_watermark(wav[a:b], sample_rate=24000, offset=a)
        np.testing.assert_array_equal(
            out, JWatermarker().apply_watermark(wav[a:b], sample_rate=24000, offset=a))
        parts.append(out)
    stream = np.concatenate(parts)
    assert Watermarker().get_watermark(stream, sample_rate=24000) == 1.0
    assert Watermarker().get_watermark(wav, sample_rate=24000) == 0.0
