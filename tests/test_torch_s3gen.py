"""The port's S3Gen (chatterbox_tpu_torch/models/s3gen: meanflow for Turbo,
10-step CFG flow matching for the 520M family) held against chatterbox_tpu
on the JAX CPU backend at FlowDims.tiny_test() with a 32-channel HiFT,
float32 on both sides, the same noise handed to both (the JAX draws are
reproduced here from its own keys, in its own split order)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.api.pipelines import drop_invalid_tokens_sliced  # noqa: E402
from chatterbox_tpu.models.s3gen import flow as jflow  # noqa: E402
from chatterbox_tpu.models.s3gen import hift as jhift  # noqa: E402
from chatterbox_tpu.models.s3gen import model as jmodel  # noqa: E402
from chatterbox_tpu.models.s3gen.model import RefDict as JRefDict  # noqa: E402
from chatterbox_tpu.models.s3gen.model import S3GenEngine as JEngine  # noqa: E402

from chatterbox_tpu_torch.convert.from_jax import s3gen_from_jax  # noqa: E402
from chatterbox_tpu_torch.models.s3gen import flow, hift  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.model import (RefDict, S3GenEngine,  # noqa: E402
                                                     S3GenNoise, pack_tokens)

DIMS = flow.FlowDims.tiny_test()
JDIMS = jflow.FlowDims.tiny_test()
HIFT_BASE = 32
P = 64            # prompt tokens; with 61 generated + 3 silence tokens the
N_GEN = 61        # JAX engine's token and mel buckets (128, 128) are exact


def _params(meanflow):
    k1, k2 = jax.random.split(jax.random.key(0))
    jp = {"flow": jflow.flow_init(k1, meanflow=meanflow, dims=JDIMS),
          "mel2wav": jhift.hift_init(k2, base_channels=HIFT_BASE)}
    tp = s3gen_from_jax(jax.tree.map(np.asarray, jp), dims=DIMS, hift_base=HIFT_BASE,
                        meanflow=meanflow, device="cpu")
    return jp, tp


_CACHE = {}


def params(meanflow=True):
    if meanflow not in _CACHE:
        _CACHE[meanflow] = _params(meanflow)
    return _CACHE[meanflow]


def _ref(rng):
    return (rng.integers(0, 6561, (1, P)).astype(np.int32), np.array([P], np.int32),
            (rng.standard_normal((1, 2 * P, 80)) * 0.5).astype(np.float32),
            rng.standard_normal((1, 192)).astype(np.float32))


def test_flow_mels_match_with_given_noise():
    jp, tp = params()
    rng = np.random.default_rng(0)
    G = 20
    prompt, _, feat, emb = _ref(rng)
    tokens = np.concatenate([prompt, rng.integers(0, 6561, (1, G))], axis=1)
    T = tokens.shape[1]
    z = rng.standard_normal((1, 2 * T, 80)).astype(np.float32)
    ref = jflow.flow_inference(
        jp["flow"], token=jnp.asarray(tokens, jnp.int32), token_len=jnp.asarray([T]),
        prompt_len=jnp.asarray([P]), prompt_feat=jnp.asarray(feat),
        embedding=jnp.asarray(emb), key=jax.random.key(1), n_timesteps=2,
        meanflow=True, noise=jnp.asarray(z), noise_aligned=True, dims=JDIMS)
    out = flow.flow_inference(tp["flow"], torch.from_numpy(tokens).long(), P,
                              torch.from_numpy(feat), torch.from_numpy(emb),
                              torch.from_numpy(z), n_timesteps=2, dims=DIMS)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    # float32 on both sides; convolution and matmul summation order differ
    # (7e-7 measured on mels of scale 4.5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_cfg_flow_mels_match_with_given_noise():
    """The 520M flow: cosine t-span, 10 Euler steps, one batch-2 UNet call
    per step whose uncond half has mu, spks and cond zeroed; the noise
    covers the whole [prompt | gen] buffer."""
    jp, tp = params(meanflow=False)
    rng = np.random.default_rng(7)
    G = 16
    prompt, _, feat, emb = _ref(rng)
    tokens = np.concatenate([prompt, rng.integers(0, 6561, (1, G))], axis=1)
    T = tokens.shape[1]
    z = rng.standard_normal((1, 2 * T, 80)).astype(np.float32)
    ref = jflow.flow_inference(
        jp["flow"], token=jnp.asarray(tokens, jnp.int32), token_len=jnp.asarray([T]),
        prompt_len=jnp.asarray([P]), prompt_feat=jnp.asarray(feat),
        embedding=jnp.asarray(emb), key=jax.random.key(1), n_timesteps=10,
        meanflow=False, noise=jnp.asarray(z), noise_aligned=True, dims=JDIMS)
    out = flow.flow_inference(tp["flow"], torch.from_numpy(tokens).long(), P,
                              torch.from_numpy(feat), torch.from_numpy(emb),
                              torch.from_numpy(z), n_timesteps=10, dims=DIMS,
                              meanflow=False)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    # float32 on both sides, ten steps of summation-order differences
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_hift_decode_matches_with_fixed_source():
    jp, tp = params()
    rng = np.random.default_rng(1)
    T = 24
    mel = rng.standard_normal((1, T, 80)).astype(np.float32)
    s = (rng.standard_normal((1, T * 480, 1)) * 0.1).astype(np.float32)
    ref = np.asarray(jhift.hift_decode(jp["mel2wav"], jnp.asarray(mel), jnp.asarray(s)))
    out = hift.hift_decode(tp["mel2wav"], torch.from_numpy(mel), torch.from_numpy(s))
    assert out.shape == ref.shape == (1, T * 480)
    # torch.stft/istft against the JAX matmul-DFT, float32 rounding (1.2e-7
    # measured)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_hift_source_matches_with_given_phase_and_noise():
    jp, tp = params()
    rng = np.random.default_rng(2)
    T = 24
    f0 = np.abs(rng.standard_normal((1, T)) * 150 + 100).astype(np.float32)
    f0[:, :4] = 0.0                                     # some unvoiced frames
    key = jax.random.key(3)
    ref = np.asarray(jhift.hift_source(jp["mel2wav"], key, jnp.asarray(f0)))
    k_phase, k_noise = jax.random.split(key)            # hift.py's own split
    phase = jax.random.uniform(k_phase, (1, 1, 9), minval=-jnp.pi, maxval=jnp.pi)
    noise_u = jax.random.normal(k_noise, (1, T * 480, 9))
    noise = hift.SourceNoise(torch.from_numpy(np.array(phase)),
                             torch.from_numpy(np.array(noise_u)))
    out = hift.hift_source(tp["mel2wav"], torch.from_numpy(f0), noise)
    assert out.shape == ref.shape == (1, T * 480, 1)
    # the port sums the harmonic phase in float64, JAX in float32: at these
    # f0 (up to ~500 Hz) over 11520 samples the phases differ by ~1e-4 rad
    # (1.2e-5 measured on the source)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5)


def jax_vocode_noise(key, n_mel, n_gen_mel, meanflow=True):
    """The draws the JAX fused vocoder makes from `key` (model.py
    k_noise/k_flow/k_hift split, cfm.py noise placement, hift.py split),
    for exact buckets: the flow buffer is n_mel frames, of which the last
    n_gen_mel are vocoded. Meanflow draws the generated region's noise
    apart; the CFG flow draws the whole buffer from k_flow."""
    k_noise, k_flow, k_hift = jax.random.split(key, 3)
    z = np.array(jax.random.normal(k_flow, (1, n_mel, 80)))
    if meanflow:
        noise = np.asarray(jax.random.normal(k_noise, (1, n_mel, 80)))
        p_mel = n_mel - n_gen_mel
        z[:, p_mel:] = noise[:, : n_gen_mel]
    k_phase, k_src = jax.random.split(k_hift)
    phase = jax.random.uniform(k_phase, (1, 1, 9), minval=-jnp.pi, maxval=jnp.pi)
    noise_u = jax.random.normal(k_src, (1, n_gen_mel * 480, 9))
    return S3GenNoise(torch.from_numpy(z), hift.SourceNoise(
        torch.from_numpy(np.array(phase)), torch.from_numpy(np.array(noise_u))))


def test_pack_tokens_matches_jax_filter():
    rng = np.random.default_rng(4)
    gen = rng.integers(0, 6564, (40,)).astype(np.int32)
    gen[3] = 6561
    gen[9] = 6563
    prompt = rng.integers(0, 6561, (1, 10)).astype(np.int32)
    eng = JEngine({"flow": None, "mel2wav": None}, meanflow=True, dims=JDIMS)
    row, tl = eng._pack_from_decode(jnp.asarray(gen), jnp.asarray(30),
                                    jnp.asarray(prompt), jnp.asarray(10), bucket=64,
                                    append_sil=3, cfg_slice=False, sos=6561,
                                    eos=6562, vocab=6561)
    out = pack_tokens(torch.from_numpy(gen), 30, torch.from_numpy(prompt), 3)
    n = int(np.asarray(tl)[0])
    np.testing.assert_array_equal(out.numpy(), np.asarray(row)[:, :n])


# (stream, n_raw): SOS and EOS in range, ids >= 6561, EOS before SOS, an
# empty slice, a stream with neither special
_CFG_STREAMS = [
    ([5, 6561, 7, 8, 6563, 9, 6562, 10, 6562], 9),
    ([5, 6561, 7, 8, 6563, 9, 6562, 10, 11], 5),
    ([6562, 3, 6561, 4, 5], 5),
    ([6561, 6562, 1, 2], 4),
    ([1, 8000, 2, 3, 6561], 4),
]


@pytest.mark.parametrize("stream,n_raw", _CFG_STREAMS)
def test_cfg_pack_tail_matches_jax(stream, n_raw):
    """The 520M token tail: slice strictly between the first SOS and the
    first EOS among the first n_raw, drop ids >= 6561, vocode one silence
    token when nothing is left, append no silence."""
    gen = np.asarray(stream + [6562] * 3, np.int32)
    prompt = np.arange(10, 20, dtype=np.int32)[None]
    host = drop_invalid_tokens_sliced(gen[:n_raw])
    host = host[host < 6561]
    if host.size == 0:
        host = np.array([4299])
    eng = JEngine({"flow": None, "mel2wav": None}, meanflow=False, dims=JDIMS)
    row, tl = eng._pack_from_decode(jnp.asarray(gen), jnp.asarray(n_raw),
                                    jnp.asarray(prompt), jnp.asarray(10), bucket=64,
                                    append_sil=0, cfg_slice=True, sos=6561,
                                    eos=6562, vocab=6561)
    out = pack_tokens(torch.from_numpy(gen), n_raw, torch.from_numpy(prompt),
                      cfg_slice=True)
    np.testing.assert_array_equal(out.numpy()[0, 10:], host)
    np.testing.assert_array_equal(out.numpy(), np.asarray(row)[:, :int(np.asarray(tl)[0])])


# Other specials and a wider vocabulary, every kept id below the flow's
# 6561 rows: (cfg_slice, append_sil, sos, eos, vocab)
_KNOBS = [(False, 2, 6561, 6562, 8194),
          (True, 0, 7000, 7001, 8194),
          (True, 0, 3, 4, 6561)]


def _knob_tokens(sos, eos, vocab):
    """40 ids: kept ids below 6561, ids in [6561, vocab) only where nothing
    keeps them, ids >= vocab, and the specials sos / eos (sos at 2, eos at 30)."""
    rng = np.random.default_rng(12)
    gen = rng.integers(5, 6561, (40,)).astype(np.int32)
    gen[[2, 30]] = sos, eos
    gen[[9, 17]] = vocab + 6, vocab + 100            # dropped by the vocab filter
    if vocab > 6561:
        gen[[0, 33]] = 6561 + 7, vocab - 1           # outside the sos..eos slice
    return gen


@pytest.mark.parametrize("cfg_slice,append_sil,sos,eos,vocab", _KNOBS)
def test_pack_tokens_with_other_specials_matches_jax(cfg_slice, append_sil, sos, eos, vocab):
    gen = _knob_tokens(sos, eos, vocab)
    prompt = np.arange(10, 20, dtype=np.int32)[None]
    if not cfg_slice:                                # Turbo keeps every id below vocab
        gen[[0, 2, 30, 33]] = 11, 12, 13, 14
    eng = JEngine({"flow": None, "mel2wav": None}, meanflow=not cfg_slice, dims=JDIMS)
    row, tl = eng._pack_from_decode(jnp.asarray(gen), jnp.asarray(36),
                                    jnp.asarray(prompt), jnp.asarray(10), bucket=64,
                                    append_sil=append_sil, cfg_slice=cfg_slice, sos=sos,
                                    eos=eos, vocab=vocab)
    out = pack_tokens(torch.from_numpy(gen), 36, torch.from_numpy(prompt), append_sil,
                      cfg_slice, sos=sos, eos=eos, vocab=vocab)
    np.testing.assert_array_equal(out.numpy(), np.asarray(row)[:, :int(np.asarray(tl)[0])])
    assert out.shape[1] > 10 + append_sil


@pytest.mark.parametrize("cfg_slice", [False, True])
def test_pack_tokens_raises_on_a_kept_id_the_flow_cannot_embed(cfg_slice):
    """vocab = 8194 keeps ids 6561..8193, which index past the flow's
    embedding: the port raises (the JAX gather gives NaN embeddings)."""
    gen = _knob_tokens(7000, 7001, 8194)
    gen[[0, 33]] = 11, 12
    gen[20] = 7500                                   # kept by both tails, the largest
    prompt = torch.arange(10, 20)[None]
    with pytest.raises(ValueError, match="7500.*8194"):
        pack_tokens(torch.from_numpy(gen), 36, prompt, cfg_slice=cfg_slice, sos=7000,
                    eos=7001, vocab=8194)
    gen[20] = 8194                                   # at vocab: dropped, no error
    if not cfg_slice:
        gen[[2, 30]] = 13, 14                        # Turbo keeps the specials too
    pack_tokens(torch.from_numpy(gen), 36, prompt, cfg_slice=cfg_slice, sos=7000,
                eos=7001, vocab=8194)


def test_inference_from_decode_with_other_specials_matches_jax(monkeypatch):
    """The 520M tail (cfg_slice) with sos 7000, eos 7001 and vocab 8194 on
    the meanflow engine, the JAX buckets pinned to the exact lengths (C7)."""
    jp, tp = params()
    rng = np.random.default_rng(13)
    prompt, plen, feat, emb = _ref(rng)
    gen = _knob_tokens(7000, 7001, 8194)
    n_gen = 27 - 2                                   # ids 3..29 less the two >= vocab
    monkeypatch.setattr(jmodel, "TOKEN_BUCKETS", (P + n_gen,))
    monkeypatch.setattr(jmodel, "GEN_MEL_BUCKETS", (2 * n_gen,))
    key = jax.random.key(14)
    tail = dict(cfg_slice=True, sos=7000, eos=7001, vocab=8194)
    eng = JEngine(jp, meanflow=True, dims=JDIMS)
    eng.pcm16_fetch = False
    ref, n_ref = eng.inference_from_decode(jnp.asarray(gen), 36,
                                           JRefDict(prompt, plen, feat, emb), key,
                                           n_timesteps=2, **tail)
    noise = jax_vocode_noise(key, 2 * (P + n_gen), 2 * n_gen)
    out, n_out = S3GenEngine(tp, dims=DIMS).inference_from_decode(
        torch.from_numpy(gen), 36, RefDict(prompt, plen, feat, emb), noise=noise, **tail)
    assert n_out == n_ref == n_gen
    assert out.shape == ref.shape == (1, n_gen * 2 * 480) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)   # as the test below
    with pytest.raises(ValueError, match="flow embeds only 6561"):
        S3GenEngine(tp, dims=DIMS).inference_from_decode(
            torch.from_numpy(gen), 36, RefDict(prompt, plen, feat, emb), noise=noise,
            **dict(tail, cfg_slice=False))


def test_inference_from_decode_waveform_matches():
    jp, tp = params()
    rng = np.random.default_rng(5)
    prompt, plen, feat, emb = _ref(rng)
    gen = rng.integers(0, 6561, (70,)).astype(np.int32)
    gen[N_GEN:] = 6562                                  # past n_tokens: ignored
    key = jax.random.key(6)
    eng = JEngine(jp, meanflow=True, dims=JDIMS)
    eng.pcm16_fetch = False
    ref, n_ref = eng.inference_from_decode(
        jnp.asarray(gen), N_GEN, JRefDict(prompt, plen, feat, emb), key,
        n_timesteps=2, append_sil=3)
    n_mel = 2 * (P + N_GEN + 3)
    noise = jax_vocode_noise(key, n_mel, 2 * (N_GEN + 3))
    port = S3GenEngine(tp, dims=DIMS)
    out, n_out = port.inference_from_decode(
        torch.from_numpy(gen), torch.tensor(N_GEN), RefDict(prompt, plen, feat, emb),
        noise=noise, append_sil=3)
    assert n_out == n_ref == N_GEN + 3
    assert out.shape == ref.shape == (1, (N_GEN + 3) * 2 * 480)
    assert np.isfinite(out).all()
    # flow + HiFT in float32: summation order, STFT formulation and the
    # float64 harmonic phase (1.5e-7 measured on a wave of scale 0.16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_unmapped_keys_raise():
    jp, _ = params()
    tree = jax.tree.map(np.asarray, jp)
    tree["mel2wav"]["conv_post"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        s3gen_from_jax(tree, dims=DIMS, hift_base=HIFT_BASE, device="cpu")


@pytest.mark.parametrize("cin,cout,k,stride", [(32, 16, 16, 8), (16, 8, 11, 5), (8, 4, 7, 3),
                                               (4, 3, 5, 1)])
def test_conv_transpose_by_phases_matches_torch(cin, cout, k, stride):
    """nn.conv_transpose1d_cf (one ordinary convolution by output phases,
    HiFT's upsamplers) against F.conv_transpose1d, with and without a bias:
    the same shape and values to float32 rounding."""
    import torch.nn.functional as F
    from chatterbox_tpu_torch.nn import core as nn
    g = torch.Generator().manual_seed(cin + k)
    w = torch.randn(cin, cout, k, generator=g)
    b = torch.randn(cout, generator=g)
    x = torch.randn(2, cin, 9, generator=g)
    pad = (k - stride) // 2
    for p in ({"w": w, "b": b}, {"w": w}):
        ref = F.conv_transpose1d(x, w, p.get("b"), stride=stride, padding=pad)
        out = nn.conv_transpose1d_cf(p, x, stride, pad)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=2e-5)
