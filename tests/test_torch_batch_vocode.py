"""The port's batched vocode (chatterbox_tpu_torch/models/s3gen: the lens
masks of the encoder, the mask of the UNet and both solvers,
`flow_inference_batch`, `S3GenEngine.inference_batch` and its dispatch /
fetch halves) held against chatterbox_tpu on the JAX CPU backend and
against the port's own single-request calls, at FlowDims.tiny_test() with a
32-channel HiFT, float32, rows of different prompt and generated lengths in
different voices. JAX's noise is handed to the port: its flow noise over
the padded batch, its HiFT keys' phases and source noise."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.models.s3gen import encoder as jenc  # noqa: E402
from chatterbox_tpu.models.s3gen import flow as jflow  # noqa: E402
from chatterbox_tpu.models.s3gen import hift as jhift  # noqa: E402
from chatterbox_tpu.models.s3gen import unet as junet  # noqa: E402

from chatterbox_tpu_torch.models.s3gen import encoder, flow, unet  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.hift import SourceNoise, hift_inference  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.model import (RefDict, S3GenEngine,  # noqa: E402
                                                     S3GenNoise, pack_prompt_gen,
                                                     trim_fade)

from tests.test_torch_convert import few_threads  # noqa: E402,F401
from tests.test_torch_s3gen import DIMS, JDIMS, params  # noqa: E402

PS, GS = (6, 10, 8), (5, 12, 9)           # three rows: prompt and generated tokens


def _voice(rng, P):
    return RefDict(rng.integers(0, 6561, (1, P)).astype(np.int32), np.array([P], np.int32),
                   (rng.standard_normal((1, 2 * P, 80)) * 0.5).astype(np.float32),
                   rng.standard_normal((1, 192)).astype(np.float32))


def _batch(seed, Ps=PS, Gs=GS):
    """Voices of prompt lengths Ps and generated rows of lengths Gs."""
    rng = np.random.default_rng(seed)
    refs = [_voice(rng, P) for P in Ps]
    rows = [rng.integers(0, 6561, G).astype(np.int32) for G in Gs]
    return rows, refs


def _packed(rows, refs):
    """The JAX flow's padded inputs: tokens, lengths, padded prompt mels."""
    tokens, Ps, Gs = pack_prompt_gen(rows, refs)
    feat_T = max(r.prompt_feat.shape[1] for r in refs)
    feats = np.zeros((len(refs), feat_T, 80), np.float32)
    for i, r in enumerate(refs):
        feats[i, :r.prompt_feat.shape[1]] = r.prompt_feat[0]
    embs = np.concatenate([r.embedding for r in refs])
    return tokens, np.array([p + g for p, g in zip(Ps, Gs)]), np.array(Ps), feats, embs


def _jax_flow(jp, meanflow, tokens, tlen, plen, feats, embs, key):
    """JAX's masked flow_inference; with no noise given it starts from
    normal(key, mu.shape), which is returned for the port."""
    B, T = tokens.shape
    z = np.asarray(jax.random.normal(key, (B, 2 * T, 80), jnp.float32))
    mels = jflow.flow_inference(
        jp["flow"], token=jnp.asarray(tokens, jnp.int32), token_len=jnp.asarray(tlen),
        prompt_len=jnp.asarray(plen), prompt_feat=jnp.asarray(feats),
        embedding=jnp.asarray(embs), key=key, n_timesteps=2 if meanflow else 10,
        meanflow=meanflow, dims=JDIMS)
    return np.asarray(mels), z


def _port_flow(tp, meanflow, tokens, tlen, plen, feats, embs, z):
    return flow.flow_inference_batch(
        tp["flow"], torch.from_numpy(tokens), torch.from_numpy(tlen), torch.from_numpy(plen),
        torch.from_numpy(feats), torch.from_numpy(embs), torch.from_numpy(z),
        n_timesteps=2 if meanflow else 10, dims=DIMS, meanflow=meanflow).numpy()


# the existing flow tests' tolerances: 1e-5 for 2 meanflow steps, 1e-4 for 10 CFG steps
TOL = {True: 1e-5, False: 1e-4}


def test_masked_encoder_matches_jax():
    """Three rows of 11, 22 and 17 valid tokens in a 22-token buffer:
    JAX's upsample_encoder_apply under its key masks and the zeroed pad,
    over each row's 2 * lens valid frames."""
    jp, tp = params()
    rng = np.random.default_rng(1)
    lens = np.array([11, 22, 17])
    x = rng.standard_normal((3, 22, DIMS.enc_dim)).astype(np.float32)
    ref, ref_lens = jenc.upsample_encoder_apply(
        jp["flow"]["encoder"], jnp.asarray(x), jnp.asarray(lens), d=DIMS.enc_dim,
        n_heads=DIMS.enc_heads)
    out = encoder.upsample_encoder_apply(tp["flow"]["encoder"], torch.from_numpy(x),
                                         d=DIMS.enc_dim, n_heads=DIMS.enc_heads,
                                         lens=torch.from_numpy(lens)).numpy()
    assert out.shape == ref.shape == (3, 44, DIMS.enc_dim)
    np.testing.assert_array_equal(np.asarray(ref_lens), 2 * lens)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(out[b, :2 * n], np.asarray(ref)[b, :2 * n], rtol=0,
                                   atol=1e-5)


def test_masked_unet_matches_jax():
    """The meanflow estimator at rows of 14, 30 and 21 valid frames: JAX's
    unet_apply with its mask; outside the mask both return zeros."""
    jp, tp = params()
    rng = np.random.default_rng(2)
    B, T = 3, 30
    x, mu, cond = (rng.standard_normal((B, T, 80)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((B, 80)).astype(np.float32)
    t, r = np.full((B,), 0.25, np.float32), np.full((B,), 0.75, np.float32)
    mask = np.arange(T)[None] < np.array([14, 30, 21])[:, None]
    ref = junet.unet_apply(jp["flow"]["decoder"], *map(jnp.asarray, (x, mask, mu, t, spks,
                                                                     cond)),
                           r=jnp.asarray(r), n_heads=DIMS.unet_heads)
    out = unet.unet_apply(tp["flow"]["decoder"], *map(torch.from_numpy, (x, mu, t, spks,
                                                                         cond)),
                          r=torch.from_numpy(r), n_heads=DIMS.unet_heads,
                          mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
    assert (out[~mask] == 0).all()


@pytest.mark.parametrize("meanflow", [True, False])
def test_masked_flow_matches_jax(meanflow):
    """Three rows of different P / G in three voices through one masked
    flow call, on JAX's noise: each row's valid frames equal JAX's
    flow_inference with per-row lengths (meanflow and 10-step CFG)."""
    jp, tp = params(meanflow)
    rows, refs = _batch(3)
    inputs = _packed(rows, refs)
    ref, z = _jax_flow(jp, meanflow, *inputs, jax.random.key(4))
    out = _port_flow(tp, meanflow, *inputs, z)
    assert out.shape == ref.shape
    for b, n in enumerate(inputs[1]):
        np.testing.assert_allclose(out[b, :2 * n], ref[b, :2 * n], rtol=0,
                                   atol=TOL[meanflow])


@pytest.mark.parametrize("meanflow", [True, False])
def test_batched_rows_equal_the_exact_length_flow(meanflow):
    """Padding is invisible: each row of the masked batch equals the port's
    single flow_inference of that row alone at its exact length, on the
    row's own noise."""
    _, tp = params(meanflow)
    rows, refs = _batch(5)
    tokens, tlen, plen, feats, embs = _packed(rows, refs)
    z = np.random.default_rng(6).standard_normal((3, 2 * tokens.shape[1], 80)
                                                 ).astype(np.float32)
    out = _port_flow(tp, meanflow, tokens, tlen, plen, feats, embs, z)
    for b, (n, P) in enumerate(zip(tlen, plen)):
        alone = flow.flow_inference(
            tp["flow"], torch.from_numpy(tokens[b:b + 1, :n]), int(P),
            torch.from_numpy(refs[b].prompt_feat), torch.from_numpy(embs[b:b + 1]),
            torch.from_numpy(z[b:b + 1, :2 * n]), n_timesteps=2 if meanflow else 10,
            dims=DIMS, meanflow=meanflow).numpy()
        np.testing.assert_allclose(out[b, :2 * n], alone[0], rtol=0, atol=1e-5)


def _jax_source(key, n_frames):
    k_phase, k_src = jax.random.split(key)
    return SourceNoise(
        torch.from_numpy(np.asarray(jax.random.uniform(k_phase, (1, 1, 9), minval=-jnp.pi,
                                                       maxval=jnp.pi))),
        torch.from_numpy(np.asarray(jax.random.normal(k_src, (1, n_frames * 480, 9)))))


@pytest.mark.parametrize("meanflow", [True, False])
def test_inference_batch_matches_jax_flow_then_exact_hift(meanflow):
    """Each inference_batch row against JAX: its masked flow_inference on
    the same noise, then hift_inference over that row's exact generated
    region with the row's own key, then the trim-fade."""
    jp, tp = params(meanflow)
    rows, refs = _batch(7)
    inputs = _packed(rows, refs)
    mels, z = _jax_flow(jp, meanflow, *inputs, jax.random.key(8))
    fade = trim_fade()
    noises, expect = [], []
    for b, (n, P) in enumerate(zip(inputs[1], inputs[2])):
        G = n - P
        k = jax.random.key(100 + b)
        gen = jnp.asarray(mels[b:b + 1, 2 * P:2 * n])
        wav = np.array(jhift.hift_inference(jp["mel2wav"], k, gen)[0])[0]
        wav[:len(fade)] *= fade
        expect.append(wav)
        noises.append(S3GenNoise(torch.from_numpy(z[b:b + 1, :2 * n]), _jax_source(k, 2 * G)))
    eng = S3GenEngine(tp, dims=DIMS, meanflow=meanflow)
    out = eng.inference_batch(rows, refs, noises=noises)
    assert [len(w) for w in out] == [g * 960 for g in GS]
    for w, e in zip(out, expect):
        assert np.isfinite(w).all()
        np.testing.assert_allclose(w, e, rtol=0, atol=TOL[meanflow])


@pytest.mark.parametrize("meanflow", [True, False])
def test_inference_batch_rows_equal_inference(meanflow):
    """Per-row generators: each row equals the port's single-request
    `inference` drawn from a generator of the same seed, and a row's
    audio does not depend on its batchmates (alone, or with other rows in
    another order)."""
    _, tp = params(meanflow)
    eng = S3GenEngine(tp, dims=DIMS, meanflow=meanflow)
    rows, refs = _batch(9)
    gens = lambda seeds: [torch.Generator().manual_seed(s) for s in seeds]
    out = eng.inference_batch(rows, refs, gens([11, 12, 13]))
    for b in range(3):
        single = eng.inference(rows[b], refs[b], generator=gens([11 + b])[0])[0]
        np.testing.assert_allclose(out[b], single, rtol=0, atol=1e-5)
    swapped = eng.inference_batch([rows[2], rows[1]], [refs[2], refs[1]], gens([13, 12]))
    np.testing.assert_allclose(swapped[1], out[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(swapped[0], out[2], rtol=0, atol=1e-5)


def test_trim_fade_is_applied_to_each_row():
    """Every row starts with 20 ms of silence and a 20 ms fade-in over its
    own HiFT output, however long the row (one generated token is exactly
    the fade's 960 samples)."""
    _, tp = params()
    eng = S3GenEngine(tp, dims=DIMS)
    rows, refs = _batch(10, Gs=(1, 7, 3))
    noises = [eng.draw_noise(2 * (P + G), 2 * G, torch.Generator().manual_seed(20 + i))
              for i, (P, G) in enumerate(zip(PS, (1, 7, 3)))]
    out = eng.inference_batch(rows, refs, noises=noises)
    inputs = _packed(rows, refs)
    z = np.zeros((3, 2 * inputs[0].shape[1], 80), np.float32)
    for b, nz in enumerate(noises):
        z[b, :nz.z.shape[1]] = nz.z[0].numpy()
    mels = _port_flow(tp, True, *inputs, z)
    fade = trim_fade()
    for b, (n, P) in enumerate(zip(inputs[1], inputs[2])):
        raw = hift_inference(tp["mel2wav"], torch.from_numpy(mels[b:b + 1, 2 * P:2 * n]),
                             noises[b].source)[0][0].numpy()
        assert (out[b][:480] == 0).all()
        np.testing.assert_allclose(out[b][:960], raw[:960] * fade, rtol=0, atol=1e-6)
        np.testing.assert_allclose(out[b][960:], raw[960:], rtol=0, atol=1e-6)


def test_dispatch_and_fetch_halves():
    """Dispatch returns the batch's audio on the device as one flat tensor
    with the rows' lengths, and reads nothing back; fetch splits it. An
    empty row vocodes nothing (as `inference`), a one-row batch works."""
    _, tp = params()
    eng = S3GenEngine(tp, dims=DIMS)
    rows, refs = _batch(11)
    rows[1] = rows[1][:0]
    seeds = [31, 32, 33]
    handle = eng.inference_batch_dispatch(rows, refs,
                                          [torch.Generator().manual_seed(s) for s in seeds])
    flat, lengths = handle
    assert torch.is_tensor(flat) and flat.ndim == 1
    assert lengths == [len(r) * 960 for r in rows] and flat.numel() == sum(lengths)
    out = eng.inference_batch_fetch(handle)
    assert [len(w) for w in out] == lengths and out[1].size == 0
    one = eng.inference_batch([rows[0]], [refs[0]], [torch.Generator().manual_seed(31)])
    np.testing.assert_allclose(one[0], out[0], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="speech token ids"):
        eng.inference_batch([np.array([6561])], [refs[0]])
    with pytest.raises(ValueError, match="generators"):
        eng.inference_batch(rows, refs, [torch.Generator()])


def test_bf16_flow_from_batched_bf16_min_b():
    """Below batched_bf16_min_b the flow stays float32 (bit for bit the
    engine without the switch); at it the encoder and the estimator run in
    bfloat16: close to float32, not equal, and the parameters themselves
    are left as they were."""
    _, tp = params()
    f32 = S3GenEngine(tp, dims=DIMS, batched_bf16_min_b=None)
    bf16 = S3GenEngine(tp, dims=DIMS, batched_bf16_min_b=3)
    rows, refs = _batch(12)
    gens = lambda: [torch.Generator().manual_seed(s) for s in (41, 42, 43)]
    below = bf16.inference_batch(rows[:2], refs[:2], gens()[:2])
    for a, b in zip(below, f32.inference_batch(rows[:2], refs[:2], gens()[:2])):
        np.testing.assert_array_equal(a, b)
    at = bf16.inference_batch(rows, refs, gens())
    ref = f32.inference_batch(rows, refs, gens())
    assert bf16._params_flow_bf16["flow"]["decoder"]["time_mlp"]["lin1"]["w"].dtype \
        == torch.bfloat16
    assert tp["flow"]["decoder"]["time_mlp"]["lin1"]["w"].dtype == torch.float32
    err = max(np.abs(a - b).max() for a, b in zip(at, ref))
    scale = max(np.abs(b).max() for b in ref)
    assert 0 < err < 0.05 * scale, (err, scale)
