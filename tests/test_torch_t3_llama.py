"""The port's 520M-family T3 (chatterbox_tpu_torch: llama backbone with
RoPE, perceiver, emotion input, learned positions, the CFG sampler and the
batch-2 CFG decode) held against chatterbox_tpu on the JAX CPU backend: a
2-layer Llama_fused_test T3, quantized int8_fused by the JAX package and
carried across with convert/from_jax.py. JAX's Pallas kernels run in
interpret mode, the port's kernels as their plain versions (CPU tensors)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.models.t3 import backbone as jbb  # noqa: E402
from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.models.t3.config import T3Config as JT3Config  # noqa: E402
from chatterbox_tpu.ops import sampling as JS  # noqa: E402
from chatterbox_tpu.sampling.chunked import t3_generate_bucketed  # noqa: E402
from chatterbox_tpu.sampling.decode import t3_generate as jax_generate  # noqa: E402
from chatterbox_tpu.utils.dtypes import cast_params as jcast  # noqa: E402
from chatterbox_tpu.utils.quantize import quantize_t3_backbone as jquant  # noqa: E402

from chatterbox_tpu_torch.convert.from_jax import t3_from_jax  # noqa: E402
from chatterbox_tpu_torch.models.t3 import backbone as bb  # noqa: E402
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.models.t3.config import T3Config  # noqa: E402
from chatterbox_tpu_torch.ops import sampling as S  # noqa: E402
from chatterbox_tpu_torch.sampling.decode import (build_prefix, decode_step,  # noqa: E402
                                                  t3_generate)

HP_KW = dict(text_tokens_dict_size=64, backbone_name="Llama_fused_test",
             speech_tokens_dict_size=6564, input_pos_emb="learned",
             speech_cond_prompt_len=8, use_perceiver_resampler=True,
             emotion_adv=True, max_text_tokens=64, max_speech_tokens=128)
JHP, HP = JT3Config(**HP_KW), T3Config(**HP_KW)
TEXT = np.array([[60, 5, 17, 3, 42, 9, 11, 0]], np.int64)   # framed text ids
FORCED = [17, 6000, 4299, 12, 3001, 77]                      # teacher-forced tokens
EMOTION = 0.7


def _models(dtype, mode):
    params = jt3m.t3_init(jax.random.key(0), JHP)
    if dtype == "bf16":
        params = jcast(params, jnp.bfloat16)
    if mode is not None:
        params = jquant(params, mode=mode)
    return params, t3_from_jax(jax.tree.map(np.asarray, params), HP, device="cpu")


_CACHE = {}


def models(dtype="f32", mode="int8_fused"):
    if (dtype, mode) not in _CACHE:
        _CACHE[dtype, mode] = _models(dtype, mode)
    return _CACHE[dtype, mode]


def _cond(rng):
    spk = rng.standard_normal((1, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (1, HP.speech_cond_prompt_len))
    jcond = jt3m.T3CondArrays(jnp.asarray(spk), jnp.asarray(prompt, jnp.int32),
                              jnp.full((1, 1, 1), EMOTION))
    tcond = t3m.T3CondTensors(torch.from_numpy(spk), torch.from_numpy(prompt),
                              torch.full((1, 1, 1), EMOTION))
    return jcond, tcond


@pytest.mark.parametrize("dtype,atol", [("f32", 2e-5), ("bf16", 2e-2)])
def test_perceiver_cond_embeds_match(dtype, atol):
    """[speaker | perceiver(prompt + learned positions) | emotion] prefix.
    f32: summation order only (4.6e-7 of scale measured). bf16: every op
    rounds to bf16, XLA keeps some chains in f32 (5.4e-3 of scale
    measured)."""
    qp, tp = models(dtype)
    jcond, tcond = _cond(np.random.default_rng(0))
    ref = np.asarray(jt3m.cond_embeds(qp, JHP, jcond).astype(jnp.float32))
    out = torch.cat([p.float() for p in t3m.cond_embeds(tp, HP, tcond)], dim=1).numpy()
    assert out.shape == ref.shape == (1, t3m.cond_len(HP), HP.backbone.hidden_size)
    assert t3m.cond_len(HP) == jt3m.cond_len(JHP) == 34
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol * np.abs(ref).max())


def _jax_cfg_teacher_forced(qp, jcond):
    """The CFG prefix [cond | text | BOS | BOS] at batch 2 (row 1 with its
    text embeddings zeroed), prefill, then one decode step per FORCED token
    at speech position step + 1: the calls the JAX decode engine makes."""
    cfg, B, Lt = JHP.backbone, 2, TEXT.shape[1]
    dt = qp["speech_emb"]["w"].dtype
    ce = jt3m.cond_embeds(qp, JHP, jcond)
    ce = jnp.broadcast_to(ce, (B,) + ce.shape[1:])
    te = jnp.take(qp["text_emb"]["w"], jnp.broadcast_to(jnp.asarray(TEXT), (B, Lt)), axis=0)
    te = te * jnp.array([1.0, 0.0])[:, None, None]
    te = te + jnp.take(qp["text_pos_emb"]["w"], jnp.arange(Lt), axis=0)
    bos = jt3m.speech_embed_token(qp, JHP, jnp.full((B,), JHP.start_speech_token),
                                  jnp.zeros((), jnp.int32))
    x = jnp.concatenate([ce.astype(dt), te.astype(dt), bos.astype(dt), bos.astype(dt)],
                        axis=1)
    P = x.shape[1]
    t_max = P + len(FORCED)
    cache = jbb.KVCache.zeros(cfg, B, t_max)
    h, cache = jbb.backbone_apply_unrolled(
        qp["backbone"], cfg, x, jnp.tile(jnp.arange(P)[None], (B, 1)), cache,
        jnp.zeros((), jnp.int32), jbb.prefill_mask(P, t_max, jnp.full((B,), P)))
    out = [jt3m.speech_logits(qp, h[:, -1]).astype(jnp.float32)]
    for i, tok in enumerate(FORCED[:-1]):
        emb = jt3m.speech_embed_token(qp, JHP, jnp.full((B,), tok), jnp.asarray(i + 1))
        pos = P + i
        h, cache = jbb.backbone_apply_unrolled(
            qp["backbone"], cfg, emb, jnp.full((B, 1), pos), cache, jnp.asarray(pos),
            jbb.decode_mask(t_max, jnp.full((B,), pos)))
        out.append(jt3m.speech_logits(qp, h[:, 0]).astype(jnp.float32))
    return np.stack([np.asarray(o) for o in out])


def _port_cfg_teacher_forced(tp, tcond):
    x = build_prefix(tp, HP, tcond, torch.from_numpy(TEXT), 2, cfg_mode=True)
    P = x.shape[1]
    cache = bb.KVCache.zeros(HP.backbone, 2, P + len(FORCED), "cpu")
    h = bb.backbone_apply(tp["backbone"], HP.backbone, x,
                          torch.arange(P)[None].expand(2, -1), cache, 0)
    out = [t3m.speech_logits(tp, h[:, -1]).float()]
    for i, tok in enumerate(FORCED[:-1]):
        out.append(decode_step(tp, HP, torch.tensor(tok), i, cache, P + i))
    return torch.stack(out).numpy()


# Tolerances are relative to the largest logit. f32 params: the same
# arithmetic in another summation order, but the fused kernels round their
# norm output and hidden units to bf16 and the KV cache is bf16, so an order
# difference can flip such a rounding and each decode step compounds it.
# bf16 params: every activation (RoPE included) rounds to bf16 between ops.
# Float params keep the activations in f32; only the bf16 cache rounds.
# Measured: 1.0e-3, 6.3e-3 and 2.2e-5 of scale (~2.5).
@pytest.mark.parametrize("dtype,mode,atol", [("f32", "int8_fused", 3e-3),
                                             ("bf16", "int8_fused", 3e-2),
                                             ("f32", None, 3e-4)])
def test_cfg_teacher_forced_logits_match(dtype, mode, atol):
    qp, tp = models(dtype, mode)
    jcond, tcond = _cond(np.random.default_rng(1))
    ref = _jax_cfg_teacher_forced(qp, jcond)
    out = _port_cfg_teacher_forced(tp, tcond)
    assert out.shape == ref.shape == (len(FORCED), 2, HP.speech_tokens_dict_size)
    assert np.isfinite(out).all()
    # the rows differ: the uncond row really lost its text
    assert np.abs(out[:, 0] - out[:, 1]).max() > 1e-3
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol * max(scale, 1.0))


@pytest.mark.parametrize("top_p,min_p,temp,w", [(1.0, 0.05, 0.8, 0.5),
                                                (0.9, 0.05, 0.8, 0.5),
                                                (1.0, 0.0, 1.0, 0.0),
                                                (0.8, 0.1, 1.3, 0.3)])
def test_process_logits_cfg_matches(top_p, min_p, temp, w):
    rng = np.random.default_rng(int(top_p * 10 + min_p * 100))
    V = 8194
    cond = (rng.standard_normal(V) * 3).astype(np.float32)
    uncond = (cond + rng.standard_normal(V)).astype(np.float32)
    seen = rng.random(V) < 0.05
    ref = np.asarray(JS.process_logits_cfg(
        jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(seen),
        JS.SamplerParams.make(temperature=temp, top_p=top_p, min_p=min_p,
                              repetition_penalty=1.2, cfg_weight=w)))
    out = S.process_logits_cfg(torch.from_numpy(cond), torch.from_numpy(uncond),
                               torch.from_numpy(seen),
                               S.SamplerParams(temp, top_p, 1.2, min_p, w)).numpy()
    np.testing.assert_array_equal(out <= S.NEG_INF, ref <= JS.NEG_INF)
    kept = ref > JS.NEG_INF
    assert kept.sum() > 0
    np.testing.assert_allclose(out[kept], ref[kept], rtol=1e-6)


def _jax_text():
    text = np.zeros((1, 32), np.int32)
    text[0, :TEXT.shape[1]] = TEXT[0]
    return jnp.asarray(text), jnp.asarray(TEXT.shape[1])


# min_p = 1 keeps only the most likely token, so both engines decode
# greedily whatever their random numbers
GREEDY = dict(temperature=0.8, top_p=1.0, min_p=1.0, repetition_penalty=1.3,
              cfg_weight=0.5)


@pytest.mark.parametrize("batch2", [True, False])
def test_greedy_cfg_tokens_equal(batch2):
    qp, tp = models()
    jcond, tcond = _cond(np.random.default_rng(2))
    n = 10
    jres = jax_generate(qp, JHP, jcond, *_jax_text(), JS.SamplerParams.make(**GREEDY),
                        jax.random.key(3), max_new_tokens=n, cfg_mode=True,
                        cfg_batch2=batch2)
    res = t3_generate(tp, HP, tcond, torch.from_numpy(TEXT), S.SamplerParams(**GREEDY),
                      max_new_tokens=n, cfg_mode=True, cfg_batch2=batch2,
                      generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert int(res.n_tokens) == int(jres.n_tokens)
    assert len(set(res.tokens.tolist())) > 1


def test_one_engine_equals_the_bucketed_engine():
    """The JAX package grows its cache in doubling segments for XLA's static
    shapes; the port's single engine gives the same tokens."""
    qp, tp = models()
    jcond, tcond = _cond(np.random.default_rng(4))
    n = 12
    jres = t3_generate_bucketed(qp, JHP, jcond, *_jax_text(),
                                JS.SamplerParams.make(**GREEDY), jax.random.key(5),
                                max_new_tokens=n, cfg_mode=True, first_segment=4)
    res = t3_generate(tp, HP, tcond, torch.from_numpy(TEXT), S.SamplerParams(**GREEDY),
                      max_new_tokens=n, cfg_mode=True)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert int(res.n_tokens) == int(jres.n_tokens)


def test_sampled_cfg_tokens_equal_with_jax_gumbel_draws():
    """Replaying the JAX loop's own key splits (key, sub = split(key) per
    step, categorical(sub) = argmax(logits + gumbel(sub))) gives its
    tokens."""
    qp, tp = models()
    jcond, tcond = _cond(np.random.default_rng(6))
    n, V = 10, HP.speech_tokens_dict_size
    kw = dict(temperature=0.8, top_p=1.0, min_p=0.05, repetition_penalty=1.2,
              cfg_weight=0.5)
    key = jax.random.key(7)
    jres = jax_generate(qp, JHP, jcond, *_jax_text(), JS.SamplerParams.make(**kw), key,
                        max_new_tokens=n, cfg_mode=True)
    draws, k = [], key
    for _ in range(n):
        k, sub = jax.random.split(k)
        draws.append(np.asarray(jax.random.gumbel(sub, (V,), jnp.float32)))
    res = t3_generate(tp, HP, tcond, torch.from_numpy(TEXT), S.SamplerParams(**kw),
                      max_new_tokens=n, cfg_mode=True,
                      gumbel=torch.from_numpy(np.stack(draws)))
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert int(res.n_tokens) == int(jres.n_tokens)
    assert len(set(res.tokens.tolist())) > 2      # really sampled


def test_fused_operands_link_to_qkv_row_slices():
    qp, tp = models()
    lp = tp["backbone"]["layers"][0]
    D = HP.backbone.hidden_size
    assert lp["v"]["w_q"].data_ptr() == lp["fused"]["qkv_wt"][2 * D:].data_ptr()
    np.testing.assert_array_equal(lp["q"]["w_q"].numpy(),
                                  np.asarray(qp["backbone"]["layers"][0]["q"]["w_q"]))
    tree = jax.tree.map(np.asarray, qp)
    tree["backbone"]["layers"][1]["k"]["w_q"] = tree["backbone"]["layers"][1]["k"]["w_q"] + 1
    with pytest.raises(ValueError):
        t3_from_jax(tree, HP, device="cpu")
    tree = jax.tree.map(np.asarray, qp)
    del tree["backbone"]["layers"][0]["fused"]["sg_8"]
    with pytest.raises(KeyError):
        t3_from_jax(tree, HP, device="cpu")
