"""The port's Turbo T3 (chatterbox_tpu_torch: backbone, model, sampler and
decode engine) held against chatterbox_tpu on the JAX CPU backend: a 2-layer
GPT2_FUSED_TEST T3, quantized int8_fused by the JAX package and carried
across with convert/from_jax.py. JAX's Pallas kernels run in interpret mode,
the port's kernels as their plain versions (CPU tensors)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.models.t3 import backbone as jbb  # noqa: E402
from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.models.t3.config import T3Config as JT3Config  # noqa: E402
from chatterbox_tpu.ops import sampling as JS  # noqa: E402
from chatterbox_tpu.sampling.decode import t3_generate as jax_generate  # noqa: E402
from chatterbox_tpu.utils.dtypes import cast_params as jcast  # noqa: E402
from chatterbox_tpu.utils.quantize import quantize_t3_backbone as jquant  # noqa: E402

from chatterbox_tpu_torch.convert.from_jax import t3_from_jax  # noqa: E402
from chatterbox_tpu_torch.models.t3 import backbone as bb  # noqa: E402
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.models.t3.config import T3Config  # noqa: E402
from chatterbox_tpu_torch.nn import core as nn  # noqa: E402
from chatterbox_tpu_torch.ops import sampling as S  # noqa: E402
from chatterbox_tpu_torch.sampling.decode import t3_generate  # noqa: E402

HP_KW = dict(text_tokens_dict_size=64, backbone_name="GPT2_fused_test",
             speech_tokens_dict_size=6564, input_pos_emb=None,
             speech_cond_prompt_len=8, use_perceiver_resampler=False,
             emotion_adv=False, max_text_tokens=64, max_speech_tokens=128)
JHP, HP = JT3Config(**HP_KW), T3Config(**HP_KW)
TEXT = np.array([[5, 17, 3, 42, 9, 11]], np.int64)
FORCED = [17, 6000, 4299, 12, 3001, 77]        # teacher-forced speech tokens


def _models(dtype, mode):
    params = jt3m.t3_init(jax.random.key(0), JHP)
    if dtype == "bf16":
        params = jcast(params, jnp.bfloat16)
    if mode is not None:
        params = jquant(params, mode=mode)
    return params, t3_from_jax(jax.tree.map(np.asarray, params), HP, device="cpu")


_CACHE = {}


def models(dtype, mode="int8_fused"):
    if (dtype, mode) not in _CACHE:
        _CACHE[dtype, mode] = _models(dtype, mode)
    return _CACHE[dtype, mode]


def _cond(rng):
    spk = rng.standard_normal((1, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (1, HP.speech_cond_prompt_len))
    jcond = jt3m.T3CondArrays(jnp.asarray(spk), jnp.asarray(prompt, jnp.int32), None)
    tcond = t3m.T3CondTensors(torch.from_numpy(spk), torch.from_numpy(prompt))
    return jcond, tcond


def _jax_teacher_forced(qp, jcond):
    """Prefill over the dense [cond | text | BOS] prefix, then one decode
    step per FORCED token, with the JAX package's functions (the same calls
    its decode engine makes)."""
    cfg = JHP.backbone
    dt = qp["speech_emb"]["w"].dtype
    ce = jt3m.cond_embeds(qp, JHP, jcond)
    te = jnp.take(qp["text_emb"]["w"], jnp.asarray(TEXT), axis=0)
    bos = jt3m.speech_embed_token(qp, JHP, jnp.full((1,), JHP.start_speech_token),
                                  jnp.zeros((), jnp.int32))
    x = jnp.concatenate([ce.astype(dt), te.astype(dt), bos.astype(dt)], axis=1)
    P = x.shape[1]
    t_max = P + len(FORCED)
    cache = jbb.KVCache.zeros(cfg, 1, t_max)
    h, cache = jbb.backbone_apply_unrolled(
        qp["backbone"], cfg, x, jnp.arange(P)[None], cache,
        jnp.zeros((), jnp.int32), jbb.prefill_mask(P, t_max, jnp.full((1,), P)))
    out = [jt3m.speech_logits(qp, h[:, -1]).astype(jnp.float32)]
    for i, tok in enumerate(FORCED[:-1]):
        emb = jt3m.speech_embed_token(qp, JHP, jnp.full((1,), tok), None)
        pos = P + i
        h, cache = jbb.backbone_apply_unrolled(
            qp["backbone"], cfg, emb.astype(dt), jnp.full((1, 1), pos), cache,
            jnp.asarray(pos), jbb.decode_mask(t_max, jnp.full((1,), pos)))
        out.append(jt3m.speech_logits(qp, h[:, 0]).astype(jnp.float32))
    return np.concatenate([np.asarray(o) for o in out])


def _port_teacher_forced(tp, tcond):
    dt = tp["speech_emb"]["w"].dtype
    parts = t3m.cond_embeds(tp, HP, tcond)
    parts.append(nn.embedding(tp["text_emb"], torch.from_numpy(TEXT)))
    parts.append(nn.embedding(tp["speech_emb"],
                                  torch.tensor([[HP.start_speech_token]])))
    x = torch.cat([p.to(dt) for p in parts], dim=1)
    P = x.shape[1]
    cache = bb.KVCache.zeros(HP.backbone, 1, P + len(FORCED), "cpu")
    h = bb.backbone_apply(tp["backbone"], HP.backbone, x, torch.arange(P)[None],
                          cache, 0)
    out = [t3m.speech_logits(tp, h[:, -1]).float()]
    for i, tok in enumerate(FORCED[:-1]):
        emb = nn.embedding(tp["speech_emb"], torch.tensor([[tok]])).to(dt)
        h = bb.backbone_apply(tp["backbone"], HP.backbone, emb,
                              torch.tensor([[P + i]]), cache, P + i)
        out.append(t3m.speech_logits(tp, h[:, 0]).float())
    return torch.cat(out).numpy()


# Tolerances are relative to the largest logit (~2.4). f32 params: the same
# arithmetic in another summation order, but the fused kernels still round
# their LN output and hidden activations to bf16 and the KV cache is bf16,
# so an order difference can flip such a rounding and each decode step
# compounds it (1e-4 after prefill, 1.4e-3 of scale after 5 steps). bf16
# params: every activation is rounded to bf16 between ops, and XLA keeps
# some fused chains of bf16 ops in f32 where torch rounds each op (1.3e-2
# of scale at most). Plain int8 (the Nano serving mode: unfused decode
# layers) and float params keep the activations in f32; only the bf16 KV
# cache rounds (3e-5 and 7e-5 of scale measured).
@pytest.mark.parametrize("dtype,mode,atol", [("f32", "int8_fused", 3e-3),
                                             ("bf16", "int8_fused", 3e-2),
                                             ("f32", "int8", 3e-4),
                                             ("f32", None, 3e-4)])
def test_teacher_forced_logits_match(dtype, mode, atol):
    qp, tp = models(dtype, mode)
    jcond, tcond = _cond(np.random.default_rng(1))
    ref = _jax_teacher_forced(qp, jcond)
    out = _port_teacher_forced(tp, tcond)
    assert out.shape == ref.shape == (len(FORCED), HP.speech_tokens_dict_size)
    assert np.isfinite(out).all()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol * max(scale, 1.0))


def _jax_gen(qp, jcond, sp, key, top_k, n):
    bucket = 32
    text = np.zeros((1, bucket), np.int32)
    text[0, :TEXT.shape[1]] = TEXT[0]
    return jax_generate(qp, JHP, jcond, jnp.asarray(text), jnp.asarray(TEXT.shape[1]),
                        sp, key, max_new_tokens=n, top_k=top_k, cfg_mode=False)


def test_greedy_tokens_equal():
    qp, tp = models("f32")
    jcond, tcond = _cond(np.random.default_rng(2))
    n = 8
    jres = _jax_gen(qp, jcond, JS.SamplerParams.make(temperature=0.8, top_p=0.95,
                                                     repetition_penalty=1.2),
                    jax.random.key(3), 1, n)
    res = t3_generate(tp, HP, tcond, torch.from_numpy(TEXT),
                      S.SamplerParams(0.8, 0.95, 1.2), max_new_tokens=n,
                      top_k=1, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert int(res.n_tokens) == int(jres.n_tokens)


def test_sampled_tokens_equal_with_jax_gumbel_draws():
    """The port samples by gumbel-max from draws it is handed: replaying the
    JAX loop's own key splits (key, sub = split(key) per step, then
    categorical(sub) = argmax(logits + gumbel(sub))) gives its tokens."""
    qp, tp = models("f32")
    jcond, tcond = _cond(np.random.default_rng(4))
    n, V = 8, HP.speech_tokens_dict_size
    key = jax.random.key(5)
    jres = _jax_gen(qp, jcond, JS.SamplerParams.make(temperature=0.8, top_p=0.95,
                                                     repetition_penalty=1.2),
                    key, 1000, n)
    draws, k = [], key
    for _ in range(n):
        k, sub = jax.random.split(k)
        draws.append(np.asarray(jax.random.gumbel(sub, (V,), jnp.float32)))
    res = t3_generate(tp, HP, tcond, torch.from_numpy(TEXT),
                      S.SamplerParams(0.8, 0.95, 1.2), max_new_tokens=n,
                      top_k=1000, gumbel=torch.from_numpy(np.stack(draws)))
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert int(res.n_tokens) == int(jres.n_tokens)
    assert len(set(res.tokens.tolist())) > 1      # really sampled


@pytest.mark.parametrize("top_k,top_p,temp", [(1000, 0.95, 0.8), (0, 0.95, 0.8),
                                              (50, 1.0, 1.3), (0, 1.0, 1.0)])
def test_process_logits_turbo_matches(top_k, top_p, temp):
    rng = np.random.default_rng(top_k + int(top_p * 100))
    V = 6563
    logits = (rng.standard_normal(V) * 3).astype(np.float32)
    seen = rng.random(V) < 0.05
    ref = JS.process_logits_turbo(jnp.asarray(logits), jnp.asarray(seen),
                                  JS.SamplerParams.make(temperature=temp, top_p=top_p,
                                                        repetition_penalty=1.2),
                                  top_k)
    out = S.process_logits_turbo(torch.from_numpy(logits), torch.from_numpy(seen),
                                 S.SamplerParams(temp, top_p, 1.2), top_k)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(out.numpy() <= S.NEG_INF, ref <= JS.NEG_INF)
    kept = ref > JS.NEG_INF
    np.testing.assert_allclose(out.numpy()[kept], ref[kept], rtol=1e-6)


def test_unmapped_or_missing_keys_raise():
    qp, _ = models("f32")
    tree = jax.tree.map(np.asarray, qp)
    tree["extra"] = {"w": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        t3_from_jax(tree, HP, device="cpu")
    tree = jax.tree.map(np.asarray, qp)
    del tree["backbone"]["layers"][0]["fused"]["s1_8"]
    with pytest.raises(KeyError):
        t3_from_jax(tree, HP, device="cpu")
