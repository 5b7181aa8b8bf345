"""The port's int8 KV cache and decode-attention knobs (models/t3/backbone.py
`KVCacheInt8`, `quantize_kv`, `fused_attn`; sampling/decode.py
`t3_generate(kv_int8=, fused_attn=)`) held against chatterbox_tpu on the JAX
CPU backend, for both fused test backbones: GPT2_fused_test (Turbo family,
batch 1) and Llama_fused_test (520M family, CFG batch 2). Weights are
quantized int8_fused by the JAX package and carried across with
convert/from_jax.py; JAX's Pallas kernels run in interpret mode, the port's
kernels as their plain versions (CPU tensors)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.models.t3 import backbone as jbb  # noqa: E402
from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.ops import sampling as JS  # noqa: E402
from chatterbox_tpu.ops.pallas_attention import TT  # noqa: E402
from chatterbox_tpu.sampling.decode import t3_generate as jax_generate  # noqa: E402

from chatterbox_tpu_torch.convert.from_jax import kv_cache_from_jax  # noqa: E402
from chatterbox_tpu_torch.kernels import decode_attention as A  # noqa: E402
from chatterbox_tpu_torch.models.t3 import backbone as bb  # noqa: E402
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.ops import sampling as S  # noqa: E402
from chatterbox_tpu_torch.sampling.decode import (build_prefix, decode_step,  # noqa: E402
                                                  t3_generate)

from tests import test_torch_t3 as G  # noqa: E402   Turbo family fixtures
from tests import test_torch_t3_llama as L  # noqa: E402   520M family fixtures

FAMILIES = {"gpt2": (G, 1, False), "llama": (L, 2, True)}   # module, batch, cfg


def _aligned(n: int) -> int:
    return -(-n // TT) * TT


def _jax_prefix(mod, qp, jcond, batch, cfg_mode):
    """The dense prefix the JAX decode engine builds, (batch, P, D)."""
    hp = mod.JHP
    dt = qp["speech_emb"]["w"].dtype
    Lt = mod.TEXT.shape[1]
    ce = jnp.broadcast_to(jt3m.cond_embeds(qp, hp, jcond),
                          (batch,) + jt3m.cond_embeds(qp, hp, jcond).shape[1:])
    te = jnp.take(qp["text_emb"]["w"],
                  jnp.broadcast_to(jnp.asarray(mod.TEXT), (batch, Lt)), axis=0)
    if cfg_mode:
        te = te * jnp.array([1.0, 0.0])[:, None, None]
    if hp.input_pos_emb == "learned":
        te = te + jnp.take(qp["text_pos_emb"]["w"], jnp.arange(Lt), axis=0)
    bos = jt3m.speech_embed_token(qp, hp, jnp.full((batch,), hp.start_speech_token),
                                  jnp.zeros((), jnp.int32))
    parts = [ce, te] + [bos] * (2 if cfg_mode else 1)
    return jnp.concatenate([p.astype(dt) for p in parts], axis=1)


def _jax_run(mod, qp, jcond, batch, cfg_mode, cache_cls, fused, t_max=None):
    """Prefill, then one decode step per forced token: (logits (steps,
    batch, V), the cache after prefill, the cache length)."""
    cfg = mod.JHP.backbone
    x = _jax_prefix(mod, qp, jcond, batch, cfg_mode)
    P = x.shape[1]
    t_max = t_max or (_aligned(P + len(mod.FORCED)) if fused else P + len(mod.FORCED))
    cache = cache_cls.zeros(cfg, batch, t_max)
    h, cache = jbb.backbone_apply_unrolled(
        qp["backbone"], cfg, x, jnp.tile(jnp.arange(P)[None], (batch, 1)), cache,
        jnp.zeros((), jnp.int32), jbb.prefill_mask(P, t_max, jnp.full((batch,), P)))
    prefilled = jax.tree.map(np.asarray, cache)
    out = [jt3m.speech_logits(qp, h[:, -1]).astype(jnp.float32)]
    for i, tok in enumerate(mod.FORCED[:-1]):
        emb = jt3m.speech_embed_token(qp, mod.JHP, jnp.full((batch,), tok),
                                      jnp.asarray(i + 1))
        pos = P + i
        h, cache = jbb.backbone_apply_unrolled(
            qp["backbone"], cfg, emb, jnp.full((batch, 1), pos), cache, jnp.asarray(pos),
            jbb.decode_mask(t_max, jnp.full((batch,), pos)), fused_attn=fused)
        out.append(jt3m.speech_logits(qp, h[:, 0]).astype(jnp.float32))
    return np.stack([np.asarray(o) for o in out]), prefilled, t_max


def _port_prefill(mod, tp, tcond, batch, cfg_mode, cache):
    x = build_prefix(tp, mod.HP, tcond, torch.from_numpy(mod.TEXT), batch, cfg_mode)
    P = x.shape[1]
    h = bb.backbone_apply(tp["backbone"], mod.HP.backbone, x,
                          torch.arange(P)[None].expand(batch, -1), cache, 0)
    return t3m.speech_logits(tp, h[:, -1]).float(), P


def _port_steps(mod, tp, cache, P, fused, first=None):
    out = [] if first is None else [first]
    for i, tok in enumerate(mod.FORCED[:-1]):
        out.append(decode_step(tp, mod.HP, torch.tensor(tok), i, cache, P + i, fused))
    return torch.stack(out).numpy()


def _port_run(mod, tp, tcond, batch, cfg_mode, cache_cls, fused, t_max):
    cache = cache_cls.zeros(mod.HP.backbone, batch, t_max, "cpu")
    first, P = _port_prefill(mod, tp, tcond, batch, cfg_mode, cache)
    return _port_steps(mod, tp, cache, P, fused, first)


def _close(out, ref, atol):
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_prefilled_int8_cache_matches_jax(family):
    """The int8 cache after prefill: k_q / v_q equal, or off by one where
    a value sits on a rounding boundary of its quantization in one engine
    and not the other; the scales within a bf16 ulp."""
    mod, batch, cfg_mode = FAMILIES[family]
    qp, tp = mod.models("f32")
    jcond, tcond = mod._cond(np.random.default_rng(21))
    _, jcache, t_max = _jax_run(mod, qp, jcond, batch, cfg_mode, jbb.KVCacheInt8, True)
    cache = bb.KVCacheInt8.zeros(mod.HP.backbone, batch, t_max, "cpu")
    _port_prefill(mod, tp, tcond, batch, cfg_mode, cache)
    for name in ("k_q", "v_q"):
        d = np.abs(getattr(cache, name).numpy().astype(np.int32)
                   - np.asarray(getattr(jcache, name)).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, (name, d.max(), (d > 0).mean())
    for name in ("k_s", "v_s"):
        ref = np.asarray(getattr(jcache, name)).astype(np.float32)
        np.testing.assert_allclose(getattr(cache, name).float().numpy(), ref,
                                   rtol=2.0 ** -7, atol=0)


# Tolerances relative to the largest logit. The carried cache state is
# the same on both sides, so a decode step differs by summation order and
# the fused kernels' bf16 roundings only (as test_torch_t3's 3e-3 after
# five steps). Each later step then quantizes its own K/V, where a value
# that lands on the other side of an int8 rounding boundary moves one code.
@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("fused", [True, False])
def test_decode_from_a_carried_int8_cache_matches_jax(family, fused):
    """Both engines decode from the JAX prefill's int8 cache (carried across
    with kv_cache_from_jax): the port's B4 (fused) or its dequantized cache
    against JAX's int8 Pallas kernel or its dequantized cache."""
    mod, batch, cfg_mode = FAMILIES[family]
    qp, tp = mod.models("f32")
    jcond, tcond = mod._cond(np.random.default_rng(22))
    ref, jcache, t_max = _jax_run(mod, qp, jcond, batch, cfg_mode, jbb.KVCacheInt8,
                                  fused)
    cache = kv_cache_from_jax(jcache, device="cpu")
    assert isinstance(cache, bb.KVCacheInt8) and cache.max_len == t_max
    P = _jax_prefix(mod, qp, jcond, batch, cfg_mode).shape[1]
    out = _port_steps(mod, tp, cache, P, fused)
    _close(out, ref[1:], 3e-3)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("dtype,atol", [("f32", 3e-3), ("bf16", 3e-2)])
def test_teacher_forced_int8_logits_match_jax(family, dtype, atol):
    """Prefill and five decode steps on each engine's own int8 cache with
    fused attention (JAX: the int8 Pallas kernel; the port: B4's plain
    version). bf16 params round every activation to bf16 between ops, as in
    test_torch_t3 (3e-2 of scale there)."""
    mod, batch, cfg_mode = FAMILIES[family]
    qp, tp = mod.models(dtype)
    jcond, tcond = mod._cond(np.random.default_rng(23))
    ref, _, t_max = _jax_run(mod, qp, jcond, batch, cfg_mode, jbb.KVCacheInt8, True)
    out = _port_run(mod, tp, tcond, batch, cfg_mode, bb.KVCacheInt8, True, t_max)
    _close(out, ref, atol)
    if cfg_mode:
        assert np.abs(out[:, 0] - out[:, 1]).max() > 1e-3


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_teacher_forced_fused_bf16_cache_matches_jax(family):
    """The bf16 cache with fused attention: B3 over the tile-aligned cache
    (JAX's streamed Pallas kernel) and B7 over an unaligned one."""
    mod, batch, cfg_mode = FAMILIES[family]
    qp, tp = mod.models("f32")
    jcond, tcond = mod._cond(np.random.default_rng(24))
    for t_max in (None, 300):
        ref, _, t = _jax_run(mod, qp, jcond, batch, cfg_mode, jbb.KVCache, True, t_max)
        out = _port_run(mod, tp, tcond, batch, cfg_mode, bb.KVCache, True, t)
        _close(out, ref, 3e-3)


def _jax_text(mod):
    text = np.zeros((1, 32), np.int32)
    text[0, :mod.TEXT.shape[1]] = mod.TEXT[0]
    return jnp.asarray(text), jnp.asarray(mod.TEXT.shape[1])


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("kv_int8", [True, False])
def test_greedy_tokens_equal_jax(family, kv_int8):
    """t3_generate(kv_int8=k, fused_attn=True) against the JAX engine with
    the same knobs, greedy (top_k 1 for Turbo, min_p 1 for CFG), so both
    decode the same tokens whatever their random numbers; tokens after the
    first EOS are the stop token in both."""
    mod, batch, cfg_mode = FAMILIES[family]
    qp, tp = mod.models("f32")
    jcond, tcond = mod._cond(np.random.default_rng(25))
    n = 10
    if cfg_mode:
        jsp, sp, kw = JS.SamplerParams.make(**L.GREEDY), S.SamplerParams(**L.GREEDY), {}
    else:
        jsp = JS.SamplerParams.make(temperature=0.8, top_p=0.95, repetition_penalty=1.2)
        sp, kw = S.SamplerParams(0.8, 0.95, 1.2), {"top_k": 1}
    jres = jax_generate(qp, mod.JHP, jcond, *_jax_text(mod), jsp, jax.random.key(3),
                        max_new_tokens=n, cfg_mode=cfg_mode, kv_int8=kv_int8,
                        fused_attn=True, **kw)
    before = dict(A.launches)
    res = t3_generate(tp, mod.HP, tcond, torch.from_numpy(mod.TEXT), sp,
                      max_new_tokens=n, cfg_mode=cfg_mode, kv_int8=kv_int8,
                      fused_attn=True, generator=torch.Generator().manual_seed(0), **kw)
    assert A.launches == before                        # CPU tensors: plain versions
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert int(res.n_tokens) == int(jres.n_tokens)
    assert len(set(res.tokens.tolist())) > 1


def test_fused_attn_none_means_false_and_fused_rounds_the_cache():
    from chatterbox_tpu_torch.sampling.decode import cache_len
    assert cache_len(130, False) == 130
    assert cache_len(130, True) == 256 and cache_len(512, True) == 512
    qp, tp = G.models("f32")
    _, tcond = G._cond(np.random.default_rng(26))
    args = (tp, G.HP, tcond, torch.from_numpy(G.TEXT), S.SamplerParams(0.8, 0.95, 1.2))
    a = t3_generate(*args, max_new_tokens=6, top_k=1, fused_attn=None)
    b = t3_generate(*args, max_new_tokens=6, top_k=1, fused_attn=False)
    np.testing.assert_array_equal(a.tokens.numpy(), b.tokens.numpy())


def test_turbo_pipeline_with_int8_kv_matches_jax():
    """ChatterboxTurboTTS.generate(kv_int8=True) end to end, greedy, against
    the JAX pipeline with the same knob (float32 S3Gen on both sides, the
    vocoder noise handed across as tests/test_torch_pipeline.py does)."""
    from tests import test_torch_pipeline as TP
    from tests.test_torch_s3gen import jax_vocode_noise
    jtts, tts = TP._pipelines()
    kw = dict(top_k=1, max_new_tokens=TP.N_NEW, kv_int8=True)
    ref = jtts.generate("hello world, this is a test", **kw)
    key, _ = jax.random.split(jax.random.key(7))
    _, k_voc = jax.random.split(key)
    noise = jax_vocode_noise(k_voc, 2 * (TP.P + TP.N_NEW + 3), 2 * (TP.N_NEW + 3))
    tts.s3gen.draw_noise = lambda n_mel, n_gen_mel, generator: noise
    out = tts.generate("hello world, this is a test", **kw)
    assert tts.last_decode.n_forward == TP.N_NEW - 1
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_cfg_pipeline_with_int8_kv_matches_jax(monkeypatch):
    """ChatterboxTTS.generate(kv_int8=True), greedy (min_p 1), against the
    JAX pipeline with the same knob; the JAX vocoder's buckets pinned to the
    exact lengths as in tests/test_torch_pipeline.py."""
    from chatterbox_tpu.models.s3gen import model as jmodel
    from tests import test_torch_pipeline as TP
    from tests.test_torch_s3gen import jax_vocode_noise
    monkeypatch.setattr(jmodel, "TOKEN_BUCKETS", (TP.P_CFG + TP.N_CFG,))
    monkeypatch.setattr(jmodel, "GEN_MEL_BUCKETS", (2 * TP.N_CFG,))
    jtts, tts = TP._cfg_pipelines()
    kw = dict(min_p=1.0, max_new_tokens=TP.N_CFG, exaggeration=0.6, kv_int8=True)
    ref = jtts.generate("hello world, this is a test", **kw)
    key, _ = jax.random.split(jax.random.key(7))
    _, k_voc = jax.random.split(key)
    noise = jax_vocode_noise(k_voc, 2 * (TP.P_CFG + TP.N_CFG), 2 * TP.N_CFG,
                             meanflow=False)
    tts.s3gen.draw_noise = lambda n_mel, n_gen_mel, generator: noise
    out = tts.generate("hello world, this is a test", **kw)
    assert tts.last_decode.n_forward == TP.N_CFG - 1
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
