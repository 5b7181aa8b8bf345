"""The port's batched decode (sampling/batched.py) and BatchDecoder
(serve/batching.py) held against chatterbox_tpu on the JAX CPU backend, for
both fused test backbones (GPT2_fused_test: Turbo family; Llama_fused_test:
520M CFG family at 2B rows), on the bf16 and the int8 KV cache; and the
fused decode-layer functions at the batched engine's 8 and 16 rows against
the Pallas kernels in interpret mode. The port's kernels run as their plain
versions (CPU tensors).

Token comparisons are greedy (top_k 1 for Turbo, min_p 1 for CFG), so the
two engines decode the same tokens whatever their random numbers. A random
2-layer model's two best logits sometimes lie within the engines' rounding
differences of each other (f32 summation order; an int8 code one off in the
cache), and such a near-tie flips one late token: the inputs below are draws
without one."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.ops import sampling as JS  # noqa: E402
from chatterbox_tpu.ops.fused_layer import attnout_ln_mlp_int8 as jax_b2  # noqa: E402
from chatterbox_tpu.ops.fused_layer import attnout_rms_glu_int8 as jax_b6  # noqa: E402
from chatterbox_tpu.ops.fused_layer import ln_qkv_int8 as jax_b1  # noqa: E402
from chatterbox_tpu.ops.fused_layer import rms_qkv_int8 as jax_b5  # noqa: E402
from chatterbox_tpu.sampling import batched as JB  # noqa: E402
from chatterbox_tpu.serve import batching as JSB  # noqa: E402

from chatterbox_tpu_torch.api.pipelines import T3CondHost  # noqa: E402
from chatterbox_tpu_torch.kernels import fused_layer as K  # noqa: E402
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.ops import sampling as S  # noqa: E402
from chatterbox_tpu_torch.sampling.batched import (BatchGenResult,  # noqa: E402
                                                   t3_generate_batched)
from chatterbox_tpu_torch.serve.batching import (BatchDecoder, TTSRequest,  # noqa: E402
                                                 drop_invalid_tokens_sliced,
                                                 pow2_sizes)

from tests import test_torch_fused_layer as FG  # noqa: E402   fused-layer helpers
from tests import test_torch_t3 as G  # noqa: E402   Turbo family fixtures
from tests import test_torch_t3_llama as L  # noqa: E402   520M family fixtures

FAMILIES = {"gpt2": (G, False), "llama": (L, True)}     # module, cfg_mode
LENS = [5, 12, 9]                                       # distinct text lengths
WIDTH = 32                                              # the JAX text bucket


def _batch(mod, seed, lens=LENS):
    """Conditioning and left-aligned text of len(lens) rows, numpy-made."""
    rng = np.random.default_rng(seed)
    B, hp = len(lens), mod.HP
    spk = rng.standard_normal((B, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (B, hp.speech_cond_prompt_len))
    emo = np.full((B, 1, 1), 0.6, np.float32) if hp.emotion_adv else None
    text = np.zeros((B, WIDTH), np.int64)
    for i, n in enumerate(lens):
        text[i, :n] = rng.integers(1, hp.text_tokens_dict_size, n)
    jcond = jt3m.T3CondArrays(jnp.asarray(spk), jnp.asarray(prompt, jnp.int32),
                              None if emo is None else jnp.asarray(emo))
    tcond = t3m.T3CondTensors(torch.from_numpy(spk), torch.from_numpy(prompt),
                              None if emo is None else torch.from_numpy(emo))
    return jcond, tcond, text


def _greedy(cfg_mode):
    if cfg_mode:
        return JS.SamplerParams.make(**L.GREEDY), S.SamplerParams(**L.GREEDY), 1000
    return (JS.SamplerParams.make(temperature=0.8, top_p=0.95, repetition_penalty=1.2),
            S.SamplerParams(0.8, 0.95, 1.2), 1)


def _port(mod, tp, tcond, text, sp, top_k, cfg_mode, kv_int8, n):
    gens = [torch.Generator().manual_seed(i) for i in range(text.shape[0])]
    return t3_generate_batched(tp, mod.HP, tcond, torch.from_numpy(text), LENS, sp, gens,
                               max_new_tokens=n, top_k=top_k, cfg_mode=cfg_mode,
                               kv_int8=kv_int8)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("kv_int8", [False, True])
def test_batched_greedy_tokens_equal_jax(family, kv_int8):
    """Three rows of distinct text lengths (so distinct left pads); the int8
    cache takes B4 with lo = pad, the bf16 cache plain attention under the
    left-pad mask."""
    mod, cfg_mode = FAMILIES[family]
    qp, tp = mod.models("f32")
    jcond, tcond, text = _batch(mod, 41)
    jsp, sp, top_k = _greedy(cfg_mode)
    n = 10
    jres = JB.t3_generate_batched(qp, mod.JHP, jcond, jnp.asarray(text, jnp.int32),
                                  jnp.asarray(LENS, jnp.int32), jsp,
                                  jax.random.split(jax.random.key(2), len(LENS)),
                                  max_new_tokens=n, top_k=top_k, cfg_mode=cfg_mode,
                                  kv_int8=kv_int8)
    res = _port(mod, tp, tcond, text, sp, top_k, cfg_mode, kv_int8, n)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.n_tokens.numpy(), np.asarray(jres.n_tokens))
    assert len(set(res.tokens.numpy().ravel().tolist())) > 3
    assert res.n_forward == n - 1


@pytest.mark.parametrize("family,kv_int8", [("gpt2", True), ("llama", False)])
def test_one_chunk_equals_the_bucketed_schedule(family, kv_int8):
    """The JAX package grows the batched cache in doubling segments for
    XLA's static shapes; the port's one chunk gives the same tokens."""
    mod, cfg_mode = FAMILIES[family]
    qp, tp = mod.models("f32")
    jcond, tcond, text = _batch(mod, 32)
    jsp, sp, top_k = _greedy(cfg_mode)
    n = 12
    jres = JB.t3_generate_batched_bucketed(
        qp, mod.JHP, jcond, jnp.asarray(text, jnp.int32), jnp.asarray(LENS, jnp.int32),
        jsp, jax.random.split(jax.random.key(4), len(LENS)), max_new_tokens=n,
        top_k=top_k, cfg_mode=cfg_mode, first_segment=4, kv_int8=kv_int8)
    res = _port(mod, tp, tcond, text, sp, top_k, cfg_mode, kv_int8, n)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.n_tokens.numpy(), np.asarray(jres.n_tokens))


def _requests(mod, seed, lens, sampler=None, seeds=None):
    rng = np.random.default_rng(seed)
    hp = mod.HP
    out = []
    for i, n in enumerate(lens):
        cond = T3CondHost(rng.standard_normal((1, 256)).astype(np.float32),
                          rng.integers(0, 6561, (1, hp.speech_cond_prompt_len)), 0.6)
        out.append(TTSRequest(rng.integers(1, hp.text_tokens_dict_size, n), cond,
                              sampler=None if sampler is None else sampler[i],
                              request_id=100 + i,
                              seed=None if seeds is None else seeds[i]))
    return out


@pytest.mark.parametrize("family,kv_int8", [("gpt2", True), ("llama", False)])
def test_a_row_alone_equals_the_row_in_a_batch(family, kv_int8):
    """Sampled (not greedy): a request's tokens depend on its own seed,
    prompt and sampler, not on its three batchmates of other lengths (and
    so other left pads)."""
    mod, cfg_mode = FAMILIES[family]
    _, tp = mod.models("f32")
    reqs = _requests(mod, 33, [7, 15, 4, 11], seeds=[5, 6, 7, 8])
    dec = BatchDecoder(tp, mod.HP, max_batch=4, max_new_tokens=10, cfg=cfg_mode,
                       kv_int8=kv_int8)
    together = dec.decode_batch(reqs)
    alone = dec.decode_batch([reqs[1]])[0]
    assert [r.request_id for r in together] == [100, 101, 102, 103]
    np.testing.assert_array_equal(alone.speech_tokens, together[1].speech_tokens)
    assert len(alone.speech_tokens) > 0


def test_batch_decoder_pads_to_a_power_of_two_with_the_last_request():
    assert pow2_sizes(1) == [1] and pow2_sizes(3) == [1, 2, 4]
    assert pow2_sizes(8) == [1, 2, 4, 8]
    _, tp = G.models("f32")
    dec = BatchDecoder(tp, G.HP, max_batch=4, max_new_tokens=8, top_k=50, seed=3)
    reqs = _requests(G, 34, [6, 9, 3])
    res, real = dec.decode_batch_dispatch(reqs)
    assert res.tokens.shape == (4, 8) and real == reqs
    # the pad row repeats the last request and its (drawn) seed
    np.testing.assert_array_equal(res.tokens[3].numpy(), res.tokens[2].numpy())
    out = dec.decode_batch_fetch((res, real))
    assert [r.request_id for r in out] == [100, 101, 102]
    for i, r in enumerate(out):
        t = res.tokens[i, :int(res.n_tokens[i])].numpy()
        np.testing.assert_array_equal(r.speech_tokens, t[t < 6561])


@pytest.mark.parametrize("family,max_batch,n_requests", [
    ("gpt2", 2, 3),       # more requests than max_batch
    ("gpt2", 17, 1),      # a full batch pads to 32 rows
    ("llama", 9, 1),      # 9 CFG requests pad to 16, i.e. 32 rows
])
def test_batch_decoder_refuses_batches_past_its_bounds(family, max_batch, n_requests):
    mod, cfg_mode = FAMILIES[family]
    _, tp = mod.models("f32")
    with pytest.raises(ValueError, match="requests|rows"):
        dec = BatchDecoder(tp, mod.HP, max_batch=max_batch, max_new_tokens=2,
                           cfg=cfg_mode)
        dec.decode_batch(_requests(mod, 37, [4] * n_requests))


def test_cfg_results_are_sliced_between_sos_and_eos():
    SOS, EOS = 6561, 6562
    assert drop_invalid_tokens_sliced(np.array([4, SOS, 8, 9, EOS, 3])).tolist() == [8, 9]
    assert drop_invalid_tokens_sliced(np.array([4, 5])).tolist() == [4, 5]
    tokens = torch.tensor([[4, SOS, 8, 6563, 9, EOS, 3], [7, 6, EOS, EOS, EOS, EOS, EOS]])
    res = BatchGenResult(tokens, torch.tensor([6, 3]), 5)
    reqs = [TTSRequest(np.ones(3, np.int64), None, request_id=i) for i in (1, 2)]
    _, tp = L.models("f32")
    cfg = BatchDecoder(tp, L.HP, cfg=True).decode_batch_fetch((res, reqs))
    assert [r.speech_tokens.tolist() for r in cfg] == [[8, 9], [7, 6]]
    turbo = BatchDecoder(tp, L.HP).decode_batch_fetch((res, reqs))
    assert [r.speech_tokens.tolist() for r in turbo] == [[4, 8, 9], [7, 6]]


def test_cfg_batch_decoder_matches_jax_with_per_row_samplers():
    """Three CFG requests of distinct lengths, padded to four, each with its
    own repetition penalty and guidance weight (greedy through min_p 1):
    the port's results equal the JAX BatchDecoder's."""
    mod = L
    qp, tp = mod.models("f32")
    pens, ws = [1.3, 1.05, 2.0], [0.5, 0.0, 0.8]
    jsp = [JS.SamplerParams.make(temperature=0.8, top_p=1.0, min_p=1.0,
                                 repetition_penalty=p, cfg_weight=w)
           for p, w in zip(pens, ws)]
    sp = [S.SamplerParams(0.8, 1.0, p, 1.0, w) for p, w in zip(pens, ws)]
    reqs = _requests(mod, 35, [6, 14, 9], sampler=sp, seeds=[1, 2, 3])
    jreqs = [JSB.TTSRequest(r.text_tokens.astype(np.int32), r.cond, sampler=s,
                            request_id=r.request_id, seed=r.seed)
             for r, s in zip(reqs, jsp)]
    jout = JSB.BatchDecoder(qp, mod.JHP, max_batch=4, max_new_tokens=10,
                            cfg=True).decode_batch(jreqs)
    out = BatchDecoder(tp, mod.HP, max_batch=4, max_new_tokens=10,
                       cfg=True).decode_batch(reqs)
    for a, b in zip(out, jout):
        assert a.request_id == b.request_id
        np.testing.assert_array_equal(a.speech_tokens, np.asarray(b.speech_tokens))
    assert any(len(a.speech_tokens) > 2 for a in out)


def test_batched_loop_refuses_fused_attn():
    mod = G
    _, tp = mod.models("f32")
    _, tcond, text = _batch(mod, 36)
    with pytest.raises(ValueError, match="kv_int8"):
        t3_generate_batched(tp, mod.HP, tcond, torch.from_numpy(text), LENS,
                            S.SamplerParams(), [torch.Generator()] * 3,
                            max_new_tokens=4, fused_attn=True)


# The fused decode-layer functions at the batched engine's rows (8: eight
# Turbo requests or four CFG requests; 16: eight CFG requests). Tolerances
# as tests/test_torch_fused_layer.py and tests/test_torch_fused_llama.py
# state them: the QKV kernels agree to f32 rounding; the second halves round
# their norm output and hidden units to bf16, where another summation order
# can move a value across a bf16 rounding boundary (~2e-4 on the outputs).
RTOL, ATOL_QKV, ATOL_MLP = 1e-5, 2e-5, 1e-3


@pytest.mark.parametrize("B", [8, 16])
def test_gpt2_fused_layer_at_batched_rows_matches_pallas(B):
    rng = np.random.default_rng(40 + B)
    D, I = 512, 2048
    x = FG._act(rng, B, D, jnp.bfloat16)
    g, be = FG._vec(rng, D, 0.1, 1.0), FG._vec(rng, D, 0.1)
    w_q, s = FG._quant(rng, D, 3 * D)
    bias = FG._vec(rng, 3 * D)
    tt = lambda w: torch.from_numpy(w.T.copy())
    ref = jax_b1(x, FG._b8(g), FG._b8(be), jnp.asarray(w_q), FG._b8(s), FG._b8(bias),
                 eps=FG.EPS, interpret=True)
    out = K.ln_qkv_int8(FG._t(x), FG._t(g), FG._t(be), tt(w_q), FG._t(s), FG._t(bias),
                        FG.EPS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL_QKV)
    a, xres = FG._act(rng, B, D, jnp.bfloat16, 0.5), FG._act(rng, B, D, jnp.bfloat16)
    (wo, so), (w1, s1), (w2, s2) = FG._quant(rng, D, D), FG._quant(rng, D, I), \
        FG._quant(rng, I, D)
    bo, b1, b2 = FG._vec(rng, D), FG._vec(rng, I), FG._vec(rng, D)
    g2, be2 = FG._vec(rng, D, 0.1, 1.0), FG._vec(rng, D, 0.1)
    ref = jax_b2(a, xres, jnp.asarray(wo), FG._b8(so), FG._b8(bo), FG._b8(g2),
                 FG._b8(be2), jnp.asarray(w1), FG._b8(s1), FG._b8(b1), jnp.asarray(w2),
                 FG._b8(s2), FG._b8(b2), eps=FG.EPS, interpret=True)
    out = K.attnout_ln_mlp_int8(FG._t(a), FG._t(xres), tt(wo), FG._t(so), FG._t(bo),
                                FG._t(g2), FG._t(be2), tt(w1), FG._t(s1), FG._t(b1),
                                tt(w2), FG._t(s2), FG._t(b2), FG.EPS)
    assert out.shape == (B, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL_MLP)


@pytest.mark.parametrize("B", [8, 16])
def test_llama_fused_layer_at_batched_rows_matches_pallas(B):
    rng = np.random.default_rng(50 + B)
    D, I, tw = 512, 1024, 512
    tt = lambda w: torch.from_numpy(w.T.copy())
    x = FG._act(rng, B, D, jnp.bfloat16)
    g = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    w_q, s = FG._quant(rng, D, 3 * D)
    ref = jax_b5(x, FG._b8(g), jnp.asarray(w_q), FG._b8(s), eps=FG.EPS, interpret=True)
    out = K.rms_qkv_int8(FG._t(x), FG._t(g), tt(w_q), FG._t(s), FG.EPS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL_QKV)
    a, xres = FG._act(rng, B, D, jnp.bfloat16, 0.5), FG._act(rng, B, D, jnp.bfloat16)
    (wo, so), (wg, sg), (wu, su), (wd, sd) = (FG._quant(rng, D, D), FG._quant(rng, D, I),
                                              FG._quant(rng, D, I), FG._quant(rng, I, D))
    g2 = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ref = jax_b6(a, xres, jnp.asarray(wo), FG._b8(so), FG._b8(g2), jnp.asarray(wg),
                 FG._b8(sg), jnp.asarray(wu), FG._b8(su), jnp.asarray(wd), FG._b8(sd),
                 eps=FG.EPS, tw=tw, interpret=True)
    out = K.attnout_rms_glu_int8(FG._t(a), FG._t(xres), tt(wo), FG._t(so), FG._t(g2),
                                 tt(wg), FG._t(sg), tt(wu), FG._t(su), tt(wd), FG._t(sd),
                                 FG.EPS, tw)
    assert out.shape == (B, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL_MLP)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_batched_steps_hand_the_kernels_packed_operands(family, monkeypatch):
    """On the card each wrapper refuses a strided tensor, and a batch of
    several rows makes q a strided view of the QKV output: every tensor the
    int8 batched engine hands a kernel wrapper is contiguous, and B4 runs
    once per layer and decode step."""
    from chatterbox_tpu_torch.models.t3 import backbone as bb
    mod, cfg_mode = FAMILIES[family]
    _, tp = mod.models("f32")
    _, tcond, text = _batch(mod, 38)
    calls = []

    def packed(fn):
        def spy(*args, **kw):
            for a in list(args) + list(kw.values()):
                if torch.is_tensor(a):
                    assert a.is_contiguous(), fn.__name__
            calls.append(fn.__name__)
            return fn(*args, **kw)
        return spy

    for name in ("decode_attention_streamed_int8", "apply_fused_gpt2_qkv_int8",
                 "apply_fused_gpt2_mlp_int8", "apply_fused_llama_qkv_int8",
                 "apply_fused_llama_mlp_int8"):
        monkeypatch.setattr(bb, name, packed(getattr(bb, name)))
    jsp, sp, top_k = _greedy(cfg_mode)
    res = _port(mod, tp, tcond, text, sp, top_k, cfg_mode, True, 5)
    L = mod.HP.backbone.num_layers
    assert calls.count("decode_attention_streamed_int8") == L * res.n_forward == L * 4
