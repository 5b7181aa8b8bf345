"""The port's speculative T3 decode (sampling/speculative.py) and Turbo's
generate(draft=, n_draft=) held against chatterbox_tpu on the JAX CPU
backend and against the port's own sequential decode: a 2-layer
GPT2_tiny_test T3 (float32) as target and, as drafts, another seed's
weights (every draft rejected) or the target's layers quantized int8 (most
accepted), carried from JAX with convert/from_jax.py; the int8_fused
self-draft on GPT2_fused_test (the fused path through the plain kernel
versions)."""
import dataclasses
import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.models.t3.config import T3Config as JT3Config  # noqa: E402
from chatterbox_tpu.ops.sampling import SamplerParams as JSP  # noqa: E402
from chatterbox_tpu.sampling.speculative import \
    t3_generate_speculative as jax_speculative  # noqa: E402
from chatterbox_tpu.utils.quantize import quantize_tree as jquantize_tree  # noqa: E402

import chatterbox_tpu_torch as port  # noqa: E402
from chatterbox_tpu_torch.convert.from_jax import t3_from_jax  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.flow import FlowDims  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.model import S3GenEngine, s3gen_init  # noqa: E402
from chatterbox_tpu_torch.models.s3tok.model import S3TokenizerConfig  # noqa: E402
from chatterbox_tpu_torch.models.t3 import backbone as bb  # noqa: E402
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.models.t3.config import T3Config  # noqa: E402
from chatterbox_tpu_torch.ops import sampling as S  # noqa: E402
from chatterbox_tpu_torch.sampling import speculative as spec  # noqa: E402
from chatterbox_tpu_torch.sampling.decode import prefill, t3_generate  # noqa: E402
from chatterbox_tpu_torch.utils.quantize import quantize_tree  # noqa: E402
from tests.test_torch_convert import few_threads  # noqa: E402,F401
from tests.test_torch_pipeline import _conds, _Tok  # noqa: E402

JHP = JT3Config.tiny_test("gpt2")
HP = T3Config(**{f.name: getattr(JHP, f.name) for f in dataclasses.fields(JHP)})
V, STOP = HP.speech_tokens_dict_size, HP.stop_speech_token
TEXT = np.arange(1, 9)[None]
GREEDY = dict(temperature=0.8, top_p=1.0, repetition_penalty=1.2)
SAMPLED = dict(temperature=0.8, top_p=0.95, repetition_penalty=1.2)


@pytest.fixture(scope="module")
def models():
    """{draft: (JAX target, JAX draft, the port's target, the port's draft,
    JAX cond, the port's cond)} for the "independent" and "int8" drafts."""
    jp, jd = (jt3m.t3_init(jax.random.key(s), JHP) for s in (0, 1))
    jq = dict(jp, backbone=dict(jp["backbone"], layers=jquantize_tree(
        jp["backbone"]["layers"], min_size=1, mode="int8")))
    carry = lambda p: t3_from_jax(jax.tree.map(np.asarray, p), HP, device="cpu")  # noqa: E731
    tp = carry(jp)
    jcond = jt3m.T3CondArrays(jnp.zeros((1, 256)), jnp.zeros((1, 8), jnp.int32), None)
    tcond = t3m.T3CondTensors(torch.zeros(1, 256), torch.zeros(1, 8, dtype=torch.long))
    return {"independent": (jp, jd, tp, carry(jd), jcond, tcond),
            "int8": (jp, jq, tp, carry(jq), jcond, tcond)}


def _spec(tp, td, tcond, sp_kw, **kw):
    return spec.t3_generate_speculative(tp, td, HP, HP, tcond, tcond, torch.from_numpy(TEXT),
                                        S.SamplerParams(**sp_kw), **kw)


def _jax_spec(models, sp_kw, key, **kw):
    jp, jd, _, _, jcond, _ = models
    text = jnp.pad(jnp.asarray(TEXT, jnp.int32), ((0, 0), (0, 8)))
    return jax_speculative(jp, jd, JHP, JHP, jcond, jcond, text, jnp.asarray(TEXT.shape[1]),
                           JSP.make(cfg_weight=0.0, **sp_kw), key, **kw)


@pytest.fixture(scope="module")
def sequential(models):
    _, _, tp, _, _, tcond = models["int8"]
    return t3_generate(tp, HP, tcond, torch.from_numpy(TEXT), S.SamplerParams(**GREEDY),
                       max_new_tokens=24, top_k=1)


@pytest.mark.parametrize("k,draft", [(1, "independent"), (3, "int8"), (4, "int8"),
                                     (7, "independent")])
def test_greedy_tokens_equal_sequential_and_jax(models, sequential, k, draft):
    """top_k=1: acceptance is argmax agreement, so the speculative tokens
    are the sequential decode's and JAX's speculative decode's, exactly
    (the independent draft is rejected at every round, the int8 draft
    mostly accepted)."""
    models = models[draft]
    _, _, tp, td, _, tcond = models
    out = _spec(tp, td, tcond, GREEDY, max_new_tokens=24, n_draft=k, top_k=1,
                generator=torch.Generator().manual_seed(k))
    ref = _jax_spec(models, GREEDY, jax.random.key(3), max_new_tokens=24, n_draft=k, top_k=1)
    assert int(out.n_tokens) == int(sequential.n_tokens) == int(ref.n_tokens)
    np.testing.assert_array_equal(out.tokens.numpy(), sequential.tokens.numpy())
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert out.n_drafted == k * out.n_rounds and out.n_accepted == int(ref.n_accepted)


def jax_round_draws(key, rounds: int, K: int):
    """The random numbers JAX's speculative loop draws from `key`, round by
    round (its key split into draft, accept and residual keys; one
    categorical key a draft step), as the port's `draws`: draft gumbels
    (R, K, V), uniforms (R, K), residual gumbels (R, V)."""
    g_d, us, g_r = [], [], []
    for _ in range(rounds):
        key, k_draft, k_acc, k_res = jax.random.split(key, 4)
        rows = []
        for _ in range(K):
            k_draft, sub = jax.random.split(k_draft)
            rows.append(np.asarray(jax.random.gumbel(sub, (V,))))
        g_d.append(np.stack(rows))
        us.append(np.asarray(jax.random.uniform(k_acc, (K,))))
        g_r.append(np.asarray(jax.random.gumbel(k_res, (V,))))
    return tuple(torch.from_numpy(np.stack(x)) for x in (g_d, us, g_r))


@pytest.mark.parametrize("draft", ["independent", "int8"])
def test_sampled_tokens_equal_jax_on_its_draws(models, draft):
    """top_k=50, top_p=0.95, with JAX's own random numbers replayed: every
    token, the round count and the acceptances equal JAX's (the processed
    probabilities agree to float32 rounding, far from any draw's edge):
    the residual path with the independent draft, acceptance, rejection
    and the bonus token with the int8 one."""
    models = models[draft]
    _, _, tp, td, _, tcond = models
    key = jax.random.key(6)
    ref = _jax_spec(models, SAMPLED, key, max_new_tokens=20, n_draft=3, top_k=50)
    out = _spec(tp, td, tcond, SAMPLED, max_new_tokens=20, n_draft=3, top_k=50,
                draws=jax_round_draws(key, 20, 3))
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert (int(out.n_tokens), out.n_rounds, out.n_accepted) == (
        int(ref.n_tokens), int(ref.n_rounds), int(ref.n_accepted))
    assert (out.n_accepted > 0) == (draft == "int8")


def test_self_draft_accepts(models):
    """draft == target: p == q up to slab-against-step rounding, so nearly
    every draft is accepted, and the draft's extra step (d_K's KV) keeps
    the next round from one rejection each."""
    _, _, tp, _, _, tcond = models["int8"]
    out = _spec(tp, tp, tcond, SAMPLED, max_new_tokens=32, n_draft=4, top_k=50,
                ignore_eos=True, generator=torch.Generator().manual_seed(5))
    assert int(out.n_tokens) == 32 and out.n_tokens.item() == 32
    assert out.n_accepted / out.n_drafted > 0.8
    assert out.n_rounds <= 12


def test_int8_draft_acceptance(models):
    """The target's layers quantized int8 as the draft (min_size=1, so the
    tiny layers are perturbed): acceptance far above an independent
    draft's ~0."""
    _, _, tp, _, _, tcond = models["int8"]
    qd = dict(tp, backbone=dict(tp["backbone"],
                                layers=quantize_tree(tp["backbone"]["layers"], min_size=1)))
    assert "w_q" in qd["backbone"]["layers"][0]["qkv"]
    out = _spec(tp, qd, tcond, SAMPLED, max_new_tokens=32, n_draft=4, top_k=50,
                ignore_eos=True, generator=torch.Generator().manual_seed(8))
    assert int(out.n_tokens) == 32
    assert out.n_accepted / out.n_drafted > 0.5


def test_sampled_stream_is_valid_and_deterministic(models):
    _, _, tp, td, _, tcond = models["independent"]
    runs = [_spec(tp, td, tcond, SAMPLED, max_new_tokens=20, n_draft=4, top_k=50,
                  generator=torch.Generator().manual_seed(6)) for _ in range(2)]
    toks, n = runs[0].tokens.numpy(), int(runs[0].n_tokens)
    assert 0 < n <= 20 and toks.shape == (20,)
    assert (toks >= 0).all() and (toks < V).all()
    assert (toks[n:] == STOP).all()
    eos = np.flatnonzero(toks[:n] == STOP)
    assert eos.size == 0 or eos[0] == n - 1
    np.testing.assert_array_equal(toks, runs[1].tokens.numpy())


def test_eos_stops_the_stream_and_ignore_eos_does_not(models):
    """A target that always prefers EOS: the first round emits it and
    stops, n_tokens 1; with ignore_eos the stream runs to its budget."""
    _, _, tp, td, _, tcond = models["independent"]
    eos = dict(tp, speech_head=dict(tp["speech_head"]))
    eos["speech_head"]["b"] = tp["speech_head"]["b"].clone()
    eos["speech_head"]["b"][STOP] = 1e4
    out = _spec(eos, td, tcond, GREEDY, max_new_tokens=10, n_draft=3, top_k=1)
    assert int(out.n_tokens) == 1 and out.n_rounds == 1
    assert (out.tokens.numpy() == STOP).all()
    out = _spec(eos, td, tcond, GREEDY, max_new_tokens=10, n_draft=3, top_k=1,
                ignore_eos=True)
    assert int(out.n_tokens) == 10


N_DRAWS = 400       # speculative decodes of one token
CHI2_BOUND = 16.27  # chi-square, 3 degrees of freedom, p = 0.001


def test_first_token_follows_the_target_distribution(models):
    """Over N_DRAWS decodes of one token on fresh draws, the first emitted
    token's frequencies against the target's processed probabilities p
    (top_k=4, temperature 1.5): chi-square below CHI2_BOUND, total variation
    below 0.1, and no token outside p's support. The draft is the target
    with its speech-head bias shifted (std 1), so that its distribution q
    overlaps p only partly and both acceptance and the residual max(p - q,
    0) are exercised."""
    _, _, tp, _, _, tcond = models["int8"]
    kw = dict(temperature=1.5, top_p=1.0, repetition_penalty=1.2)
    draft = dict(tp, speech_head=dict(tp["speech_head"]))
    shift = torch.from_numpy(np.random.default_rng(9).standard_normal(V).astype(np.float32))
    draft["speech_head"]["b"] = tp["speech_head"]["b"] + shift
    # p and q of the first position: the start token is in the history
    pen = torch.zeros(V, dtype=torch.bool)
    pen[HP.start_speech_token] = True
    probs = []
    for params in (tp, draft):
        _, logits, _ = prefill(params, HP, tcond, torch.from_numpy(TEXT), 1, False, 1)
        probs.append(spec.probs_or_stop(S.process_logits_turbo(
            logits[0], pen, S.SamplerParams(**kw), 4), STOP))
    p, q = probs
    support = torch.nonzero(p > 0).flatten()
    assert len(support) == 4 and set(torch.nonzero(q > 0).flatten().tolist()) != set(
        support.tolist())
    g = torch.Generator().manual_seed(10)
    first = [int(_spec(tp, draft, tcond, kw, max_new_tokens=1, n_draft=2, top_k=4,
                       generator=g).tokens[0]) for _ in range(N_DRAWS)]
    counts = np.bincount(first, minlength=V)
    assert counts[support.numpy()].sum() == N_DRAWS
    expected = N_DRAWS * p[support].numpy()
    chi2 = float(((counts[support.numpy()] - expected) ** 2 / expected).sum())
    tv = 0.5 * float(np.abs(counts[support.numpy()] / N_DRAWS - p[support].numpy()).sum())
    assert chi2 < CHI2_BOUND and tv < 0.1, (chi2, tv, counts[support.numpy()], expected)


def test_accept_resample_rows():
    """accept_resample by hand: all accepted gives the bonus token at K; a
    rejection at i resamples from max(p - q, 0) there and pads with stop."""
    p = torch.tensor([[0.5, 0.5, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
    q = torch.tensor([[0.5, 0.5, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]])
    g = torch.zeros(4)
    row, n = spec.accept_resample(p, q, torch.tensor([0, 2]), torch.tensor([0.1, 0.1]), g,
                                  stop_token=3)
    assert int(n) == 2 and row.tolist() == [0, 2, 3]
    row, n = spec.accept_resample(p, q, torch.tensor([0, 1]), torch.tensor([0.1, 0.1]), g,
                                  stop_token=3)
    assert int(n) == 1 and row.tolist() == [0, 2, 3]       # p1 - q1 leaves token 2 only


def _turbo(hp, seed=0):
    """A Turbo pipeline on the CPU with a float T3 (the verify target), a
    tiny meanflow S3Gen and _Tok."""
    dims, tok_cfg = FlowDims.tiny_test(), S3TokenizerConfig.tiny_test()
    s3 = S3GenEngine(s3gen_init(1, "cpu", meanflow=True, dims=dims, hift_base=32,
                                tok_cfg=tok_cfg), dims=dims, tok_cfg=tok_cfg)
    return port.ChatterboxTurboTTS(t3m.t3_init(hp, seed=seed, device="cpu"), hp, s3, None,
                                   _Tok(), _conds(np.random.default_rng(0))[1], seed=seed)


FUSED_HP = T3Config(**dict(HP.__dict__, backbone_name="GPT2_fused_test"))


def test_int8_fused_self_draft_in_generate(monkeypatch):
    """generate(draft="int8") on GPT2_fused_test: the draft is the target
    quantized int8_fused (built once), each draft step takes the two fused
    layer calls (plain kernel versions here) per layer, the verify none,
    and greedy tokens equal generate()'s without a draft."""
    tts = _turbo(FUSED_HP)
    calls = {"qkv": 0, "mlp": 0}
    for name, key in (("apply_fused_gpt2_qkv_int8", "qkv"),
                      ("apply_fused_gpt2_mlp_int8", "mlp")):
        f = getattr(bb, name)
        monkeypatch.setattr(bb, name, lambda *a, _f=f, _k=key, **k: (
            calls.__setitem__(_k, calls[_k] + 1), _f(*a, **k))[1])
    kw = dict(top_k=1, max_new_tokens=12)
    seq = tts.generate("hello there", **kw)
    seq_tokens = tts.last_decode.tokens.clone()
    assert calls == {"qkv": 0, "mlp": 0}
    wav = tts.generate("hello there", draft="int8", n_draft=3, **kw)
    res = tts.last_decode
    assert isinstance(res, spec.SpecResult)
    draft = tts._quantized_self_draft()
    assert "fused" in draft.t3_params["backbone"]["layers"][0]
    assert draft is tts._quantized_self_draft() and draft.conds is tts.conds
    L = FUSED_HP.backbone.num_layers
    assert calls == {"qkv": L * 4 * res.n_rounds, "mlp": L * 4 * res.n_rounds}
    np.testing.assert_array_equal(res.tokens.numpy(), seq_tokens.numpy())
    assert wav.shape == seq.shape and np.isfinite(wav).all()


def test_draft_pipeline_and_the_knobs(caplog):
    """A draft pipeline (another seed's weights) builds on its own
    conditionals; C3: kv_int8=True beside draft= logs the warning and
    decodes the tokens of kv_int8=False (draft= kept); draft="int8" on
    quantized weights raises."""
    tts, other = _turbo(HP), _turbo(HP, seed=3)
    other.conds = tts.conds
    kw = dict(top_k=50, max_new_tokens=16, draft=other, n_draft=3)
    tts.set_seed(4)
    with caplog.at_level(logging.WARNING):
        tts.generate("hi", kv_int8=True, **kw)
    assert any("kv_int8 is ignored" in r.message for r in caplog.records)
    with_kv = tts.last_decode
    tts.set_seed(4)
    tts.generate("hi", **kw)
    assert isinstance(with_kv, spec.SpecResult)
    np.testing.assert_array_equal(with_kv.tokens.numpy(), tts.last_decode.tokens.numpy())
    other.conds = None
    with pytest.raises(ValueError, match="draft pipeline needs conditionals"):
        tts.generate("hi", **kw)
    quantized = port.ChatterboxTurboTTS.random_init(
        hp=FUSED_HP, flow_dims=FlowDims.tiny_test(), tok_cfg=S3TokenizerConfig.tiny_test(),
        hift_base=32, tokenizer=_Tok(), device="cpu")
    quantized.conds = tts.conds
    with pytest.raises(ValueError, match="already quantized"):
        quantized.generate("hi", draft="int8", max_new_tokens=4)
