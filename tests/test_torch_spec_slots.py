"""The port's speculative slot path (chatterbox_tpu_torch/sampling/
continuous.py `decode_chunk_multi_spec`, `ContinuousTTSServer(draft_int8=)`)
and the backbone's slab step (`backbone_slab_rows`): the slab against its
tokens fed one at a time by `backbone_step_rows` and against the JAX
package's `backbone_apply_unrolled` with a per-row start; the spec rounds
against JAX's `decode_chunk_multi_spec` with its draws replayed and
against the port's draft-off rounds; the server, as tests/
test_continuous.py holds the JAX one (draft on against draft off, token for
token and stream byte for byte). The 2-layer GPT2_fused_test T3 in float32
(the verify target; the server quantizes its draft int8_fused, whose
kernels run as their plain versions on CPU tensors) and Llama_fused_test
for the slab. Tokens and bytes exact; hidden states and cache to the
tolerances stated."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.models.t3 import backbone as jbb  # noqa: E402
from chatterbox_tpu.sampling import continuous as JC  # noqa: E402
from chatterbox_tpu.utils.quantize import quantize_t3_backbone as jquant  # noqa: E402

from chatterbox_tpu_torch.convert.from_jax import t3_from_jax  # noqa: E402
from chatterbox_tpu_torch.models.t3 import backbone as bb  # noqa: E402
from chatterbox_tpu_torch.sampling import continuous as C  # noqa: E402
from chatterbox_tpu_torch.utils.quantize import quantize_t3_backbone  # noqa: E402

from tests import test_torch_t3 as G  # noqa: E402
from tests import test_torch_t3_llama as L  # noqa: E402
from tests.test_torch_continuous import _engine, _jax_cond, _req, _voice  # noqa: E402
from tests.test_torch_convert import few_threads  # noqa: E402,F401
from tests.test_torch_streaming import _jax_draws  # noqa: E402

SLAB_TOL = 2e-5        # float32 hidden states: a slab against its single steps / JAX


def _float(mod):
    """The family's float32 T3, unquantized: (JAX params, port params)."""
    return mod.models("f32", None)


def _server(**kw):
    kw = dict(dict(n_slots=3, text_bucket=16, max_new_tokens=20, chunk=4, top_k=40), **kw)
    return C.ContinuousTTSServer(_float(G)[1], G.HP, **kw)


# ---------------------------------------------------------------------------
# the backbone's slab step
# ---------------------------------------------------------------------------

def _prefilled_rows(mod, lens, T, seed):
    """A (L, 3, H, T, hd) bf16 cache whose rows hold prefixes of `lens`
    (random embeddings through the float T3), left-aligned."""
    tp = _float(mod)[1]
    cfg = mod.HP.backbone
    rng = np.random.default_rng(seed)
    cache = bb.KVCache.zeros(cfg, len(lens), T, "cpu")
    for b, n in enumerate(lens):
        x = torch.from_numpy(rng.standard_normal((1, n, cfg.hidden_size)).astype(np.float32))
        c = bb.KVCache.zeros(cfg, 1, T, "cpu")
        bb.backbone_apply(tp["backbone"], cfg, x, torch.arange(n)[None], c, 0)
        cache.k[:, b], cache.v[:, b] = c.k[:, 0], c.v[:, 0]
    return cache


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_slab_rows_match_single_steps_and_jax(family):
    """Three rows at base positions 6, 11 and 8 (their last prefix position
    re-fed, as the verify does) and a 5-token slab: the hidden states and
    the cache equal 5 calls of backbone_step_rows on a copy of the cache
    (within SLAB_TOL, the cache within a bf16 unit), and JAX's
    backbone_apply_unrolled with a (B,) start and a (B, 1, 5, T) mask on
    the same cache."""
    mod = G if family == "gpt2" else L
    jp, tp = _float(mod)
    cfg = mod.HP.backbone
    T, s = 32, 5
    lens = [7, 12, 9]
    cache = _prefilled_rows(mod, lens, T, 3)
    steps = bb.KVCache(cache.k.clone(), cache.v.clone())
    jcache = jbb.KVCache(jnp.asarray(cache.k.float().numpy(), jnp.bfloat16),
                         jnp.asarray(cache.v.float().numpy(), jnp.bfloat16))
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((3, s, cfg.hidden_size)).astype(np.float32)
    pos0 = torch.tensor([n - 1 for n in lens])
    out = bb.backbone_slab_rows(tp["backbone"], cfg, torch.from_numpy(emb), pos0, cache)
    single = torch.cat([bb.backbone_step_rows(tp["backbone"], cfg,
                                              torch.from_numpy(emb[:, j:j + 1]), pos0 + j,
                                              steps) for j in range(s)], 1)
    np.testing.assert_allclose(out.numpy(), single.numpy(), rtol=0, atol=SLAB_TOL)
    for a, b in ((cache.k, steps.k), (cache.v, steps.v)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=2.0 ** -7,
                                   atol=1e-6)
    # JAX's unrolled backbone with a per-row start over the same cache
    pos_q = pos0.numpy()[:, None] + np.arange(s)[None]
    mask = (np.arange(T)[None, None] <= pos_q[:, :, None])[:, None]
    jout, jc = jbb.backbone_apply_unrolled(
        jp["backbone"], mod.JHP.backbone, jnp.asarray(emb), jnp.asarray(pos_q, jnp.int32),
        jcache, jnp.asarray(pos0.numpy(), jnp.int32), jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=SLAB_TOL)
    np.testing.assert_allclose(cache.k.float().numpy(), np.asarray(jc.k, np.float32),
                               rtol=2.0 ** -7, atol=1e-6)
    # nothing written past each row's slab
    for b, n in enumerate(lens):
        assert not cache.k[:, b, :, n - 1 + s:].any()


def test_slab_rows_refuse_the_int8_cache():
    cfg = G.HP.backbone
    cache = bb.KVCacheInt8.zeros(cfg, 2, 256, "cpu")
    with pytest.raises(ValueError, match="bf16 cache"):
        bb.backbone_slab_rows(_float(G)[1]["backbone"], cfg,
                              torch.zeros((2, 3, cfg.hidden_size)), torch.tensor([4, 5]),
                              cache)


# ---------------------------------------------------------------------------
# decode_chunk_multi_spec against the JAX package and the draft-off rounds
# ---------------------------------------------------------------------------

def _admit_both(jstate, state, slot, r, max_new, cap, bucket, jp, tp, key, gumbel=True):
    hp, jhp = G.HP, G.JHP
    sp = r.sampler
    text = np.zeros((1, bucket), np.int32)
    text[0, :len(r.text_tokens)] = r.text_tokens
    if jstate is not None:
        jstate = JC.admit(jp, jhp, jstate, jnp.asarray(slot), _jax_cond(G, r.cond),
                          jnp.asarray(text), jnp.asarray(len(r.text_tokens), jnp.int32), key,
                          jnp.asarray(max_new, jnp.int32), jnp.asarray(sp.temperature),
                          jnp.asarray(sp.top_p), jnp.asarray(sp.repetition_penalty),
                          min_p=jnp.asarray(sp.min_p), cfg_weight=jnp.asarray(sp.cfg_weight))
    C.admit(tp, hp, state, slot, r.cond.as_tensors("cpu"), torch.as_tensor(r.text_tokens[None]),
            gumbel=_jax_draws(key, cap, hp.speech_tokens_dict_size) if gumbel else None,
            generator=None if gumbel else torch.Generator().manual_seed(r.seed),
            max_new=max_new, temperature=sp.temperature, top_p=sp.top_p,
            repetition_penalty=sp.repetition_penalty, min_p=sp.min_p,
            cfg_weight=sp.cfg_weight)
    return jstate


@pytest.mark.parametrize("K", [4, 6])
def test_spec_rounds_match_jax_and_draft_off(K):
    """Two requests admitted at different rounds into three slots (3
    rounds, a second admit, 3 more), sampled, each with its JAX key's draws
    replayed: every slot's tokens, steps and done flags equal JAX's
    decode_chunk_multi_spec on the same float target and int8_fused draft,
    and the port's draft-off decode_chunk_multi on the same draws (the
    second request admitted after the step the spec rounds had reached)."""
    jp, tp = _float(G)
    jq = jquant(jp, mode="int8_fused")
    tq = t3_from_jax(jax.tree.map(np.asarray, jq), G.HP, device="cpu")
    cap, bucket = 24, 16
    reqs = [_req(G, i, 70 + i, n_text=4 + 3 * i, temperature=0.9) for i in range(2)]
    keys = [jax.random.key(200 + i) for i in range(2)]
    jstate = JC.init_slots(G.JHP, 3, bucket, cap)
    state = C.init_slots(G.HP, 3, bucket, cap, device="cpu")
    off = C.init_slots(G.HP, 3, bucket, cap, device="cpu")
    sw = dict(n_rounds=3, n_draft=K, top_k=40)
    jstate = _admit_both(jstate, state, 0, reqs[0], cap, cap, bucket, jp, tp, keys[0])
    _admit_both(None, off, 0, reqs[0], cap, cap, bucket, jp, tp, keys[0])
    jstate = JC.decode_chunk_multi_spec(jp, jq, G.JHP, jstate, **sw)
    C.decode_chunk_multi_spec(tp, tq, G.HP, state, **sw)
    n0 = int(state.step[0])
    assert n0 >= 3                                   # at least a token a round
    C.decode_chunk_multi(tp, G.HP, off, n_steps=n0, top_k=40)
    jstate = _admit_both(jstate, state, 2, reqs[1], 14, cap, bucket, jp, tp, keys[1])
    _admit_both(None, off, 2, reqs[1], 14, cap, bucket, jp, tp, keys[1])
    jstate = JC.decode_chunk_multi_spec(jp, jq, G.JHP, jstate, **sw)
    C.decode_chunk_multi_spec(tp, tq, G.HP, state, **sw)
    jstatus = np.asarray(JC.pack_status(jstate))
    status = C.pack_status(state).numpy()
    np.testing.assert_array_equal(status[:9], jstatus[:9])       # done, active, step
    np.testing.assert_array_equal(status[9:].reshape(3, cap)[[0, 2]],
                                  jstatus[9:].reshape(3, cap)[[0, 2]])
    steps = status[6:9]
    # drafts accepted: more tokens than rounds
    assert steps[1] == 0 and steps[0] > n0 > 3 and steps[2] > 3
    assert len(set(status[9:9 + int(steps[0])].tolist())) > 2      # really sampled
    # draft-off on the same draws reaches the same tokens
    C.decode_chunk_multi(tp, G.HP, off, n_steps=cap, top_k=40)
    for slot in (0, 2):
        n = int(steps[slot])
        np.testing.assert_array_equal(off.tokens[slot, :n].numpy(),
                                      state.tokens[slot, :n].numpy())


def test_generator_draws_by_step_equal_draft_off():
    """Slots that draw from their requests' torch.Generators: spec rounds
    fed the slots' step bounds a round at a time (so the draw table grows
    across calls) give draft-off's tokens on generators of the same seeds;
    each slot's table holds exactly the rows its bounds asked for, drawn
    once."""
    _, tp = _float(G)
    tq = quantize_t3_backbone(tp, mode="int8_fused")
    cap, bucket, K = 20, 16, 3
    reqs = [_req(G, i, 90 + i, n_text=5 + i, temperature=0.8) for i in range(2)]
    on = C.init_slots(G.HP, 2, bucket, cap, device="cpu")
    off = C.init_slots(G.HP, 2, bucket, cap, device="cpu")
    for st in (on, off):
        for slot, r in enumerate(reqs):
            _admit_both(None, st, slot, r, cap, cap, bucket, None, tp, None, gumbel=False)
    bound = [0, 0]
    for _ in range(4):
        C.decode_chunk_multi_spec(tp, tq, G.HP, on, n_rounds=1, n_draft=K, top_k=40,
                                  step_bound=bound)
        bound = [min(b + K + 1, cap) for b in bound]
        assert on.n_drawn == bound
        assert all(int(s) <= b for s, b in zip(on.step, bound))
    table = on.draw_table.clone()
    C.decode_chunk_multi(tp, G.HP, off, n_steps=cap, top_k=40)
    for slot in range(2):
        n = int(on.step[slot])
        assert n >= 4
        np.testing.assert_array_equal(off.tokens[slot, :n].numpy(),
                                      on.tokens[slot, :n].numpy())
        # the table's rows are the generator's draws in order
        g = torch.Generator().manual_seed(reqs[slot].seed)
        rows = torch.stack([C.S.gumbel((G.HP.speech_tokens_dict_size,), g, "cpu")
                            for _ in range(bound[slot])])
        np.testing.assert_array_equal(table[slot, :bound[slot]].numpy(), rows.numpy())


# ---------------------------------------------------------------------------
# the server (as tests/test_continuous.py TestSpeculativeDraft)
# ---------------------------------------------------------------------------

def _staggered(**kw):
    srv = _server(**kw)
    rs = [_req(G, i, 900 + i, n_text=4 + i, max_new=20, temperature=0.7 + 0.1 * i)
          for i in range(3)]
    srv.submit(rs[0])
    srv.step()
    srv.submit(rs[1])
    srv.submit(rs[2])
    return dict(srv.run_until_idle()), srv


def test_draft_tokens_identical_to_draft_off():
    """Staggered requests on generators of their seeds: the tokens with
    draft on (K = 3 and 8) equal draft off; the counters count a host read
    a dispatch, K draft steps and one verify a spec round."""
    off, _ = _staggered()
    for K in (3, 8):
        on, srv = _staggered(draft_int8=True, n_draft=K)
        assert set(on) == set(off)
        for rid in off:
            np.testing.assert_array_equal(on[rid], off[rid], err_msg=f"rid={rid} K={K}")
        assert srv.decode_steps == K * srv.spec_rounds
        assert srv.spec_rounds == srv.rounds * -(-4 // (K + 1))
        assert srv._t_full == srv._cap_base + 20 + K + 1
    assert all(len(t) for t in off.values())


def test_draft_progress_lower_bound():
    """Even with every draft rejected a spec round emits at least a token a
    running row, so the server ends within the draft-off round count."""
    srv = _server(draft_int8=True, n_draft=4, max_new_tokens=9)
    srv.submit(_req(G, 5, 55, max_new=9))
    rounds = 0
    while srv.serve_round():
        rounds += 1
        assert rounds < 40
    assert 1 <= len(srv.results[5]) <= 9


def test_draft_serve_round_matches_step_path():
    mk = lambda: [_req(G, i, 60 + i, max_new=12) for i in range(2)]
    a_srv = _server(draft_int8=True, n_draft=6)
    for r in mk():
        a_srv.submit(r)
    a = dict(a_srv.run_until_idle())
    b_srv = _server(draft_int8=True, n_draft=6)
    for r in mk():
        b_srv.submit(r)
    while True:
        b_srv.step()
        if all(x is None for x in b_srv._slot_req) and not b_srv._pending:
            break
    assert set(a) == {0, 1}
    for rid in a:
        np.testing.assert_array_equal(a[rid], b_srv.results[rid])


def test_draft_refusals():
    with pytest.raises(ValueError, match="cfg"):
        C.ContinuousTTSServer(_float(L)[1], L.HP, cfg=True, draft_int8=True)
    with pytest.raises(ValueError, match="kv_int8"):
        _server(draft_int8=True, kv_int8=True)
    with pytest.raises(ValueError, match="already quantized"):
        C.ContinuousTTSServer(G.models("f32")[1], G.HP, draft_int8=True)
    with pytest.raises(ValueError, match="bf16 slot cache"):
        state = C.init_slots(G.HP, 2, 16, 8, kv_int8=True, device="cpu")
        C.decode_chunk_multi_spec(_float(G)[1], G.models("f32")[1], G.HP, state, n_rounds=1)


def test_draft_streams_byte_identical_to_draft_off():
    """Two concurrent streams: every (chunk, final) with draft on equals
    draft off byte for byte."""
    eng, ref = _engine(), _voice()

    def drive(**kw):
        srv = _server(max_new_tokens=14, s3gen=eng, stream_chunk=5, **kw)
        chunks = {s: [] for s in (71, 72)}
        for s in chunks:
            srv.submit(_req(G, s, s, max_new=14, ref=ref),
                       on_chunk=lambda c, f, s=s: chunks[s].append((c, f)))
        srv.run_until_idle()
        return chunks

    off = drive()
    on = drive(draft_int8=True, n_draft=5)
    for s in off:
        assert len(on[s]) == len(off[s]) > 0
        for (c1, f1), (c2, f2) in zip(off[s], on[s]):
            assert f1 == f2
            np.testing.assert_array_equal(c1, c2)
