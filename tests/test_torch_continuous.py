"""The port's continuous slot engine (chatterbox_tpu_torch/sampling/
continuous.py) and the backbone's per-row decode step, held against the
port's own scalar step, against chatterbox_tpu's `admit` /
`decode_chunk_multi` on the JAX CPU backend with JAX's gumbel draws
replayed, and, as tests/test_continuous.py holds the JAX server, against
isolated runs, the batched engine and solo streams. Both families: the
2-layer GPT2_fused_test (Turbo) and Llama_fused_test (520M CFG, two rows a
slot) T3s, int8_fused, whose kernels run as their plain versions (CPU
tensors); the bf16 and the int8 slot cache; a tiny meanflow S3Gen for the
streams and the vocode."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.ops import sampling as JS  # noqa: E402
from chatterbox_tpu.sampling import continuous as JC  # noqa: E402

from chatterbox_tpu_torch.api.pipelines import T3CondHost  # noqa: E402
from chatterbox_tpu_torch.kernels.decode_attention import TT  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.model import SIL_TOKEN, RefDict, S3GenEngine  # noqa: E402
from chatterbox_tpu_torch.models.t3 import backbone as bb  # noqa: E402
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.ops.sampling import SamplerParams  # noqa: E402
from chatterbox_tpu_torch.sampling import continuous as C  # noqa: E402
from chatterbox_tpu_torch.sampling.batched import t3_generate_batched  # noqa: E402
from chatterbox_tpu_torch.serve.batching import (ContinuousServingLoop,  # noqa: E402
                                                 TTSRequest, drop_invalid_tokens_sliced,
                                                 vocode_seed)
from chatterbox_tpu_torch.serve.streaming import StreamingVocoder  # noqa: E402

from tests import test_torch_t3 as G  # noqa: E402   Turbo family fixtures
from tests import test_torch_t3_llama as L  # noqa: E402   520M family fixtures
from tests.test_torch_convert import few_threads  # noqa: E402,F401
from tests.test_torch_s3gen import DIMS, params  # noqa: E402
from tests.test_torch_streaming import _jax_draws  # noqa: E402

FAMILIES = {"gpt2": (G, False), "llama": (L, True)}      # fixtures module, CFG


def _tp(mod):
    return mod.models("f32")[1]


def _cond(mod):
    hp = mod.HP
    return T3CondHost(np.zeros((1, 256), np.float32),
                      np.zeros((1, hp.speech_cond_prompt_len), np.int64), 0.6)


def _req(mod, rid, seed, n_text=5, max_new=None, temperature=0.8, cfg=False, **kw):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 60, n_text)
    if cfg:
        ids = np.concatenate([mod.TEXT[0, :1], ids, mod.TEXT[0, -1:]])   # SOT / EOT framed
        sp = SamplerParams(temperature=temperature, top_p=1.0, min_p=0.02,
                           repetition_penalty=1.2, cfg_weight=0.5)
    else:
        sp = SamplerParams(temperature=temperature, cfg_weight=0.0)
    return TTSRequest(ids, _cond(mod), sp, rid, seed, max_new, **kw)


def _server(mod, cfg=False, **kw):
    kw = dict(dict(n_slots=3, text_bucket=16, max_new_tokens=24, chunk=4, top_k=40), **kw)
    return C.ContinuousTTSServer(_tp(mod), mod.HP, cfg=cfg, **kw)


def _engine():
    return S3GenEngine(params()[1], dims=DIMS)


def _voice(seed=9, P=10):
    rng = np.random.default_rng(seed)
    return RefDict(rng.integers(0, 6561, (1, P)).astype(np.int32), np.array([P], np.int32),
                   (rng.standard_normal((1, 2 * P, 80)) * 0.5).astype(np.float32),
                   rng.standard_normal((1, 192)).astype(np.float32))


# ---------------------------------------------------------------------------
# the backbone's per-row step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("cache,fused", [("bf16", False), ("bf16", True), ("int8", True)])
def test_per_row_step_matches_the_scalar_step(family, cache, fused):
    """Three rows of prefixes of different lengths in one left-aligned
    cache: one per-row step (positions and cache offsets from a device
    tensor) against each row's scalar step at its own offset, hidden
    states and the written cache. With fused_attn the decode-attention
    kernels (plain versions: B3 on the bf16 cache, B4 on the int8 cache)
    take the rows' positions as `cur` in both."""
    mod, _ = FAMILIES[family]
    hp, tp = mod.HP, _tp(mod)
    cfg = hp.backbone
    int8 = cache == "int8"
    cls = bb.KVCacheInt8 if int8 else bb.KVCache
    T = TT
    rng = np.random.default_rng(3)
    lens = [7, 12, 9]
    full = cls.zeros(cfg, 3, T, "cpu")
    singles, emb = [], []
    for b, n in enumerate(lens):
        x = torch.from_numpy(rng.standard_normal((1, n, cfg.hidden_size)).astype(np.float32))
        c = cls.zeros(cfg, 1, T, "cpu")
        bb.backbone_apply(tp["backbone"], cfg, x, torch.arange(n)[None], c, 0)
        for f_all, f_one in zip(C._cache_fields(full), C._cache_fields(c)):
            f_all[:, b] = f_one[:, 0]
        singles.append(c)
        emb.append(torch.from_numpy(rng.standard_normal((1, 1, cfg.hidden_size)
                                                        ).astype(np.float32)))
    pos = torch.tensor(lens)
    out = bb.backbone_step_rows(tp["backbone"], cfg, torch.cat(emb), pos, full,
                                fused_attn=fused)
    for b, n in enumerate(lens):
        ref = bb.backbone_apply(tp["backbone"], cfg, emb[b], torch.tensor([[n]]), singles[b],
                                n, fused_attn=fused)
        np.testing.assert_allclose(out[b].numpy(), ref[0].numpy(), rtol=0, atol=2e-5)
        # the prefix untouched, nothing written past the row's position; at
        # it, the new K / V of a 3-row against a 1-row projection (the plain
        # kernel's sums) within one unit of rounding: a bf16 ulp, an int8 code
        for f_all, f_one in zip(C._cache_fields(full), C._cache_fields(singles[b])):
            a, r = f_all[:, b].float().numpy(), f_one[:, 0].float().numpy()
            np.testing.assert_array_equal(a[:, :, :n], r[:, :, :n])
            assert not a[:, :, n + 1:].any()
            np.testing.assert_allclose(a[:, :, n], r[:, :, n], rtol=2.0 ** -7,
                                       atol=1.0 if f_all.dtype == torch.int8 else 0)


# ---------------------------------------------------------------------------
# admit / decode_chunk_multi against the JAX package, its draws replayed
# ---------------------------------------------------------------------------

def _jax_cond(mod, cond):
    emo = jnp.full((1, 1, 1), cond.emotion_adv) if mod.HP.emotion_adv else None
    return jt3m.T3CondArrays(jnp.asarray(cond.speaker_emb),
                             jnp.asarray(cond.cond_prompt_speech_tokens, jnp.int32), emo)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kv_int8", [False, True])
def test_admit_and_decode_chunk_multi_match_jax(family, kv_int8):
    """Two requests admitted at different rounds into three slots (3 steps,
    a second admit, 5 more steps), sampled: every slot's tokens, steps and
    done flags equal JAX's admit / decode_chunk_multi with each request's
    gumbel draws replayed from its JAX key."""
    mod, cfg_mode = FAMILIES[family]
    qp, tp = mod.models("f32")
    hp, jhp = mod.HP, mod.JHP
    reqs = [_req(mod, i, 50 + i, n_text=4 + 3 * i, temperature=0.9, cfg=cfg_mode)
            for i in range(2)]
    cap, bucket = 10, 16
    V = hp.speech_tokens_dict_size
    jstate = JC.init_slots(jhp, 3, bucket, cap, cfg=cfg_mode, kv_int8=kv_int8)
    state = C.init_slots(hp, 3, bucket, cap, cfg=cfg_mode, kv_int8=kv_int8, device="cpu")
    sw = dict(top_k=40, cfg_mode=cfg_mode)

    def both_admit(slot, r, max_new):
        key = jax.random.key(100 + slot)
        sp = r.sampler
        text = np.zeros((1, bucket), np.int32)
        text[0, :len(r.text_tokens)] = r.text_tokens
        jst = JC.admit(qp, jhp, jstate, jnp.asarray(slot), _jax_cond(mod, r.cond),
                       jnp.asarray(text), jnp.asarray(len(r.text_tokens), jnp.int32), key,
                       jnp.asarray(max_new, jnp.int32), jnp.asarray(sp.temperature),
                       jnp.asarray(sp.top_p), jnp.asarray(sp.repetition_penalty),
                       min_p=jnp.asarray(sp.min_p), cfg_weight=jnp.asarray(sp.cfg_weight),
                       cfg_mode=cfg_mode)
        C.admit(tp, hp, state, slot, r.cond.as_tensors("cpu"),
                torch.as_tensor(r.text_tokens[None]), gumbel=_jax_draws(key, cap, V),
                max_new=max_new, temperature=sp.temperature, top_p=sp.top_p,
                repetition_penalty=sp.repetition_penalty, min_p=sp.min_p,
                cfg_weight=sp.cfg_weight, cfg_mode=cfg_mode)
        return jst

    jstate = both_admit(0, reqs[0], 10)
    jstate = JC.decode_chunk_multi(qp, jhp, jstate, n_steps=3, **sw)
    C.decode_chunk_multi(tp, hp, state, n_steps=3, **sw)
    jstate = both_admit(2, reqs[1], 6)
    jstate = JC.decode_chunk_multi(qp, jhp, jstate, n_steps=5, **sw)
    C.decode_chunk_multi(tp, hp, state, n_steps=5, **sw)
    jstatus = np.asarray(JC.pack_status(jstate))
    status = C.pack_status(state).numpy()
    np.testing.assert_array_equal(status[:9], jstatus[:9])       # done, active, step
    np.testing.assert_array_equal(status[9:].reshape(3, cap)[[0, 2]],
                                  jstatus[9:].reshape(3, cap)[[0, 2]])
    assert list(status[6:9]) == [8, 0, 5]
    assert len(set(status[9:9 + 8].tolist())) > 2


# ---------------------------------------------------------------------------
# the server (as tests/test_continuous.py holds the JAX package's)
# ---------------------------------------------------------------------------

def test_mid_decode_admission_no_drain():
    srv = _server(G)
    srv.submit(_req(G, 1, 100, max_new=24))
    srv.step()
    assert 1 not in srv.results
    srv.submit(_req(G, 2, 200, max_new=4))
    srv.step()
    assert 2 in srv.results and 1 not in srv.results
    srv.run_until_idle()
    assert set(srv.results) == {1, 2} and len(srv.results[2]) <= 4


@pytest.mark.parametrize("kv_int8", [False, True])
def test_outputs_match_isolated_runs(kv_int8):
    """A request's tokens are the same alone on a fresh server and admitted
    mid-decode beside others (per-request seeds, samplers and caps)."""
    reqs = [_req(G, i, 300 + i, n_text=4 + i, max_new=12, temperature=0.6 + 0.2 * i)
            for i in range(3)]
    iso = {}
    for r in reqs:
        srv = _server(G, kv_int8=kv_int8)
        srv.submit(r)
        iso.update(srv.run_until_idle())
    srv = _server(G, kv_int8=kv_int8)
    srv.submit(reqs[0])
    srv.step()
    srv.submit(reqs[1])
    srv.step()
    srv.submit(reqs[2])
    srv.run_until_idle()
    for r in reqs:
        np.testing.assert_array_equal(srv.results[r.request_id], iso[r.request_id])
    assert all(len(t) for t in iso.values())


def test_kv_int8_growth_crosses_a_tile_boundary():
    """A budget past one tile grows the int8 cache (with its scales) from 256
    to 512 positions mid-decode; solo and staggered tokens stay equal (the
    long request, and a short one that joins it mid-decode)."""
    N = TT + 8
    mk = lambda: _server(G, n_slots=2, max_new_tokens=N, chunk=32, kv_int8=True)
    reqs = [_req(G, 0, 700, n_text=4, max_new=N), _req(G, 1, 701, n_text=5, max_new=40)]
    iso = {}
    for r in reqs:
        srv = mk()
        assert srv.state.cache.max_len == TT
        srv.submit(r)
        iso.update(srv.run_until_idle())
    assert srv.state.cache.max_len == TT          # the short request never grows it
    srv = mk()
    srv.submit(reqs[0])
    srv.step()
    srv.submit(reqs[1])
    srv.run_until_idle()
    assert srv.state.cache.max_len == 2 * TT and srv.state.cache.k_s.shape[3] == 2 * TT
    for r in reqs:
        np.testing.assert_array_equal(srv.results[r.request_id], iso[r.request_id])
    assert len(iso[0]) > TT - 64


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cache_growth_leaves_tokens_unchanged(family):
    """The cache starts small and doubles as rows advance; tokens equal a
    server whose cache was full-size from the start."""
    mod, cfg = FAMILIES[family]
    small, full = _server(mod, cfg=cfg), _server(mod, cfg=cfg)
    cap0 = small._t_cap
    assert cap0 < small._t_full
    full.state = C.init_slots(mod.HP, 3, 16, 24, cfg=cfg, device="cpu")
    full._t_cap = full._t_full
    for srv in (small, full):
        for i in range(3):
            srv.submit(_req(mod, i, 500 + i, n_text=14, max_new=24, cfg=cfg))
        srv.run_until_idle()
    assert small._t_cap > cap0 and small.state.cache.max_len == small._t_cap
    assert set(small.results) == set(full.results) == {0, 1, 2}
    for rid in small.results:
        np.testing.assert_array_equal(small.results[rid], full.results[rid])


def test_more_requests_than_slots():
    srv = _server(G)
    for i in range(6):
        srv.submit(_req(G, i, 400 + i, max_new=6))
    results = srv.run_until_idle()
    assert set(results) == set(range(6))
    assert all((t < 6561).all() for t in results.values())


def test_cfg_staggered_matches_the_batched_engine():
    """Three CFG requests through two slots, admitted at different rounds:
    each request's tokens equal the batched CFG engine's (sampling/
    batched.py) for that request alone with the same seed: cross-engine,
    left-aligned slots against left-padded rows."""
    hp, tp = L.HP, _tp(L)
    srv = _server(L, cfg=True, n_slots=2, max_new_tokens=12, top_k=1000)
    reqs = [_req(L, i, 20 + i, n_text=4 + 2 * i, temperature=1.0 + 0.3 * i, cfg=True)
            for i in range(3)]
    for r in reqs:
        srv.submit(r)
        srv.step()
    res = srv.run_until_idle()
    assert set(res) == {0, 1, 2}
    for r in reqs:
        ids = torch.as_tensor(r.text_tokens[None])
        out = t3_generate_batched(tp, hp, r.cond.as_tensors("cpu"), ids, [ids.shape[1]],
                                  r.sampler, [torch.Generator().manual_seed(r.seed)],
                                  max_new_tokens=12, cfg_mode=True)
        t = drop_invalid_tokens_sliced(out.tokens[0, :int(out.n_tokens[0])].numpy())
        np.testing.assert_array_equal(res[r.request_id], t[t < 6561])


def test_cfg_mid_decode_admission():
    srv = _server(L, cfg=True, n_slots=2)
    srv.submit(_req(L, 1, 31, n_text=6, max_new=24, cfg=True))
    srv.step()
    srv.submit(_req(L, 2, 32, n_text=4, max_new=4, cfg=True))
    srv.step()
    assert 2 in srv.results and 1 not in srv.results
    srv.run_until_idle()
    assert set(srv.results) == {1, 2}


def test_continuous_with_vocoding():
    """Tokens and audio per request: each wav equals the batched vocode of
    the request's tokens with its seed-derived generator, alone (float32
    sums of a 2-row and a 1-row flow: 1e-5)."""
    eng, ref = _engine(), _voice()
    srv = _server(G, s3gen=eng)
    for i in range(2):
        srv.submit(_req(G, i, 500 + i, max_new=6, ref=ref))
    srv.run_until_idle()
    assert set(srv.wavs) == {0, 1}
    for rid, w in srv.wavs.items():
        assert np.isfinite(w).all() and len(w) == max(len(srv.results[rid]), 1) * 960
        alone = eng.inference_batch([srv.results[rid]], [ref], [torch.Generator().manual_seed(
            vocode_seed(500 + rid))])[0]
        np.testing.assert_allclose(w, alone, rtol=0, atol=1e-5)


def _drive_reuse(srv, first, rest, cbs=None):
    """Run `first` until it retires, then submit the rest at once, so they
    reuse its slot while the lagged snapshot still shows it."""
    srv.submit(first, on_chunk=None if cbs is None else cbs[0])
    for _ in range(100):
        srv.serve_round()
        if first.request_id in srv.results:
            break
    assert first.request_id in srv.results
    for i, r in enumerate(rest):
        srv.submit(r, on_chunk=None if cbs is None else cbs[1 + i])
    while srv.serve_round():
        pass
    return srv.results


def test_reused_slot_gets_its_own_tokens():
    one = lambda: _server(G, n_slots=1, max_new_tokens=8)
    res = _drive_reuse(one(), _req(G, 1, 810, max_new=4), [_req(G, 2, 811, max_new=8)])
    iso = one()
    iso.submit(_req(G, 2, 811, max_new=8))
    np.testing.assert_array_equal(res[2], iso.run_until_idle()[2])


def test_reused_slot_stream_gets_its_own_audio():
    eng, ref = _engine(), _voice()
    mk = lambda: _server(G, n_slots=1, max_new_tokens=8, s3gen=eng, stream_chunk=4)
    got_a, got_b, solo = [], [], []
    _drive_reuse(mk(), _req(G, 1, 820, max_new=4, ref=ref), [_req(G, 2, 821, max_new=8,
                                                                   ref=ref)],
                 cbs=[lambda c, f: got_a.append((c, f)), lambda c, f: got_b.append((c, f))])
    iso = mk()
    iso.submit(_req(G, 2, 821, max_new=8, ref=ref), on_chunk=lambda c, f: solo.append((c, f)))
    iso.run_until_idle()
    assert len(got_b) == len(solo) > 0
    for (c1, f1), (c2, f2) in zip(got_b, solo):
        assert f1 == f2
        np.testing.assert_array_equal(c1, c2)


def _streams(seeds, cfg=False, max_new=14, first_chunk=None, stream_chunk=5, ref=None,
             mod=None):
    mod = mod or (L if cfg else G)
    srv = _server(mod, cfg=cfg, max_new_tokens=max_new, s3gen=_engine(),
                  stream_chunk=stream_chunk, first_chunk=first_chunk)
    chunks = {s: [] for s in seeds}
    for s in seeds:
        srv.submit(_req(mod, s, s, max_new=max_new, temperature=0.9, cfg=cfg,
                        ref=ref or _voice()),
                   on_chunk=lambda c, f, s=s: chunks[s].append((c, f)))
    srv.run_until_idle()
    return chunks, srv


@pytest.mark.parametrize("cfg", [False, True])
def test_streams_byte_identical_to_solo(cfg):
    """Three concurrent streams: each request's (chunk, final) sequence is
    byte for byte its solo run's, with exactly one final, last."""
    seeds = (171, 172, 173) if cfg else (71, 72, 73)
    solos = {s: _streams([s], cfg)[0][s] for s in seeds}
    conc, _ = _streams(list(seeds), cfg)
    for s, solo in solos.items():
        assert len(conc[s]) == len(solo) > 0
        for (c1, f1), (c2, f2) in zip(solo, conc[s]):
            assert f1 == f2
            np.testing.assert_array_equal(c1, c2)
        finals = [f for _, f in conc[s]]
        assert finals[-1] and sum(finals) == 1


@pytest.mark.parametrize("cfg", [False, True])
def test_stream_audio_is_the_vocode_of_its_tokens(cfg):
    """A stream's audio covers its valid tokens (and Turbo's 3 silence
    tokens), and equals a StreamingVocoder with the request's vocode
    generator fed the same tokens in the same blocks."""
    seed = 181 if cfg else 81
    chunks, srv = _streams([seed], cfg)
    toks = srv.results[seed]
    total = sum(c.size for c, _ in chunks[seed])
    assert total == (max(len(toks), 1) if cfg else len(toks) + 3) * 960
    assert all(np.isfinite(c).all() for c, _ in chunks[seed])
    voc = StreamingVocoder(srv.s3gen, _voice(),
                           torch.Generator().manual_seed(vocode_seed(seed)))
    tail = toks if cfg else np.concatenate([toks, np.full(3, SIL_TOKEN)])
    cuts = [5 * (i + 1) for i in range(len(toks) // 5)]
    blocks = [b for b in np.split(tail, cuts) if len(b)]
    again = [voc.feed(b, final=i == len(blocks) - 1) for i, b in enumerate(blocks)]
    np.testing.assert_array_equal(np.concatenate([c for c, _ in chunks[seed]]),
                                  np.concatenate(again))


def test_mixed_stream_and_batch_traffic():
    eng, ref = _engine(), _voice()
    srv = _server(G, max_new_tokens=10, s3gen=eng, stream_chunk=5)
    got = []
    srv.submit(_req(G, 1, 91, max_new=10, ref=ref), on_chunk=lambda c, f: got.append((c, f)))
    srv.submit(_req(G, 2, 92, max_new=8))
    srv.run_until_idle()
    iso = _server(G, max_new_tokens=10)
    iso.submit(_req(G, 2, 92, max_new=8))
    np.testing.assert_array_equal(srv.results[2], iso.run_until_idle()[2])
    assert got and got[-1][1]


def test_cfg_empty_stream_silence_fallback():
    srv = _server(L, cfg=True, n_slots=2, max_new_tokens=8, s3gen=_engine())
    feeds = srv._finish_feeds(C._SlotStream(voc=None, cb=lambda c, f: None, first_chunk=5))
    assert len(feeds) == 1
    _, blk, final = feeds[0]
    assert final and list(blk) == [SIL_TOKEN]


def test_first_feed_rounds_last_until_the_first_audio(monkeypatch):
    """C1: the first-feed rounds (first_chunk steps) last until the stream's
    first audio, not until first_chunk raw tokens: a stream whose first 8
    tokens are specials keeps 4-step rounds through its first 12 steps
    (gating on raw tokens would go back to 8-step rounds after one).
    Tokens are those of the plain schedule."""
    real = C.decode_chunk_multi
    round_steps = []

    def specials_first(params, hp, state, **kw):
        round_steps.append(kw["n_steps"])
        real(params, hp, state, **kw)
        state.tokens[:, :8] = hp.speech_tokens_dict_size - 1      # a special, not EOS
        return state

    monkeypatch.setattr(C, "decode_chunk_multi", specials_first)
    eng, ref = _engine(), _voice()
    first_audio = []
    srv = _server(G, n_slots=2, max_new_tokens=20, chunk=8, s3gen=eng, stream_chunk=5,
                  first_chunk=4)
    srv.submit(_req(G, 1, 61, max_new=20, ref=ref),
               on_chunk=lambda c, f: first_audio.append(len(round_steps)) if len(c)
               else None)
    srv.run_until_idle()
    n = first_audio[0]
    assert n >= 3 and round_steps[:n] == [4] * n
    assert set(round_steps[n:]) <= {8}
    assert srv.rounds == len(round_steps) and srv.decode_steps == sum(round_steps)
    plain = _server(G, n_slots=2, max_new_tokens=20, chunk=8)
    plain.submit(_req(G, 1, 61, max_new=20))
    np.testing.assert_array_equal(srv.results[1], plain.run_until_idle()[1])


def test_refusals():
    with pytest.raises(ValueError, match="at most 16"):
        _server(G, n_slots=17)
    with pytest.raises(ValueError, match="at most 16"):
        _server(L, cfg=True, n_slots=9)
    _server(L, cfg=True, n_slots=8)
    with pytest.raises(ValueError, match="first_chunk"):
        _server(G, first_chunk=3)
    srv = _server(G, s3gen=_engine())
    with pytest.raises(ValueError, match="ref"):
        srv.submit(_req(G, 1, 1), on_chunk=lambda c, f: None)
    with pytest.raises(ValueError, match="s3gen"):
        _server(G).submit(_req(G, 1, 1, ref=_voice()), on_chunk=lambda c, f: None)


# ---------------------------------------------------------------------------
# ContinuousServingLoop (serve/batching.py)
# ---------------------------------------------------------------------------

def _run_loop(server, reqs, n_wait, streams=()):
    import threading
    got, ev = {}, threading.Event()

    def on_result(res):
        got[res.request_id] = res
        if len(got) == n_wait:
            ev.set()

    loop = ContinuousServingLoop(server, on_result)
    try:
        loop.start()
        for r in reqs:
            loop.submit(r)
        for r, cb in streams:
            loop.submit_stream(r, cb)
        assert ev.wait(120), f"only {sorted(got)} completed"
    finally:
        loop.stop()
    assert not loop._thread.is_alive()
    return got


def test_loop_results_match_a_direct_run():
    reqs = lambda: [_req(G, i, 600 + i, n_text=4 + i, max_new=8) for i in range(4)]
    direct = _server(G)
    for r in reqs():
        direct.submit(r)
    expect = direct.run_until_idle()
    got = _run_loop(_server(G), reqs(), 4)
    for rid, res in got.items():
        assert res.wav is None
        np.testing.assert_array_equal(res.speech_tokens, expect[rid])


def test_loop_vocodes_streams_and_fires_wavs():
    eng, ref = _engine(), _voice()
    reqs = lambda: [_req(G, i, 800 + i, max_new=6, ref=ref) for i in range(2)]
    direct = _server(G, s3gen=eng)
    for r in reqs():
        direct.submit(r)
    direct.run_until_idle()
    chunks = []
    got = _run_loop(_server(G, s3gen=eng, stream_chunk=5), reqs(), 3,
                    streams=[(_req(G, 9, 809, max_new=6, ref=ref),
                              lambda c, f: chunks.append((c, f)))])
    for rid in (0, 1):
        np.testing.assert_array_equal(got[rid].speech_tokens, direct.results[rid])
        np.testing.assert_array_equal(got[rid].wav, direct.wavs[rid])
    assert chunks and chunks[-1][1] and got[9].wav is None


def test_stop_finishes_in_flight_requests():
    got = {}
    loop = ContinuousServingLoop(_server(G), lambda res: got.update({res.request_id: res}))
    loop.submit(_req(G, 7, 900, max_new=8))
    try:
        loop.start()
    finally:
        loop.stop()                     # graceful: finishes the request first
    assert 7 in got and not loop._thread.is_alive()


def test_pop_ready_defers_until_the_wav_arrives():
    class StubEngine:
        device = torch.device("cpu")

        def inference_batch_dispatch(self, rows, refs, generators):
            return rows

        def inference_batch_fetch(self, handle):
            return [np.zeros(3, np.float32) for _ in handle]

    srv = _server(G, s3gen=StubEngine())
    srv.submit(_req(G, 1, 950, max_new=4, ref=object()))
    deferred = False
    for _ in range(100):
        busy = srv.serve_round()
        if 1 in srv.results and 1 not in srv.wavs:
            assert srv.pop_ready() == []
            deferred = True
        if not busy:
            break
    assert deferred
    ready = srv.pop_ready()
    assert [rid for rid, _, _ in ready] == [1] and ready[0][2] is not None
    assert not srv.results and not srv.wavs and not srv._await_wav


def test_tokens_emitted_counts_the_finished_requests_tokens():
    """tokens_emitted: the tokens of every finished request's result, plain
    and streamed, with more requests than slots."""
    srv = _server(G, n_slots=2, max_new_tokens=12, s3gen=_engine(), stream_chunk=4)
    assert srv.tokens_emitted == 0
    for rid in range(3):
        srv.submit(_req(G, rid, 30 + rid, max_new=12, ref=_voice()))
    srv.submit(_req(G, 3, 33, max_new=12, ref=_voice()), on_chunk=lambda c, f: None)
    srv.run_until_idle()
    assert sorted(srv.results) == [0, 1, 2, 3]
    assert srv.tokens_emitted == sum(len(t) for t in srv.results.values()) > 0
