"""The port's multilingual pipeline held against chatterbox_tpu on the JAX
CPU backend: MTLTokenizer and its normalizers on a grapheme vocabulary
trained here (chip_smoke.py's writer) in all 23 languages,
T3Config.multilingual(), teacher-forced CFG logits and
ChatterboxMultilingualTTS.generate on a 2-layer Llama_tiny_test T3 with the
2454-row text embedding (float32, greedy) and a tiny 10-step CFG S3Gen,
generate_stream against generate, and load_mtl_tts from a tiny checkpoint
directory through both packages."""
import json
import logging
import sys
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import chip_smoke  # noqa: E402
import chatterbox_tpu.text.tokenizer as jtok  # noqa: E402
from chatterbox_tpu.api.pipelines import ChatterboxMultilingualTTS as JMTL  # noqa: E402
from chatterbox_tpu.api.pipelines import Conditionals as JConds  # noqa: E402
from chatterbox_tpu.api.pipelines import SUPPORTED_LANGUAGES as JLANGS  # noqa: E402
from chatterbox_tpu.api.pipelines import T3CondHost as JT3Cond  # noqa: E402
from chatterbox_tpu.models.s3gen import flow as jflow  # noqa: E402
from chatterbox_tpu.models.s3gen import hift as jhift  # noqa: E402
from chatterbox_tpu.models.s3gen import model as jmodel  # noqa: E402
from chatterbox_tpu.models.s3gen.model import RefDict as JRefDict  # noqa: E402
from chatterbox_tpu.models.s3gen.model import S3GenEngine as JEngine  # noqa: E402
from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.models.t3.config import T3Config as JT3Config  # noqa: E402

import chatterbox_tpu_torch as port  # noqa: E402
import chatterbox_tpu_torch.text.tokenizer as tok  # noqa: E402
from chatterbox_tpu_torch.api import pipelines  # noqa: E402
from chatterbox_tpu_torch.convert.from_jax import (s3gen_from_jax, t3_from_jax,  # noqa: E402
                                                   ve_from_jax)
from chatterbox_tpu_torch.models.s3gen import model as s3m  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.flow import FlowDims  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.model import S3GenEngine  # noqa: E402
from chatterbox_tpu_torch.models.s3tok.model import S3TokenizerConfig  # noqa: E402
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.models.t3.config import T3Config  # noqa: E402
from chatterbox_tpu_torch.models.ve.model import ve_init  # noqa: E402
from chatterbox_tpu_torch.nn import core as nn  # noqa: E402
from tests import test_torch_t3_llama as T3L  # noqa: E402
from tests.test_torch_convert import assert_trees_equal, few_threads  # noqa: E402,F401
from tests.test_torch_load import tiny_sizes  # noqa: E402

LANGS = sorted(chip_smoke.MTL_SAMPLES)
HP_KW = dict(text_tokens_dict_size=2454, backbone_name="Llama_tiny_test",
             speech_tokens_dict_size=6564, speech_cond_prompt_len=8,
             max_text_tokens=64, max_speech_tokens=128)
JHP, HP = JT3Config(**HP_KW), T3Config(**HP_KW)


# ---------------------------------------------------------------------------
# tokenizer and normalizers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    """The grapheme vocabulary with Cangjie5_TC.json beside it, and a copy
    of the vocabulary alone."""
    d = tmp_path_factory.mktemp("mtl")
    chip_smoke.write_mtl_tokenizer(d)
    bare = tmp_path_factory.mktemp("mtl_bare")
    (bare / chip_smoke.MTL_VOCAB_FILE).write_text((d / chip_smoke.MTL_VOCAB_FILE).read_text())
    return str(d / chip_smoke.MTL_VOCAB_FILE), str(bare / chip_smoke.MTL_VOCAB_FILE)


@pytest.fixture(autouse=True)
def _no_normalizer_singletons(monkeypatch):
    """The optional normalizers cache their instances in module globals:
    start every test without one, in both packages."""
    for mod in (tok, jtok):
        for name in ("_kakasi", "_dicta", "_russian_stresser"):
            monkeypatch.setattr(mod, name, None)


def test_supported_languages_match_jax():
    assert pipelines.SUPPORTED_LANGUAGES == JLANGS and len(JLANGS) == 23
    assert sorted(JLANGS) == LANGS
    langs = port.ChatterboxMultilingualTTS.get_supported_languages()
    langs.pop("zh")                                   # a copy
    assert port.ChatterboxMultilingualTTS.get_supported_languages()["zh"] == "Chinese"


@pytest.mark.parametrize("lang", LANGS)
def test_mtl_tokenizer_matches_jax(vocab, lang):
    """encode / text_to_tokens / decode of a sentence in each language: ids
    exact, the `[lang]` tag first, every id inside the 2454-row embedding."""
    ours, theirs = tok.MTLTokenizer(vocab[0]), jtok.MTLTokenizer(vocab[0])
    text = chip_smoke.MTL_SAMPLES[lang]
    ids = ours.encode(text, language_id=lang)
    assert ids == theirs.encode(text, language_id=lang)
    assert ids[0] == ours.tokenizer.token_to_id(f"[{lang}]")
    arr = ours.text_to_tokens(text, language_id=lang)
    assert arr.dtype == np.int32 and arr.shape == (1, len(ids)) and arr.max() < 2454
    np.testing.assert_array_equal(arr, theirs.text_to_tokens(text, language_id=lang))
    assert ours.decode(ids) == theirs.decode(ids)
    assert ours.encode(text) == theirs.encode(text)             # no language: no tag


def test_zh_with_and_without_cangjie(vocab):
    """zh through Cangjie5_TC.json: each mapped glyph becomes its [cj_*]
    codes and [cj_.], the second glyph of a shared code carries [cj_1];
    without the mapping file the glyphs pass through (as in JAX)."""
    ours, theirs = tok.MTLTokenizer(vocab[0]), jtok.MTLTokenizer(vocab[0])
    cj = {ours.tokenizer.token_to_id(t) for t in chip_smoke.CJ_TOKENS}
    for text in ("你好", "妳好", "世界。中文", "你X"):
        ids = ours.encode(text, language_id="zh")
        assert ids == theirs.encode(text, language_id="zh")
        assert cj & set(ids)
    one = ours.tokenizer.token_to_id("[cj_1]")
    assert one in ours.encode("妳", language_id="zh")
    assert one not in ours.encode("你", language_id="zh")
    bare_ours, bare_theirs = tok.MTLTokenizer(vocab[1]), jtok.MTLTokenizer(vocab[1])
    assert not bare_ours.cangjie_converter.word2cj
    ids = bare_ours.encode("你好", language_id="zh")
    assert ids == bare_theirs.encode("你好", language_id="zh") and not cj & set(ids)


@pytest.mark.parametrize("text", ["한국어", "가", "안녕하세요, 세계!", "abc 123", " 힣 "])
def test_korean_normalize_matches_jax(text):
    assert tok.korean_normalize(text) == jtok.korean_normalize(text)


def test_cangjie_converter_matches_jax(tmp_path):
    (tmp_path / "Cangjie5_TC.json").write_text(
        json.dumps(chip_smoke.CANGJIE_ENTRIES, ensure_ascii=False), encoding="utf-8")
    ours, theirs = tok.ChineseCangjieConverter(tmp_path), jtok.ChineseCangjieConverter(tmp_path)
    for text in ("你好世界", "妳", "中文 abc", "未知字"):
        assert ours(text) == theirs(text)
    assert ours("妳") == "[cj_o][cj_n][cj_f][cj_1][cj_.]"
    assert tok.ChineseCangjieConverter(tmp_path / "none")("你") == "你"


NORMALIZERS = {
    "ja": ("hiragana_normalize", "日本語です", {"pykakasi": types.SimpleNamespace(
        kakasi=lambda: types.SimpleNamespace(convert=lambda t: [
            {"orig": c, "hira": {"日": "に", "本": "ほん", "歯": "は"}.get(c, c)} for c in t]))}),
    "he": ("add_hebrew_diacritics", "שלום", {"dicta_onnx": types.SimpleNamespace(
        Dicta=lambda: types.SimpleNamespace(add_diacritics=lambda t: t.replace("שלום", "שָׁלוֹם")))}),
    "ru": ("add_russian_stress", "привет", {
        "russian_text_stresser": types.ModuleType("russian_text_stresser"),
        "russian_text_stresser.text_stresser": types.SimpleNamespace(
            RussianTextStresser=lambda: types.SimpleNamespace(
                stress_text=lambda t: t.replace("привет", "приве́т")))}),
}


@pytest.mark.parametrize("lang", sorted(NORMALIZERS))
def test_normalizer_fallback_and_stub_match_jax(lang, vocab, monkeypatch, caplog):
    """The optional package absent: the text passes through unchanged with a
    warning (its count not asserted: every call warns, as in JAX), and
    MTLTokenizer's ids equal JAX's. A stub package present: both packages'
    normalizer give the stub's output."""
    fn, text, stubs = NORMALIZERS[lang]
    for name in stubs:
        monkeypatch.setitem(sys.modules, name, None)          # ImportError
    with caplog.at_level(logging.WARNING):
        assert getattr(tok, fn)(text) == getattr(jtok, fn)(text) == text
    assert any("not available" in r.message for r in caplog.records)
    ids = tok.MTLTokenizer(vocab[0]).encode(text, language_id=lang)
    assert ids == jtok.MTLTokenizer(vocab[0]).encode(text, language_id=lang)
    for name, mod in stubs.items():
        monkeypatch.setitem(sys.modules, name, mod)
    ours = getattr(tok, fn)(text)
    assert ours == getattr(jtok, fn)(text) != text
    if lang == "ja":
        assert tok.hiragana_normalize("歯") == jtok.hiragana_normalize("歯") == " は"


# ---------------------------------------------------------------------------
# config and T3
# ---------------------------------------------------------------------------

def test_multilingual_config_matches_jax():
    ours, theirs = T3Config.multilingual(), JT3Config.multilingual()
    for f in ours.__dataclass_fields__:
        assert getattr(ours, f) == getattr(theirs, f), f
    assert set(ours.__dataclass_fields__) == set(theirs.__dataclass_fields__)
    assert ours.is_multilingual and not T3Config.english_only().is_multilingual
    assert ours.backbone == T3Config.english_only().backbone
    assert t3m.t3_init(ours, device="meta")["text_emb"]["w"].shape == (2454, 1024)


def test_teacher_forced_cfg_logits_with_2454_text_ids(mtl_pipelines, monkeypatch):
    """test_torch_t3_llama's teacher-forced CFG decode (batch 2, the BOS fed
    twice) on the pipelines' tiny multilingual T3, float32, with framed text
    ids up to 2453: within 3e-4 of the logits' scale (summation order and
    the bf16 cache)."""
    qp, tp = mtl_pipelines[0].t3_params, mtl_pipelines[1].t3_params
    monkeypatch.setattr(T3L, "JHP", JHP)
    monkeypatch.setattr(T3L, "HP", HP)
    monkeypatch.setattr(T3L, "TEXT", np.array([[255, 2453, 704, 1500, 17, 2000, 0]]))
    jcond, tcond = T3L._cond(np.random.default_rng(3))
    ref = T3L._jax_cfg_teacher_forced(qp, jcond)
    out = T3L._port_cfg_teacher_forced(tp, tcond)
    assert out.shape == ref.shape == (len(T3L.FORCED), 2, 6564)
    np.testing.assert_allclose(out, ref, rtol=0, atol=3e-4 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

P_MTL, N_MTL = 16, 20      # prompt and generated tokens of the pipeline tests


class _MTok:
    """Stand-in for MTLTokenizer: a language tag id, then ids from the
    text's bytes, all below the 2454-row text embedding."""

    def text_to_tokens(self, text, language_id=None):
        ids = (np.frombuffer(text.encode(), np.uint8).astype(np.int32) * 7) % 2400 + 50
        tag = [] if language_id is None else [LANGS.index(language_id) + 1]
        return np.concatenate([tag, ids]).astype(np.int32)[None]


def _mtl_pipelines():
    qp = jt3m.t3_init(jax.random.key(0), JHP)
    # zero the special and out-of-vocab columns of the bias-free speech head:
    # greedy decoding stays on ordinary speech tokens (no EOS)
    qp["speech_head"]["w"] = qp["speech_head"]["w"].at[:, 6561:].set(0)
    k1, k2 = jax.random.split(jax.random.key(1))
    dims, jdims = FlowDims.tiny_test(), jflow.FlowDims.tiny_test()
    sp = {"flow": jflow.flow_init(k1, meanflow=False, dims=jdims),
          "mel2wav": jhift.hift_init(k2, base_channels=32)}
    jeng = JEngine(sp, meanflow=False, dims=jdims)
    jeng.pcm16_fetch = False
    rng = np.random.default_rng(3)
    t3 = (rng.standard_normal((1, 256)).astype(np.float32),
          rng.integers(0, 6561, (1, 8)).astype(np.int32))
    gen = (rng.integers(0, 6561, (1, P_MTL)).astype(np.int32), np.array([P_MTL], np.int32),
           (rng.standard_normal((1, 2 * P_MTL, 80)) * 0.5).astype(np.float32),
           rng.standard_normal((1, 192)).astype(np.float32))
    jtts = JMTL(qp, JHP, jeng, None, _MTok(), JConds(JT3Cond(*t3, 0.5), JRefDict(*gen)), seed=7)
    tts = port.ChatterboxMultilingualTTS(
        t3_from_jax(jax.tree.map(np.asarray, qp), HP, device="cpu"), HP,
        S3GenEngine(s3gen_from_jax(jax.tree.map(np.asarray, sp), dims=dims, hift_base=32,
                                   meanflow=False, device="cpu"), dims=dims, meanflow=False),
        None, _MTok(), port.Conditionals(port.T3CondHost(*t3, 0.5), port.RefDict(*gen)), seed=7)
    return jtts, tts


@pytest.fixture(scope="module")
def mtl_pipelines():
    return _mtl_pipelines()


@pytest.mark.parametrize("cfg_weight", [0.5, 0.0])
def test_generate_matches_jax_pipeline(mtl_pipelines, cfg_weight, monkeypatch):
    """Greedy (min_p = 1) in French: N_MTL tokens decoded at batch 2 (at
    cfg_weight 0 too: the port's t3_generate is called with cfg_batch2),
    the last token's 40 ms trimmed after the watermark, the waveform within
    1e-5 of JAX's (float32; the JAX vocoder's buckets pinned to the exact
    lengths and its noise handed to the port)."""
    from tests.test_torch_s3gen import jax_vocode_noise
    monkeypatch.setattr(jmodel, "TOKEN_BUCKETS", (P_MTL + N_MTL,))
    monkeypatch.setattr(jmodel, "GEN_MEL_BUCKETS", (2 * N_MTL,))
    jtts, tts = mtl_pipelines
    jtts.set_seed(7)
    kw = dict(language_id="fr", min_p=1.0, max_new_tokens=N_MTL, exaggeration=0.6,
              cfg_weight=cfg_weight)
    ref = jtts.generate("Bonjour à tous, ça va?", **kw)
    key = jax.random.key(7)
    key, _ = jax.random.split(key)
    _, k_voc = jax.random.split(key)
    noise = jax_vocode_noise(k_voc, 2 * (P_MTL + N_MTL), 2 * N_MTL, meanflow=False)
    monkeypatch.setattr(tts.s3gen, "draw_noise", lambda n_mel, n_gen_mel, generator: noise)
    batch2 = []
    generate = pipelines.t3_generate
    monkeypatch.setattr(pipelines, "t3_generate", lambda *a, **k: (
        batch2.append(k["cfg_batch2"]), generate(*a, **k))[1])
    out = tts.generate("Bonjour à tous, ça va?", **kw)
    assert batch2 == [True]
    assert tts.last_decode.n_forward == N_MTL - 1 and int(tts.last_decode.n_tokens) == N_MTL
    assert tts.conds.t3.emotion_adv == 0.6
    assert out.shape == ref.shape == (1, (N_MTL - 1) * 960)
    assert out.dtype == np.float32 and np.abs(out).max() > 1e-3
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


class _IdentityWM:
    def apply_watermark(self, wav, sample_rate=None, offset=0):
        return np.asarray(wav, np.float32)


def test_generate_stream_matches_generate_with_trim(mtl_pipelines, monkeypatch):
    """Greedy, the same numbers through the engine's draw_noise: the
    stream's samples are generate's, 40 ms trim included (held back until
    the stream ends), and the audio within 2e-2 (the growing-window flow
    re-estimates earlier frames; the watermark stubbed, as the JAX test
    of this does)."""
    _, tts = mtl_pipelines
    monkeypatch.setattr(tts, "watermarker", _IdentityWM())
    monkeypatch.setattr(tts.s3gen, "draw_noise", chip_smoke.StreamDraws(8, 64, "cpu"))
    kw = dict(language_id="fr", min_p=1.0, max_new_tokens=12)
    full = tts.generate("Salut toi.", **kw)[0]
    chunks = list(tts.generate_stream("Salut toi.", chunk_tokens=5, **kw))
    assert len(chunks) >= 2 and all(c.dtype == np.float32 for c in chunks)
    total = np.concatenate(chunks)
    assert total.shape == full.shape == (11 * 960,)
    np.testing.assert_allclose(total, full, rtol=0, atol=2e-2)


def test_unknown_language_raises(mtl_pipelines):
    _, tts = mtl_pipelines
    for call in (tts.generate, lambda *a, **k: list(tts.generate_stream(*a, **k))):
        with pytest.raises(ValueError, match="Unsupported language_id 'xx'"):
            call("x", language_id="xx")
    with pytest.raises(ValueError, match="Supported languages: ar, da"):
        tts.generate("x", language_id="Klingon")
    tts.generate("x", language_id="FR", min_p=1.0, max_new_tokens=2)    # case-insensitive


# ---------------------------------------------------------------------------
# load_mtl_tts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext,t3_model,t3_file", [
    ("safetensors", None, "t3_mtl23ls_v2.safetensors"),
    ("pt", "v3", "t3_mtl23ls_v3.safetensors")])
def test_load_mtl_tts_matches_jax(tmp_path, ext, t3_model, t3_file):
    """A tiny checkpoint directory (only the T3 file the name resolves to;
    ve and s3gen as .pt or .safetensors; the grapheme vocabulary with its
    Cangjie mapping; conds.pt) through both packages' from_local: the port's
    trees are the written ones bit for bit, as are JAX's carried across;
    the tokenizers and voices agree."""
    t3 = t3m.t3_init(HP, seed=1, device="cpu")
    s3 = s3m.s3gen_init(2, "cpu", meanflow=False, dims=FlowDims.tiny_test(), hift_base=32,
                        tok_cfg=S3TokenizerConfig.tiny_test())
    s3["speaker_encoder"] = chip_smoke.seeded_batch_stats(s3["speaker_encoder"], 3)
    ve = ve_init(nn.Init(4, "cpu"))
    chip_smoke.write_mtl_checkpoint(tmp_path, t3, HP, s3, ve, pt=ext == "pt", t3_file=t3_file)
    rng = np.random.default_rng(5)
    port.Conditionals(
        port.T3CondHost(rng.standard_normal((1, 256)).astype(np.float32),
                        rng.integers(0, 6561, (1, 8)).astype(np.int32), 0.5),
        port.RefDict(rng.integers(0, 6561, (1, 10)).astype(np.int32), np.array([10], np.int32),
                     rng.standard_normal((1, 20, 80)).astype(np.float32),
                     rng.standard_normal((1, 192)).astype(np.float32))
    ).save(str(tmp_path / "conds.pt"))
    assert sorted(f.suffix for f in tmp_path.iterdir()).count(f".{ext}") >= 2
    with tiny_sizes(dict(kw=HP_KW, preset="multilingual")):
        jtts = JMTL.from_local(tmp_path, t3_model=t3_model)
        tts = port.ChatterboxMultilingualTTS.from_local(tmp_path, device="cpu",
                                                        t3_model=t3_model)
    assert type(tts) is port.ChatterboxMultilingualTTS and tts.hp.is_multilingual
    assert not tts.s3gen.meanflow and tts.device.type == "cpu"
    assert_trees_equal(tts.t3_params, t3)
    assert_trees_equal(tts.ve_params, ve)
    assert_trees_equal(tts.s3gen.params, s3)
    assert_trees_equal(t3_from_jax(jax.tree.map(np.asarray, jtts.t3_params), HP,
                                   device="cpu"), t3)
    assert_trees_equal(ve_from_jax(jax.tree.map(np.asarray, jtts.ve_params), device="cpu"), ve)
    assert_trees_equal(s3gen_from_jax(
        jax.tree.map(np.asarray, jtts.s3gen.params), dims=FlowDims.tiny_test(), hift_base=32,
        meanflow=False, tok_cfg=S3TokenizerConfig.tiny_test(), device="cpu"), s3)
    for lang in ("ko", "zh", "fr"):
        text = chip_smoke.MTL_SAMPLES[lang]
        np.testing.assert_array_equal(tts.tokenizer.text_to_tokens(text, language_id=lang),
                                      jtts.tokenizer.text_to_tokens(text, language_id=lang))
    for a, b in zip(tts.conds.gen, jtts.conds.gen):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tts.conds.t3.speaker_emb, jtts.conds.t3.speaker_emb)
    assert tts.conds.t3.emotion_adv == jtts.conds.t3.emotion_adv == 0.5
