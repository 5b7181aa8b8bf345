"""The slice end to end at a tiny size: a checkpoint directory in the
reference's layout (chip_smoke.py's writer, a BPE trained here) loaded by
chatterbox_tpu's `from_local` and the port's `from_local(device="cpu")`,
for Turbo (GPT2_fused_test T3, meanflow S3Gen, GPT-2 wrapper tokenizer,
conds.pt) and the 520M family (Llama_fused_test T3 with perceiver, CFG
S3Gen, EnTokenizer, no conds.pt); then `prepare_conditionals` on the same
6 s WAV in both, teacher-forced T3 logits through the loaded weights on
those conditionals, and the port's `generate(audio_prompt_path=...)`.

The JAX loaders build their models at the reference's sizes; the tests
shrink them by patching the sizes they read (T3Config's presets,
s3gen_init's and S3GenEngine's defaults) in both packages alike."""
import contextlib
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from chatterbox_tpu.api.pipelines import ChatterboxTTS as JCfgTTS  # noqa: E402
from chatterbox_tpu.api.pipelines import ChatterboxTurboTTS as JTTS  # noqa: E402
from chatterbox_tpu.models.s3gen import model as jmodel  # noqa: E402
from chatterbox_tpu.models.s3gen.flow import FlowDims as JFlowDims  # noqa: E402
from chatterbox_tpu.models.s3tok.model import S3TokenizerConfig as JTokCfg  # noqa: E402
from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.models.t3.config import T3Config as JT3Config  # noqa: E402

import chatterbox_tpu_torch as port  # noqa: E402
from chatterbox_tpu_torch.convert.from_jax import (s3gen_from_jax, t3_from_jax,  # noqa: E402
                                                   ve_from_jax)
from chatterbox_tpu_torch.models.s3gen import model as s3m  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.flow import FlowDims  # noqa: E402
from chatterbox_tpu_torch.models.s3tok.model import S3TokenizerConfig  # noqa: E402
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.models.t3.config import T3Config  # noqa: E402
from chatterbox_tpu_torch.models.ve.model import ve_init  # noqa: E402
from chatterbox_tpu_torch.nn import core as nn  # noqa: E402
from chatterbox_tpu_torch.utils.audio_io import save_wav  # noqa: E402
from tests import test_torch_t3 as T3T  # noqa: E402
from tests import test_torch_t3_llama as T3L  # noqa: E402
from tests.test_torch_convert import assert_trees_equal, few_threads  # noqa: E402,F401
from tests.test_torch_pipeline import _Tok  # noqa: E402
from tests.test_torch_text import train_en_bpe  # noqa: E402

FAMILIES = {
    # the Turbo T3 of test_torch_t3 (teacher-forced helpers reused)
    "turbo": dict(kw=T3T.HP_KW, preset="turbo", meanflow=True, jcls=JTTS,
                  cls=port.ChatterboxTurboTTS, t3_file="t3_turbo_v1.safetensors",
                  s3_file="s3gen_meanflow.safetensors"),
    # test_torch_t3_llama's T3 with a start-of-text id inside its 64-id
    # vocabulary (the teacher-forced helpers frame their text themselves)
    "english": dict(kw=dict(T3L.HP_KW, start_text_token=61), preset="english_only",
                    meanflow=False, jcls=JCfgTTS, cls=port.ChatterboxTTS,
                    t3_file="t3_cfg.safetensors", s3_file="s3gen.safetensors"),
}
TEXT = "hello world this is a test"



@contextlib.contextmanager
def tiny_sizes(fam):
    """Both packages' loaders at the test sizes."""
    kw = fam["kw"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT3Config, fam["preset"], classmethod(lambda cls: cls(**kw)))
        mp.setattr(T3Config, fam["preset"], classmethod(lambda cls: cls(**kw)))
        jsz = dict(tok_cfg=JTokCfg.tiny_test(), dims=JFlowDims.tiny_test())
        mp.setattr(jmodel, "s3gen_init", functools.partial(jmodel.s3gen_init, hift_base=32,
                                                           **jsz))
        mp.setattr(jmodel, "S3GenEngine", functools.partial(jmodel.S3GenEngine, **jsz))
        sz = dict(tok_cfg=S3TokenizerConfig.tiny_test(), dims=FlowDims.tiny_test())
        mp.setattr(s3m, "s3gen_init", functools.partial(s3m.s3gen_init, hift_base=32, **sz))
        mp.setattr(s3m, "S3GenEngine", functools.partial(s3m.S3GenEngine, **sz))
        yield


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def loaded(request, tmp_path_factory):
    """(family, written trees, the JAX pipeline, the port's, the prompt WAV)."""
    name = request.param
    fam = FAMILIES[name]
    hp = T3Config(**fam["kw"])
    d = tmp_path_factory.mktemp(name)
    t3 = t3m.t3_init(hp, seed=1, device="cpu")
    s3 = s3m.s3gen_init(2, "cpu", meanflow=fam["meanflow"], dims=FlowDims.tiny_test(),
                        hift_base=32, tok_cfg=S3TokenizerConfig.tiny_test())
    # CAMPPlus with seeded batch statistics (an x-vector of order 1)
    s3["speaker_encoder"] = chip_smoke.seeded_batch_stats(s3["speaker_encoder"], 3)
    ve = ve_init(nn.Init(4, "cpu"))
    chip_smoke.write_checkpoint(d, fam["t3_file"], fam["s3_file"], t3, hp, s3, ve)
    if name == "turbo":
        chip_smoke.write_turbo_tokenizer(d, 60, [TEXT * 3, "a quick brown fox"])
        rng = np.random.default_rng(5)
        port.Conditionals(
            port.T3CondHost(rng.standard_normal((1, 256)).astype(np.float32),
                            rng.integers(0, 6561, (1, 8)).astype(np.int32), 0.0),
            port.RefDict(rng.integers(0, 6561, (1, 10)).astype(np.int32),
                         np.array([10], np.int32),
                         rng.standard_normal((1, 20, 80)).astype(np.float32),
                         rng.standard_normal((1, 192)).astype(np.float32))
        ).save(str(d / "conds.pt"))
    else:
        train_en_bpe(d / "tokenizer.json", vocab_size=60)
    wav = d / "prompt.wav"
    save_wav(wav, 0.5 * chip_smoke.synthetic_voice(6.0, 24000, seed=6), 24000)
    with tiny_sizes(fam):
        jtts = fam["jcls"].from_local(d)
        tts = fam["cls"].from_local(d, device="cpu")
    return name, (t3, s3, ve), jtts, tts, str(wav)


def test_from_local_loads_the_written_trees(loaded):
    name, (t3, s3, ve), jtts, tts = loaded[:4]
    assert tts.t3_params["speech_emb"]["w"].device.type == "cpu"
    assert_trees_equal(tts.t3_params, t3)
    assert_trees_equal(tts.ve_params, ve)
    assert_trees_equal(tts.s3gen.params, s3)
    # the JAX loader's trees, carried across, are the same bit for bit
    hp = T3Config(**FAMILIES[name]["kw"])
    assert_trees_equal(t3_from_jax(jax.tree.map(np.asarray, jtts.t3_params), hp,
                                   device="cpu"), t3)
    assert_trees_equal(ve_from_jax(jax.tree.map(np.asarray, jtts.ve_params), device="cpu"), ve)
    assert_trees_equal(s3gen_from_jax(
        jax.tree.map(np.asarray, jtts.s3gen.params), dims=FlowDims.tiny_test(), hift_base=32,
        meanflow=FAMILIES[name]["meanflow"], tok_cfg=S3TokenizerConfig.tiny_test(),
        device="cpu"), s3)
    assert tts.s3gen.meanflow == FAMILIES[name]["meanflow"]
    assert type(tts) is FAMILIES[name]["cls"]
    # conds.pt is optional, as in the JAX loaders
    if name == "turbo":
        for a, b in zip(tts.conds.gen, jtts.conds.gen):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(tts.conds.t3.speaker_emb, jtts.conds.t3.speaker_emb)
    else:
        assert tts.conds is None and jtts.conds is None


def test_tokenizers_match_jax(loaded):
    _, _, jtts, tts = loaded[:4]
    for text in (TEXT, "A quick brown fox!", "unknown zz words"):
        ours, theirs = tts.tokenizer.text_to_tokens(text), jtts.tokenizer.text_to_tokens(text)
        assert ours.dtype == np.int32 and ours.shape[0] == 1
        np.testing.assert_array_equal(ours, theirs)
        assert ours.max() < 60


_CONDS = {}


def conditionals(loaded):
    """prepare_conditionals on the prompt WAV in both pipelines (once)."""
    name, _, jtts, tts, wav = loaded
    if name not in _CONDS:
        jtts.prepare_conditionals(wav, exaggeration=0.7)
        tts.prepare_conditionals(wav, exaggeration=0.7)
        _CONDS[name] = jtts.conds, tts.conds
    return _CONDS[name]


def test_prepare_conditionals_matches_jax(loaded):
    """S3 tokens exact; the voice-encoder and CAMPPlus embeddings and the
    prompt mels to 1e-4 (Turbo's prompt brought to -27 LUFS first in both)."""
    ref, out = conditionals(loaded)
    assert out.t3.emotion_adv == ref.t3.emotion_adv == 0.7
    assert out.t3.speaker_emb.shape == (1, 256)
    np.testing.assert_allclose(out.t3.speaker_emb, ref.t3.speaker_emb, rtol=0, atol=1e-4)
    assert out.t3.cond_prompt_speech_tokens.shape == (1, 8)
    np.testing.assert_array_equal(out.t3.cond_prompt_speech_tokens,
                                  ref.t3.cond_prompt_speech_tokens)
    assert out.gen.prompt_token.shape == (1, 150)
    np.testing.assert_array_equal(out.gen.prompt_token, ref.gen.prompt_token)
    np.testing.assert_array_equal(out.gen.prompt_token_len, ref.gen.prompt_token_len)
    np.testing.assert_allclose(out.gen.prompt_feat, ref.gen.prompt_feat, rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.gen.embedding, ref.gen.embedding, rtol=0, atol=1e-4)


def test_teacher_forced_logits_through_loaded_weights(loaded):
    """The loaded float T3 on the conditionals each package built, through
    the teacher-forced decode of test_torch_t3(_llama); the bound those
    tests hold float weights to (3e-4 of the largest logit)."""
    name, _, jtts, tts, _ = loaded
    ref_c, out_c = conditionals(loaded)
    spk, tok = ref_c.t3.speaker_emb, ref_c.t3.cond_prompt_speech_tokens
    jcond = jt3m.T3CondArrays(jnp.asarray(spk), jnp.asarray(tok),
                              jnp.full((1, 1, 1), ref_c.t3.emotion_adv))
    tcond = out_c.t3.as_tensors("cpu")
    if name == "turbo":
        ref = T3T._jax_teacher_forced(jtts.t3_params, jcond)
        out = T3T._port_teacher_forced(tts.t3_params, tcond)
    else:
        ref = T3L._jax_cfg_teacher_forced(jtts.t3_params, jcond)
        out = T3L._port_cfg_teacher_forced(tts.t3_params, tcond)
    assert out.shape == ref.shape and np.isfinite(out).all()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=3e-4 * max(scale, 1.0))


def test_generate_from_audio_prompt(loaded):
    name, _, _, tts, wav = loaded
    tts.set_seed(0)
    out = tts.generate(TEXT, audio_prompt_path=wav, max_new_tokens=6)
    assert out.ndim == 2 and out.shape[0] == 1 and out.dtype == np.float32
    assert np.isfinite(out).all()
    assert tts.conds.gen.prompt_token.shape == (1, 150)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_random_init_builds_the_frontend(tmp_path, name):
    """random_init draws the frontend's weights too (the S3 tokenizer and
    CAMPPlus inside S3Gen, the voice encoder), as the JAX one does, so a
    prompt file works on random weights."""
    fam = FAMILIES[name]
    tts = fam["cls"].random_init(hp=T3Config(**fam["kw"]), flow_dims=FlowDims.tiny_test(),
                                 tok_cfg=S3TokenizerConfig.tiny_test(), hift_base=32,
                                 tokenizer=_Tok(), device="cpu")
    assert set(tts.s3gen.params) == {"flow", "mel2wav", "tokenizer", "speaker_encoder"}
    assert set(tts.ve_params) == {"lstm", "proj", "similarity_weight", "similarity_bias"}
    wav = tmp_path / "prompt.wav"
    save_wav(wav, 0.5 * chip_smoke.synthetic_voice(5.5, 24000, seed=7), 24000)
    out = tts.generate(TEXT, audio_prompt_path=str(wav), max_new_tokens=4)
    assert out.ndim == 2 and np.isfinite(out).all()
    assert tts.conds.t3.cond_prompt_speech_tokens.shape == (1, 8)
