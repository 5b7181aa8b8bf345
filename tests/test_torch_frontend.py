"""The port's conditioning frontend (chatterbox_tpu_torch: audio/, the S3
tokenizer, CAMPPlus, the voice encoder, S3GenEngine.embed_ref / tokenize,
utils/loudness.py and utils/audio_io.py) held against chatterbox_tpu on the
JAX CPU backend, on the same seeded waveforms (harmonics plus noise), in
float32. CAMPPlus and the voice encoder run at their real widths, the S3
tokenizer at S3TokenizerConfig.tiny_test(); the batch norms get seeded
statistics, so the x-vector is of order 1."""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from chatterbox_tpu.models.s3gen import campplus as jcamp  # noqa: E402
from chatterbox_tpu.models.s3gen import model as jmodel  # noqa: E402
from chatterbox_tpu.models.s3tok.model import S3TokenizerConfig as JTokCfg  # noqa: E402
from chatterbox_tpu.models.s3gen.flow import FlowDims as JFlowDims  # noqa: E402
from chatterbox_tpu.models.ve import model as jve  # noqa: E402
from chatterbox_tpu.utils import audio_io as jio  # noqa: E402
from chatterbox_tpu.utils import loudness as jloud  # noqa: E402

from chatterbox_tpu_torch.audio import mels  # noqa: E402
from chatterbox_tpu_torch.audio.resample import resample  # noqa: E402
from chatterbox_tpu_torch.convert.from_jax import (_convert, s3gen_from_jax,  # noqa: E402
                                                   ve_from_jax)
from chatterbox_tpu_torch.models.s3gen import campplus  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.flow import FlowDims  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.model import S3GenEngine  # noqa: E402
from chatterbox_tpu_torch.models.s3tok.model import S3TokenizerConfig  # noqa: E402
from chatterbox_tpu_torch.models.ve import model as ve  # noqa: E402
from chatterbox_tpu_torch.utils import audio_io, loudness  # noqa: E402

from chip_smoke import seeded_batch_stats as with_batch_stats  # noqa: E402
from chip_smoke import synthetic_voice as voice  # noqa: E402
from tests.test_torch_convert import few_threads  # noqa: E402,F401

jmels = importlib.import_module("chatterbox_tpu.audio.mels")
jresample = importlib.import_module("chatterbox_tpu.audio.resample")


# ---------------------------------------------------------------------------
# resampler and features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("orig,new", [(24000, 16000), (16000, 24000), (44100, 24000)])
def test_resample_matches_jax(orig, new):
    wav = voice(1.3, orig, seed=1)
    ref = np.asarray(jresample.resample(jnp.asarray(wav), orig, new))
    out = resample(torch.from_numpy(wav), orig, new).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,sr", [("mel_spectrogram_24k", 24000),
                                     ("log_mel_spectrogram_s3tok", 16000),
                                     ("melspectrogram_ve", 16000),
                                     ("kaldi_fbank_80", 16000)])
def test_features_match_jax(name, sr):
    wav = voice(1.5, sr, seed=2)[None]
    ref = np.asarray(getattr(jmels, name)(jnp.asarray(wav)))
    out = getattr(mels, name)(torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# CAMPPlus and the voice encoder
# ---------------------------------------------------------------------------

_CAMP = {}


def camp_params():
    if not _CAMP:
        jp = with_batch_stats(jax.tree.map(np.asarray, jcamp.campplus_init(jax.random.key(3))), 4)
        _CAMP["j"], _CAMP["t"] = jp, _convert(jp, "cpu")
    return _CAMP["j"], _CAMP["t"]


def test_campplus_xvector_matches_jax():
    jp, tp = camp_params()
    wav = voice(2.3, 16000, seed=5)
    ref = np.asarray(jax.jit(jcamp.campplus_embed_wav)(jp, jnp.asarray(wav)[None]))
    out = campplus.campplus_embed_wav(tp, torch.from_numpy(wav)[None])
    assert out.shape == ref.shape == (1, 192) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_campplus_padded_xvector_matches_jax():
    """A row zero-padded to the next 0.5 s with its valid length, through
    the JAX engine's own masked program (the one its embed_ref runs, at
    test_embed_ref_matches_jax's length): the port's masked variant and its
    exact-length x-vector both give that vector."""
    jeng, eng = engines()
    wav = resample(torch.from_numpy(voice(6.01, 24000, seed=11)), 24000, 16000).numpy()
    n = len(wav)
    padded = np.pad(wav, (0, 8000 - n % 8000))
    ref = np.asarray(jeng._xvector(jeng.params, jnp.asarray(padded)[None],
                                   jnp.asarray([n], jnp.int32)))
    params = eng.params["speaker_encoder"]
    out = campplus.campplus_embed_wav(params, torch.from_numpy(padded)[None], torch.tensor([n]))
    exact = campplus.campplus_embed_wav(params, torch.from_numpy(wav)[None])
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(exact.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("sr", [16000, 24000])
def test_voice_encoder_embedding_matches_jax(sr):
    jp = jax.tree.map(np.asarray, jve.ve_init(jax.random.key(6)))
    tp = ve_from_jax(jp, device="cpu")
    wavs = [voice(2.7, sr, seed=7), voice(1.2, sr, seed=8, f0=210.0)]
    ref = jve.embeds_from_wavs(jp, wavs, sample_rate=sr)
    out = ve.embeds_from_wavs(tp, wavs, sample_rate=sr)
    assert out.shape == ref.shape == (2, 256)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ve.embeds_from_wavs(tp, wavs, sr, as_spk=True),
                               jve.embeds_from_wavs(jp, wavs, sr, as_spk=True),
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# S3GenEngine.embed_ref and tokenize (the S3 tokenizer at tiny_test width)
# ---------------------------------------------------------------------------

_ENGINES = {}


def engines():
    """The JAX and the port's meanflow engines on the same tiny weights
    (CAMPPlus at full width with seeded batch statistics)."""
    if not _ENGINES:
        jtok, jdims = JTokCfg.tiny_test(), JFlowDims.tiny_test()
        jp = jax.tree.map(np.asarray, jmodel.s3gen_init(
            jax.random.key(9), meanflow=True, tok_cfg=jtok, dims=jdims, hift_base=32))
        jp["speaker_encoder"] = with_batch_stats(jp["speaker_encoder"], 10)
        tp = s3gen_from_jax(jp, dims=FlowDims.tiny_test(), hift_base=32,
                            tok_cfg=S3TokenizerConfig.tiny_test(), device="cpu")
        _ENGINES["j"] = jmodel.S3GenEngine(jp, meanflow=True, tok_cfg=jtok, dims=jdims)
        _ENGINES["t"] = S3GenEngine(tp, dims=FlowDims.tiny_test(),
                                    tok_cfg=S3TokenizerConfig.tiny_test())
    return _ENGINES["j"], _ENGINES["t"]


def test_embed_ref_matches_jax():
    """Tokens exact; prompt mels and the x-vector to 1e-4. The JAX engine
    pads CAMPPlus's input to a 0.5 s bucket under a mask, the port runs the
    exact length. The prompt's length is no whole number of tokens, so the
    mel == 2 * token repair runs."""
    jeng, eng = engines()
    wav = voice(6.01, 24000, seed=11)
    ref = jeng.embed_ref(wav, 24000)
    out = eng.embed_ref(wav, 24000)
    assert out.prompt_token.shape == ref.prompt_token.shape == (1, 151)
    assert out.prompt_token.dtype == np.int32
    np.testing.assert_array_equal(out.prompt_token, ref.prompt_token)
    np.testing.assert_array_equal(out.prompt_token_len, ref.prompt_token_len)
    assert out.prompt_feat.shape == ref.prompt_feat.shape == (1, 302, 80)
    np.testing.assert_allclose(out.prompt_feat, ref.prompt_feat, rtol=0, atol=1e-4)
    assert np.abs(ref.embedding).max() > 0.1
    np.testing.assert_allclose(out.embedding, ref.embedding, rtol=0, atol=1e-4)


@pytest.mark.parametrize("max_len", [None, 40])
def test_tokenize_matches_jax(max_len):
    jeng, eng = engines()
    wav = voice(2.05, 16000, seed=12)
    ref_tok, ref_len = jeng.tokenize(wav, max_len=max_len)
    out_tok, out_len = eng.tokenize(wav, max_len=max_len)
    assert out_tok.shape == ref_tok.shape
    assert out_tok.shape[1] == (52 if max_len is None else 40)
    np.testing.assert_array_equal(out_tok, ref_tok)
    np.testing.assert_array_equal(out_len, ref_len)


# ---------------------------------------------------------------------------
# loudness and WAV files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["voice", "loud", "short", "silent"])
def test_norm_loudness_matches_jax(case):
    wav = {"voice": voice(3.0, 24000, seed=13), "loud": 3 * voice(2.0, 24000, seed=14),
           "short": voice(0.3, 24000, seed=15),
           "silent": np.zeros(24000, np.float32)}[case]
    ref = jloud.norm_loudness(wav, 24000, -27.0)
    out = loudness.norm_loudness(wav, 24000, -27.0)
    assert out.dtype == ref.dtype
    if case == "silent":
        np.testing.assert_array_equal(out, wav)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    assert loudness.integrated_loudness(wav, 24000) == jloud.integrated_loudness(wav, 24000)


@pytest.mark.parametrize("kind", ["pcm16", "int32", "float32", "stereo16", "resampled"])
def test_load_audio_matches_jax(tmp_path, kind):
    """WAVs written by scipy, read by both packages. The JAX package reads
    them through its native reader (built from runtime/wavio.cpp here),
    whose scaling and downmix the port's scipy reader reproduces."""
    from scipy.io import wavfile
    from chatterbox_tpu.runtime import get_lib
    assert get_lib() is not None
    wav = voice(0.8, 16000, seed=16)
    data = {"pcm16": (wav * 32767).astype(np.int16),
            "int32": (wav.astype(np.float64) * 2**31 * 0.9).astype(np.int32),
            "float32": wav, "resampled": (wav * 32767).astype(np.int16),
            "stereo16": np.stack([(wav * 32767).astype(np.int16),
                                  (wav[::-1] * 20000).astype(np.int16)], axis=1)}[kind]
    path = tmp_path / f"{kind}.wav"
    wavfile.write(path, 16000, data)
    target = 24000 if kind == "resampled" else 16000
    ref = jio.load_audio(str(path), target)
    out = audio_io.load_audio(path, target)
    assert out.dtype == ref.dtype == np.float32 and np.abs(out).max() <= 1.0
    np.testing.assert_array_equal(out, ref)


def test_save_wav_reads_back_in_jax(tmp_path):
    wav = 1.5 * voice(0.5, 24000, seed=17)
    audio_io.save_wav(tmp_path / "out.wav", wav, 24000)
    np.testing.assert_array_equal(jio.load_audio(str(tmp_path / "out.wav"), 24000),
                                  np.clip(wav, -1.0, 1.0))
