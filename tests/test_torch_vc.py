"""The port's voice conversion (api/pipelines.py `ChatterboxVC`,
convert/weights.py `load_vc`) on the CPU against chatterbox_tpu's, at small
widths: a 10-step CFG S3Gen (the 520M family's, which both packages' VC
uses) with the tiny S3 tokenizer and CAMPPlus; `generate` on the same
source audio and target voice with JAX's noise handed to the port, its
buckets pinned to every length; `load_vc` from a checkpoint directory
written here (chip_smoke.py's writer), through both packages, bit for bit;
and the knobs of VC's methods against the JAX methods'."""
import contextlib
import functools
import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from chatterbox_tpu.api import pipelines as jpipelines  # noqa: E402
from chatterbox_tpu.models.s3gen import model as jmodel  # noqa: E402
from chatterbox_tpu.models.s3gen.flow import FlowDims as JFlowDims  # noqa: E402
from chatterbox_tpu.models.s3tok.model import S3TokenizerConfig as JTokCfg  # noqa: E402

import chatterbox_tpu_torch as port  # noqa: E402
from chatterbox_tpu_torch.convert.from_jax import s3gen_from_jax  # noqa: E402
from chatterbox_tpu_torch.convert.native_ckpt import save_safetensors  # noqa: E402
from chatterbox_tpu_torch.models.s3gen import model as s3m  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.flow import FlowDims  # noqa: E402
from chatterbox_tpu_torch.models.s3tok.model import S3TokenizerConfig  # noqa: E402
from chatterbox_tpu_torch.utils.audio_io import save_wav  # noqa: E402
from tests.test_torch_convert import assert_trees_equal, few_threads  # noqa: E402,F401
from tests.test_torch_s3gen import jax_vocode_noise  # noqa: E402
from tests.test_torch_streaming import _refs, pin_buckets  # noqa: E402

SIZES = dict(dims=FlowDims.tiny_test(), tok_cfg=S3TokenizerConfig.tiny_test())
JSIZES = dict(dims=JFlowDims.tiny_test(), tok_cfg=JTokCfg.tiny_test())


@pytest.fixture(scope="module")
def vcs():
    """(JAX's ChatterboxVC, the port's) on one random CFG S3Gen with its
    frontend, CAMPPlus with seeded batch statistics, and one target voice."""
    tree = jmodel.s3gen_init(jax.random.key(81), meanflow=False, hift_base=32, **JSIZES)
    tree = chip_smoke.seeded_batch_stats(jax.tree.map(np.asarray, tree), 82)
    jeng = jmodel.S3GenEngine(jax.tree.map(jax.numpy.asarray, tree), meanflow=False,
                              **JSIZES)
    jeng.pcm16_fetch = False
    eng = s3m.S3GenEngine(s3gen_from_jax(tree, hift_base=32, meanflow=False, device="cpu",
                                         **SIZES), meanflow=False, **SIZES)
    jref, ref = _refs(83)
    return (jpipelines.ChatterboxVC(jeng, ref_dict=jref),
            port.ChatterboxVC(eng, ref_dict=ref))


def _source(seconds=1.6, sr=16000):
    return 0.5 * chip_smoke.synthetic_voice(seconds, sr, seed=84, f0=120.0)


def test_vc_generate_matches_jax(vcs, monkeypatch):
    """The S3 tokens of the source equal JAX's; the converted audio (10
    CFG flow steps, HiFT, trim-fade, watermark) is JAX's within 1e-5 on
    JAX's draws."""
    pin_buckets(monkeypatch)
    jvc, vc = vcs
    src = _source()
    toks, n = vc.s3gen.tokenize(src)
    jtoks, jn = jvc.s3gen.tokenize(src)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    G, P = toks.shape[1], int(vc.ref_dict.prompt_token_len[0])
    assert G == 40 and int(n[0]) == int(jn[0]) == G
    jvc._key = jax.random.key(0)
    ref = jvc.generate(src)
    k = jax.random.split(jax.random.key(0))[1]          # JAX VC's first key
    monkeypatch.setattr(vc.s3gen, "draw_noise", lambda n_mel, n_gen_mel, generator:
                        jax_vocode_noise(k, n_mel, n_gen_mel, meanflow=False))
    out = vc.generate(src)
    assert 2 * (P + G) == 100
    assert out.shape == ref.shape == (1, G * 960) and out.dtype == np.float32
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_vc_target_voice_path(vcs, tmp_path):
    """generate(src_path, target_voice_path=) embeds the first 10 s of the
    target (set_target_voice) and reads the source at 16 kHz: the same as
    set_target_voice then generate(samples) under the same seed."""
    _, vc = vcs
    target, src = tmp_path / "target.wav", tmp_path / "src.wav"
    save_wav(target, 0.5 * chip_smoke.synthetic_voice(11.0, 24000, seed=85), 24000)
    save_wav(src, _source(), 16000)
    vc.set_seed(3)
    a = vc.generate(str(src), target_voice_path=str(target))
    ref = vc.ref_dict
    assert ref.prompt_feat.shape[1] == 2 * int(ref.prompt_token_len[0]) == 500  # 10 s
    vc.ref_dict = None
    with pytest.raises(ValueError, match="target"):
        vc.generate(_source())
    vc.set_target_voice(str(target))
    vc.set_seed(3)
    from chatterbox_tpu_torch.utils.audio_io import load_audio
    b = vc.generate(load_audio(str(src), 16000))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1, 40 * 960)


@contextlib.contextmanager
def tiny_s3gen(mp):
    """Both packages' S3Gen loaders at the test sizes (their loaders build
    at the reference's)."""
    mp.setattr(jmodel, "s3gen_init", functools.partial(jmodel.s3gen_init, hift_base=32,
                                                       **JSIZES))
    mp.setattr(jmodel, "S3GenEngine", functools.partial(jmodel.S3GenEngine, **JSIZES))
    mp.setattr(s3m, "s3gen_init", functools.partial(s3m.s3gen_init, hift_base=32, **SIZES))
    mp.setattr(s3m, "S3GenEngine", functools.partial(s3m.S3GenEngine, **SIZES))
    yield


@pytest.mark.parametrize("with_conds", [True, False])
def test_load_vc_bit_for_bit(tmp_path, monkeypatch, with_conds):
    """s3gen.safetensors written from a port tree (and conds.pt): both
    packages' load_vc read the same weights, bit for bit, into a CFM engine
    (meanflow=False, 10 steps), and the voice of conds.pt when present."""
    s3 = s3m.s3gen_init(86, "cpu", meanflow=False, hift_base=32, **SIZES)
    s3["speaker_encoder"] = chip_smoke.seeded_batch_stats(s3["speaker_encoder"], 87)
    save_safetensors(chip_smoke.s3gen_state_dict(s3), tmp_path / "s3gen.safetensors")
    if with_conds:
        _, ref = _refs(88)
        port.Conditionals(port.T3CondHost(np.zeros((1, 256), np.float32)),
                          ref).save(str(tmp_path / "conds.pt"))
    with tiny_s3gen(monkeypatch):
        jvc = jpipelines.ChatterboxVC.from_local(tmp_path)
        vc = port.ChatterboxVC.from_local(tmp_path, device="cpu")
    assert vc.s3gen.meanflow is False and vc.s3gen.n_timesteps == 10
    assert jvc.s3gen.meanflow is False and jvc.s3gen.n_timesteps == 10
    assert vc.s3gen.device.type == "cpu"
    assert_trees_equal(vc.s3gen.params, s3)
    assert_trees_equal(s3gen_from_jax(jax.tree.map(np.asarray, jvc.s3gen.params),
                                      hift_base=32, meanflow=False, device="cpu", **SIZES),
                       s3)
    if with_conds:
        for a, b, c in zip(vc.ref_dict, jvc.ref_dict, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
            np.testing.assert_array_equal(np.asarray(b), np.asarray(c))
    else:
        assert vc.ref_dict is None and jvc.ref_dict is None


def test_random_init_is_cfm():
    vc = port.ChatterboxVC.random_init(flow_dims=FlowDims.tiny_test(),
                                       tok_cfg=S3TokenizerConfig.tiny_test(), hift_base=32,
                                       device="cpu")
    assert vc.s3gen.meanflow is False and vc.s3gen.n_timesteps == 10
    # the CFM estimator has no meanflow time-step mixer
    assert_trees_equal(vc.s3gen.params["flow"]["decoder"],
                       s3m.s3gen_init(0, "cpu", meanflow=False, hift_base=32,
                                      **SIZES)["flow"]["decoder"])
    assert vc.ref_dict is None and vc.sr == 24000


@pytest.mark.parametrize("method", ["generate", "set_target_voice", "from_local"])
def test_vc_takes_only_the_jax_knobs(method):
    """Every knob of the port's ChatterboxVC method is one the JAX method
    has (from_local's `device` included)."""
    ours = set(inspect.signature(getattr(port.ChatterboxVC, method)).parameters)
    theirs = set(inspect.signature(getattr(jpipelines.ChatterboxVC, method)).parameters)
    assert ours <= theirs, ours - theirs
