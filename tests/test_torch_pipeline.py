"""The port's pipelines end to end on the CPU against chatterbox_tpu's:
ChatterboxTurboTTS (a 2-layer GPT2_FUSED_TEST T3 quantized int8_fused, a
tiny meanflow S3Gen) and ChatterboxTTS (a 2-layer Llama_fused_test T3 with
perceiver, emotion input and learned positions, quantized int8_fused, a tiny
10-step CFG S3Gen), synthetic Conditionals, greedy decode. Also the conds.pt
interchange, the prompt checks, and the rule that the port never imports
JAX or the JAX package."""
import ast
import inspect
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from chatterbox_tpu.api.pipelines import ChatterboxMultilingualTTS as JMTL  # noqa: E402
from chatterbox_tpu.api.pipelines import ChatterboxTTS as JCfgTTS  # noqa: E402
from chatterbox_tpu.api.pipelines import ChatterboxTurboTTS as JTTS  # noqa: E402
from chatterbox_tpu.api.pipelines import Conditionals as JConds  # noqa: E402
from chatterbox_tpu.api.pipelines import T3CondHost as JT3Cond  # noqa: E402
from chatterbox_tpu.models.s3gen import flow as jflow  # noqa: E402
from chatterbox_tpu.models.s3gen import hift as jhift  # noqa: E402
from chatterbox_tpu.models.s3gen import model as jmodel  # noqa: E402
from chatterbox_tpu.models.s3gen.model import RefDict as JRefDict  # noqa: E402
from chatterbox_tpu.models.s3gen.model import S3GenEngine as JEngine  # noqa: E402
from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.models.t3.config import T3Config as JT3Config  # noqa: E402
from chatterbox_tpu.utils.quantize import quantize_t3_backbone as jquant  # noqa: E402

import chatterbox_tpu_torch as port  # noqa: E402
from chatterbox_tpu_torch.convert.from_jax import s3gen_from_jax, t3_from_jax  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.flow import FlowDims  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.model import S3GenEngine  # noqa: E402
from chatterbox_tpu_torch.models.t3.config import T3Config  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
HP_KW = dict(text_tokens_dict_size=64, backbone_name="GPT2_fused_test",
             speech_tokens_dict_size=6564, input_pos_emb=None,
             speech_cond_prompt_len=8, use_perceiver_resampler=False,
             emotion_adv=False, max_text_tokens=64, max_speech_tokens=128)
P = 64           # prompt tokens: with 61 tokens + 3 silence the JAX buckets
N_NEW = 61       # (128 tokens, 128 mel frames) are exact, as in the port


class _Tok:
    def text_to_tokens(self, text):
        return (np.frombuffer(text.encode(), np.uint8) % 60 + 1)[None].astype(np.int32)


def _conds(rng):
    t3 = (rng.standard_normal((1, 256)).astype(np.float32),
          rng.integers(0, 6561, (1, 8)).astype(np.int32))
    gen = (rng.integers(0, 6561, (1, P)).astype(np.int32), np.array([P], np.int32),
           (rng.standard_normal((1, 2 * P, 80)) * 0.5).astype(np.float32),
           rng.standard_normal((1, 192)).astype(np.float32))
    return (JConds(JT3Cond(*t3, 0.0), JRefDict(*gen)),
            port.Conditionals(port.T3CondHost(*t3, 0.0), port.RefDict(*gen)))


def _pipelines(mode="int8_fused", head_spread=0.0):
    jhp = JT3Config(**HP_KW)
    qp = jquant(jt3m.t3_init(jax.random.key(0), jhp), mode=mode)
    # keep greedy decoding on ordinary speech tokens (no EOS, nothing the
    # vocoder filters), so both engines vocode exactly N_NEW + 3 tokens;
    # `head_spread` adds seeded noise of that size to the speech logits,
    # which keeps the top two tokens apart
    b = qp["speech_head"]["b"] + head_spread * jnp.asarray(
        np.random.default_rng(5).standard_normal(6564), jnp.float32)
    qp["speech_head"]["b"] = b.at[6561:].set(-1e4)
    k1, k2 = jax.random.split(jax.random.key(1))
    dims, jdims = FlowDims.tiny_test(), jflow.FlowDims.tiny_test()
    sp = {"flow": jflow.flow_init(k1, meanflow=True, dims=jdims),
          "mel2wav": jhift.hift_init(k2, base_channels=32)}
    jeng = JEngine(sp, meanflow=True, dims=jdims)
    jeng.pcm16_fetch = False
    jconds, tconds = _conds(np.random.default_rng(0))
    jtts = JTTS(qp, jhp, jeng, None, _Tok(), jconds, seed=7)
    tts = port.ChatterboxTurboTTS(
        t3_from_jax(jax.tree.map(np.asarray, qp), T3Config(**HP_KW), device="cpu"),
        T3Config(**HP_KW),
        S3GenEngine(s3gen_from_jax(jax.tree.map(np.asarray, sp), dims=dims,
                                   hift_base=32, device="cpu"), dims=dims),
        None, _Tok(), tconds, seed=7)
    return jtts, tts


def test_turbo_generate_matches_jax_pipeline():
    from tests.test_torch_s3gen import jax_vocode_noise
    jtts, tts = _pipelines()
    kw = dict(top_k=1, max_new_tokens=N_NEW)
    ref = jtts.generate("hello world, this is a test", **kw)
    # the JAX pipeline's second key draws its vocoder noise; hand the same
    # numbers to the port
    key = jax.random.key(7)
    key, _ = jax.random.split(key)
    _, k_voc = jax.random.split(key)
    noise = jax_vocode_noise(k_voc, 2 * (P + N_NEW + 3), 2 * (N_NEW + 3))
    tts.s3gen.draw_noise = lambda n_mel, n_gen_mel, generator: noise
    out = tts.generate("hello world, this is a test", **kw)
    assert tts.last_decode.n_forward == N_NEW - 1
    assert out.shape == ref.shape == (1, (N_NEW + 3) * 2 * 480)
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3
    # float32 end to end on the CPU; the watermark (the same numpy code in
    # both packages) is applied to near-equal waves
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


LLAMA_KW = dict(backbone_name="Llama_fused_test", speech_tokens_dict_size=6564,
                speech_cond_prompt_len=8, max_text_tokens=64, max_speech_tokens=128)
P_CFG, N_CFG = 24, 40      # prompt and generated tokens of the CFG pipeline test


def _cfg_pipelines():
    jhp = JT3Config(**LLAMA_KW)
    qp = jquant(jt3m.t3_init(jax.random.key(0), jhp), mode="int8_fused")
    # the llama speech head has no bias: zero the special and out-of-vocab
    # columns, so greedy decoding stays on ordinary speech tokens (no EOS,
    # nothing the vocoder filters) and both engines vocode N_CFG tokens
    qp["speech_head"]["w_q"] = qp["speech_head"]["w_q"].at[:, 6561:].set(0)
    k1, k2 = jax.random.split(jax.random.key(1))
    dims, jdims = FlowDims.tiny_test(), jflow.FlowDims.tiny_test()
    sp = {"flow": jflow.flow_init(k1, meanflow=False, dims=jdims),
          "mel2wav": jhift.hift_init(k2, base_channels=32)}
    jeng = JEngine(sp, meanflow=False, dims=jdims)
    jeng.pcm16_fetch = False
    rng = np.random.default_rng(3)
    t3 = (rng.standard_normal((1, 256)).astype(np.float32),
          rng.integers(0, 6561, (1, 8)).astype(np.int32))
    gen = (rng.integers(0, 6561, (1, P_CFG)).astype(np.int32),
           np.array([P_CFG], np.int32),
           (rng.standard_normal((1, 2 * P_CFG, 80)) * 0.5).astype(np.float32),
           rng.standard_normal((1, 192)).astype(np.float32))
    jtts = JCfgTTS(qp, jhp, jeng, None, _Tok(), JConds(JT3Cond(*t3, 0.5), JRefDict(*gen)),
                   seed=7)
    tts = port.ChatterboxTTS(
        t3_from_jax(jax.tree.map(np.asarray, qp), T3Config(**LLAMA_KW), device="cpu"),
        T3Config(**LLAMA_KW),
        S3GenEngine(s3gen_from_jax(jax.tree.map(np.asarray, sp), dims=dims, hift_base=32,
                                   meanflow=False, device="cpu"),
                    dims=dims, meanflow=False),
        None, _Tok(), port.Conditionals(port.T3CondHost(*t3, 0.5), port.RefDict(*gen)), seed=7)
    return jtts, tts


def test_cfg_generate_matches_jax_pipeline(monkeypatch):
    from tests.test_torch_s3gen import jax_vocode_noise
    # C7: the JAX vocoder pads HiFT's input to a mel bucket, which changes the
    # last samples; pin its buckets to the exact lengths (its bucket pick
    # falls back to the last bucket when none is large enough)
    monkeypatch.setattr(jmodel, "TOKEN_BUCKETS", (P_CFG + N_CFG,))
    monkeypatch.setattr(jmodel, "GEN_MEL_BUCKETS", (2 * N_CFG,))
    jtts, tts = _cfg_pipelines()
    # min_p = 1 keeps only the most likely token: greedy in both engines
    kw = dict(min_p=1.0, max_new_tokens=N_CFG, exaggeration=0.6)
    ref = jtts.generate("hello world, this is a test", **kw)
    key = jax.random.key(7)
    key, _ = jax.random.split(key)
    _, k_voc = jax.random.split(key)
    noise = jax_vocode_noise(k_voc, 2 * (P_CFG + N_CFG), 2 * N_CFG, meanflow=False)
    tts.s3gen.draw_noise = lambda n_mel, n_gen_mel, generator: noise
    out = tts.generate("hello world, this is a test", **kw)
    assert tts.last_decode.n_forward == N_CFG - 1
    assert tts.conds.t3.emotion_adv == 0.6
    assert out.shape == ref.shape == (1, N_CFG * 2 * 480)
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3
    # float32 end to end on the CPU (the T3's fused kernels round to bf16 at
    # the same points in both); ten flow steps of summation-order differences
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_cfg_weight_zero_decodes_batch_1():
    _, tts = _cfg_pipelines()
    kw = dict(min_p=1.0, max_new_tokens=4)
    tts.generate("hi", cfg_weight=0.0, **kw)
    assert tts.last_decode.n_forward == 3
    # a prompt path is read now (the frontend is ported): a missing file raises
    with pytest.raises(FileNotFoundError):
        tts.generate("hi", audio_prompt_path="no-such-ref.wav", **kw)


def test_conds_pt_from_jax_loads_in_port(tmp_path):
    jconds, _ = _conds(np.random.default_rng(1))
    path = tmp_path / "conds.pt"
    jconds.save(str(path))
    c = port.Conditionals.load(str(path))
    np.testing.assert_array_equal(c.t3.speaker_emb, jconds.t3.speaker_emb)
    np.testing.assert_array_equal(c.t3.cond_prompt_speech_tokens,
                                  jconds.t3.cond_prompt_speech_tokens)
    for a, b in zip(c.gen, jconds.gen):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    npz = tmp_path / "conds.npz"
    c.save(str(npz))
    c2 = port.Conditionals.load(str(npz))
    np.testing.assert_array_equal(c2.gen.prompt_feat, c.gen.prompt_feat)


@pytest.mark.parametrize("port_cls,jax_cls", [(port.ChatterboxTurboTTS, JTTS),
                                               (port.ChatterboxTTS, JCfgTTS),
                                               (port.ChatterboxMultilingualTTS, JMTL)])
def test_generate_takes_only_the_jax_pipelines_knobs(port_cls, jax_cls):
    """No ignore_eos (a benchmark decodes through t3_generate, as bench.py
    does); every knob of the port's generate and generate_stream is one the
    JAX pipeline's method has (Turbo's draft= and n_draft= included; the
    multilingual generate has no kv_int8, as JAX's has none)."""
    ours = set(inspect.signature(port_cls.generate).parameters)
    assert "ignore_eos" not in ours
    assert ours <= set(inspect.signature(jax_cls.generate).parameters)
    with pytest.raises(TypeError, match="ignore_eos"):
        port_cls.generate(None, "hi", ignore_eos=True)
    stream = set(inspect.signature(port_cls.generate_stream).parameters)
    assert "ignore_eos" not in stream
    assert stream <= set(inspect.signature(jax_cls.generate_stream).parameters)


def test_audio_prompt_of_5_s_or_less_is_refused(tmp_path):
    """The frontend is ported: a prompt path reaches Turbo's
    prepare_conditionals, which refuses a prompt of 5 s or less as the JAX
    pipeline does (tests/test_torch_load.py runs whole prompts)."""
    from chatterbox_tpu_torch.utils.audio_io import save_wav
    _, tts = _pipelines()
    wav = tmp_path / "short.wav"
    save_wav(wav, np.zeros(3 * 24000, np.float32), 24000)
    with pytest.raises(AssertionError, match="longer than 5 seconds"):
        tts.generate("hi", audio_prompt_path=str(wav), max_new_tokens=2)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "chatterbox_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    # the checkpoint loaders and the conditioning frontend are walked too
    walked = {f.relative_to(REPO).as_posix() for f in files}
    assert {f"chatterbox_tpu_torch/{m}.py" for m in (
        "audio/filters", "audio/mels", "audio/resample", "audio/stft",
        "convert/native_ckpt", "convert/weights", "models/s3gen/campplus",
        "models/s3tok/model", "models/ve/model", "text/tokenizer", "utils/audio_io",
        "utils/loudness", "sampling/chunked", "serve/streaming",
        "sampling/speculative", "sampling/continuous", "serve/batching", "serve/http",
        "serve/mcp", "utils/profiling", "cli", "__init__", "parallel/mesh",
        "parallel/train", "runtime/__init__", "examples/train_t3", "utils/dtensor",
        "examples/train_flow")} <= walked
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "chatterbox_tpu"), (f, mod)
