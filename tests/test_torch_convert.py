"""The port's checkpoint reading and conversion (chatterbox_tpu_torch/convert:
weights.py, native_ckpt.py) held against chatterbox_tpu's.

  * its own .safetensors reader and writer against the `safetensors`
    package and the JAX loader (bit for bit);
  * every converter by a round trip: a port tree with random leaves ->
    chip_smoke.py's reference-layout writer -> a .safetensors file -> the
    JAX converter then convert/from_jax.py, and the port's converter; both
    must give back the tree bit for bit (a writer that invented a layout
    the JAX converter does not read fails here);
  * the error paths (a missing key, the S3 tokenizer's dry map, a
    misshaped leaf) and the S3 tokenizer against the torch replica of
    S3TokenizerV2 in tests/test_s3tok_convert.py;
  * native checkpoints saved by one package and loaded by the other.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
safetensors_numpy = pytest.importorskip("safetensors.numpy")

import chip_smoke  # noqa: E402
from chatterbox_tpu.convert import native_ckpt as jnative  # noqa: E402
from chatterbox_tpu.convert import weights as jw  # noqa: E402
from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.models.t3.config import T3Config as JT3Config  # noqa: E402
from chatterbox_tpu.models.ve import model as jve  # noqa: E402

from chatterbox_tpu_torch.convert import native_ckpt  # noqa: E402
from chatterbox_tpu_torch.convert import weights as W  # noqa: E402
from chatterbox_tpu_torch.convert.from_jax import (s3gen_from_jax, t3_from_jax,  # noqa: E402
                                                   ve_from_jax)
from chatterbox_tpu_torch.models.s3gen import model as s3m  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.flow import FlowDims  # noqa: E402
from chatterbox_tpu_torch.models.s3tok.model import (S3TokenizerConfig,  # noqa: E402
                                                     s3tokenizer_encode_mel)
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.models.t3.config import T3Config  # noqa: E402
from chatterbox_tpu_torch.models.ve.model import ve_init  # noqa: E402
from chatterbox_tpu_torch.nn import core as nn  # noqa: E402

GPT2_KW = dict(text_tokens_dict_size=64, backbone_name="GPT2_fused_test",
               speech_tokens_dict_size=6564, input_pos_emb=None,
               speech_cond_prompt_len=8, use_perceiver_resampler=False,
               emotion_adv=False, max_text_tokens=64, max_speech_tokens=128)
LLAMA_KW = dict(text_tokens_dict_size=64, backbone_name="Llama_fused_test",
                speech_tokens_dict_size=6564, input_pos_emb="learned",
                speech_cond_prompt_len=8, use_perceiver_resampler=True,
                emotion_adv=True, max_text_tokens=64, max_speech_tokens=128)
DIMS = FlowDims.tiny_test()
TOK = S3TokenizerConfig.tiny_test()
HIFT = 32


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module's CPU work (the modules that
    import this fixture too): the suite runs six workers on eight cores,
    which torch's default of a thread a core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomized(tree, seed):
    """The tree with every leaf replaced by seeded normal values of its
    shape (so a swapped or transposed leaf cannot go unseen)."""
    rng = np.random.default_rng(seed)

    def f(node):
        if isinstance(node, dict):
            return {k: f(v) for k, v in node.items()}
        if isinstance(node, list):
            return [f(v) for v in node]
        return torch.from_numpy(rng.standard_normal(tuple(node.shape)).astype(np.float32))
    return f(tree)


def assert_trees_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in b:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}/{i}")
    else:
        assert a.dtype == b.dtype == torch.float32, (path, a.dtype, b.dtype)
        assert torch.equal(a, b), path


def s3gen_tree(meanflow, seed):
    return randomized(s3m.s3gen_init(device="meta", meanflow=meanflow, dims=DIMS,
                                     hift_base=HIFT, tok_cfg=TOK), seed)


@pytest.fixture
def tiny_s3gen_schema(monkeypatch):
    """convert_s3gen checks against s3gen_init's default sizes; these tests
    write the tiny ones."""
    monkeypatch.setattr(s3m, "s3gen_init",
                        functools.partial(s3m.s3gen_init, dims=DIMS, hift_base=HIFT,
                                          tok_cfg=TOK))


# ---------------------------------------------------------------------------
# the .safetensors reader and writer
# ---------------------------------------------------------------------------

def _mixed_tensors(rng):
    return {"f32": rng.standard_normal((3, 5)).astype(np.float32),
            "f16": rng.standard_normal((7,)).astype(np.float16),
            "i64": rng.integers(-2**40, 2**40, (2, 3)).astype(np.int64),
            "i32": rng.integers(-2**30, 2**30, (4, 1, 2)).astype(np.int32),
            "i8": rng.integers(-128, 128, (5,)).astype(np.int8),   # odd length
            "scalar": np.array(2.5, np.float32),
            "after_odd": rng.standard_normal((2, 2)).astype(np.float32),
            "empty": np.zeros((0, 4), np.float32)}


def test_reader_matches_safetensors_package(tmp_path):
    path = tmp_path / "mixed.safetensors"
    safetensors_numpy.save_file(_mixed_tensors(np.random.default_rng(0)), str(path),
                                metadata={"format": "np"})
    ref = safetensors_numpy.load_file(str(path))
    for out in (W.load_safetensors(path), jw.load_safetensors(path)):
        assert set(out) == set(ref)
        for k in ref:
            assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape, k
            assert out[k].tobytes() == ref[k].tobytes(), k


def test_reader_bf16_file_matches_torch_reader(tmp_path):
    """A file holding bfloat16: every tensor as float32, as the JAX loader's
    fallback through safetensors.torch gives it (where numpy has no
    bfloat16)."""
    from safetensors.torch import load_file, save_file
    rng = np.random.default_rng(1)
    tensors = {"w": torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
               .to(torch.bfloat16),
               "b": torch.from_numpy(rng.standard_normal((6,)).astype(np.float32)),
               "n": torch.arange(5, dtype=torch.int64)}
    path = tmp_path / "bf16.safetensors"
    save_file(tensors, str(path))
    ref = {k: v.float().numpy() for k, v in load_file(str(path)).items()}
    out = W.load_safetensors(path)
    raw = W.read_safetensors(path)
    assert raw["w"].dtype == torch.bfloat16 and torch.equal(raw["w"], tensors["w"])
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype == np.float32
        assert out[k].tobytes() == ref[k].tobytes(), k


def test_writer_reads_back_through_safetensors_package(tmp_path):
    from safetensors.torch import load_file
    rng = np.random.default_rng(2)
    tensors = _mixed_tensors(rng)
    path = tmp_path / "w.safetensors"
    native_ckpt.save_safetensors(tensors, path)
    ref = safetensors_numpy.load_file(str(path))
    assert set(ref) == set(tensors)
    for k, v in tensors.items():
        assert ref[k].dtype == v.dtype and ref[k].tobytes() == np.asarray(v).tobytes(), k
    bf = {"w": torch.randn(3, 4).to(torch.bfloat16), "i": torch.arange(3)}
    native_ckpt.save_safetensors(bf, path)
    back = load_file(str(path))
    assert all(torch.equal(back[k], bf[k]) and back[k].dtype == bf[k].dtype for k in bf)


# ---------------------------------------------------------------------------
# converters: writer -> file -> JAX converter + from_jax, and port converter
# ---------------------------------------------------------------------------

def _round_trip(tmp_path, sd):
    path = tmp_path / "ckpt.safetensors"
    native_ckpt.save_safetensors(sd, path)
    return W.load_safetensors(path), jw.load_safetensors(path)


@pytest.mark.parametrize("kw", [GPT2_KW, LLAMA_KW], ids=["gpt2", "llama_perceiver"])
def test_t3_converter_round_trip(tmp_path, kw):
    hp, jhp = T3Config(**kw), JT3Config(**kw)
    tree = randomized(t3m.t3_init(hp, device="meta"), 0)
    sd, jsd = _round_trip(tmp_path, chip_smoke.t3_state_dict(tree, hp))
    assert_trees_equal(W.convert_t3(sd, hp, device="cpu"), tree)
    assert_trees_equal(t3_from_jax(jw.convert_t3(jsd, jhp), hp, device="cpu"), tree)


def test_torch_pt_reader_matches_jax(tmp_path):
    sd = {"a.weight": torch.randn(3, 2).to(torch.bfloat16), "a.bias": torch.randn(2),
          "n": torch.arange(4)}
    torch.save(sd, tmp_path / "ve.pt")
    ours, theirs = W.load_torch_pt(tmp_path / "ve.pt"), jw.load_torch_pt(tmp_path / "ve.pt")
    assert set(ours) == set(theirs) == set(sd)
    for k in sd:
        assert ours[k].dtype == theirs[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_t3_converter_unwraps_model_key(tmp_path):
    hp = T3Config(**GPT2_KW)
    tree = randomized(t3m.t3_init(hp, device="meta"), 1)
    sd = chip_smoke.t3_state_dict(tree, hp)
    for wrapped in ({"model": [sd]}, {"model": sd}):
        assert W._unwrap_model(wrapped) is sd
        assert jw._unwrap_model(wrapped) is sd
    assert W._unwrap_model(sd) is sd


def test_voice_encoder_converter_round_trip(tmp_path):
    tree = randomized(ve_init(nn.Init(0, "meta")), 2)
    sd, jsd = _round_trip(tmp_path, chip_smoke.ve_state_dict(tree))
    assert_trees_equal(W.convert_voice_encoder(sd, device="cpu"), tree)
    assert_trees_equal(ve_from_jax(jw.convert_voice_encoder(jsd), device="cpu"), tree)


@pytest.mark.parametrize("meanflow", [True, False], ids=["meanflow", "cfg"])
def test_s3gen_converter_round_trip(tmp_path, tiny_s3gen_schema, meanflow):
    """S3 tokenizer, CAMPPlus, the upsample encoder, the UNet (meanflow's
    time mixer or not) and HiFT through convert_s3gen."""
    tree = s3gen_tree(meanflow, 3)
    sd, jsd = _round_trip(tmp_path, chip_smoke.s3gen_state_dict(tree))
    assert ("flow.decoder.estimator.time_embed_mixer.weight" in sd) == meanflow
    assert_trees_equal(W.convert_s3gen(sd, meanflow=meanflow, device="cpu"), tree)
    jtree = {"tokenizer": jw.convert_s3tokenizer(jsd), "speaker_encoder": jw.convert_campplus(jsd),
             "flow": jw.convert_flow(jsd), "mel2wav": jw.convert_hift(jsd)}
    carried = s3gen_from_jax(jtree, dims=DIMS, hift_base=HIFT, meanflow=meanflow,
                             tok_cfg=TOK, device="cpu")
    assert_trees_equal(carried, tree)


@pytest.mark.parametrize("style", ["parametrizations", "weight_g"])
@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "conv_transpose"])
def test_weight_norm_convs_match_jax(style, transposed):
    """Weight-normed convs fold to g * v / ||v|| as the JAX converter folds
    them; the port keeps torch's layout, the JAX package its own."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal((6, 4, 5)).astype(np.float32)
    g = rng.standard_normal((6, 1, 1)).astype(np.float32)
    names = (("parametrizations.weight.original0", "parametrizations.weight.original1")
             if style == "parametrizations" else ("weight_g", "weight_v"))
    sd = {f"c.{names[0]}": g, f"c.{names[1]}": v,
          "c.bias": rng.standard_normal(4 if transposed else 6).astype(np.float32)}
    if transposed:
        out, ref = W.conv_t1d(sd, "c"), jw.conv_t1d(sd, "c")
        back = ref["w"][::-1].transpose(1, 2, 0)         # from_jax's un-flip
    else:
        out, ref = W.conv1d(sd, "c"), jw.conv1d(sd, "c")
        back = ref["w"].transpose(2, 1, 0)
    assert out["w"].tobytes() == np.ascontiguousarray(back).tobytes()
    np.testing.assert_array_equal(out["b"], ref["b"])


# ---------------------------------------------------------------------------
# error paths
# ---------------------------------------------------------------------------

def test_missing_key_raises_as_jax(tmp_path):
    hp, jhp = T3Config(**GPT2_KW), JT3Config(**GPT2_KW)
    sd = chip_smoke.t3_state_dict(randomized(t3m.t3_init(hp, device="meta"), 5), hp)
    del sd["tfmr.h.1.mlp.c_fc.bias"]
    with pytest.raises(KeyError) as ours:
        W.convert_t3(sd, hp, device="cpu")
    with pytest.raises(KeyError) as theirs:
        jw.convert_t3(sd, jhp)
    assert str(ours.value) == str(theirs.value)


def test_misshaped_leaf_raises(tmp_path):
    hp = T3Config(**GPT2_KW)
    sd = chip_smoke.t3_state_dict(randomized(t3m.t3_init(hp, device="meta"), 6), hp)
    sd["speech_head.bias"] = sd["speech_head.bias"][:-1]
    with pytest.raises(ValueError, match="speech_head/b"):
        W.convert_t3(sd, hp, device="cpu")


def test_s3tokenizer_errors_and_dry_map_match_jax(tiny_s3gen_schema):
    sd = chip_smoke.s3gen_state_dict(s3gen_tree(True, 7))
    tok = {k: v for k, v in sd.items() if k.startswith("tokenizer.")}
    drifted = set(tok) | {"tokenizer.encoder.blocks.0.attn.rel_pos.weight",
                          "tokenizer._mel_filters"}
    drifted.discard("tokenizer.encoder.ln_post.bias")
    assert W.dry_map_s3tokenizer(drifted) == jw.dry_map_s3tokenizer(drifted)
    assert W.dry_map_s3tokenizer(tok) == jw.dry_map_s3tokenizer(tok)
    broken = dict(sd)
    del broken["tokenizer.encoder.blocks.1.attn.query.weight"]
    with pytest.raises(W.S3TokenizerConversionError) as ours:
        W.convert_s3gen(broken, meanflow=True, device="cpu")
    with pytest.raises(jw.S3TokenizerConversionError) as theirs:
        jw.convert_s3tokenizer(broken)
    assert str(ours.value) == str(theirs.value)
    renamed = {k.replace("quantizer._codebook.", "quantizer."): v for k, v in tok.items()}
    assert np.array_equal(W.convert_s3tokenizer(renamed)["fsq_proj"]["w"],
                          jw.convert_s3tokenizer(renamed)["fsq_proj"]["w"])


def test_s3tokenizer_writer_matches_torch_replica():
    """C6: the S3 tokenizer is the JAX package's reconstruction of
    S3TokenizerV2, whose oracle was a torch replica of the public package's
    layout (DESIGN.md, "Named P0 risk"); this holds the port to that same
    replica (key names from the writer, tokens from the replica's state
    dict, exactly), and only a real checkpoint can close the risk."""
    from tests.test_s3tok_convert import TS3TokenizerV2, _state_dict_prefixed
    torch.manual_seed(0)
    model = TS3TokenizerV2(TOK.n_mels, TOK.n_state, TOK.n_heads, TOK.n_layers).eval()
    sd = _state_dict_prefixed(model)
    out = {}
    chip_smoke._s3tok_state_dict(out, W._tensors(W.convert_s3tokenizer(sd), "cpu"))
    assert set(out) == set(sd)
    mel = np.random.default_rng(0).standard_normal((2, TOK.n_mels, 48)).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(mel)).numpy()
        tokens, tok_len = s3tokenizer_encode_mel(
            W._tensors(W.convert_s3tokenizer(sd), "cpu"), TOK,
            torch.from_numpy(mel.transpose(0, 2, 1)), torch.full((2,), 48))
    assert (tok_len == 12).all()
    np.testing.assert_array_equal(tokens.numpy(), ref)


# ---------------------------------------------------------------------------
# native checkpoints
# ---------------------------------------------------------------------------

def test_native_checkpoint_jax_save_port_load(tmp_path):
    """Both packages flatten a tree to '/'-joined keys: a T3 and a voice
    encoder saved by the JAX package load into the port's trees."""
    jhp, hp = JT3Config(**LLAMA_KW), T3Config(**LLAMA_KW)
    jt3 = jax.tree.map(np.asarray, jt3m.t3_init(jax.random.key(0), jhp))
    jvep = jax.tree.map(np.asarray, jve.ve_init(jax.random.key(1)))
    jnative.save_engine_checkpoint(tmp_path, t3_params=jt3, ve_params=jvep, meta={"a": 1})
    t3 = native_ckpt.load_pytree(tmp_path / "t3_native.safetensors",
                                 t3m.t3_init(hp, device="meta"), device="cpu")
    assert_trees_equal(t3, t3_from_jax(jt3, hp, device="cpu"))
    vep = native_ckpt.load_pytree(tmp_path / "ve_native.safetensors",
                                  ve_init(nn.Init(0, "meta")), device="cpu")
    assert_trees_equal(vep, ve_from_jax(jvep, device="cpu"))


def test_native_checkpoint_port_save_jax_load(tmp_path):
    jhp, hp = JT3Config(**GPT2_KW), T3Config(**GPT2_KW)
    tree = randomized(t3m.t3_init(hp, device="meta"), 8)
    vep = randomized(ve_init(nn.Init(0, "meta")), 9)
    native_ckpt.save_engine_checkpoint(tmp_path, t3_params=tree, ve_params=vep,
                                       meta={"family": "turbo"})
    assert (tmp_path / "chatterbox_tpu.json").read_text() == '{\n  "family": "turbo"\n}'
    jt3 = jnative.load_pytree(tmp_path / "t3_native.safetensors",
                              jt3m.t3_init(jax.random.key(0), jhp))
    assert_trees_equal(t3_from_jax(jt3, hp, device="cpu"), tree)
    back = native_ckpt.load_pytree(tmp_path / "ve_native.safetensors", vep, device="cpu")
    assert_trees_equal(back, vep)
    with pytest.raises(KeyError, match="missing key"):
        native_ckpt.load_pytree(tmp_path / "ve_native.safetensors",
                                dict(vep, extra=torch.zeros(1)), device="cpu")
