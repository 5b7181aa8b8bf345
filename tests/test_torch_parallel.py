"""The port's (data, model) DTensor mesh (chatterbox_tpu_torch/parallel)
held against the JAX package's sharding rules, against the JAX package's
training steps and decode engines, and against the port's own
single-process steps and decodes.

One module-scoped run starts 4 gloo processes on the CPU
(tests/test_torch_parallel_worker.py): the T3 step at dp 2 x tp 2 (tiny
llama and tiny GPT-2), the flow step at data = 4 on JAX's draws for its
keys, and a sharded state saved, loaded into a fresh sharded state and
stepped again. Their losses and updated parameters are held to the same
steps in this process on plain tensors, and to the JAX package's
`t3_train_step` / `flow_train_step` from the workers' initial parameters
(saved by process 0, read by JAX's `load_pytree`) on the same batches:
losses within rtol 1e-5 (the sharded matrix products sum in another
order); parameters within 2 lr x steps elementwise with the 99th
percentile of the difference under 1e-6, since Adam moves a leaf whose
gradient is rounding noise (a key bias under softmax) by up to lr a step
in either direction.

The same run decodes over the meshes (tensor-parallel `t3_generate` at dp
2 x tp 2, data-parallel `t3_generate_batched` at data 4) and reads
train_flow's `real_batches` on every process; the tensor-parallel tokens
(sampled on JAX's own key splits) and the greedy data-parallel rows are
held to the JAX package's unsharded engines, and every decode and batch to
one process of the port.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from chatterbox_tpu.convert.native_ckpt import load_pytree as jax_load_pytree  # noqa: E402
from chatterbox_tpu.models.s3gen import flow as jflow  # noqa: E402
from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.models.t3.config import T3Config as JT3Config  # noqa: E402
from chatterbox_tpu.ops import sampling as JS  # noqa: E402
from chatterbox_tpu.parallel import mesh as jmesh  # noqa: E402
from chatterbox_tpu.parallel import train as jtrain  # noqa: E402
from chatterbox_tpu.sampling import batched as JB  # noqa: E402
from chatterbox_tpu.sampling.decode import t3_generate as jax_generate  # noqa: E402

from chatterbox_tpu_torch.convert.native_ckpt import _flatten  # noqa: E402
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.models.t3.config import T3Config  # noqa: E402
from chatterbox_tpu_torch.ops.sampling import SamplerParams  # noqa: E402
from chatterbox_tpu_torch.parallel import mesh as M  # noqa: E402
from chatterbox_tpu_torch.sampling.batched import t3_generate_batched  # noqa: E402
from chatterbox_tpu_torch.sampling.decode import t3_generate  # noqa: E402
from chatterbox_tpu_torch.utils.quantize import quantize_t3_backbone  # noqa: E402
from tests import test_torch_parallel_worker as W  # noqa: E402
from tests.test_torch_flow_train import jax_draws  # noqa: E402
from tests.test_torch_train import jax_key  # noqa: E402


def flow_key(i):
    return jax.random.key(100 + i)


DECODE_KEY = 5       # the key of the JAX decodes the mesh decodes replay


def jax_gumbel(fam: str) -> np.ndarray:
    """The gumbel rows JAX's `t3_generate` draws from key DECODE_KEY, one a
    step (key, sub = split(key); categorical(sub) = argmax(logits +
    gumbel(sub))), for `gumbel=` replay."""
    draws, k = [], jax.random.key(DECODE_KEY)
    for _ in range(W.DECODE_N):
        k, sub = jax.random.split(k)
        draws.append(np.asarray(jax.random.gumbel(
            sub, (T3Config.tiny_test(fam).speech_tokens_dict_size,), jnp.float32)))
    return np.stack(draws)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    draws = [jax_draws(flow_key(i), W.B, W.FLOW_T_MEL) for i in range(W.STEPS)]
    gumbel = {fam: jax_gumbel(fam) for fam in ("llama", "gpt2")}
    return SimpleNamespace(res=W.spawn(out, draws, gumbel), out=out, gumbel=gumbel)


def assert_adam_close(got: dict, want: dict, steps: int = W.STEPS):
    """Parameters after `steps` Adam updates at lr W.LR: see the module
    docstring for the bound."""
    assert set(got) == set(want)
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert d.max() <= 2 * W.LR * steps, d.max()
    assert np.percentile(d, 99) < 1e-6, np.percentile(d, 99)


def jax_flat(tree) -> dict:
    return {jax_key(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("fam", ["llama", "gpt2"])
def test_t3_step_dp2_tp2_equals_one_process(mesh_run, fam):
    losses, params = W.single_t3(fam)
    np.testing.assert_allclose(mesh_run.res[f"{fam}_losses"], losses, rtol=1e-5)
    assert_adam_close({k: mesh_run.res[f"{fam}/{k}"] for k in params}, params)


@pytest.mark.parametrize("fam", ["llama", "gpt2"])
def test_t3_step_dp2_tp2_matches_jax(mesh_run, fam):
    """The workers' run against jtrain.t3_train_step from the workers'
    initial parameters on the same batches and optimizer."""
    jhp, hp = JT3Config.tiny_test(fam), T3Config.tiny_test(fam)
    jp = jax_load_pytree(mesh_run.out / f"{fam}_init.safetensors",
                         jt3m.t3_init(jax.random.key(1), jhp))
    jp = jax.tree.map(jnp.asarray, jp)
    np.testing.assert_array_equal(jax_flat(jp)["speech_head/w"],
                                  t3m.t3_init(hp, seed=0, device="cpu")["speech_head"]["w"].numpy())
    jopt = jtrain.make_optimizer(**W.OPT)
    js = jtrain.TrainState(jp, jopt.init(jp))
    jstep = jax.jit(lambda s, *a: jtrain.t3_train_step(s, jhp, jopt, *a))
    i32 = lambda t: jnp.asarray(t.numpy(), jnp.int32)
    losses = []
    for i in range(W.STEPS):
        cond, text, tl, speech, sl = W.t3_batch(hp, i)
        jc = jt3m.T3CondArrays(jnp.asarray(cond.speaker_emb.numpy()),
                               i32(cond.cond_prompt_speech_tokens),
                               None if cond.emotion_adv is None
                               else jnp.asarray(cond.emotion_adv.numpy()))
        js, jm = jstep(js, jc, i32(text), i32(tl), i32(speech), i32(sl))
        losses.append([float(jm["loss_text"]), float(jm["loss_speech"])])
    np.testing.assert_allclose(mesh_run.res[f"{fam}_losses"], losses, rtol=1e-5)
    want = jax_flat(js.params)
    assert_adam_close({k: mesh_run.res[f"{fam}/{k}"] for k in want}, want)


def test_t3_params_placed_by_the_rules(mesh_run):
    res = mesh_run.res
    assert tuple(res["mesh_shape"]) == (2, 2)       # dp defaults to 2 at n >= 4
    shard = lambda d: f"(Replicate(), Shard(dim={d}))"
    assert str(res["llama_placement_q"]) == shard(1)
    assert str(res["llama_placement_o"]) == shard(0)
    assert str(res["gpt2_placement_qkv"]) == shard(1)
    assert str(res["gpt2_placement_attn_out"]) == shard(0)
    for name in ("llama_placement_input_ln", "gpt2_placement_ln1", "flow_placement"):
        assert "Shard" not in str(res[name]), name
    assert bool(res["odd_batch_refused"])


def test_sharded_state_saves_and_resumes(mesh_run):
    """Gathered on save, sharded again on load: the resumed third step is
    the uninterrupted run's third step."""
    res = mesh_run.res
    assert int(res["resumed_step_count"]) == 2
    np.testing.assert_allclose(res["resumed_losses"], res["llama_losses"][2], rtol=1e-6)
    keys = [k[len("resumed/"):] for k in res if k.startswith("resumed/")]
    for k in keys:
        np.testing.assert_allclose(res[f"resumed/{k}"], res[f"llama/{k}"],
                                   rtol=0, atol=1e-7, err_msg=k)


def test_flow_step_data4_equals_one_process(mesh_run):
    losses, params = W.single_flow(W.read_draws(mesh_run.out))
    np.testing.assert_allclose(mesh_run.res["flow_losses"], losses, rtol=1e-5)
    assert_adam_close({k: mesh_run.res[f"flow/{k}"] for k in params}, params)


def test_flow_step_data4_matches_jax(mesh_run):
    """The workers' run against jtrain.flow_train_step from the workers'
    initial parameters, on the same batches, JAX drawing from the keys
    whose draws the workers were given."""
    jdims = jflow.FlowDims.tiny_test()
    jp = jax_load_pytree(mesh_run.out / "flow_init.safetensors",
                         jflow.flow_init(jax.random.key(1), meanflow=False, dims=jdims))
    jp = jax.tree.map(jnp.asarray, jp)
    jopt = jtrain.make_optimizer(**W.OPT)
    js = jtrain.TrainState(jp, jopt.init(jp))
    jstep = jax.jit(lambda s, k, *a: jtrain.flow_train_step(s, jopt, k, *a, jdims))
    losses = []
    for i in range(W.STEPS):
        token, tl, feat, fl, emb = (t.numpy() for t in W.flow_batch(i))
        js, jm = jstep(js, flow_key(i), jnp.asarray(token, jnp.int32), jnp.asarray(tl, jnp.int32),
                       jnp.asarray(feat), jnp.asarray(fl, jnp.int32), jnp.asarray(emb))
        losses.append(float(jm["loss_cfm"]))
    np.testing.assert_allclose(mesh_run.res["flow_losses"], losses, rtol=1e-5)
    want = jax_flat(js.params)
    # the port keeps conv weights (Cout, Cin, K); JAX (K, Cin, Cout)
    got = {k: (lambda v: v.transpose(2, 1, 0) if v.ndim == 3 else v)(mesh_run.res[f"flow/{k}"])
           for k in want}
    assert_adam_close(got, want)


# ---------------------------------------------------------------------------
# the rules against the JAX package's, leaf by leaf (no processes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", ["tiny_gpt2", "tiny_llama", "turbo", "english_only"])
def test_t3_param_spec_matches_jax(cfg):
    if cfg.startswith("tiny"):
        jhp, hp = JT3Config.tiny_test(cfg[5:]), T3Config.tiny_test(cfg[5:])
    else:
        jhp, hp = getattr(JT3Config, cfg)(), getattr(T3Config, cfg)()
    shapes = jax.eval_shape(lambda k: jt3m.t3_init(k, jhp), jax.random.key(0))
    jflat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
             (tuple(jmesh.t3_param_spec(path, leaf)), leaf.shape)
             for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    port = t3m.t3_init(hp, device="meta")
    pflat = dict(_flatten(port))
    assert set(jflat) == set(pflat)
    sharded = 0
    for k, (jspec, shape) in jflat.items():
        assert M.t3_param_spec(tuple(k.split("/"))) == jspec, k
        assert tuple(pflat[k].shape) == tuple(shape), k
        sharded += bool(jspec)
    assert sharded >= 2 * hp.backbone.num_layers


class _Mesh:
    """The names and sizes `placements` reads, of a dp x tp mesh."""
    mesh_dim_names = M.AXES

    def __init__(self, dp, tp):
        self.sizes = (dp, tp)

    def size(self, i):
        return self.sizes[i]


def test_non_dividing_leaf_is_replicated_as_jax_does():
    """A (D, 6563) Turbo speech head over a model axis of 2 or 4, and a
    7-wide weight: the JAX package replicates what does not divide."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    jm = jmesh.make_mesh(8, dp=2)                  # dp 2 x tp 4 over conftest's 8 devices
    tree = {"backbone": {"layers": [{"q": {"w": np.zeros((16, 7), np.float32)},
                                     "o": {"w": np.zeros((8, 16), np.float32)}}]},
            "speech_head": {"w": np.zeros((16, 6563), np.float32)}}
    placed = jmesh.shard_t3_params(jax.tree.map(jax.numpy.asarray, tree), jm)
    want = {"backbone/layers/0/q/w": P(), "backbone/layers/0/o/w": P("model", None),
            "speech_head/w": P()}
    for k, spec in want.items():
        leaf = placed
        for part in k.split("/"):
            leaf = leaf[int(part)] if part.isdigit() else leaf[part]
        assert isinstance(leaf.sharding, NamedSharding)
        assert leaf.sharding.spec == spec, k
    for tp in (2, 4):
        for k, spec in want.items():
            path = tuple(k.split("/"))
            got = M.placements(_Mesh(2, tp), M.t3_param_spec(path),
                               tree["speech_head"]["w"].shape if "speech" in k
                               else tree["backbone"]["layers"][0][path[3]]["w"].shape)
            sharded = [repr(p) for p in got if "Shard" in repr(p)]
            assert sharded == ([] if spec == P() else ["Shard(dim=0)"]), (k, tp, got)


# ---------------------------------------------------------------------------
# decoding over the meshes (the same 4-process run)
# ---------------------------------------------------------------------------

def _jax_params(mesh_run, fam):
    """The workers' seed-0 T3 params (their `<fam>_init.safetensors`) as a
    JAX tree."""
    jp = jax_load_pytree(mesh_run.out / f"{fam}_init.safetensors",
                         jt3m.t3_init(jax.random.key(1), JT3Config.tiny_test(fam)))
    return jax.tree.map(jnp.asarray, jp)


def _jax_cond(cond):
    return jt3m.T3CondArrays(jnp.asarray(cond.speaker_emb.numpy()),
                             jnp.asarray(cond.cond_prompt_speech_tokens.numpy(), jnp.int32),
                             None if cond.emotion_adv is None
                             else jnp.asarray(cond.emotion_adv.numpy()))


def _jax_sampler(sp):
    return JS.SamplerParams.make(temperature=sp.temperature, top_p=sp.top_p,
                                 repetition_penalty=sp.repetition_penalty, min_p=sp.min_p,
                                 cfg_weight=sp.cfg_weight)


@pytest.fixture(scope="module")
def jax_tokens(mesh_run):
    """JAX's `t3_generate` tokens of a (family, mode) decode of the
    workers' params, on key DECODE_KEY, each computed once."""
    done = {}

    def tokens(fam, mode):
        if (fam, mode) not in done:
            hp, cond, text, sp, kw = W.decode_args(fam, mode == "greedy")
            done[fam, mode] = np.asarray(jax_generate(
                _jax_params(mesh_run, fam), JT3Config.tiny_test(fam), _jax_cond(cond),
                jnp.asarray(text.numpy(), jnp.int32), jnp.asarray(text.shape[1]),
                _jax_sampler(sp), jax.random.key(DECODE_KEY), max_new_tokens=W.DECODE_N,
                top_k=kw["top_k"], cfg_mode=kw["cfg_mode"], ignore_eos=True).tokens)
        return done[fam, mode]
    return tokens


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("fam", ["llama", "gpt2"])
def test_tp_decode_dp2_tp2_matches_jax(mesh_run, jax_tokens, fam, mode):
    """`t3_generate(shard_t3_params(params, mesh), ...)` at dp 2 x tp 2 (the
    JAX package's tests/test_parallel.py:61-92 with tiny llama and CFG;
    tiny GPT-2 without) gives the JAX package's unsharded `t3_generate`
    tokens exactly: greedy (min_p 1 with CFG, top_k 1 without), and sampled
    on JAX's own key splits replayed through `gumbel=` (every process
    checked its tokens equal to the others')."""
    got = mesh_run.res[f"tp_{fam}_{mode}"]
    np.testing.assert_array_equal(got, jax_tokens(fam, mode))
    assert len(set(got.tolist())) > 2


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("fam", ["llama", "gpt2"])
def test_tp_decode_dp2_tp2_equals_one_process(mesh_run, fam, mode):
    """The same tensor-parallel decodes give the port's one-process tokens
    on the same draws exactly. The quantized one-process paths are held to
    JAX by tests/test_torch_t3_llama.py::
    test_sampled_cfg_tokens_equal_with_jax_gumbel_draws and
    tests/test_torch_t3.py::test_sampled_tokens_equal_with_jax_gumbel_draws."""
    want = W.single_decode(fam, mode == "greedy", mesh_run.gumbel[fam])
    np.testing.assert_array_equal(mesh_run.res[f"tp_{fam}_{mode}"], want)
    assert len(set(want.tolist())) > 2


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("fam", ["llama", "gpt2"])
def test_one_process_decode_matches_jax(mesh_run, jax_tokens, fam, mode):
    """The workers' float params decoded in one process, on JAX's key
    splits replayed through `gumbel=` when sampled, give the JAX package's
    `t3_generate` tokens, with the tensor-parallel test's sampler."""
    got = W.single_decode(fam, mode == "greedy", mesh_run.gumbel[fam])
    np.testing.assert_array_equal(got, jax_tokens(fam, mode))


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_dp_batched_data4_equals_one_process(mesh_run, mode):
    """`t3_generate_batched(replicate(params), ..., shard_batch(cond),
    shard_batch(text), ...)` at data 4, 8 rows of tiny GPT-2 (two a
    process), rows of distinct text lengths and generators (the JAX
    package's tests/test_parallel.py:95-121): every row the one-process
    run's, and rows 0 and 3, the same input and generator seed, equal.
    The greedy rows are held to JAX's `t3_generate_batched` by the two
    tests below (JAX draws from keys, the port from torch generators, so
    only greedy rows compare)."""
    got = mesh_run.res[f"dp_{mode}"]
    assert got.shape == (W.BATCH_ROWS, 6)
    np.testing.assert_array_equal(got, W.single_batched(mode == "greedy"))
    np.testing.assert_array_equal(got[0], got[3])
    assert len({tuple(r) for r in got.tolist()}) >= W.BATCH_ROWS - 1


@pytest.fixture(scope="module")
def jax_batched_tokens(mesh_run):
    """JAX's greedy `t3_generate_batched` tokens of the data-parallel batch."""
    hp, cond, text, lens, _, kw = W.batched_args(greedy=True)
    return np.asarray(JB.t3_generate_batched(
        _jax_params(mesh_run, "gpt2"), JT3Config.tiny_test("gpt2"), _jax_cond(cond),
        jnp.asarray(text.numpy(), jnp.int32), jnp.asarray(lens, jnp.int32),
        JS.SamplerParams.make(), jax.random.split(jax.random.key(1), W.BATCH_ROWS),
        **kw).tokens)


def test_one_process_batched_matches_jax(jax_batched_tokens):
    np.testing.assert_array_equal(W.single_batched(greedy=True), jax_batched_tokens)


def test_dp_batched_data4_greedy_matches_jax(mesh_run, jax_batched_tokens):
    """The greedy data-parallel rows give JAX's unsharded batched tokens."""
    np.testing.assert_array_equal(mesh_run.res["dp_greedy"], jax_batched_tokens)


@pytest.mark.parametrize("step", [0, 1])
def test_real_batches_one_global_batch_on_every_process(mesh_run, step):
    """train_flow's `real_batches` in the 4-process world (C12): every
    process gets process 0's batch (token, token_len, feat, feat_len,
    embedding), and the processes' `local_rows` of it partition it."""
    got = W.read_batches(mesh_run.out)
    names = [f"{step}/{j}" for j in range(5)]
    for r in range(1, W.WORLD):
        for k in names:
            np.testing.assert_array_equal(got[r][k], got[0][k], err_msg=f"process {r}, {k}")
    for k in names:
        np.testing.assert_array_equal(np.concatenate([g[f"{k}/rows"] for g in got]), got[0][k])
    assert (got[0][f"{step}/1"] == W.WAV_TOKENS).all() and np.abs(got[0][f"{step}/2"]).max() > 0


# ---------------------------------------------------------------------------
# what a mesh refuses (a world of one, in this process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_mesh():
    return M.make_mesh(device_type="cpu")


@pytest.mark.parametrize("case", ["kv_int8", "fused_attn", "int8", "int8_fused",
                                  "batched_kv_int8", "batched_int8"])
def test_mesh_decode_refuses_what_jax_never_shards(one_mesh, case):
    """The JAX package's rules place float `w` / `b` leaves only and its
    decode keeps the Pallas attention off: the int8 cache, the
    decode-attention kernels and quantized params raise under a mesh."""
    hp, cond, text, sp, kw = W.decode_args("gpt2", greedy=True)
    if case == "int8_fused":            # widths the fused kernels take
        hp = dataclasses.replace(hp, backbone_name="GPT2_fused_test")
    params = t3m.t3_init(hp, seed=0, device="cpu")
    if case in ("int8", "int8_fused", "batched_int8"):
        params = quantize_t3_backbone(params, mode="int8_fused" if case == "int8_fused" else "int8")
    with pytest.raises(ValueError):
        if case.startswith("batched"):
            hp, cond, text, lens, gens, bkw = W.batched_args(greedy=True)
            t3_generate_batched(M.replicate(params, one_mesh), hp, M.shard_batch(cond, one_mesh),
                                M.shard_batch(text, one_mesh), lens, SamplerParams(), gens,
                                kv_int8=case == "batched_kv_int8", **bkw)
        else:
            t3_generate(M.shard_t3_params(params, one_mesh), hp, cond, text, sp,
                        kv_int8=case == "kv_int8", fused_attn=case == "fused_attn", **kw)


@pytest.mark.parametrize("fam", ["llama", "gpt2"])
def test_mesh_whose_model_axis_does_not_divide_the_heads_is_refused(fam):
    cfg = T3Config.tiny_test(fam).backbone           # 4 heads, 4 KV heads
    assert M.local_heads(cfg, _Mesh(2, 2)) == (2, 2)
    with pytest.raises(ValueError):
        M.local_heads(cfg, _Mesh(1, 3))
