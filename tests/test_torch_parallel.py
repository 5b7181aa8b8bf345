"""The port's (data, model) DTensor mesh (chatterbox_tpu_torch/parallel)
held against the JAX package's sharding rules, against the JAX package's
training steps and against the port's own single-process steps.

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
"""
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from chatterbox_tpu.convert.native_ckpt import load_pytree as jax_load_pytree  # noqa: E402
from chatterbox_tpu.models.s3gen import flow as jflow  # noqa: E402
from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.models.t3.config import T3Config as JT3Config  # noqa: E402
from chatterbox_tpu.parallel import mesh as jmesh  # noqa: E402
from chatterbox_tpu.parallel import train as jtrain  # noqa: E402

from chatterbox_tpu_torch.convert.native_ckpt import _flatten  # noqa: E402
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.models.t3.config import T3Config  # noqa: E402
from chatterbox_tpu_torch.parallel import mesh as M  # noqa: E402
from tests import test_torch_parallel_worker as W  # noqa: E402
from tests.test_torch_flow_train import jax_draws  # noqa: E402
from tests.test_torch_train import jax_key  # noqa: E402


def flow_key(i):
    return jax.random.key(100 + i)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    draws = [jax_draws(flow_key(i), W.B, W.FLOW_T_MEL) for i in range(W.STEPS)]
    return SimpleNamespace(res=W.spawn(out, draws), out=out)


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
