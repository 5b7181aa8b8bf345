"""Flow training in the port (chatterbox_tpu_torch/models/s3gen/flow.py:
cfm_interpolate, flow_compute_loss; parallel/train.py: flow_train_step;
the train_flow runner) held against chatterbox_tpu on the JAX CPU backend:
tiny flows (FlowDims.tiny_test(), CFM and meanflow), JAX-initialised and
carried across with flow_from_jax, on batches drawn with numpy. JAX draws
its five random quantities from one key; the port takes them ready-made
through `draws=` (FlowDraws), computed here from JAX's key as JAX computes
them.

Tolerances: losses rtol 1e-5 (f32, summation order only); gradients 1e-4
of each leaf's largest |g| plus 1e-7 absolute (a key bias under softmax
has a zero gradient, computed as rounding noise); after Adam steps,
parameters within 2 lr x steps elementwise with the 99th percentile of the
difference under 1e-6 (tests/test_torch_train.py says why)."""
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.convert.native_ckpt import load_pytree as jax_load_pytree  # noqa: E402
from chatterbox_tpu.models.s3gen import flow as jflow  # noqa: E402
from chatterbox_tpu.parallel import train as jtrain  # noqa: E402

from chatterbox_tpu_torch.convert.from_jax import flow_from_jax, flow_to_jax  # noqa: E402
from chatterbox_tpu_torch.convert.native_ckpt import _flatten  # noqa: E402
from chatterbox_tpu_torch.examples import train_flow  # noqa: E402
from chatterbox_tpu_torch.models.s3gen import flow as F  # noqa: E402
from chatterbox_tpu_torch.parallel import train as TR  # noqa: E402
from chatterbox_tpu_torch.utils.dtensor import full  # noqa: E402
from chatterbox_tpu_torch.utils.audio_io import save_wav  # noqa: E402
from tests.test_torch_train import assert_adam_close, assert_grads_close, jax_key  # noqa: E402

JDIMS, DIMS = jflow.FlowDims.tiny_test(), F.FlowDims.tiny_test()


def models(meanflow=False):
    jp = jflow.flow_init(jax.random.key(0), meanflow=meanflow, dims=JDIMS)
    return jp, flow_from_jax(jax.tree.map(np.array, jp), DIMS, meanflow=meanflow, device="cpu")


def make_batch(B=3, T_tok=12, seed=0):
    """numpy (token, token_len, feat, feat_len, embedding), rows shorter
    than the pad."""
    rng = np.random.default_rng(seed)
    token = rng.integers(0, 50, (B, T_tok)).astype(np.int32)
    token_len = np.array([T_tok, T_tok - 4, T_tok - 7][:B], np.int32)
    feat = (0.3 * rng.standard_normal((B, 2 * T_tok, 80))).astype(np.float32)
    emb = rng.standard_normal((B, 192)).astype(np.float32)
    return token, token_len, feat, 2 * token_len, emb


def jax_draws(key, B, T_mel) -> F.FlowDraws:
    """JAX's draws inside flow_compute_loss for `key`, as port tensors."""
    k = jax.random.split(key, 5)
    u = lambda kk: jax.random.uniform(kk, (B,))
    arrs = (u(k[0]), u(k[1]), jax.random.uniform(k[2], (B,), jnp.float32),
            jax.random.normal(k[3], (B, T_mel, 80), jnp.float32), u(k[4]))
    return F.FlowDraws(*(torch.from_numpy(np.array(a)) for a in arrs))


def kw(batch, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return dict(zip(("token", "token_len", "feat", "feat_len", "embedding"), map(conv, batch)))


def port_loss_grads(params, batch, draws, remat=False, **extra):
    ps = [p.requires_grad_(True) for _, p in _flatten(params)]
    for p in ps:
        p.grad = None
    loss = F.flow_compute_loss(params, None, **kw(batch, "torch"), dims=DIMS, draws=draws,
                               remat=remat, **extra)
    loss.backward()
    return float(loss), {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                         .copy() for k, p in _flatten(params)}


def test_cfm_interpolate_matches_jax():
    rng = np.random.default_rng(3)
    x1, z = (rng.standard_normal((2, 10, 80)).astype(np.float32) for _ in range(2))
    t = rng.uniform(0, 1, 2).astype(np.float32)
    jy, ju = jflow.cfm_interpolate(jnp.asarray(x1), jnp.asarray(z), jnp.asarray(t), 1e-6)
    y, u = F.cfm_interpolate(*map(torch.from_numpy, (x1, z, t)), 1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("meanflow", [False, True])
def test_loss_and_grads_match_jax_on_its_draws(meanflow):
    jp, tp = models(meanflow)
    batch = make_batch()
    key = jax.random.key(3)

    def loss(p):
        return jflow.flow_compute_loss(p, key, **kw(batch, "jax"), dims=JDIMS)

    jl, jg = jax.jit(jax.value_and_grad(loss))(jp)
    got, grads = port_loss_grads(tp, batch, jax_draws(key, 3, 24))
    np.testing.assert_allclose(got, float(jl), rtol=1e-5)
    # the JAX tree holds conv weights (K, Cin, Cout): compare in its layout
    assert_grads_close({k: g.transpose(2, 1, 0) if g.ndim == 3 else g
                        for k, g in grads.items()}, jg)


def test_remat_equals_no_remat():
    _, tp = models()
    batch = make_batch(seed=1)
    draws = jax_draws(jax.random.key(4), 3, 24)
    a = port_loss_grads(tp, batch, draws)
    b = port_loss_grads(tp, batch, draws, remat=True)
    assert a[0] == b[0]
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k], err_msg=k)


def test_padding_invariance():
    """Garbage past each row's length (tokens and mels) moves nothing."""
    _, tp = models()
    token, tl, feat, fl, emb = make_batch(seed=2)
    draws = jax_draws(jax.random.key(2), 3, 24)
    token2, feat2 = token.copy(), feat.copy()
    for b in (1, 2):
        token2[b, tl[b]:] = 49
        feat2[b, 2 * tl[b]:] = 123.0
    with torch.no_grad():
        l1 = F.flow_compute_loss(tp, None, **kw((token, tl, feat, fl, emb), "torch"),
                                 dims=DIMS, draws=draws)
        l2 = F.flow_compute_loss(tp, None, **kw((token2, tl, feat2, fl, emb), "torch"),
                                 dims=DIMS, draws=draws)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)


def test_generator_draws_in_order():
    """A generator's draws are FlowDraws in JAX's order and shapes; the same
    seed gives the same loss."""
    _, tp = models()
    batch = make_batch(seed=5)
    d = F.draw_flow_noise(torch.Generator().manual_seed(9), 3, 24)
    assert [tuple(t.shape) for t in d] == [(3,), (3,), (3,), (3, 24, 80), (3,)]
    with torch.no_grad():
        a = F.flow_compute_loss(tp, torch.Generator().manual_seed(9), **kw(batch, "torch"),
                                dims=DIMS)
        b = F.flow_compute_loss(tp, None, **kw(batch, "torch"), dims=DIMS, draws=d)
    assert float(a) == float(b) and np.isfinite(float(a))


def test_overfits_one_batch():
    """AdamW steps on one fixed batch and fixed draws lower the loss."""
    _, tp = models()
    batch = make_batch(B=2, T_tok=8, seed=0)
    draws = jax_draws(jax.random.key(7), 2, 16)
    opt = TR.make_optimizer(3e-3)
    st = opt.init(tp)
    losses = []
    for _ in range(12):
        st, m = TR.flow_train_step(st, opt, None, *map(torch.from_numpy, batch), DIMS,
                                   remat=False, draws=draws)
        losses.append(float(m["loss_cfm"]))
    assert losses[-1] < 0.9 * losses[0], losses


def test_three_steps_match_optax():
    lr, steps = 1e-3, 3
    jp, tp = models()
    okw = dict(warmup_steps=1, total_steps=4, clip_norm=1.0)
    jopt, opt = jtrain.make_optimizer(lr, **okw), TR.make_optimizer(lr, **okw)
    js, st = jtrain.TrainState(jp, jopt.init(jp)), opt.init(tp)
    jstep = jax.jit(lambda s, k, *a: jtrain.flow_train_step(s, jopt, k, *a, JDIMS))
    for i in range(steps):
        batch = make_batch(seed=20 + i)
        key = jax.random.key(1000 + i)
        js, jm = jstep(js, key, *map(jnp.asarray, batch))
        st, m = TR.flow_train_step(st, opt, None, *map(torch.from_numpy, batch), DIMS,
                                   draws=jax_draws(key, 3, 24))
        np.testing.assert_allclose(float(m["loss_cfm"]), float(jm["loss_cfm"]), rtol=1e-5)
    want = {jax_key(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(js.params)[0]}
    got = {k: v.detach().numpy() for k, v in _flatten(flow_to_jax(st.params))}
    assert_adam_close(got, want, lr, steps)


def test_flow_converters_round_trip_and_check_the_schema():
    jp, tp = models(meanflow=True)
    back = flow_to_jax(tp)
    for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        leaf = back
        for p in path:
            leaf = leaf[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(v), err_msg=jax_key(path))
    bad = jax.tree.map(np.array, jp)
    del bad["decoder"]["time_mixer"]
    with pytest.raises(KeyError, match="time_mixer"):
        flow_from_jax(bad, DIMS, meanflow=True, device="cpu")
    with pytest.raises(KeyError, match="time_mixer"):
        flow_from_jax(jax.tree.map(np.array, jp), DIMS, meanflow=False, device="cpu")


# ---------------------------------------------------------------------------
# the runner, in process on the CPU
# ---------------------------------------------------------------------------

RUN = ["--device", "cpu", "--tiny", "--batch", "2", "--tokens", "8", "--warmup", "1"]


def test_train_flow_runner_saves_and_resumes(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    first = train_flow.main(RUN + ["--steps", "2", "--ckpt-dir", str(ckpt)])
    out = capsys.readouterr().out
    assert "mesh: data=1  dims=tiny" in out and f"saved checkpoint to {ckpt}" in out
    assert re.search(r"step +1  loss_cfm \d+\.\d+", out), out
    saved = {k: full(v).detach().numpy().copy() for k, v in _flatten(first.params)}
    # the JAX package reads flow.safetensors into its own flow tree
    jloaded = jax_load_pytree(ckpt / "flow.safetensors",
                              jflow.flow_init(jax.random.key(5), dims=JDIMS))
    jport = {k: full(v).detach().numpy() for k, v in _flatten(flow_to_jax(first.params))}
    for path, v in jax.tree_util.tree_flatten_with_path(jloaded)[0]:
        np.testing.assert_array_equal(np.asarray(v), jport[jax_key(path)])

    # as the JAX runner does, a resumed run takes --steps more steps, its
    # schedule read from the restored update count (here 2, 3, 4 of 3 steps:
    # half the peak rate, then 0)
    resumed = train_flow.main(RUN + ["--steps", "3", "--resume", "--ckpt-dir", str(ckpt)])
    out = capsys.readouterr().out
    assert f"resumed from {ckpt}" in out, out
    assert resumed.step == 5
    moved = max(np.abs(full(v).detach().numpy() - saved[k]).max()
                for k, v in _flatten(resumed.params))
    assert 0 < moved <= 1e-4


def test_train_flow_runner_reads_wavs(tmp_path, capsys):
    data = tmp_path / "wavs"
    data.mkdir()
    rng = np.random.default_rng(0)
    t = np.arange(24000) / 24000
    for i in range(3):
        w = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.01 * rng.standard_normal(t.size)
        save_wav(data / f"{i}.wav", w.astype(np.float32), 24000)
    st = train_flow.main(RUN + ["--steps", "2", "--data", str(data),
                                "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "data: 3 wavs (native loader: " in out, out
    losses = [float(x) for x in re.findall(r"loss_cfm (\d+\.\d+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses)) and st.step == 2
