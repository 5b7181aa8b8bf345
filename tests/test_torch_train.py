"""T3 training in the port (chatterbox_tpu_torch: backbone_train, t3_forward
/ t3_loss, the AdamW step with optax's schedule and clipping, the train_t3
runner) held against chatterbox_tpu on the JAX CPU backend: tiny T3s of
both families (GPT-2 with learned wpe; llama with RoPE, perceiver, emotion
input and learned positions), JAX-initialised and carried across with
t3_from_jax, on batches drawn with numpy.

Tolerances: logits and losses rtol 1e-5 (f32, summation order only);
gradients 1e-4 of each leaf's largest |g|, plus 1e-7 absolute for leaves
whose true gradient is zero and whose computed one is rounding noise (a
key bias under softmax). After Adam steps, parameters within 2 lr x steps
elementwise (Adam moves a noise-gradient element by up to lr a step, in
the direction the noise's sign gives) with the 99th percentile of the
difference under 1e-6."""
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.convert.native_ckpt import load_pytree as jax_load_pytree  # noqa: E402
from chatterbox_tpu.models.t3 import model as jt3m  # noqa: E402
from chatterbox_tpu.models.t3.config import T3Config as JT3Config  # noqa: E402
from chatterbox_tpu.parallel import train as jtrain  # noqa: E402

from chatterbox_tpu_torch.convert.from_jax import t3_from_jax  # noqa: E402
from chatterbox_tpu_torch.convert.native_ckpt import _flatten  # noqa: E402
from chatterbox_tpu_torch.examples import train_t3  # noqa: E402
from chatterbox_tpu_torch.models.t3 import backbone as bb  # noqa: E402
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.models.t3.config import T3Config  # noqa: E402
from chatterbox_tpu_torch.parallel import train as TR  # noqa: E402
from chatterbox_tpu_torch.utils.dtensor import full  # noqa: E402

FAMS = ["gpt2", "llama"]
LENS = np.array([10, 6, 3]), np.array([12, 9, 5])


def jax_key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def models(fam):
    """(JAX hp, port hp, JAX params, port params carried across; copies,
    since a CPU tensor from numpy shares its memory and training writes
    in place)."""
    jhp, hp = JT3Config.tiny_test(fam), T3Config.tiny_test(fam)
    jp = jt3m.t3_init(jax.random.key(0), jhp)
    return jhp, hp, jp, t3_from_jax(jax.tree.map(np.array, jp), hp, device="cpu")


def batch(hp, seed, B=3):
    """The same batch for both packages: (JAX args, port args) after the
    params, each (cond, text, text_lens, speech, speech_lens)."""
    rng = np.random.default_rng(seed)
    spk = rng.standard_normal((B, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (B, hp.speech_cond_prompt_len))
    emo = np.full((B, 1, 1), 0.3 + 0.2 * seed, np.float32)
    text = rng.integers(0, hp.text_tokens_dict_size, (B, 10))
    speech = rng.integers(0, 6561, (B, 12))
    tl, sl = LENS
    jc = jt3m.T3CondArrays(jnp.asarray(spk), jnp.asarray(prompt, jnp.int32),
                           jnp.asarray(emo) if hp.emotion_adv else None)
    tc = t3m.T3CondTensors(torch.from_numpy(spk), torch.from_numpy(prompt),
                           torch.from_numpy(emo) if hp.emotion_adv else None)
    i32 = lambda a: jnp.asarray(a, jnp.int32)
    return ((jc, i32(text), i32(tl), i32(speech), i32(sl)),
            (tc, torch.from_numpy(text), torch.from_numpy(tl), torch.from_numpy(speech),
             torch.from_numpy(sl)))


def port_grads(params, hp, args, remat=False):
    ps = [p.requires_grad_(True) for _, p in _flatten(params)]
    for p in ps:
        p.grad = None
    lt, ls = t3m.t3_loss(params, hp, *args, remat=remat)
    (lt + ls).backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
             for k, p in _flatten(params)}
    return float(lt), float(ls), grads


def assert_grads_close(got: dict, jgrads):
    flat = {jax_key(p): np.asarray(g) for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(flat) == set(got)
    for k, g in flat.items():
        tol = 1e-4 * np.abs(g).max() + 1e-7
        np.testing.assert_allclose(got[k], g, rtol=0, atol=tol, err_msg=k)


def assert_adam_close(got: dict, want: dict, lr: float, steps: int):
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert d.max() <= 2 * lr * steps, d.max()
    assert np.percentile(d, 99) < 1e-6, np.percentile(d, 99)


@pytest.mark.parametrize("fam", FAMS)
def test_forward_logits_and_losses_match_jax(fam):
    jhp, hp, jp, tp = models(fam)
    jargs, targs = batch(hp, 0)
    jtl, jsl = jax.jit(lambda p, *a: jt3m.t3_forward(p, jhp, *a))(jp, jargs[0], jargs[1],
                                                                   jargs[3])
    with torch.no_grad():
        tl, sl = t3m.t3_forward(tp, hp, targs[0], targs[1], targs[3])
        lt, ls = t3m.t3_loss(tp, hp, *targs)
    for got, want in ((tl, jtl), (sl, jsl)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    jlt, jls = jax.jit(lambda p, *a: jt3m.t3_loss(p, jhp, *a))(jp, *jargs)
    np.testing.assert_allclose([float(lt), float(ls)], [float(jlt), float(jls)], rtol=1e-5)


@pytest.mark.parametrize("fam", FAMS)
def test_backbone_train_equals_the_cached_forward(fam):
    """The cache-free training pass computes what backbone_apply computes
    over a fresh float32 cache from offset 0 (the JAX training forward)."""
    _, hp, _, tp = models(fam)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 17, 64))
                         .astype(np.float32))
    cfg = hp.backbone
    with torch.no_grad():
        got = bb.backbone_train(tp["backbone"], cfg, x)
        cache = bb.KVCache.zeros(cfg, 2, 17, "cpu", dtype=torch.float32)
        want = bb.backbone_apply(tp["backbone"], cfg, x, torch.arange(17)[None].expand(2, 17),
                                 cache, 0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fam", FAMS)
def test_grads_match_jax(fam):
    jhp, hp, jp, tp = models(fam)
    jargs, targs = batch(hp, 1)

    def loss(p):
        lt, ls = jt3m.t3_loss(p, jhp, *jargs)
        return lt + ls

    jl, jg = jax.jit(jax.value_and_grad(loss))(jp)
    lt, ls, grads = port_grads(tp, hp, targs)
    np.testing.assert_allclose(lt + ls, float(jl), rtol=1e-5)
    assert_grads_close(grads, jg)


@pytest.mark.parametrize("fam", FAMS)
def test_remat_equals_no_remat(fam):
    _, hp, _, tp = models(fam)
    _, targs = batch(hp, 2)
    a = port_grads(tp, hp, targs, remat=False)
    b = port_grads(tp, hp, targs, remat=True)
    assert a[:2] == b[:2]
    for k in a[2]:
        np.testing.assert_array_equal(a[2][k], b[2][k], err_msg=k)


def test_training_refuses_quantized_params():
    _, hp, _, tp = models("gpt2")
    x = torch.zeros(1, 4, 64)
    lp = tp["backbone"]["layers"][0]
    w = lp["qkv"]["w"]
    int8 = dict(lp, qkv={"w_q": w.to(torch.int8), "w_scale": torch.ones(w.shape[1]),
                         "b": lp["qkv"]["b"]})
    with pytest.raises(ValueError, match="quantized"):
        bb.backbone_train(dict(tp["backbone"], layers=[int8]), hp.backbone, x)
    fused = dict(tp["backbone"], layers=[dict(lp, fused={})])
    with pytest.raises(ValueError, match="fused"):
        bb.backbone_train(fused, hp.backbone, x)


@pytest.mark.parametrize("fam", FAMS)
def test_three_steps_match_optax(fam):
    """Warm-up 1 (the first update at lr 0), cosine to step 4, clipping at
    1.0 (these grads reach it)."""
    lr, steps = 1e-3, 3
    jhp, hp, jp, tp = models(fam)
    kw = dict(warmup_steps=1, total_steps=4, clip_norm=1.0)
    jopt, opt = jtrain.make_optimizer(lr, **kw), TR.make_optimizer(lr, **kw)
    js, st = jtrain.TrainState(jp, jopt.init(jp)), opt.init(tp)
    jstep = jax.jit(lambda s, *a: jtrain.t3_train_step(s, jhp, jopt, *a))
    for i in range(steps):
        jargs, targs = batch(hp, 10 + i)
        js, jm = jstep(js, *jargs)
        st, m = TR.t3_train_step(st, hp, opt, *targs)
        np.testing.assert_allclose([float(m["loss_text"]), float(m["loss_speech"])],
                                   [float(jm["loss_text"]), float(jm["loss_speech"])], rtol=1e-5)
        assert st.step == i + 1
        assert st.adamw.param_groups[0]["lr"] == opt.schedule(i)
    want = {jax_key(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(js.params)[0]}
    assert_adam_close({k: p.detach().numpy() for k, p in _flatten(st.params)}, want, lr, steps)
    moved = np.abs(want["text_head/w"] - np.asarray(jp["text_head"]["w"])).max()
    assert moved > 1e-4          # the steps did move the weights


@pytest.mark.parametrize("lr,warmup,total", [(1e-4, 10, 100), (3e-3, 3, 10), (1e-3, 0, 7),
                                             (2e-4, 5, 0), (1e-3, 0, 0)])
def test_schedule_matches_optax(lr, warmup, total):
    """The rate of the update after `count` updates, count 0 included (0
    with a warm-up), against the JAX package's optax chain as it builds it."""
    opt = TR.make_optimizer(lr, warmup_steps=warmup, total_steps=total)
    if warmup or total:
        sched = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr, warmup_steps=max(warmup, 1),
            decay_steps=max(total, warmup + 1))
        want = [float(sched(c)) for c in range(total + 3)]
    else:
        want = [lr] * 5
    got = [opt.schedule(c) for c in range(len(want))]
    # the same float32 arithmetic; XLA's cos and numpy's differ by an ulp or two
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)
    if warmup:
        assert got[0] == 0.0


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_matches_optax(scale):
    """Below the bound the gradients pass; above it each is divided by the
    global norm and multiplied by the bound, as optax.clip_by_global_norm."""
    rng = np.random.default_rng(0)
    grads = [(scale * rng.standard_normal(s)).astype(np.float32) for s in ((5, 7), (3,), (2, 2, 4))]
    tx = optax.clip_by_global_norm(1.0)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(grads))
    np.testing.assert_allclose(float(TR.global_norm([torch.from_numpy(g) for g in grads])),
                               float(optax.global_norm(grads)), rtol=1e-6)
    params = {"a": torch.zeros(5, 7), "b": torch.zeros(3), "c": torch.zeros(2, 2, 4)}
    opt = TR.make_optimizer(1.0, weight_decay=0.0, clip_norm=1.0)
    st = opt.init(params)
    for p, g in zip(TR.leaves(params), grads):
        p.grad = torch.from_numpy(g.copy())
    seen = {}
    st.adamw.step = lambda: seen.update({id(p): p.grad.clone() for p in TR.leaves(params)})
    opt.update(st)
    for p, w in zip(TR.leaves(params), want):
        np.testing.assert_allclose(seen[id(p)].numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_a_leaf_the_loss_does_not_reach_decays_as_optax():
    """A leaf without a gradient still decays by lr wd p and its moments
    age: optax sees a zero gradient there."""
    w = np.random.default_rng(3).standard_normal((4, 3)).astype(np.float32)
    jparams = {"used": jnp.asarray(w), "unused": jnp.asarray(w)}
    tx = optax.adamw(1e-2, weight_decay=0.1)
    jst = tx.init(jparams)
    params = {"used": torch.from_numpy(w.copy()), "unused": torch.from_numpy(w.copy())}
    opt = TR.make_optimizer(1e-2, weight_decay=0.1)
    st = opt.init(params)
    for _ in range(2):
        g = jax.grad(lambda p: jnp.sum(p["used"] ** 2))(jparams)
        upd, jst = tx.update(g, jst, jparams)
        jparams = optax.apply_updates(jparams, upd)
        (params["used"] ** 2).sum().backward()
        opt.update(st)
    for k in params:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jparams[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# the runner, in process on the CPU
# ---------------------------------------------------------------------------

RUN = ["--device", "cpu", "--tiny", "--batch", "2", "--warmup", "1"]


class _Crash(Exception):
    pass


def test_train_t3_runner_checkpoints_and_resumes(tmp_path, capsys, monkeypatch):
    """A 5-step run that dies after its step-3 checkpoint, resumed to 5,
    ends where an uninterrupted 5-step run ends (the same schedule over 5
    steps, the data stream realigned)."""
    ckpt = tmp_path / "ckpt"
    stream = train_t3.synthetic_batches

    def dies_after_3(*a, **k):
        it = stream(*a, **k)
        for _ in range(3):
            yield next(it)
        raise _Crash

    monkeypatch.setattr(train_t3, "synthetic_batches", dies_after_3)
    with pytest.raises(_Crash):
        train_t3.main(RUN + ["--steps", "5", "--ckpt-every", "3", "--ckpt-dir", str(ckpt)])
    monkeypatch.undo()
    out = capsys.readouterr().out
    assert "mesh: (1, 1) over 1 devices; model: tiny" in out
    for f in ("params.safetensors", "opt_state.safetensors", "step.npy"):
        assert (ckpt / f).exists(), f
    assert int(np.load(ckpt / "step.npy")) == 3

    resumed = train_t3.main(RUN + ["--steps", "5", "--ckpt-every", "5", "--resume",
                                   "--ckpt-dir", str(ckpt)])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "done: 2 steps" in out, out
    m = re.search(r"step +5  loss_text (\d+\.\d+)  loss_speech (\d+\.\d+)", out)
    assert m and float(m.group(1)) > 0 and float(m.group(2)) > 0, out
    whole = train_t3.main(RUN + ["--steps", "5", "--ckpt-every", "5",
                                 "--ckpt-dir", str(tmp_path / "whole")])
    assert "done: 5 steps" in capsys.readouterr().out
    for (k, a), (_, b) in zip(_flatten(resumed.params), _flatten(whole.params)):
        np.testing.assert_array_equal(full(a).detach().numpy(), full(b).detach().numpy(),
                                      err_msg=k)

    # the JAX package reads the port's checkpoint into its own tree
    jtemplate = jt3m.t3_init(jax.random.key(1), JT3Config.tiny_test("llama"))
    jloaded = jax_load_pytree(ckpt / "params.safetensors", jtemplate)
    got = {jax_key(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jloaded)[0]}
    for k, p in _flatten(resumed.params):
        np.testing.assert_array_equal(got[k], full(p).detach().numpy(), err_msg=k)


def test_runners_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from chatterbox_tpu_torch.examples import train_flow
    for main in (train_t3.main, train_flow.main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["--tiny", "--steps", "1"])
