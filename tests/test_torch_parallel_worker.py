"""The port's sharded training steps and its decode over a mesh in a
4-process gloo world on the CPU, and the same runs in one process, for
tests/test_torch_parallel.py and chip_smoke.py's phase 11 (which runs them
under the card host's torch). It imports torch and the port only, so the
processes start light, and holds no tests.

`spawn(out, draws, gumbel)` writes the flow's random numbers, the decodes'
gumbel rows (when given) and WAVS clips to <out>, starts WORLD processes of
this module over a file store in <out> (no port is opened) and returns
process 0's results. Each process runs the sharded T3 steps at dp 2 x tp 2
(both tiny families), a save and resume of a sharded state, the flow step
at data = 4, `t3_generate` over `shard_t3_params` at dp 2 x tp 2 (tiny
llama with CFG, tiny GPT-2; greedy and on the given gumbel rows, else on
numpy-made ones), `t3_generate_batched` over `replicate` / `shard_batch` at
data = 4 (tiny GPT-2, 8 rows), and train_flow's `real_batches` on the WAVs
(process 0 alone loads; each process writes the two batches it got and its
`local_rows` of them to <out>/batches_<rank>.npz). Process 0 writes the
initial parameters (`<fam>_init.safetensors`, `flow_init.safetensors` in
the JAX package's layouts) and the results (<out>/mesh.npz). `single_t3` /
`single_flow` / `single_decode` / `single_batched` compute the same runs on
plain tensors in the calling process.

    RANK=r WORLD_SIZE=4 python -m tests.test_torch_parallel_worker <out dir>
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chatterbox_tpu_torch.convert.from_jax import flow_to_jax
from chatterbox_tpu_torch.convert.native_ckpt import (_flatten, load_into, load_optimizer,
                                                      load_pytree, save_optimizer,
                                                      save_pytree)
from chatterbox_tpu_torch.models.s3gen.flow import FlowDims, FlowDraws, flow_init
from chatterbox_tpu_torch.models.t3 import model as t3m
from chatterbox_tpu_torch.models.t3.config import T3Config
from chatterbox_tpu_torch.nn import core as nn
from chatterbox_tpu_torch.ops.sampling import SamplerParams
from chatterbox_tpu_torch.parallel import mesh as M
from chatterbox_tpu_torch.parallel import train as TR
from chatterbox_tpu_torch.sampling.batched import t3_generate_batched
from chatterbox_tpu_torch.sampling.decode import t3_generate
from chatterbox_tpu_torch.utils.audio_io import save_wav
from chatterbox_tpu_torch.utils.dtensor import full

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
LR, STEPS, B = 1e-3, 3, 4
OPT = dict(lr=LR, warmup_steps=1, total_steps=5, clip_norm=1.0)
FLOW_DIMS = FlowDims.tiny_test()
FLOW_T_MEL = 16                   # 8 tokens a row, 2 mel frames a token


# the decode runs: the JAX package's tensor-parallel test's arguments (8
# tokens, EOS ignored, temperature 0.8, min_p 0.05, repetition 1.2, top_p 1);
# greedy is min_p 1 with CFG, top_k 1 without, on zero draws
DECODE_N = 8
DECODE_SP = dict(temperature=0.8, top_p=1.0, repetition_penalty=1.2, min_p=0.05,
                 cfg_weight=0.5)
BATCH_ROWS, BATCH_LENS = 8, [6, 6, 9, 6, 3, 12, 7, 10]
BATCH_SEEDS = [11, 12, 13, 11, 15, 16, 17, 18]        # rows 0 and 3: the same seed
WAVS, WAV_TOKENS = 6, 8                               # real_batches: clips, tokens a row


def decode_args(fam: str, greedy: bool, draws=None):
    """(hp, cond, text, sampler, keywords) of the tensor-parallel decode of
    one tiny family, its conditioning and text from a numpy seed; sampled
    on `draws` (DECODE_N gumbel rows) or, without them, on rows from the
    same seed."""
    hp = T3Config.tiny_test(fam)
    rng = np.random.default_rng(20 if fam == "llama" else 21)
    cond = t3m.T3CondTensors(
        torch.from_numpy(rng.standard_normal((1, 256)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 6561, (1, hp.speech_cond_prompt_len))),
        torch.full((1, 1, 1), 0.5) if hp.emotion_adv else None)
    text = torch.from_numpy(rng.integers(1, hp.text_tokens_dict_size, (1, 10)))
    own = rng.gumbel(size=(DECODE_N, hp.speech_tokens_dict_size)).astype(np.float32)
    draws = own if draws is None else np.asarray(draws, np.float32)
    cfg = fam == "llama"
    sp = SamplerParams(**dict(DECODE_SP, min_p=1.0 if greedy and cfg else DECODE_SP["min_p"]))
    kw = dict(max_new_tokens=DECODE_N, ignore_eos=True, cfg_mode=cfg,
              top_k=1 if greedy and not cfg else 0,
              gumbel=torch.zeros(draws.shape) if greedy else torch.from_numpy(draws))
    return hp, cond, text, sp, kw


def batched_args(greedy: bool):
    """(hp, cond, text, lens, generators, keywords) of the data-parallel
    batched decode: tiny GPT-2, BATCH_ROWS rows from a numpy seed, row 3 a
    copy of row 0 with the same generator seed."""
    hp = T3Config.tiny_test("gpt2")
    rng = np.random.default_rng(22)
    spk = rng.standard_normal((BATCH_ROWS, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (BATCH_ROWS, hp.speech_cond_prompt_len))
    text = np.zeros((BATCH_ROWS, 16), np.int64)
    for i, n in enumerate(BATCH_LENS):
        text[i, :n] = rng.integers(1, hp.text_tokens_dict_size, n)
    for a in (spk, prompt, text):
        a[3] = a[0]
    cond = t3m.T3CondTensors(torch.from_numpy(spk), torch.from_numpy(prompt), None)
    gens = [torch.Generator().manual_seed(s) for s in BATCH_SEEDS]
    kw = dict(max_new_tokens=6, top_k=1 if greedy else 40, ignore_eos=True)
    return hp, cond, torch.from_numpy(text), list(BATCH_LENS), gens, kw


def single_decode(fam: str, greedy: bool, draws=None) -> np.ndarray:
    """The workers' tensor-parallel decode on plain tensors: the tokens."""
    hp, cond, text, sp, kw = decode_args(fam, greedy, draws)
    return t3_generate(t3m.t3_init(hp, seed=0, device="cpu"), hp, cond, text, sp,
                       **kw).tokens.numpy()


def single_batched(greedy: bool) -> np.ndarray:
    """The workers' data-parallel batched decode on plain tensors: the
    (BATCH_ROWS, 6) tokens."""
    hp, cond, text, lens, gens, kw = batched_args(greedy)
    return t3_generate_batched(t3m.t3_init(hp, seed=0, device="cpu"), hp, cond, text, lens,
                               SamplerParams(), gens, **kw).tokens.numpy()


def write_wavs(d: Path):
    """WAVS 24 kHz clips of 0.4-0.65 s, from a numpy seed."""
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(23)
    for i in range(WAVS):
        t = np.arange(9600 + 1200 * i) / 24000
        w = 0.3 * np.sin(2 * np.pi * (120 + 25 * i) * t) + 0.01 * rng.standard_normal(t.size)
        save_wav(d / f"{i}.wav", w.astype(np.float32), 24000)


def read_gumbel(out: Path) -> dict:
    """{family: gumbel rows} as `spawn` wrote them ({} when none were given)."""
    if not (out / "decode_draws.npz").exists():
        return {}
    with np.load(out / "decode_draws.npz") as z:
        return dict(z)


def read_batches(out: Path) -> list:
    """Each process's {name: array} of its two real_batches and its rows."""
    out_ = []
    for r in range(WORLD):
        with np.load(out / f"batches_{r}.npz") as z:
            out_.append(dict(z))
    return out_


def t3_batch(hp, seed):
    """A T3 batch of B rows, every length different, from a numpy seed."""
    rng = np.random.default_rng(seed)
    cond = t3m.T3CondTensors(
        torch.from_numpy(rng.standard_normal((B, 256)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 6561, (B, hp.speech_cond_prompt_len))),
        torch.full((B, 1, 1), 0.5) if hp.emotion_adv else None)
    text = torch.from_numpy(rng.integers(0, hp.text_tokens_dict_size, (B, 10)))
    speech = torch.from_numpy(rng.integers(0, 6561, (B, 12)))
    return cond, text, torch.tensor([10, 6, 3, 8]), speech, torch.tensor([12, 9, 5, 11])


def flow_batch(seed):
    rng = np.random.default_rng(seed)
    token = torch.from_numpy(rng.integers(0, 6561, (B, 8)))
    tl = torch.tensor([8, 6, 5, 8])
    feat = torch.from_numpy((0.3 * rng.standard_normal((B, 16, 80))).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((B, 192)).astype(np.float32))
    return token, tl, feat, 2 * tl, emb


def whole(params) -> dict:
    return {k: full(t).detach().numpy() for k, t in _flatten(params)}


def read_draws(out: Path) -> list:
    """The flow steps' FlowDraws, one a step, as `spawn` wrote them."""
    with np.load(out / "flow_draws.npz") as z:
        return [FlowDraws(*(torch.from_numpy(z[f"{i}/{f}"]) for f in FlowDraws._fields))
                for i in range(STEPS)]


def single_t3(fam: str):
    """The workers' T3 run in one process: the same seed's params, plain
    tensors, t3_train_step. Returns (losses (STEPS, 2), params)."""
    hp = T3Config.tiny_test(fam)
    opt = TR.make_optimizer(**OPT)
    st = opt.init(t3m.t3_init(hp, seed=0, device="cpu"))
    losses = []
    for i in range(STEPS):
        st, m = TR.t3_train_step(st, hp, opt, *t3_batch(hp, i))
        losses.append([float(m["loss_text"]), float(m["loss_speech"])])
    return np.array(losses), whole(st.params)


def single_flow(draws: list):
    """The workers' flow run in one process on the same draws. Returns
    (losses (STEPS,), params)."""
    opt = TR.make_optimizer(**OPT)
    st = opt.init(flow_init(nn.Init(0, "cpu"), meanflow=False, dims=FLOW_DIMS))
    losses = []
    for i in range(STEPS):
        st, m = TR.flow_train_step(st, opt, None, *flow_batch(i), FLOW_DIMS, draws=draws[i])
        losses.append(float(m["loss_cfm"]))
    return np.array(losses), whole(st.params)


def spawn(out: Path, draws: list, gumbel: dict = None, timeout: float = 240) -> dict:
    """Run WORLD processes of this module in `out` with the flow's `draws`
    (one FlowDraws a step, B rows of FLOW_T_MEL frames) and the sampled
    tensor-parallel decodes' `gumbel` rows ({family: (DECODE_N, vocab)};
    None: `decode_args`' own); process 0's results. Raises with a failed
    process's log."""
    np.savez(out / "flow_draws.npz", **{f"{i}/{f}": getattr(d, f).numpy()
                                        for i, d in enumerate(draws) for f in FlowDraws._fields})
    if gumbel is not None:
        np.savez(out / "decode_draws.npz", **gumbel)
    write_wavs(out / "wavs")
    env = dict(os.environ, WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_parallel_worker",
                               str(out)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise RuntimeError(f"mesh process {r} exited with {p.returncode}:\n{log[-3000:]}")
    with np.load(out / "mesh.npz") as z:
        return dict(z)


def main(out: Path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=int(os.environ["RANK"]), world_size=WORLD)
    mesh = M.make_mesh(device_type="cpu")          # 4 processes: dp 2 x tp 2
    rank0 = dist.get_rank() == 0
    res = {"mesh_shape": np.array(tuple(mesh.shape))}
    for fam in ("llama", "gpt2"):
        hp = T3Config.tiny_test(fam)
        step, init = TR.build_sharded_train_step(hp, mesh, **OPT)
        st = init(0)
        save_pytree(st.params, out / f"{fam}_init.safetensors")
        lay = st.params["backbone"]["layers"][0]
        for name in (("q", "o", "input_ln") if fam == "llama" else ("qkv", "attn_out", "ln1")):
            leaf = lay[name]["w" if "w" in lay[name] else "g"]
            res[f"{fam}_placement_{name}"] = np.array(repr(leaf.placements))
        losses = []
        for i in range(STEPS):
            st, m = step(st, *t3_batch(hp, i))
            losses.append([float(m["loss_text"]), float(m["loss_speech"])])
        res[f"{fam}_losses"] = np.array(losses)
        for k, v in whole(st.params).items():
            res[f"{fam}/{k}"] = v

    # a sharded llama state saved after 2 steps, loaded into a fresh sharded
    # state and stepped once more: the third step of the run above
    hp = T3Config.tiny_test("llama")
    step, init = TR.build_sharded_train_step(hp, mesh, **OPT)
    st = init(0)
    for i in range(2):
        st, _ = step(st, *t3_batch(hp, i))
    save_pytree(st.params, out / "params.safetensors")
    save_optimizer(st, out / "opt.safetensors")
    dist.barrier()
    st2 = init(1)
    load_into(st2.params, load_pytree(out / "params.safetensors", st2.params, device="cpu"))
    load_optimizer(st2, out / "opt.safetensors")
    res["resumed_step_count"] = np.array(st2.step)
    st2, m = step(st2, *t3_batch(hp, 2))
    res["resumed_losses"] = np.array([float(m["loss_text"]), float(m["loss_speech"])])
    for k, v in whole(st2.params).items():
        res[f"resumed/{k}"] = v

    try:
        M.shard_batch(torch.zeros(3, 2), mesh)
        res["odd_batch_refused"] = np.array(False)
    except ValueError:
        res["odd_batch_refused"] = np.array(True)

    fmesh = M.make_mesh(dp=4, device_type="cpu")
    step, init = TR.build_sharded_flow_train_step(FLOW_DIMS, fmesh, **OPT)
    st = init(0)
    save_pytree(flow_to_jax(st.params), out / "flow_init.safetensors")
    res["flow_placement"] = np.array(repr(st.params["encoder_proj"]["w"].placements))
    losses = []
    for i, draws in enumerate(read_draws(out)):
        st, m = step(st, None, *flow_batch(i), draws=draws)
        losses.append(float(m["loss_cfm"]))
    res["flow_losses"] = np.array(losses)
    for k, v in whole(st.params).items():
        res[f"flow/{k}"] = v

    # decoding over the meshes: tensor parallel at dp 2 x tp 2, data
    # parallel at data 4
    gumbel = read_gumbel(out)
    for fam in ("llama", "gpt2"):
        params = M.shard_t3_params(t3m.t3_init(T3Config.tiny_test(fam), seed=0, device="cpu"),
                                   mesh)
        for greedy in (True, False):
            hp, cond, text, sp, kw = decode_args(fam, greedy, gumbel.get(fam))
            res[f"tp_{fam}_{'greedy' if greedy else 'sampled'}"] = t3_generate(
                params, hp, cond, text, sp, **kw).tokens.numpy()
    params = M.replicate(t3m.t3_init(T3Config.tiny_test("gpt2"), seed=0, device="cpu"), fmesh)
    for greedy in (True, False):
        hp, cond, text, lens, gens, kw = batched_args(greedy)
        got = t3_generate_batched(params, hp, M.shard_batch(cond, fmesh),
                                  M.shard_batch(text, fmesh), lens, SamplerParams(), gens, **kw)
        res[f"dp_{'greedy' if greedy else 'sampled'}"] = got.tokens.numpy()

    # train_flow --data: one global batch a step, whatever order each
    # process's loader threads would deliver in
    from chatterbox_tpu_torch.examples.train_flow import real_batches
    from chatterbox_tpu_torch.models.s3gen.model import S3GenEngine, s3gen_init
    from chatterbox_tpu_torch.models.s3tok.model import S3TokenizerConfig
    engine = None
    if rank0:
        tok_cfg = S3TokenizerConfig.tiny_test()
        engine = S3GenEngine(s3gen_init(9, "cpu", meanflow=False, dims=FLOW_DIMS, hift_base=32,
                                        tok_cfg=tok_cfg),
                             dims=FLOW_DIMS, meanflow=False, tok_cfg=tok_cfg)
    batches = real_batches(out / "wavs", B, WAV_TOKENS, engine)
    mine = {}
    for i in range(2):
        batch = next(batches)
        for j, (t, r) in enumerate(zip(batch, M.local_rows(batch, fmesh))):
            mine[f"{i}/{j}"], mine[f"{i}/{j}/rows"] = t.numpy(), r.numpy()
    batches.close()
    np.savez(out / f"batches_{dist.get_rank()}.npz", **mine)
    if rank0:
        np.savez(out / "mesh.npz", **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]))
