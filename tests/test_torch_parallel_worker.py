"""The port's sharded training steps in a 4-process gloo world on the CPU,
and the same steps in one process, for tests/test_torch_parallel.py and
chip_smoke.py's phase 11 (which runs them under the card host's torch). It
imports torch and the port only, so the processes start light, and holds
no tests.

`spawn(out, draws)` writes the flow's random numbers to <out>, starts WORLD
processes of this module over a file store in <out> (no port is opened)
and returns process 0's results. Each process runs the sharded T3 steps at
dp 2 x tp 2 (both tiny families), a save and resume of a sharded state,
and the flow step at data = 4; process 0 writes the initial parameters
(`<fam>_init.safetensors`, `flow_init.safetensors` in the JAX package's
layouts) and the results (<out>/mesh.npz). `single_t3` / `single_flow`
compute the same runs on plain tensors in the calling process.

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
from chatterbox_tpu_torch.parallel import mesh as M
from chatterbox_tpu_torch.parallel import train as TR
from chatterbox_tpu_torch.utils.dtensor import full

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
LR, STEPS, B = 1e-3, 3, 4
OPT = dict(lr=LR, warmup_steps=1, total_steps=5, clip_norm=1.0)
FLOW_DIMS = FlowDims.tiny_test()
FLOW_T_MEL = 16                   # 8 tokens a row, 2 mel frames a token


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


def spawn(out: Path, draws: list, timeout: float = 240) -> dict:
    """Run WORLD processes of this module in `out` with the flow's `draws`
    (one FlowDraws a step, B rows of FLOW_T_MEL frames); process 0's
    results. Raises with a failed process's log."""
    np.savez(out / "flow_draws.npz", **{f"{i}/{f}": getattr(d, f).numpy()
                                        for i, d in enumerate(draws) for f in FlowDraws._fields})
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
    if rank0:
        np.savez(out / "mesh.npz", **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]))
