"""T3 fine-tuning loop: AdamW with warm-up + cosine decay and global-norm
clipping, layer-wise recomputation in the backward pass, a (data, model)
DTensor mesh, and checkpoints with full resume (the counterpart of
examples/train_t3.py).

  * `build_sharded_train_step`: the batch sharded over "data", the
    attention and MLP weights over "model" (parallel/mesh.py's rules);
  * checkpoints in --ckpt-dir: params.safetensors (the JAX package's keys
    and layouts, so either package's `load_pytree` reads it),
    opt_state.safetensors (Adam's moments and the update count) and
    step.npy; --resume restores all three and realigns the data stream.

The data is synthetic (random token batches with realistic length spreads)
so the loop runs anywhere; swap `synthetic_batches` for a real
(text_tokens, speech_tokens) source to fine-tune on speech.

Run (one card; the CPU with a tiny model; four cards as dp 2 x tp 2):
  python -m chatterbox_tpu_torch.examples.train_t3 --steps 100
  python -m chatterbox_tpu_torch.examples.train_t3 --device cpu --tiny --steps 20
  torchrun --nproc-per-node 4 -m chatterbox_tpu_torch.examples.train_t3 --dp 2
"""
import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def synthetic_batches(hp, batch: int, seed: int = 0, text_len: int = 48,
                      speech_len: int = 96):
    """Yields (cond, text, text_lens, speech, speech_lens) forever, CPU
    tensors drawn from the JAX runner's numpy stream."""
    from ..models.t3 import model as t3m
    rng = np.random.default_rng(seed)
    while True:
        tl = rng.integers(text_len // 2, text_len + 1, (batch,))
        sl = rng.integers(speech_len // 2, speech_len + 1, (batch,))
        text = np.zeros((batch, text_len), np.int32)
        speech = np.zeros((batch, speech_len), np.int32)
        v_speech = hp.speech_tokens_dict_size - 2   # keep clear of start/stop
        for i in range(batch):
            text[i, : tl[i]] = rng.integers(0, hp.text_tokens_dict_size, tl[i])
            speech[i, : sl[i]] = rng.integers(0, v_speech, sl[i])
        cond = t3m.T3CondTensors(
            speaker_emb=torch.from_numpy(rng.standard_normal((batch, 256)).astype(np.float32)),
            cond_prompt_speech_tokens=torch.from_numpy(rng.integers(
                0, v_speech, (batch, hp.speech_cond_prompt_len)).astype(np.int32)),
            emotion_adv=torch.from_numpy(0.5 * np.ones((batch, 1, 1), np.float32)),
        )
        yield (cond, torch.from_numpy(text), torch.from_numpy(tl.astype(np.int32)),
               torch.from_numpy(speech), torch.from_numpy(sl.astype(np.int32)))


def _to(batch, device):
    cond, *rest = batch
    return (type(cond)(*(None if t is None else t.to(device) for t in cond)),
            *(t.to(device) for t in rest))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dp", type=int, default=1, help="data-parallel size "
                    "(model axis gets the remaining devices)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--ckpt-dir", type=Path, default=Path(tempfile.gettempdir()) / "t3_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny_test config (CI / smoke); default: turbo 350M")
    ap.add_argument("--device", default="cuda",
                    help="torch device type to train on (default cuda; cpu for a "
                         "CPU run, with gloo between processes)")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from ..cli import _device
    from ..convert.native_ckpt import (load_into, load_optimizer, load_pytree,
                                       save_optimizer, save_pytree)
    from ..models.t3.config import T3Config
    from ..parallel.mesh import make_mesh
    from ..parallel.train import build_sharded_train_step

    device = torch.device(_device(args)).type
    hp = T3Config.tiny_test("llama") if args.tiny else T3Config.turbo()
    mesh = make_mesh(dp=args.dp, device_type=device)
    rank0 = dist.get_rank() == 0
    log = print if rank0 else (lambda *a, **k: None)
    log(f"mesh: {tuple(mesh.shape)} over {mesh.size()} devices; model: "
        f"{'tiny' if args.tiny else 'turbo'}", flush=True)

    step, init_state = build_sharded_train_step(
        hp, mesh, lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
        clip_norm=args.clip)
    state = init_state(0)
    batches = synthetic_batches(hp, args.batch)
    start = 0
    if args.resume and (args.ckpt_dir / "params.safetensors").exists():
        load_into(state.params, load_pytree(args.ckpt_dir / "params.safetensors",
                                            state.params, device=device))
        if (args.ckpt_dir / "opt_state.safetensors").exists():   # Adam moments + count
            load_optimizer(state, args.ckpt_dir / "opt_state.safetensors")
        start = int(np.load(args.ckpt_dir / "step.npy"))
        log(f"resumed from step {start}", flush=True)
        for _ in range(start):    # realign the synthetic data stream
            next(batches)

    t0 = time.perf_counter()
    for i in range(start, args.steps):
        state, metrics = step(state, *_to(next(batches), device))
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            lt = float(metrics["loss_text"])
            ls = float(metrics["loss_speech"])
            dt = time.perf_counter() - t0
            log(f"step {i+1:5d}  loss_text {lt:.4f}  loss_speech {ls:.4f}"
                f"  ({dt / (i + 1 - start):.2f} s/step)", flush=True)
        if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
            args.ckpt_dir.mkdir(parents=True, exist_ok=True)
            save_pytree(state.params, args.ckpt_dir / "params.safetensors")
            save_optimizer(state, args.ckpt_dir / "opt_state.safetensors")
            if rank0:
                np.save(args.ckpt_dir / "step.npy", i + 1)
    log(f"done: {args.steps - start} steps", flush=True)
    return state


if __name__ == "__main__":
    main()
