"""S3Gen flow fine-tuning loop: the masked CFM loss and a data-parallel
AdamW step over a DTensor mesh (the counterpart of examples/train_flow.py).

  * `build_sharded_flow_train_step`: params replicated, the batch sharded
    over "data" (every process of the world), the encoder and estimator
    recomputed in the backward pass;
  * per-row random conditioning prefixes and classifier-free dropout, as
    the reference trains;
  * checkpoints in --ckpt-dir: flow.safetensors (the JAX package's keys and
    layouts) and opt.safetensors (Adam's moments and the update count).

The data is synthetic ((token, mel) pairs with realistic length spreads)
unless --data names a directory of 24 kHz WAVs: the native loader
(runtime/) prefetches clips while the device extracts S3 tokens, 24 kHz
mels and the CAMPPlus x-vector with the port's frontend; over several
processes, process 0 alone loads and featurizes each batch and broadcasts
it, so every process cuts its rows from one global batch.

Run (one card; the CPU with tiny dims):
  python -m chatterbox_tpu_torch.examples.train_flow --steps 100
  python -m chatterbox_tpu_torch.examples.train_flow --device cpu --tiny --steps 20
"""
import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def synthetic_batches(batch: int, t_tok: int, seed: int = 0):
    """Yields (token, token_len, feat, feat_len, embedding) forever, CPU
    tensors drawn from the JAX runner's numpy stream."""
    rng = np.random.default_rng(seed)
    while True:
        tl = rng.integers(t_tok // 2, t_tok + 1, (batch,)).astype(np.int32)
        token = np.zeros((batch, t_tok), np.int32)
        for i in range(batch):
            token[i, : tl[i]] = rng.integers(0, 6561, tl[i])
        feat = rng.standard_normal((batch, 2 * t_tok, 80)).astype(np.float32)
        emb = rng.standard_normal((batch, 192)).astype(np.float32)
        yield (torch.from_numpy(token), torch.from_numpy(tl), torch.from_numpy(feat),
               torch.from_numpy(2 * tl), torch.from_numpy(emb))


def real_batches(data_dir, batch: int, t_tok: int, engine, sr_expect=None):
    """Batches from a directory of WAVs at sr_expect (24 kHz by default):
    the native threaded loader prefetches clips while the card extracts the
    features (S3 tokens at 16 kHz, 24 kHz mels, the CAMPPlus x-vector), each
    clip cropped to t_tok tokens of audio. In a world of several processes
    one global batch a step, as the JAX runner feeds it: process 0 alone
    loads and featurizes (`engine` may be None elsewhere) and broadcasts
    the batch's five CPU tensors to every process. Closing the generator
    stops the loader's threads."""
    import torch.distributed as dist
    from ..audio.mels import mel_spectrogram_24k
    from ..audio.resample import resample
    from ..models.s3gen.campplus import campplus_embed_wav
    from ..models.s3gen.model import S3GEN_SR
    from ..models.s3tok.model import S3_SR
    from ..nn import core as nn
    from ..runtime import WavLoader

    paths = sorted(Path(data_dir).rglob("*.wav"))
    if not paths:
        raise SystemExit(f"no .wav files under {data_dir}")
    shared = dist.is_initialized() and dist.get_world_size() > 1
    if shared and dist.get_rank() != 0:
        while True:
            out = (torch.empty((batch, t_tok), dtype=torch.int32),
                   torch.empty((batch,), dtype=torch.int32),
                   torch.empty((batch, 2 * t_tok, 80)),
                   torch.empty((batch,), dtype=torch.int32),
                   torch.empty((batch, 192)))
            for t in out:
                dist.broadcast(t, 0)
            yield out
    max_frames = int(t_tok / 25 * 48000) + 48000   # generous native-rate cap
    loader = WavLoader(paths, n_threads=4, max_frames=max_frames, epochs=1_000_000, seed=0)
    print(f"data: {len(paths)} wavs (native loader: {loader.native})", flush=True)
    dev = engine.device

    @torch.no_grad()
    def one(wav):
        sr = sr_expect or 24000
        wav = torch.from_numpy(wav).to(dev)
        with nn.no_tf32_convs():
            w16 = resample(wav, sr, S3_SR)[: t_tok * (S3_SR // 25)]
            w24 = resample(wav, sr, S3GEN_SR)[: t_tok * (S3GEN_SR // 25)]
            feat = mel_spectrogram_24k(w24[None]).transpose(1, 2)
            emb = campplus_embed_wav(engine.params["speaker_encoder"], w16[None])
        tok, tl = engine.tokenize(w16.cpu().numpy())
        return tok[0], int(tl[0]), feat[0].cpu().numpy(), emb[0].cpu().numpy()

    it = iter(loader)
    try:
        while True:
            token = np.zeros((batch, t_tok), np.int32)
            tlens = np.zeros((batch,), np.int32)
            feat = np.zeros((batch, 2 * t_tok, 80), np.float32)
            emb = np.zeros((batch, 192), np.float32)
            for b in range(batch):
                wav, _ = next(it)
                tk, tl, ft, em = one(wav)
                n = min(tl, t_tok)
                token[b, :n] = tk[:n]
                tlens[b] = n
                feat[b, : min(len(ft), 2 * t_tok)] = ft[: 2 * t_tok]
                emb[b] = em
            out = (torch.from_numpy(token), torch.from_numpy(tlens), torch.from_numpy(feat),
                   torch.from_numpy(2 * tlens), torch.from_numpy(emb))
            if shared:
                for t in out:
                    dist.broadcast(t, 0)
            yield out
    finally:
        loader.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny dims (CPU-fast; omit for the real S3Gen size)")
    ap.add_argument("--data", type=Path, default=None,
                    help="directory of 24 kHz WAVs — real features via the "
                         "native prefetching loader (default: synthetic)")
    ap.add_argument("--ckpt-dir", type=Path, default=Path(tempfile.gettempdir()) / "flow_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device type to train on (default cuda; cpu for a "
                         "CPU run, with gloo between processes)")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from ..cli import _device
    from ..convert.from_jax import flow_from_jax, flow_to_jax
    from ..convert.native_ckpt import (load_into, load_optimizer, load_pytree,
                                       save_optimizer, save_pytree)
    from ..models.s3gen.flow import FlowDims
    from ..parallel.mesh import init_world, make_mesh
    from ..parallel.train import build_sharded_flow_train_step

    device = torch.device(_device(args)).type
    dims = FlowDims.tiny_test() if args.tiny else FlowDims()
    init_world(device)
    mesh = make_mesh(dp=dist.get_world_size(), device_type=device)
    log = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    log(f"mesh: data={mesh.size()}  dims={'tiny' if args.tiny else 'full'}", flush=True)

    step, init_state = build_sharded_flow_train_step(
        dims, mesh, lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
        clip_norm=1.0)
    state = init_state(0)

    p_path = args.ckpt_dir / "flow.safetensors"
    o_path = args.ckpt_dir / "opt.safetensors"
    if args.resume and p_path.exists():
        tree = load_pytree(p_path, flow_to_jax(state.params), device="cpu")
        load_into(state.params, flow_from_jax(tree, dims, meanflow=False, device="cpu"))
        load_optimizer(state, o_path)
        log(f"resumed from {args.ckpt_dir}", flush=True)

    if args.data is not None:
        from ..models.s3gen.model import S3GenEngine, s3gen_init
        from ..models.s3tok.model import S3TokenizerConfig
        tok_cfg = S3TokenizerConfig.tiny_test() if args.tiny else S3TokenizerConfig()
        engine = None
        if dist.get_rank() == 0:        # the one process that featurizes
            engine = S3GenEngine(s3gen_init(9, device, meanflow=False, dims=dims,
                                            tok_cfg=tok_cfg),
                                 dims=dims, meanflow=False, tok_cfg=tok_cfg)
        batches = real_batches(args.data, args.batch, args.tokens, engine)
    else:
        batches = synthetic_batches(args.batch, args.tokens)
    try:
        t0 = time.perf_counter()
        for i in range(args.steps):
            token, tl, feat, fl, emb = (t.to(device) for t in next(batches))
            gen = torch.Generator(device).manual_seed(1000 + i)
            state, metrics = step(state, gen, token, tl, feat, fl, emb)
            if i % 10 == 0 or i == args.steps - 1:
                log(f"step {i:4d}  loss_cfm {float(metrics['loss_cfm']):.4f}  "
                    f"({(time.perf_counter() - t0) / (i + 1):.2f} s/step)", flush=True)
    finally:
        batches.close()

    args.ckpt_dir.mkdir(parents=True, exist_ok=True)
    save_pytree(flow_to_jax(state.params), p_path)
    save_optimizer(state, o_path)
    log(f"saved checkpoint to {args.ckpt_dir}", flush=True)
    return state


if __name__ == "__main__":
    main()
