"""Voice conversion through the port's `ChatterboxVC.generate(source_16k,
target_voice_path=...)`: the S3 tokenizer over the source, the target
voice's reference (resampler, mels, CAMPPlus, the S3 tokenizer) from its
WAV file, the CFM flow and HiFT, the watermark. One client on the driving
thread: in a closed loop it sends each request as its last completes; where
the mix's generator gives arrival times, a request that arrives while the
last is still converting waits, and its latency counts from its arrival.

Set-up makes the S3Gen weights from the seed (float32), writes the mix's
target voices as WAV files under TMPDIR, makes the sources (one per size
stratum of the mix) and converts the longest and the shortest source once.
The window opens as the first request is sent and closes when the first
request that completes at or after `--seconds` does, so it holds whole
requests only.

The check, once the window has closed and the program's state is freed, on
a seeded sample of the requests finished in the window, the longest among
them; the reference follows the program stage by stage:
  * tokens: the reference's S3 tokens of the source and of the target's
    first 10 s against the program's; a token that differs counts unless
    the reference's value lies within `tie_margin` of FSQ's rounding
    boundary there (a near-tie, which float32 rounding may tip either way);
  * voice: the worst relative L2 error of the program's target prompt mels
    and x-vector against the reference's;
  * audio: the reference's flow, HiFT, trim-fade and watermark over the
    program's tokens and reference voice, on the random numbers the
    program drew for the request: the relative L2 error of the served
    waveform.
The control computes the same numbers with the reference run with TF32 on
in the program's place.
"""
from __future__ import annotations

import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench.harness import inputs, program, trace
from portbench.harness.run_state import Request, wait_until
from portbench.harness.weights import make_tree
from portbench.reference import s3gen as ref_s3
from portbench.reference import watermark as ref_wm

SR_OUT, SR_SRC = 24_000, 16_000


def _tree(run):
    return make_tree(ref_s3.s3gen_init, run.config, run.seed_of(2), run.device, torch.float32)


def _write_wav(path: Path, wav: np.ndarray, sr: int):
    from scipy.io import wavfile
    wavfile.write(str(path), sr, np.asarray(wav, np.float32))


def _read_wav(path: Path) -> np.ndarray:
    from scipy.io import wavfile
    sr, data = wavfile.read(str(path))
    return np.asarray(data, np.float32), int(sr)


def setup(run):
    from chatterbox_tpu_torch import ChatterboxVC
    cfg, mix, dev = run.config, run.mix, run.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run.mark("imports")
    engine = program.s3gen_engine(cfg, _tree(run))
    run.mark("weights")
    vc = ChatterboxVC(engine)
    tmp = Path(tempfile.mkdtemp(prefix="portbench-vc-"))
    targets = []
    for i, s in enumerate(mix["target_s"]):
        path = tmp / f"target{i}.wav"
        _write_wav(path, inputs.synthetic_voice(s, SR_OUT, run.seed_of(20 + i),
                                                f0=mix["target_f0"][i % len(mix["target_f0"])]),
                   SR_OUT)
        targets.append(path)
    if int(mix.get("clients", 1)) != 1:
        raise ValueError("the voice-conversion entry drives one client")
    traffic = run.cell.requests(run.seed)
    sources = {float(v): inputs.synthetic_voice(v, SR_SRC, run.seed_of(40 + j), f0=110.0)
               for j, v in enumerate(traffic.values["source_s"])}
    run.inputs = {"targets": targets, "sources": sources, "tmp": tmp}

    # the program's intermediate outputs, which the check follows, and the work done
    on = run.trace
    cur = {"index": None}
    made = run.counters
    made.update(tokens={}, voices={}, vocodes=[], tokenized=[])
    trace.wrap(engine, "tokenize", "s3gen.tokenize", on, record=lambda out, a, kw: (
        made["tokens"].__setitem__(cur["index"], out[0][0].copy()),
        made["tokenized"].append((time.perf_counter(), int(out[1][0])))))
    trace.wrap(engine, "embed_ref", "s3gen.embed_ref", on, record=lambda out, a, kw: (
        made["voices"].__setitem__(cur["index"], out),
        made["tokenized"].append((time.perf_counter(), int(out.prompt_token_len[0])))))
    trace.wrap(engine, "inference", "s3gen.inference", on, record=lambda out, a, kw: (
        made["vocodes"].append((time.perf_counter(), [int(a[1].prompt_token_len[0])],
                                [len(np.asarray(a[0]).reshape(-1))]))))
    trace.wrap(vc.watermarker, "apply_watermark", "watermark", on)
    run.state.update(vc=vc, engine=engine, traffic=traffic, cur=cur, slice=trace.Slice())

    run.mark("inputs")
    # warm-up: the longest and the shortest source
    for k, v in enumerate((max(sources), min(sources))):
        cur["index"] = -1 - k
        vc.set_seed(k)
        vc.generate(sources[v], target_voice_path=str(targets[k % len(targets)]))
    if on:
        run.state["slice"].request("warm")
        run.state["slice"].poll()
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _convert(run, client: int, sizes: dict) -> Request:
    st = run.state
    rng = np.random.default_rng([sizes["seed"], 1])
    target = int(rng.integers(len(run.inputs["targets"])))
    if sizes["at"] is None:
        submit_t = time.perf_counter()
    else:
        submit_t = run.t_open + sizes["at"]
        wait_until(submit_t)
    rec = Request(index=sizes["index"], client=client, submit_t=submit_t,
                  sizes=dict(sizes, target=target))
    run.requests.append(rec)
    st["cur"]["index"] = rec.index
    with trace.span("client", run.trace):
        st["vc"].set_seed(sizes["seed"])
        wav = st["vc"].generate(run.inputs["sources"][sizes["source_s"]],
                                target_voice_path=str(run.inputs["targets"][target]))
    rec.done_t = time.perf_counter()
    rec.audio_s = wav.shape[-1] / SR_OUT
    rec.output = {"wav": wav[0]}
    return rec


def window(run):
    st = run.state
    sl, traffic = st["slice"], st["traffic"]
    run.t_open = time.perf_counter()
    run.setup_s = run.t_open - run.t_start
    deadline = run.t_open + run.seconds
    while True:
        if run.trace and time.perf_counter() >= deadline - run.workload["trace_slice_s"]:
            sl.request("start")
            sl.poll()
        rec = _convert(run, 0, traffic.next())
        if rec.done_t >= deadline:
            run.t_close = rec.done_t
            break
    done = run.in_window()
    run.served = (sum(r.audio_s for r in done), run.t_close - run.t_open)
    run.notes["done"] = [[round(r.audio_s, 2), round(r.done_t - r.submit_t, 4)]
                         for r in run.requests]
    if run.trace:
        sl.request("stop")
        sl.poll()
        run.summary = trace.TraceSummary(sl.events, sl.t1 - sl.t0)
        run.slice_counters = {"t0": sl.t0, "t1": sl.t1}


def release(run):
    run.state.pop("vc", None)
    run.state.pop("engine", None)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return float("inf")
    return float(torch.linalg.norm(a.float() - b.float()) / torch.linalg.norm(b.float()))


def _mismatch(got: torch.Tensor, want: torch.Tensor, margin: torch.Tensor, tie: float) -> float:
    """Tokens that differ where the reference is not at a near-tie."""
    if got.shape != want.shape:
        return float("inf")
    return float(((got != want) & (margin >= tie)).sum())


@torch.no_grad()
def check(run, control: bool = False) -> dict:
    cfg, dev, wl = run.config, run.device, run.workload
    tie = wl["check"]["tie_margin"]
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    def tf32(on: bool):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    tf32(False)
    tree = _tree(run)
    worst = {"tok_mismatch": 0.0, "voice_rel_err": 0.0, "wav_rel_err": 0.0}
    sample = run.sample(run.in_window(), wl["check"]["requests"])
    if not sample:
        worst = {k: float("inf") for k in worst}
    for r in sample:
        src = torch.from_numpy(run.inputs["sources"][r.sizes["source_s"]]).to(dev)
        tgt, sr = _read_wav(run.inputs["targets"][r.sizes["target"]])
        tgt = torch.from_numpy(tgt[:10 * sr]).to(dev)
        tok, margin = ref_s3.tokenize(tree, cfg, src)
        voice, vmargin = ref_s3.embed_ref(tree, cfg, tgt, sr)
        if control:
            tf32(True)
            got_tok = ref_s3.tokenize(tree, cfg, src)[0]
            got_voice = ref_s3.embed_ref(tree, cfg, tgt, sr)[0]
            tf32(False)
        else:
            got_tok = torch.from_numpy(run.counters["tokens"][r.index].astype(np.int64)).to(dev)
            pv = run.counters["voices"][r.index]
            P = int(pv.prompt_token_len[0])
            got_voice = ref_s3.Ref(
                torch.from_numpy(np.asarray(pv.prompt_token)[0, :P].astype(np.int64)).to(dev),
                torch.from_numpy(pv.prompt_feat).to(dev),
                torch.from_numpy(pv.embedding).to(dev))
        worst["tok_mismatch"] = max(
            worst["tok_mismatch"], _mismatch(got_tok, tok, margin, tie),
            _mismatch(got_voice.prompt_token, voice.prompt_token, vmargin, tie))
        worst["voice_rel_err"] = max(worst["voice_rel_err"],
                                     _rel(got_voice.prompt_feat, voice.prompt_feat),
                                     _rel(got_voice.embedding, voice.embedding))

        # the audio stage, from the program's tokens and voice (the control's: its own)
        def audio():
            g = torch.Generator(device=dev).manual_seed(int(r.sizes["seed"]))
            w = ref_s3.vocode(tree, cfg, got_voice, got_tok, g).cpu().numpy()
            return ref_wm.SpreadSpectrumWatermarker().apply_watermark(w, sample_rate=SR_OUT)

        want = torch.from_numpy(audio())
        if control:
            tf32(True)
            got = torch.from_numpy(audio())
            tf32(False)
        else:
            got = torch.from_numpy(np.asarray(r.output["wav"]))
        worst["wav_rel_err"] = max(worst["wav_rel_err"], _rel(got, want))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    shutil.rmtree(run.inputs["tmp"], ignore_errors=True)
    lim = wl["check"]["limits"]
    return {k: {"value": v, "limit": lim[k]} for k, v in worst.items()}
