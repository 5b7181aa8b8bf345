"""Command-line interface (the counterpart of chatterbox_tpu/cli.py):

    python -m chatterbox_tpu_torch.cli synth --ckpt-dir DIR --model turbo \
        --text "Hello." --audio-prompt ref.wav --out out.wav
    python -m chatterbox_tpu_torch.cli vc --ckpt-dir DIR --audio in.wav \
        --target-voice voice.wav --out out.wav
    python -m chatterbox_tpu_torch.cli serve --ckpt-dir DIR --voice ref.wav \
        --continuous --draft-int8
    python -m chatterbox_tpu_torch.cli mcp --ckpt-dir DIR --voice ref.wav
    python -m chatterbox_tpu_torch.cli info
    python -m chatterbox_tpu_torch.cli watermark out.wav

Models load from a local checkpoint directory in the reference's layout
(`--ckpt-dir`, required: nothing is downloaded). Every command that runs a
model takes `--device` (default cuda) and refuses a CUDA device where none
is present rather than running on the CPU. `serve` has no `--warmup`: the
JAX package's compile grid has no counterpart in eager PyTorch.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _device(args) -> str:
    """args.device, refused when it names CUDA and no CUDA device is there."""
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    return args.device


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the plain "
                        "versions of the kernels)")


def _build_synth(sub):
    p = sub.add_parser("synth", help="text -> speech")
    p.add_argument("--model", choices=["english", "turbo", "nano", "multilingual"],
                   default="turbo")
    p.add_argument("--text", required=True)
    p.add_argument("--out", default="out.wav")
    p.add_argument("--audio-prompt", default=None)
    p.add_argument("--language-id", default=None, help="multilingual only")
    p.add_argument("--ckpt-dir", required=True, help="local checkpoint directory")
    p.add_argument("--exaggeration", type=float, default=0.5)
    p.add_argument("--cfg-weight", type=float, default=0.5)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--top-k", type=int, default=1000)
    p.add_argument("--repetition-penalty", type=float, default=1.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stream", action="store_true",
                   help="turbo/nano: stream chunks (prints the time to first audio)")
    p.add_argument("--draft", choices=["int8"], default=None,
                   help="turbo/nano, not streamed: speculative decode, the model's own "
                        "weights quantized int8 drafting and the float model verifying "
                        "(the float model's sampling distribution, exactly)")
    _add_device(p)


def _cmd_synth(args):
    import numpy as np
    from chatterbox_tpu_torch.utils.audio_io import save_wav

    device = _device(args)
    if args.model in ("turbo", "nano"):
        from chatterbox_tpu_torch import ChatterboxTurboTTS
        model = ChatterboxTurboTTS.from_local(args.ckpt_dir, device=device,
                                              nano=args.model == "nano")
        if args.seed:
            model.set_seed(args.seed)
        kw = dict(temperature=args.temperature, top_k=args.top_k,
                  top_p=args.top_p if args.top_p is not None else 0.95,
                  repetition_penalty=args.repetition_penalty,
                  audio_prompt_path=args.audio_prompt)
        if args.stream:
            t0 = time.perf_counter()
            chunks, ttfa = [], None
            for c in model.generate_stream(args.text, **kw):
                if ttfa is None:
                    ttfa = time.perf_counter() - t0
                    print(f"TTFA: {ttfa * 1000:.0f} ms", file=sys.stderr)
                chunks.append(c)
            wav = np.concatenate(chunks)[None]
        else:
            if args.draft:
                kw["draft"] = args.draft
            wav = model.generate(args.text, **kw)
    elif args.model == "english":
        from chatterbox_tpu_torch import ChatterboxTTS
        model = ChatterboxTTS.from_local(args.ckpt_dir, device=device)
        if args.seed:
            model.set_seed(args.seed)
        wav = model.generate(args.text, audio_prompt_path=args.audio_prompt,
                             exaggeration=args.exaggeration, cfg_weight=args.cfg_weight,
                             temperature=args.temperature,
                             top_p=args.top_p if args.top_p is not None else 1.0,
                             repetition_penalty=args.repetition_penalty)
    else:
        from chatterbox_tpu_torch import ChatterboxMultilingualTTS
        model = ChatterboxMultilingualTTS.from_local(args.ckpt_dir, device=device)
        if args.seed:
            model.set_seed(args.seed)
        wav = model.generate(args.text, language_id=args.language_id or "en",
                             audio_prompt_path=args.audio_prompt,
                             exaggeration=args.exaggeration, cfg_weight=args.cfg_weight,
                             temperature=args.temperature)
    save_wav(args.out, np.asarray(wav)[0], model.sr)
    print(f"wrote {args.out} ({np.asarray(wav).shape[-1] / model.sr:.2f} s)")


def _cmd_vc(args):
    import numpy as np
    from chatterbox_tpu_torch import ChatterboxVC
    from chatterbox_tpu_torch.utils.audio_io import save_wav
    model = ChatterboxVC.from_local(args.ckpt_dir, device=_device(args))
    wav = model.generate(args.audio, target_voice_path=args.target_voice)
    save_wav(args.out, np.asarray(wav)[0], model.sr)
    print(f"wrote {args.out}")


def _cmd_info(args):
    import torch
    import chatterbox_tpu_torch
    from chatterbox_tpu_torch.models.s3gen.model import S3GEN_SR
    device = _device(args)
    cuda = torch.cuda.is_available()
    print(json.dumps({
        "version": chatterbox_tpu_torch.__version__,
        "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "device": device,
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if cuda else []),
        "sample_rate": S3GEN_SR,
        "models": ["english (500M CFG)", "turbo (350M)", "nano (110M)",
                   "multilingual (500M, 23 languages)", "vc"],
    }, indent=2))


def _parse_voice_specs(specs):
    """--voice specs -> [(name, path)]. 'name=path' registers a named voice;
    a bare path (even one holding '=': an existing file wins) -> 'default'."""
    out, seen = [], set()
    for spec in specs:
        if "=" in spec and not os.path.exists(spec):
            name, _, path = spec.partition("=")
        else:
            name, path = "default", spec
        if name in seen:
            raise SystemExit(f"duplicate voice name {name!r} "
                             f"(use name=path to register extra voices)")
        seen.add(name)
        out.append((name, path))
    return out


def _cmd_mcp(args):
    import numpy as np
    from chatterbox_tpu_torch import ChatterboxTurboTTS, Conditionals
    from chatterbox_tpu_torch.serve.mcp import MCPTTSServer

    model = ChatterboxTurboTTS.from_local(args.ckpt_dir, device=_device(args),
                                          nano=args.model == "nano")
    conds = {}
    for name, path in _parse_voice_specs(args.voice):
        model.prepare_conditionals(path)
        conds[name] = Conditionals(model.conds.t3, model.conds.gen)

    def synth_fn(text, voice, seed, **kw):
        if seed is not None:
            model.set_seed(int(seed))
        model.conds = conds[voice]
        return np.asarray(model.generate(text, **kw))[0]

    print(f"MCP TTS server ({args.model}) on stdio - voices: {sorted(conds)}",
          file=sys.stderr)
    MCPTTSServer(synth_fn, conds, sr=model.sr).serve_stdio()


def _cmd_watermark(args):
    from chatterbox_tpu_torch.utils.audio_io import load_audio
    from chatterbox_tpu_torch.utils.watermark import DETECT_Z, SpreadSpectrumWatermarker
    sr = 24000
    wav = load_audio(args.wav, sr)
    wm = SpreadSpectrumWatermarker(key=args.key)
    z, payload = wm.detect(wav, sr)
    detected = bool(z >= DETECT_Z)
    print(json.dumps({"file": args.wav,
                      "detected": detected,
                      "score_z": round(float(z), 2),
                      "threshold_z": DETECT_Z,
                      # 16-bit generator id (meaningful only when detected)
                      "payload": f"{payload:#06x}" if detected else None}))


class _NormTok:
    """The serving tokenizer: the family's punc_norm, then the tokenizer (the
    pipelines' generate normalizes inline; the serving loops tokenize
    directly)."""

    def __init__(self, tok, variant):
        self.tok = tok
        self.variant = variant

    def text_to_tokens(self, text, language_id=None):
        from chatterbox_tpu_torch.text.tokenizer import punc_norm
        text = punc_norm(text, variant=self.variant)
        if language_id is not None:
            return self.tok.text_to_tokens(text, language_id=language_id)
        return self.tok.text_to_tokens(text)


def build_server(args):
    """The TTSHTTPServer `serve` runs (not started): the model from
    args.ckpt_dir on args.device, its voices, a BatchDecoder or, with
    --continuous, a ContinuousTTSServer of max_batch slots."""
    import numpy as np
    from chatterbox_tpu_torch import (ChatterboxMultilingualTTS, ChatterboxTTS,
                                      ChatterboxTurboTTS, Conditionals)
    from chatterbox_tpu_torch.serve.batching import BatchDecoder
    from chatterbox_tpu_torch.serve.http import TTSHTTPServer, Voice

    device = _device(args)
    cfg_family = args.model in ("english", "multilingual")
    if cfg_family:
        cls = ChatterboxTTS if args.model == "english" else ChatterboxMultilingualTTS
        model = cls.from_local(args.ckpt_dir, device=device)
        variant = "mtl" if args.model == "multilingual" else "en"
        hp = model.hp

        def frame_text(ids):
            # SOT/EOT framing, which the CFG pipelines' generate adds itself
            return np.concatenate([[hp.start_text_token], ids.reshape(-1),
                                   [hp.stop_text_token]]).astype(np.int32)
        stream_fn = None        # the streaming pipeline is Turbo's
    else:
        model = ChatterboxTurboTTS.from_local(args.ckpt_dir, device=device,
                                              nano=args.model == "nano")
        variant, frame_text = "turbo", None

        def stream_fn(text, voice, seed, **kw):
            # the single-stream pipeline's generate_stream, with its sampler
            # knobs only; long texts split at sentence ends, each streamed
            from chatterbox_tpu_torch.serve.streaming import chunk_text
            kw = {k: v for k, v in kw.items()
                  if k in ("temperature", "top_p", "repetition_penalty")}
            if seed is not None:
                model.set_seed(int(seed))
            model.conds = Conditionals(voice.cond, voice.ref)
            for piece in chunk_text(text, max_chars=300):
                yield from model.generate_stream(piece, **kw)

    voices = {}
    for name, path in _parse_voice_specs(args.voice):
        model.prepare_conditionals(path)
        voices[name] = Voice(model.conds.t3, model.conds.gen)
    decoder = BatchDecoder(model.t3_params, model.hp, max_batch=args.max_batch,
                           cfg=cfg_family, kv_int8=args.kv_int8)

    def _prepare_fn(path):
        model.prepare_conditionals(path)
        return Voice(model.conds.t3, model.conds.gen)

    slots = None
    if args.continuous:
        from chatterbox_tpu_torch.sampling.continuous import ContinuousTTSServer
        slots = ContinuousTTSServer(
            model.t3_params, model.hp, n_slots=args.max_batch,
            text_bucket=args.text_bucket, s3gen=model.s3gen, cfg=cfg_family,
            kv_int8=args.kv_int8, draft_int8=args.draft_int8)
    return TTSHTTPServer(
        decoder, model.s3gen, _NormTok(model.tokenizer, variant), voices,
        sr=model.sr, host=args.host, port=args.port, stream_fn=stream_fn,
        prepare_fn=_prepare_fn, continuous=slots, frame_text=frame_text)


def _cmd_serve(args):
    server = build_server(args)
    server.start()
    print(f"serving on http://{server.host}:{server.port}  "
          f"(POST /tts [+stream] /vc /voices, GET /voices /healthz /metrics)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="chatterbox_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _build_synth(sub)
    pv = sub.add_parser("vc", help="voice conversion")
    pv.add_argument("--audio", required=True)
    pv.add_argument("--target-voice", default=None)
    pv.add_argument("--out", default="out.wav")
    pv.add_argument("--ckpt-dir", required=True)
    _add_device(pv)
    _add_device(sub.add_parser("info", help="environment and model info"))
    pw = sub.add_parser("watermark", help="detect the watermark in a wav")
    pw.add_argument("wav", help="audio file to check")
    pw.add_argument("--key", default="chatterbox-tpu",
                    help="watermark key used at synthesis time")
    ps = sub.add_parser("serve", help="batched HTTP TTS server")
    ps.add_argument("--voice", required=True, action="append",
                    help=">5 s reference wav; repeatable, 'name=path' registers a named "
                         "voice (a bare path: 'default')")
    ps.add_argument("--model", choices=["turbo", "nano", "english", "multilingual"],
                    default="turbo",
                    help="english / multilingual serve the 520M CFG family (the "
                         "request's min_p / cfg_weight / exaggeration; multilingual "
                         "takes a \"language\" field)")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8321)
    ps.add_argument("--max-batch", type=int, default=8)
    ps.add_argument("--continuous", action="store_true",
                    help="the continuous slot engine: requests join the decode at the "
                         "next round and finish on their own; max-batch becomes the "
                         "slot count, and streams decode together in the slots")
    ps.add_argument("--kv-int8", action="store_true",
                    help="the int8 KV cache (read by the int8 decode-attention kernel): "
                         "half the cache's bytes")
    ps.add_argument("--text-bucket", type=int, default=128,
                    help="--continuous: the text tokens a slot holds (longer texts are cut)")
    ps.add_argument("--draft-int8", action="store_true",
                    help="--continuous, Turbo / Nano: speculative rounds, the model's own "
                         "int8 weights drafting 8 tokens a slot and one float verify "
                         "emitting them; the tokens are those of draft-off")
    ps.add_argument("--ckpt-dir", required=True)
    _add_device(ps)
    pm = sub.add_parser("mcp", help="MCP (Model Context Protocol) TTS server over stdio")
    pm.add_argument("--voice", required=True, action="append",
                    help=">5 s reference wav; repeatable, 'name=path' registers a named "
                         "voice (a bare path: 'default')")
    pm.add_argument("--model", choices=["turbo", "nano"], default="turbo")
    pm.add_argument("--ckpt-dir", required=True)
    _add_device(pm)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    {"synth": _cmd_synth, "vc": _cmd_vc, "info": _cmd_info, "watermark": _cmd_watermark,
     "serve": _cmd_serve, "mcp": _cmd_mcp}[args.cmd](args)


if __name__ == "__main__":
    main()
