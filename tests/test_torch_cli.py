"""The port's command line (chatterbox_tpu_torch/cli.py) against the JAX
package's (chatterbox_tpu/cli.py): every flag set parses to the same values
(less JAX's `serve --warmup`, plus the port's `--device`), the voice specs
and the serving tokenizer alike; then `synth --device cpu` (plain, streamed
and speculative) on a tiny Turbo checkpoint directory written as
tests/test_torch_load.py writes one, its WAV the pipeline's own generate;
`serve`'s server built on the CPU answering a request; `info` and
`watermark`; and the refusal of a CUDA device where there is none."""
import json

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from chatterbox_tpu import cli as jcli  # noqa: E402

from chatterbox_tpu_torch import cli  # noqa: E402

COMMANDS = ("synth", "vc", "info", "watermark", "serve", "mcp")
D = ["--ckpt-dir", "ckpt"]
FLAG_SETS = [
    ["synth", "--text", "Hi."] + D,
    ["synth", "--model", "english", "--text", "Hi.", "--out", "o.wav", "--audio-prompt",
     "p.wav", "--exaggeration", "0.7", "--cfg-weight", "0.3", "--temperature", "0.6",
     "--top-p", "0.9", "--top-k", "50", "--repetition-penalty", "1.1", "--seed", "3"] + D,
    ["synth", "--model", "multilingual", "--language-id", "fr", "--text", "Bonjour."] + D,
    ["synth", "--model", "nano", "--text", "x", "--stream"] + D,
    ["synth", "--text", "x", "--draft", "int8"] + D,
    ["vc", "--audio", "in.wav", "--target-voice", "t.wav", "--out", "o.wav"] + D,
    ["vc", "--audio", "in.wav"] + D,
    ["info"],
    ["watermark", "f.wav"],
    ["watermark", "f.wav", "--key", "k"],
    ["serve", "--voice", "ref.wav"] + D,
    ["serve", "--voice", "a=x.wav", "--voice", "y.wav", "--model", "english", "--host",
     "0.0.0.0", "--port", "9000", "--max-batch", "4", "--continuous", "--kv-int8",
     "--text-bucket", "64", "--draft-int8"] + D,
    ["serve", "--voice", "v.wav", "--model", "multilingual", "--continuous"] + D,
    ["mcp", "--voice", "v.wav", "--model", "nano"] + D,
    ["mcp", "--voice", "a=v.wav", "--voice", "b=w.wav"] + D,
]


def _parsed(mod, argv, monkeypatch):
    got = []
    for c in COMMANDS:
        monkeypatch.setattr(mod, f"_cmd_{c}", lambda args, c=c: got.append((c, vars(args))))
    mod.main(argv)
    assert len(got) == 1
    return got[0]


@pytest.mark.parametrize("i", range(len(FLAG_SETS)))
def test_flag_sets_parse_as_jax(i, monkeypatch):
    argv = FLAG_SETS[i]
    cmd, theirs = _parsed(jcli, argv, monkeypatch)
    pcmd, ours = _parsed(cli, argv, monkeypatch)
    assert pcmd == cmd == argv[0]
    theirs.pop("warmup", None)
    if cmd != "watermark":
        assert ours.pop("device") == "cuda"
    assert ours == theirs
    _, ours = _parsed(cli, argv + (["--device", "cpu"] if cmd != "watermark" else []),
                      monkeypatch)
    assert ours.get("device", "cpu") == "cpu"


def test_what_the_port_parses_differently(monkeypatch, capsys):
    for argv in (["synth", "--text", "x"],                       # --ckpt-dir is required
                 ["serve", "--voice", "v.wav", "--warmup"] + D,   # no compile grid
                 ["watermark", "f.wav", "--device", "cpu"]):      # no model, no device
        with pytest.raises(SystemExit) as ei:
            cli.build_parser().parse_args(argv)
        assert ei.value.code == 2
    capsys.readouterr()


def test_voice_specs_and_normtok_match_jax(tmp_path):
    odd = tmp_path / "a=b.wav"
    odd.write_bytes(b"")
    for specs in (["ref.wav"], ["x=a.wav", "b.wav", "y=c=d.wav"], [str(odd)],
                  [f"n={odd}", "m.wav"]):
        assert cli._parse_voice_specs(specs) == jcli._parse_voice_specs(specs)
    for specs in (["a.wav", "b.wav"], ["x=a.wav", "x=b.wav"]):
        with pytest.raises(SystemExit, match="duplicate"):
            cli._parse_voice_specs(specs)

    class Rec:
        def text_to_tokens(self, text, language_id="absent"):
            return (text, language_id)

    for variant in ("turbo", "en", "mtl"):
        for text in ("hello  world", "Hi…  there", "no end punctuation", ""):
            for lang in (None, "fr"):
                assert (cli._NormTok(Rec(), variant).text_to_tokens(text, lang)
                        == jcli._NormTok(Rec(), variant).text_to_tokens(text, lang))


def test_info_and_the_cuda_refusal(capsys):
    cli.main(["info", "--device", "cpu"])
    info = json.loads(capsys.readouterr().out)
    assert info["version"] == "0.1.0" and info["torch"] == torch.__version__
    assert info["device"] == "cpu" and info["sample_rate"] == 24000
    if not torch.cuda.is_available():
        for argv in (["info"], ["synth", "--text", "x"] + D, ["serve", "--voice", "v"] + D):
            with pytest.raises(SystemExit, match="no CUDA device"):
                cli.main(argv)


# ---------------------------------------------------------------------------
# end to end on a tiny checkpoint directory
# ---------------------------------------------------------------------------

pytest.importorskip("transformers")
from tests import test_torch_load as TL  # noqa: E402
from tests.test_torch_convert import few_threads  # noqa: E402,F401

N_NEW = 12


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_ckpt")
    return d, write_tiny_checkpoint(d)


def write_tiny_checkpoint(d):
    """A tiny Turbo checkpoint directory in d (test_torch_load's writer:
    T3, meanflow S3Gen, voice encoder, BPE tokenizer, conds.pt) and a 6 s
    prompt WAV, whose path it returns."""
    import chip_smoke
    from chatterbox_tpu_torch.models.s3gen import model as s3m
    from chatterbox_tpu_torch.models.s3gen.flow import FlowDims
    from chatterbox_tpu_torch.models.s3tok.model import S3TokenizerConfig
    from chatterbox_tpu_torch.models.t3 import model as t3m
    from chatterbox_tpu_torch.models.t3.config import T3Config
    from chatterbox_tpu_torch.models.ve.model import ve_init
    from chatterbox_tpu_torch.nn import core as nn
    from chatterbox_tpu_torch.utils.audio_io import save_wav
    import chatterbox_tpu_torch as port
    fam = TL.FAMILIES["turbo"]
    hp = T3Config(**fam["kw"])
    s3 = s3m.s3gen_init(2, "cpu", meanflow=True, dims=FlowDims.tiny_test(), hift_base=32,
                        tok_cfg=S3TokenizerConfig.tiny_test())
    s3["speaker_encoder"] = chip_smoke.seeded_batch_stats(s3["speaker_encoder"], 3)
    chip_smoke.write_checkpoint(d, fam["t3_file"], fam["s3_file"], t3m.t3_init(hp, seed=1,
                                device="cpu"), hp, s3, ve_init(nn.Init(4, "cpu")))
    chip_smoke.write_turbo_tokenizer(d, 60, [TL.TEXT * 3, "a quick brown fox"])
    rng = np.random.default_rng(5)
    port.Conditionals(
        port.T3CondHost(rng.standard_normal((1, 256)).astype(np.float32),
                        rng.integers(0, 6561, (1, 8)).astype(np.int32), 0.0),
        port.RefDict(rng.integers(0, 6561, (1, 10)).astype(np.int32), np.array([10], np.int32),
                     rng.standard_normal((1, 20, 80)).astype(np.float32),
                     rng.standard_normal((1, 192)).astype(np.float32))
    ).save(str(d / "conds.pt"))
    wav = d / "prompt.wav"
    save_wav(wav, 0.5 * chip_smoke.synthetic_voice(6.0, 24000, seed=6), 24000)
    return wav


@pytest.fixture()
def tiny(monkeypatch):
    """The loaders at the test sizes; every generate / generate_stream
    capped at N_NEW tokens (the command line has no budget flag)."""
    import chatterbox_tpu_torch as port
    for name in ("generate", "generate_stream"):
        orig = getattr(port.ChatterboxTurboTTS, name)
        monkeypatch.setattr(port.ChatterboxTurboTTS, name,
                            lambda self, *a, orig=orig, **k: orig(self, *a, **dict(
                                k, max_new_tokens=N_NEW)))
    with TL.tiny_sizes(TL.FAMILIES["turbo"]):
        yield port


def _samples(path):
    from scipy.io import wavfile
    sr, x = wavfile.read(str(path))
    assert sr == 24000 and x.dtype == np.float32
    return x


@pytest.mark.parametrize("mode", ["plain", "stream", "draft"])
def test_synth_writes_the_pipelines_wav(mode, ckpt, tiny, tmp_path, capsys):
    """`synth --device cpu` from the directory: the WAV holds the samples of
    the pipeline's own call (generate, generate_stream or
    generate(draft="int8")) with the same seed and knobs."""
    d, _ = ckpt
    out = tmp_path / "out.wav"
    extra = {"plain": [], "stream": ["--stream"], "draft": ["--draft", "int8"]}[mode]
    cli.main(["synth", "--ckpt-dir", str(d), "--device", "cpu", "--text", TL.TEXT,
              "--out", str(out), "--seed", "3"] + extra)
    assert "wrote" in capsys.readouterr().out
    got = _samples(out)
    tts = tiny.ChatterboxTurboTTS.from_local(d, device="cpu")
    tts.set_seed(3)
    kw = dict(temperature=0.8, top_k=1000, top_p=0.95, repetition_penalty=1.2)
    if mode == "stream":
        ref = np.concatenate(list(tts.generate_stream(TL.TEXT, **kw)))
    else:
        ref = tts.generate(TL.TEXT, draft="int8" if mode == "draft" else None, **kw)[0]
    assert len(got) > 0 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, np.clip(ref, -1, 1).astype(np.float32))
    if mode == "plain":
        cli.main(["watermark", str(out)])
        rep = json.loads(capsys.readouterr().out)
        assert rep["file"] == str(out) and rep["threshold_z"] == 10.0


def test_serve_builds_a_cpu_server_that_answers(ckpt, tiny):
    """`serve`'s server (build_server) on the CPU from the directory and the
    prompt WAV, continuous with draft_int8: a POST /tts answers a WAV, the
    same bytes again for the same seed."""
    import urllib.request
    d, wav = ckpt
    args = cli.build_parser().parse_args(
        ["serve", "--ckpt-dir", str(d), "--device", "cpu", "--voice", str(wav),
         "--voice", f"two={wav}", "--port", "0", "--continuous", "--draft-int8",
         "--max-batch", "2", "--text-bucket", "32"])
    srv = cli.build_server(args)
    srv.loop.server.max_new_tokens = N_NEW
    assert sorted(srv.voices) == ["default", "two"] and srv.loop.server.draft
    srv.start()
    try:
        def post():
            req = urllib.request.Request(
                f"http://{srv.host}:{srv.port}/tts",
                data=json.dumps({"text": TL.TEXT, "seed": 4, "voice": "two"}).encode())
            with urllib.request.urlopen(req, timeout=240) as r:
                return r.read()
        a = post()
        assert a[:4] == b"RIFF" and len(a) > 44 and post() == a
    finally:
        srv.stop()
