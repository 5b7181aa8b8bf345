"""The port's MCP server (chatterbox_tpu_torch/serve/mcp.py), as
tests/test_mcp.py holds the JAX package's, and `handle()` against the JAX
package's MCPTTSServer: the same messages give the same dicts (the WAV
bytes of the audio content included)."""
import base64
import io
import json

import numpy as np
import pytest

pytest.importorskip("jax")
from chatterbox_tpu.serve import mcp as jmcp  # noqa: E402

import chatterbox_tpu_torch  # noqa: E402
from chatterbox_tpu_torch.serve.mcp import PROTOCOL_VERSION, TOOLS, MCPTTSServer  # noqa: E402


def _synth(calls):
    def synth(text, voice, seed, **kw):
        calls["last"] = (text, voice, seed, kw)
        rng = np.random.default_rng(len(text))
        return (np.linspace(-0.5, 0.5, 2400) + 0.01 * rng.standard_normal(2400)
                ).astype(np.float32)
    return synth


@pytest.fixture()
def server():
    calls = {}
    srv = MCPTTSServer(_synth(calls), {"default": object(), "alt": object()}, sr=24000)
    srv._calls = calls
    return srv


def rpc(method, params=None, mid=1):
    msg = {"jsonrpc": "2.0", "id": mid, "method": method}
    if params is not None:
        msg["params"] = params
    return msg


MESSAGES = [
    rpc("initialize", {"protocolVersion": PROTOCOL_VERSION}),
    rpc("ping", mid=2),
    {"jsonrpc": "2.0", "method": "notifications/initialized"},
    rpc("tools/list", mid=3),
    rpc("tools/call", {"name": "generate_speech",
                       "arguments": {"text": "hello", "voice": "alt", "seed": 7,
                                     "temperature": 0.7, "top_p": 0.9,
                                     "repetition_penalty": 1.3}}, mid=4),
    rpc("tools/call", {"name": "generate_speech", "arguments": {"text": "default voice"}}),
    rpc("tools/call", {"name": "list_voices"}, mid="a"),
    rpc("tools/call", {"name": "generate_speech", "arguments": {"text": "x", "voice": "no"}}),
    rpc("tools/call", {"name": "no_such_tool"}),
    rpc("tools/call", {"name": "generate_speech", "arguments": {}}),
    rpc("resources/list"),
    {"jsonrpc": "2.0", "id": 9},
]


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_handle_equals_jax(i):
    voices = {"default": object(), "alt": object()}
    ours = MCPTTSServer(_synth({}), voices).handle(MESSAGES[i])
    theirs = jmcp.MCPTTSServer(_synth({}), voices).handle(MESSAGES[i])
    assert ours == theirs


def test_tools_and_version_match_jax():
    assert TOOLS == jmcp.TOOLS and PROTOCOL_VERSION == jmcp.PROTOCOL_VERSION
    assert chatterbox_tpu_torch.__version__ == "0.1.0"


def test_initialize_and_ping(server):
    r = server.handle(rpc("initialize", {"protocolVersion": PROTOCOL_VERSION}))
    assert r["id"] == 1 and r["result"]["protocolVersion"] == PROTOCOL_VERSION
    assert "tools" in r["result"]["capabilities"]
    assert r["result"]["serverInfo"] == {"name": "chatterbox-tpu", "version": "0.1.0"}
    assert server.handle(rpc("ping"))["result"] == {}
    assert server.handle({"jsonrpc": "2.0", "method": "notifications/initialized"}) is None


def test_generate_speech_returns_wav_audio(server):
    r = server.handle(rpc("tools/call", {
        "name": "generate_speech",
        "arguments": {"text": "hello", "voice": "alt", "seed": 7, "temperature": 0.7}}))
    content = r["result"]["content"]
    audio = next(c for c in content if c["type"] == "audio")
    assert audio["mimeType"] == "audio/wav"
    wav = base64.b64decode(audio["data"])
    assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE" and len(wav) == 44 + 2 * 2400
    assert "0.10s" in next(c for c in content if c["type"] == "text")["text"]
    assert server._calls["last"] == ("hello", "alt", 7, {"temperature": 0.7})


def test_errors(server):
    r = server.handle(rpc("tools/call", {"name": "generate_speech",
                                         "arguments": {"text": "x", "voice": "nope"}}))
    assert r["result"]["isError"] is True and "nope" in r["result"]["content"][0]["text"]
    assert server.handle(rpc("resources/list"))["error"]["code"] == -32601
    r = server.handle(rpc("tools/call", {"name": "list_voices"}))
    assert json.loads(r["result"]["content"][0]["text"]) == ["alt", "default"]


def test_newline_delimited_session(server):
    lines = [json.dumps(rpc("initialize", {"protocolVersion": PROTOCOL_VERSION}, mid=0)),
             json.dumps({"jsonrpc": "2.0", "method": "notifications/initialized"}),
             "not json at all", "",
             json.dumps(rpc("tools/call", {"name": "generate_speech",
                                           "arguments": {"text": "hi"}}, mid=1))]
    out = io.StringIO()
    server.serve_stdio(stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out)
    resps = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(resps) == 3                  # the notification got no response
    assert resps[0]["id"] == 0 and resps[1]["error"]["code"] == -32700
    audio = next(c for c in resps[2]["result"]["content"] if c["type"] == "audio")
    assert base64.b64decode(audio["data"])[:4] == b"RIFF"
    # the same session through the JAX package's server, byte for byte
    jout = io.StringIO()
    jmcp.MCPTTSServer(_synth({}), server.voices).serve_stdio(
        stdin=io.StringIO("\n".join(lines) + "\n"), stdout=jout)
    assert jout.getvalue() == out.getvalue()
