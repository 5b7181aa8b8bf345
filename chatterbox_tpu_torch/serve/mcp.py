"""A minimal MCP (Model Context Protocol) server with TTS as its tools (the
counterpart of chatterbox_tpu/serve/mcp.py): JSON-RPC 2.0 over stdio,
newline-delimited (MCP spec rev 2024-11-05), stdlib only. Tools:

  generate_speech(text, voice?, seed?, temperature?, top_p?,
                  repetition_penalty?)  -> audio content (base64 WAV) + text
  list_voices()                         -> text content

Run: python -m chatterbox_tpu_torch.cli mcp --ckpt-dir DIR --voice ref.wav
"""
from __future__ import annotations

import base64
import json
import sys
from typing import Optional

import numpy as np

from .. import __version__
from .http import wav_bytes

PROTOCOL_VERSION = "2024-11-05"

TOOLS = [
    {
        "name": "generate_speech",
        "description": "Synthesize speech from text with a registered "
                       "voice. Returns a WAV file (24 kHz mono).",
        "inputSchema": {
            "type": "object",
            "properties": {
                "text": {"type": "string",
                         "description": "Text to synthesize"},
                "voice": {"type": "string", "default": "default",
                          "description": "Registered voice name"},
                "seed": {"type": "integer",
                         "description": "RNG seed for reproducible audio"},
                "temperature": {"type": "number", "default": 0.8},
                "top_p": {"type": "number", "default": 0.95},
                "repetition_penalty": {"type": "number", "default": 1.2},
            },
            "required": ["text"],
        },
    },
    {
        "name": "list_voices",
        "description": "List the registered voice names.",
        "inputSchema": {"type": "object", "properties": {}},
    },
]


class MCPTTSServer:
    """Protocol core, transport-agnostic: handle() maps one JSON-RPC
    message to a response dict (or None for notifications).

    synth_fn(text, voice_name, seed, **sampler_kw) -> float32 waveform.
    """

    def __init__(self, synth_fn, voices, sr: int = 24000,
                 name: str = "chatterbox-tpu"):
        self.synth_fn = synth_fn
        self.voices = voices
        self.sr = sr
        self.name = name

    # ------------------------------------------------------------------
    def handle(self, msg: dict) -> Optional[dict]:
        mid = msg.get("id")
        method = msg.get("method", "")
        if method.startswith("notifications/"):
            return None
        try:
            if method == "initialize":
                result = {
                    "protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {"tools": {}},
                    "serverInfo": {"name": self.name,
                                   "version": __version__},
                }
            elif method == "ping":
                result = {}
            elif method == "tools/list":
                result = {"tools": TOOLS}
            elif method == "tools/call":
                result = self._call(msg.get("params") or {})
            else:
                return {"jsonrpc": "2.0", "id": mid,
                        "error": {"code": -32601,
                                  "message": f"method not found: {method}"}}
        except Exception as e:     # tool errors are reported in-band
            return {"jsonrpc": "2.0", "id": mid,
                    "result": {"isError": True,
                               "content": [{"type": "text",
                                            "text": f"error: {e!r}"}]}}
        return {"jsonrpc": "2.0", "id": mid, "result": result}

    def _call(self, params: dict) -> dict:
        name = params.get("name")
        args = params.get("arguments") or {}
        if name == "list_voices":
            return {"content": [{"type": "text",
                                 "text": json.dumps(sorted(self.voices))}]}
        if name != "generate_speech":
            raise ValueError(f"unknown tool {name!r}")
        voice = args.get("voice", "default")
        if voice not in self.voices:
            raise ValueError(f"unknown voice {voice!r}")
        kw = {k: float(args[k]) for k in
              ("temperature", "top_p", "repetition_penalty") if k in args}
        wav = self.synth_fn(str(args["text"]), voice,
                            args.get("seed"), **kw)
        wav = np.asarray(wav, np.float32).reshape(-1)
        return {"content": [
            {"type": "audio",
             "data": base64.b64encode(wav_bytes(wav, self.sr)).decode(),
             "mimeType": "audio/wav"},
            {"type": "text",
             "text": f"generated {len(wav) / self.sr:.2f}s of audio "
                     f"(voice {voice!r}, {self.sr} Hz)"},
        ]}

    # ------------------------------------------------------------------
    def serve_stdio(self, stdin=None, stdout=None):
        """Newline-delimited JSON-RPC loop (the MCP stdio transport)."""
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                resp = {"jsonrpc": "2.0", "id": None,
                        "error": {"code": -32700, "message": "parse error"}}
            else:
                resp = self.handle(msg)
            if resp is not None:
                stdout.write(json.dumps(resp) + "\n")
                stdout.flush()
