"""Text tokenizers and punctuation normalization (the port's own copy of
chatterbox_tpu/text/tokenizer.py's English part):

  * EnTokenizer: the 520M model's BPE (`tokenizer.json`, HF `tokenizers`)
    with spaces written as [SPACE];
  * HFTokenizer: the GPT-2 BPE of Turbo / Nano through transformers'
    AutoTokenizer (the JAX Turbo loader's `_HFTok`);
  * punc_norm: the punctuation clean-up every pipeline applies first.

`tokenizers` and `transformers` are imported when a tokenizer is built,
never when this module is imported.
"""
from __future__ import annotations

import numpy as np

SOT = "[START]"
EOT = "[STOP]"
UNK = "[UNK]"
SPACE = "[SPACE]"


class EnTokenizer:
    """English BPE tokenizer of the 520M model."""

    def __init__(self, vocab_file_path: str):
        from tokenizers import Tokenizer
        self.tokenizer = Tokenizer.from_file(vocab_file_path)
        voc = self.tokenizer.get_vocab()
        assert SOT in voc and EOT in voc, "vocab must contain [START]/[STOP]"

    def text_to_tokens(self, text: str) -> np.ndarray:
        return np.asarray(self.encode(text), np.int32)[None]

    def encode(self, txt: str) -> list[int]:
        return self.tokenizer.encode(txt.replace(" ", SPACE)).ids

    def decode(self, seq) -> str:
        seq = np.asarray(seq).reshape(-1).tolist()
        txt = self.tokenizer.decode(seq, skip_special_tokens=False)
        return (txt.replace(" ", "").replace(SPACE, " ")
                   .replace(EOT, "").replace(UNK, ""))


class HFTokenizer:
    """Turbo / Nano's GPT-2 BPE, read from a checkpoint directory by
    transformers' AutoTokenizer; the pad token is the EOS token."""

    def __init__(self, ckpt_dir):
        from transformers import AutoTokenizer
        self.tok = AutoTokenizer.from_pretrained(str(ckpt_dir))
        if self.tok.pad_token is None:
            self.tok.pad_token = self.tok.eos_token

    def text_to_tokens(self, text: str) -> np.ndarray:
        return np.asarray(self.tok(text).input_ids, np.int32)[None]

_PUNC_REPLACEMENTS = [
    ("...", ", "), ("…", ", "), (":", ","), (" - ", ", "), (";", ", "),
    ("—", "-"), ("–", "-"), (" ,", ","),
    ("“", '"'), ("”", '"'), ("‘", "'"), ("’", "'"),
]
_PUNC_REPLACEMENTS_TURBO = [
    ("…", ", "), (":", ","), ("—", "-"), ("–", "-"), (" ,", ","),
    ("“", '"'), ("”", '"'), ("‘", "'"), ("’", "'"),
]
_ENDERS = {".", "!", "?", "-", ","}
_ENDERS_MTL = _ENDERS | {"、", "，", "。", "？", "！"}


def punc_norm(text: str, variant: str = "en") -> str:
    if len(text) == 0:
        return "You need to add some text for me to talk."
    if text[0].islower():
        text = text[0].upper() + text[1:]
    text = " ".join(text.split())
    reps = _PUNC_REPLACEMENTS_TURBO if variant == "turbo" else _PUNC_REPLACEMENTS
    for old, new in reps:
        text = text.replace(old, new)
    text = text.rstrip(" ")
    enders = _ENDERS_MTL if variant == "mtl" else _ENDERS
    if not any(text.endswith(p) for p in enders):
        text += "."
    return text
