"""Punctuation normalization before tokenizing (the port's own copy of
`punc_norm` in chatterbox_tpu/text/tokenizer.py)."""
from __future__ import annotations

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
