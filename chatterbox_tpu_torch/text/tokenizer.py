"""Text tokenizers and punctuation normalization (the port's own copy of
chatterbox_tpu/text/tokenizer.py):

  * EnTokenizer: the 520M model's BPE (`tokenizer.json`, HF `tokenizers`)
    with spaces written as [SPACE];
  * HFTokenizer: the GPT-2 BPE of Turbo / Nano through transformers'
    AutoTokenizer (the JAX Turbo loader's `_HFTok`);
  * MTLTokenizer: the multilingual grapheme vocabulary
    (`grapheme_mtl_merged_expanded_v1.json`): lowercase and NFKD, then a
    per-language normalizer (zh Cangjie codes, ja kanji -> hiragana, he
    diacritics, ko Jamo, ru stress marks), then the `[lang]` prefix;
  * punc_norm: the punctuation clean-up every pipeline applies first.

The heavy normalizers (pykakasi, dicta_onnx, russian_text_stresser,
spacy_pkuseg) are optional: each is imported on first use and, where it
does not import, the text passes through unchanged with a warning, as in
the JAX package. Korean Jamo decomposition is plain Python.
`tokenizers` and `transformers` are imported when a tokenizer is built,
never when this module is imported.
"""
from __future__ import annotations

import json
import logging
import unicodedata
from pathlib import Path
from unicodedata import category, normalize

import numpy as np

logger = logging.getLogger(__name__)

SOT = "[START]"
EOT = "[STOP]"
UNK = "[UNK]"
SPACE = "[SPACE]"
SPECIAL_TOKENS = [SOT, EOT, UNK, SPACE, "[PAD]", "[SEP]", "[CLS]", "[MASK]"]


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


# ---------------------------------------------------------------------------
# multilingual normalizers
# ---------------------------------------------------------------------------

_kakasi = None
_dicta = None
_russian_stresser = None


def is_kanji(c: str) -> bool:
    return 19968 <= ord(c) <= 40959


def is_katakana(c: str) -> bool:
    return 12449 <= ord(c) <= 12538


def hiragana_normalize(text: str) -> str:
    """Japanese: kanji -> hiragana via pykakasi (optional), then NFKD."""
    global _kakasi
    try:
        if _kakasi is None:
            import pykakasi
            _kakasi = pykakasi.kakasi()
        out = []
        for r in _kakasi.convert(text):
            inp, hira = r["orig"], r["hira"]
            if any(is_kanji(c) for c in inp):
                if hira and hira[0] in ("は", "へ"):
                    hira = " " + hira
                out.append(hira)
            else:
                out.append(inp)
        return unicodedata.normalize("NFKD", "".join(out))
    except ImportError:
        logger.warning("pykakasi not available - Japanese text processing skipped")
        return text


def add_hebrew_diacritics(text: str) -> str:
    """Hebrew: diacritics via dicta_onnx (optional)."""
    global _dicta
    try:
        if _dicta is None:
            from dicta_onnx import Dicta
            _dicta = Dicta()
        return _dicta.add_diacritics(text)
    except ImportError:
        logger.warning("dicta_onnx not available - Hebrew text processing skipped")
        return text
    except Exception as e:
        logger.warning(f"Hebrew diacritization failed: {e}")
        return text


def korean_normalize(text: str) -> str:
    """Korean: each Hangul syllable decomposed into its Jamo."""
    def decompose(ch):
        if not ("가" <= ch <= "힯"):
            return ch
        base = ord(ch) - 0xAC00
        initial = chr(0x1100 + base // (21 * 28))
        medial = chr(0x1161 + (base % (21 * 28)) // 28)
        final = chr(0x11A7 + base % 28) if base % 28 > 0 else ""
        return initial + medial + final
    return "".join(decompose(c) for c in text).strip()


def add_russian_stress(text: str) -> str:
    """Russian: stress marks via russian_text_stresser (optional)."""
    global _russian_stresser
    try:
        if _russian_stresser is None:
            from russian_text_stresser.text_stresser import RussianTextStresser
            _russian_stresser = RussianTextStresser()
        return _russian_stresser.stress_text(text)
    except ImportError:
        logger.warning("russian_text_stresser not available - stress labeling skipped")
        return text
    except Exception as e:
        logger.warning(f"Russian stress labeling failed: {e}")
        return text


class ChineseCangjieConverter:
    """Chinese glyphs -> Cangjie code tokens. The mapping, `Cangjie5_TC.json`
    (a list of "glyph\tcode" entries), is read from `model_dir`; the second
    and later glyphs of one code carry their index after it. Word
    segmentation by spacy_pkuseg is optional."""

    def __init__(self, model_dir=None):
        self.word2cj: dict[str, str] = {}
        self.cj2word: dict[str, list[str]] = {}
        self.segmenter = None
        self._load_mapping(model_dir)
        try:
            from spacy_pkuseg import pkuseg
            self.segmenter = pkuseg()
        except ImportError:
            logger.warning("pkuseg not available - Chinese segmentation will be skipped")

    def _load_mapping(self, model_dir):
        path = Path(model_dir) / "Cangjie5_TC.json" if model_dir else None
        if path is not None and path.exists():
            with open(path, encoding="utf-8") as fp:
                data = json.load(fp)
            for entry in data:
                word, code = entry.split("\t")[:2]
                self.word2cj[word] = code
                self.cj2word.setdefault(code, []).append(word)
            return
        logger.warning("Could not load Cangjie mapping (Cangjie5_TC.json not found)")

    def _encode_glyph(self, glyph: str):
        code = self.word2cj.get(glyph)
        if code is None:
            return None
        index = self.cj2word[code].index(glyph)
        return code + (str(index) if index > 0 else "")

    def __call__(self, text: str) -> str:
        if self.segmenter is not None:
            text = " ".join(self.segmenter.cut(text))
        out = []
        for t in text:
            cj = self._encode_glyph(t) if category(t) == "Lo" else None
            if cj is None:
                out.append(t)
            else:
                out.append("".join(f"[cj_{c}]" for c in cj) + "[cj_.]")
        return "".join(out)


class MTLTokenizer:
    """The multilingual grapheme tokenizer; Cangjie5_TC.json is looked up
    beside the vocabulary file."""

    def __init__(self, vocab_file_path: str):
        from tokenizers import Tokenizer
        self.tokenizer = Tokenizer.from_file(vocab_file_path)
        self.cangjie_converter = ChineseCangjieConverter(Path(vocab_file_path).parent)
        voc = self.tokenizer.get_vocab()
        assert SOT in voc and EOT in voc, "vocab must contain [START]/[STOP]"

    def preprocess_text(self, raw_text: str, lowercase=True, nfkd_normalize=True) -> str:
        t = raw_text
        if lowercase:
            t = t.lower()
        if nfkd_normalize:
            t = normalize("NFKD", t)
        return t

    def encode(self, txt: str, language_id: str | None = None,
               lowercase=True, nfkd_normalize=True) -> list[int]:
        txt = self.preprocess_text(txt, lowercase, nfkd_normalize)
        if language_id == "zh":
            txt = self.cangjie_converter(txt)
        elif language_id == "ja":
            txt = hiragana_normalize(txt)
        elif language_id == "he":
            txt = add_hebrew_diacritics(txt)
        elif language_id == "ko":
            txt = korean_normalize(txt)
        elif language_id == "ru":
            txt = add_russian_stress(txt)
        if language_id:
            txt = f"[{language_id.lower()}]{txt}"
        return self.tokenizer.encode(txt.replace(" ", SPACE)).ids

    def text_to_tokens(self, text: str, language_id: str | None = None,
                       **kw) -> np.ndarray:
        return np.asarray(self.encode(text, language_id=language_id, **kw), np.int32)[None]

    def decode(self, seq) -> str:
        seq = np.asarray(seq).reshape(-1).tolist()
        txt = self.tokenizer.decode(seq, skip_special_tokens=False)
        return (txt.replace(" ", "").replace(SPACE, " ")
                   .replace(EOT, "").replace(UNK, ""))


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
