"""The port's text tokenizer module (chatterbox_tpu_torch/text/tokenizer.py)
against chatterbox_tpu's: EnTokenizer on a BPE `tokenizer.json` trained in a
tmp dir with the chatterbox special tokens (as tests/test_text.py builds
it), and punc_norm. The Turbo GPT-2 wrapper is held against the JAX
loader's in tests/test_torch_load.py."""
import numpy as np
import pytest

pytest.importorskip("tokenizers")

from chatterbox_tpu.text import tokenizer as jtok  # noqa: E402

from chatterbox_tpu_torch.text import tokenizer as tok  # noqa: E402

TEXTS = ["Hello world, this is a test.", "the tokenizer marks a space",
         "Unseen words: zebra quokka!", ""]


def train_en_bpe(path, vocab_size=200):
    """A BPE with the chatterbox special tokens, written to `path`."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    t = Tokenizer(models.BPE(unk_token="[UNK]"))
    t.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=[
        "[START]", "[STOP]", "[UNK]", "[SPACE]", "[PAD]", "[SEP]", "[CLS]", "[MASK]"])
    t.train_from_iterator(["hello world this is a test of the tokenizer " * 5,
                           "[SPACE] marks a space in chatterbox vocabularies"], trainer)
    t.save(str(path))
    return str(path)


@pytest.fixture(scope="module")
def bpe_file(tmp_path_factory):
    return train_en_bpe(tmp_path_factory.mktemp("tok") / "tokenizer.json")


@pytest.mark.parametrize("text", TEXTS)
def test_en_tokenizer_matches_jax(bpe_file, text):
    ours, theirs = tok.EnTokenizer(bpe_file), jtok.EnTokenizer(bpe_file)
    ids = ours.text_to_tokens(text)
    ref = theirs.text_to_tokens(text)
    assert ids.dtype == ref.dtype == np.int32 and ids.shape == ref.shape
    np.testing.assert_array_equal(ids, ref)
    assert ours.decode(ids) == theirs.decode(ref)


def test_en_tokenizer_refuses_a_vocab_without_start_stop(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    t = Tokenizer(models.BPE(unk_token="[UNK]"))
    t.pre_tokenizer = pre_tokenizers.Whitespace()
    t.train_from_iterator(["plain text only"], trainers.BpeTrainer(
        vocab_size=50, special_tokens=["[UNK]"]))
    t.save(str(tmp_path / "plain.json"))
    with pytest.raises(AssertionError, match="START"):
        tok.EnTokenizer(str(tmp_path / "plain.json"))


@pytest.mark.parametrize("variant", ["en", "turbo", "mtl"])
@pytest.mark.parametrize("text", ["", "hello…  world — yes: no; “quoted” ‘x’ ...",
                                  "Ends with comma ,", "already done!", "lower case start"])
def test_punc_norm_matches_jax(text, variant):
    assert tok.punc_norm(text, variant=variant) == jtok.punc_norm(text, variant=variant)
