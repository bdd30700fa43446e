"""Port text pipeline against the JAX package's: exact tokens and ids."""

import pytest

from code_intelligence_tpu.text import Tokenizer as JaxTokenizer
from code_intelligence_tpu.text import Vocab as JaxVocab
from code_intelligence_tpu.text import build_issue_text as jax_build
from code_intelligence_tpu_torch.text import Tokenizer, Vocab, build_issue_text
from torch_port_fixtures import MARKDOWN_DOCS, tiny_vocab


@pytest.mark.parametrize("doc", MARKDOWN_DOCS)
def test_tokens_match_jax_auto_backend(doc):
    title = doc.splitlines()[0] if doc else ""
    text = build_issue_text(title, doc)
    assert text == jax_build(title, doc)
    assert Tokenizer(backend="auto").tokenize(text) == \
        JaxTokenizer(backend="auto").tokenize(text)


def test_vocab_hash_ids_and_pad_match(tmp_path):
    jv = tiny_vocab()
    jv.save(tmp_path / "vocab.json")
    pv = Vocab.load(tmp_path / "vocab.json")
    assert pv.content_hash() == jv.content_hash()
    assert (pv.pad_id, pv.unk_id, len(pv)) == (jv.pad_id, jv.unk_id, len(jv))
    toks = Tokenizer().tokenize(build_issue_text("w3 W4 unknown", "w5 w5"))
    assert pv.numericalize(toks).tolist() == jv.numericalize(toks).tolist()
    # a reordered table hashes differently
    assert Vocab(pv.itos[::-1]).content_hash() != pv.content_hash()
    assert JaxVocab(jv.itos).content_hash() == pv.content_hash()


def test_native_backend_is_not_ported():
    with pytest.raises(NotImplementedError, match="native tokenizer"):
        Tokenizer(backend="native")
    with pytest.raises(ValueError):
        Tokenizer(backend="fast")
