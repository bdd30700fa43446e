"""Host-side tokenizer: pre-rules, a regex word split, case post-rules.

The Python backend of the JAX package's tokenizer. The native C++
backend (a faster word split with identical output on ASCII text) is not
ported yet; ``backend="auto"`` therefore always means the Python path,
which produces the same tokens by construction.
"""

from __future__ import annotations

import re
from typing import List

from code_intelligence_tpu_torch.text import rules as R

# Word / number / special-marker / punctuation splitter. Special markers
# (xxrep, xxxfldtitle, ...) are whole alnum words so they survive intact.
_TOKEN_RE = re.compile(
    r"""
    [^\W\d_]+(?:'[a-z]+)?     # unicode words incl. contractions (don't -> don 't handled below)
    |\d+(?:[.,]\d+)*          # numbers
    |[^\s\w]|_                # any single punctuation/symbol char
    """,
    re.VERBOSE | re.UNICODE,
)

_CONTRACTION_RE = re.compile(r"^([^\W\d_]+)('[a-z]+)$", re.UNICODE)


def _base_tokenize(text: str) -> List[str]:
    out: List[str] = []
    for tok in _TOKEN_RE.findall(text):
        m = _CONTRACTION_RE.match(tok)
        if m:
            out.append(m.group(1))
            out.append(m.group(2))
        else:
            out.append(tok)
    return out


class Tokenizer:
    """Pre-rules -> word split -> case post-rules, with an optional BOS."""

    def __init__(self, add_bos: bool = True, backend: str = "python"):
        """``backend``: ``"python"`` or ``"auto"`` (the same path until the
        native tokenizer is ported)."""
        if backend == "native":
            raise NotImplementedError(
                "the native tokenizer backend is not ported yet "
                "(ROADMAP.md, queue 1: native tokenizer)")
        if backend not in ("python", "auto"):
            raise ValueError(f"unknown tokenizer backend {backend!r}")
        self.pre_rules = R.default_pre_rules()
        self.post_rules = R.default_post_rules()
        self.add_bos = add_bos

    def tokenize(self, text: str) -> List[str]:
        for rule in self.pre_rules:
            text = rule(text)
        toks = _base_tokenize(text.strip())
        for rule in self.post_rules:
            toks = rule(toks)
        return [R.TK_BOS] + toks if self.add_bos else toks
