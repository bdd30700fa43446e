"""Text pre/post-processing rules for GitHub-issue text.

Functional equivalent of the reference's two-stage pipeline
(`py/code_intelligence/inference.py:46-53`):
``compose(mdparse.transform_pre_rules + fastai.defaults.text_pre_rules)``
followed by fastai's post-tokenization case rules. We own the rule set (the
vocab is retrained from scratch), so the special-token *names* are ours, but
the behavior class is the same:

* markdown structure (code blocks, inline code, links, images, block quotes)
  is replaced by special marker tokens so the LM sees document structure
  rather than noisy payloads;
* HTML entities are unescaped; repeated characters/words are collapsed to
  ``xxrep``/``xxwrep`` markers; case information is factored into ``xxmaj`` /
  ``xxup`` markers so the vocab stays lowercase.

The title/body document contract of the reference
(``'xxxfldtitle ' + parse(title) + ' xxxfldbody ' + parse(body)``,
`inference.py:95-126`) is preserved verbatim via :func:`build_issue_text`.
"""

from __future__ import annotations

import html
import re
from typing import Callable, Iterable, List, Sequence

# ---------------------------------------------------------------------------
# Special tokens
# ---------------------------------------------------------------------------

TK_UNK = "xxunk"
TK_PAD = "xxpad"
TK_BOS = "xxbos"
TK_EOS = "xxeos"
TK_MAJ = "xxmaj"  # next token was Capitalized
TK_UP = "xxup"  # next token was ALL-CAPS
TK_REP = "xxrep"  # char repetition: 'cccc' -> 'xxrep 4 c'
TK_WREP = "xxwrep"  # word repetition: 'no no no' -> 'xxwrep 3 no'

# Markdown structure markers (mdparse-equivalents).
TK_CODE_BLOCK = "xxcdb"  # fenced ``` block
TK_CODE_INLINE = "xxcdi"  # `inline code`
TK_LINK = "xxlnk"
TK_IMAGE = "xximg"
TK_HTML_BLOCK = "xxhtm"
TK_QUOTE = "xxqot"
TK_LIST_ITEM = "xxlst"
TK_HEADING = "xxhdr"
TK_HRULE = "xxhrl"

# Document-field markers — the reference's exact wire/vocab contract
# (`inference.py:118`). Note the triple-x: these are the literal strings the
# reference puts in training documents, so we keep them byte-identical.
TK_FLD_TITLE = "xxxfldtitle"
TK_FLD_BODY = "xxxfldbody"

SPECIALS: List[str] = [
    TK_UNK,
    TK_PAD,
    TK_BOS,
    TK_EOS,
    TK_MAJ,
    TK_UP,
    TK_REP,
    TK_WREP,
    TK_CODE_BLOCK,
    TK_CODE_INLINE,
    TK_LINK,
    TK_IMAGE,
    TK_HTML_BLOCK,
    TK_QUOTE,
    TK_LIST_ITEM,
    TK_HEADING,
    TK_HRULE,
    TK_FLD_TITLE,
    TK_FLD_BODY,
]

Rule = Callable[[str], str]

# ---------------------------------------------------------------------------
# Markdown pre-rules (mdparse-equivalent, string -> string)
# ---------------------------------------------------------------------------

# Closed fences first; an *unclosed* fence swallows to end-of-text (GitHub
# issues very often have unterminated ``` blocks — leaking raw code into the
# token stream pollutes the vocab).
_RE_FENCED_CODE = re.compile(r"```.*?(?:```|\Z)|~~~.*?(?:~~~|\Z)", re.DOTALL)
_RE_INDENT_CODE = re.compile(r"(?:^|\n)(?:(?:    |\t)[^\n]*\n?)+")
_RE_INLINE_CODE = re.compile(r"`[^`\n]+`")
_RE_IMAGE = re.compile(r"!\[([^\]]*)\]\(([^)]*)\)")
_RE_LINK = re.compile(r"\[([^\]]*)\]\(([^)]*)\)")
_RE_AUTOLINK = re.compile(r"https?://\S+|www\.\S+")
_RE_HTML_TAG = re.compile(r"<[^>\n]+>")
# GFM: '#' only opens a heading when followed by whitespace/EOL — a bare
# '#1234' at line start is an issue reference, not a heading.
_RE_HEADING = re.compile(r"^(#{1,6})(?:[ \t]+|$)", re.MULTILINE)
_RE_QUOTE = re.compile(r"^\s{0,3}>\s?", re.MULTILINE)
_RE_LIST = re.compile(r"^\s{0,3}(?:[-*+]|\d+[.)])\s+", re.MULTILINE)
_RE_HRULE = re.compile(r"^\s{0,3}(?:-{3,}|\*{3,}|_{3,})\s*$", re.MULTILINE)
# Word-boundary guards so intra-word '_'/'*' (snake_case, a*b) survive —
# GFM does not treat intra-word underscores as emphasis.
_RE_EMPHASIS = re.compile(r"(?<!\w)(\*{1,3}|_{1,3})(?=\S)(.+?)(?<=\S)\1(?!\w)")


def md_code_blocks(t: str) -> str:
    """Replace fenced/indented code blocks with a single ``xxcdb`` marker."""
    t = _RE_FENCED_CODE.sub(f" {TK_CODE_BLOCK} ", t)
    return _RE_INDENT_CODE.sub(f"\n {TK_CODE_BLOCK} \n", t)


def md_inline_code(t: str) -> str:
    return _RE_INLINE_CODE.sub(f" {TK_CODE_INLINE} ", t)


def md_images(t: str) -> str:
    return _RE_IMAGE.sub(rf" {TK_IMAGE} \1 ", t)


def md_links(t: str) -> str:
    """``[text](url)`` -> ``xxlnk text``; bare URLs -> ``xxlnk``."""
    t = _RE_LINK.sub(rf" {TK_LINK} \1 ", t)
    return _RE_AUTOLINK.sub(f" {TK_LINK} ", t)


_RE_BR = re.compile(r"<br\s*/?>", re.IGNORECASE)


def md_html(t: str) -> str:
    # <br> carries line-break semantics — convert before the generic tag
    # replacement eats it.
    t = _RE_BR.sub("\n", t)
    return _RE_HTML_TAG.sub(f" {TK_HTML_BLOCK} ", t)


def md_structure(t: str) -> str:
    """Headings, quotes, lists, horizontal rules, emphasis."""
    t = _RE_HRULE.sub(f" {TK_HRULE} ", t)
    t = _RE_HEADING.sub(f" {TK_HEADING} ", t)
    t = _RE_QUOTE.sub(f" {TK_QUOTE} ", t)
    t = _RE_LIST.sub(f" {TK_LIST_ITEM} ", t)
    return _RE_EMPHASIS.sub(r"\2", t)


MARKDOWN_PRE_RULES: List[Rule] = [
    md_code_blocks,
    md_inline_code,
    md_images,
    md_links,
    md_html,
    md_structure,
]

# ---------------------------------------------------------------------------
# Plain-text pre-rules (fastai ``defaults.text_pre_rules`` equivalents)
# ---------------------------------------------------------------------------

_RE_REP = re.compile(r"(\S)(\1{3,})")
_RE_WREP = re.compile(r"(?:^|\s)(\S+)((?:\s+\1){3,})\b")
_RE_SPACE = re.compile(r" {2,}")


def fix_html(t: str) -> str:
    """Un-escape HTML entities and normalize whitespace artifacts.

    (``<br>`` tags are handled earlier by :func:`md_html`, which runs before
    the generic tag replacement in the default rule ordering.)
    """
    t = t.replace("&nbsp;", " ")
    t = html.unescape(t)
    return t.replace(" ", " ").replace("\r", "\n")


def replace_rep(t: str) -> str:
    """``cccc`` -> ``xxrep 4 c`` (runs of 4+ of the same char)."""

    def _sub(m: re.Match) -> str:
        c, rep = m.groups()
        return f" {TK_REP} {len(rep) + 1} {c} "

    return _RE_REP.sub(_sub, t)


def replace_wrep(t: str) -> str:
    """``no no no no`` -> ``xxwrep 4 no`` (runs of 4+ of the same word)."""

    def _sub(m: re.Match) -> str:
        w, rest = m.groups()
        n = len(rest.split()) + 1
        return f" {TK_WREP} {n} {w} "

    return _RE_WREP.sub(_sub, t)


def spec_add_spaces(t: str) -> str:
    """Add spaces around ``/``, ``#``, ``@`` so paths/labels/mentions split."""
    return re.sub(r"([/#@])", r" \1 ", t)


def rm_useless_spaces(t: str) -> str:
    return _RE_SPACE.sub(" ", t)


TEXT_PRE_RULES: List[Rule] = [
    fix_html,
    replace_rep,
    replace_wrep,
    spec_add_spaces,
    rm_useless_spaces,
]


def default_pre_rules() -> List[Rule]:
    """Markdown rules then plain-text rules, matching the reference's
    ``transform_pre_rules + defaults.text_pre_rules`` ordering
    (`inference.py:52-53`)."""
    return MARKDOWN_PRE_RULES + TEXT_PRE_RULES


def compose(rules: Iterable[Rule]) -> Rule:
    def _composed(t: str) -> str:
        for r in rules:
            t = r(t)
        return t

    return _composed


def pre_process(text: str, rules: Sequence[Rule] | None = None) -> str:
    """Apply the full pre-rule chain to one field (title OR body)."""
    if not isinstance(text, str):
        text = "" if text is None else str(text)
    return compose(rules if rules is not None else default_pre_rules())(text).strip()


def build_issue_text(title: str, body: str) -> str:
    """The reference's document contract, byte-identical:
    ``'xxxfldtitle ' + parse(title) + ' xxxfldbody ' + parse(body)``
    (`py/code_intelligence/inference.py:118`)."""
    return f"{TK_FLD_TITLE} {pre_process(title)} {TK_FLD_BODY} {pre_process(body)}"


# ---------------------------------------------------------------------------
# Post-tokenization rules (token-list -> token-list): case factoring
# ---------------------------------------------------------------------------


def replace_all_caps(tokens: Sequence[str]) -> List[str]:
    """``WARNING`` -> ``xxup warning`` (fastai ``replace_all_caps`` semantics)."""
    out: List[str] = []
    for tok in tokens:
        if len(tok) > 1 and tok.isupper() and tok.isalpha():
            out.append(TK_UP)
            out.append(tok.lower())
        else:
            out.append(tok)
    return out


def deal_caps(tokens: Sequence[str]) -> List[str]:
    """``Hello`` -> ``xxmaj hello`` (fastai ``deal_caps`` semantics)."""
    out: List[str] = []
    for tok in tokens:
        if len(tok) > 1 and tok[0].isupper() and tok[1:].islower() and tok.isalpha():
            out.append(TK_MAJ)
            out.append(tok.lower())
        else:
            out.append(tok.lower() if tok.isalpha() else tok)
    return out


def default_post_rules() -> List[Callable[[Sequence[str]], List[str]]]:
    return [replace_all_caps, deal_caps]
