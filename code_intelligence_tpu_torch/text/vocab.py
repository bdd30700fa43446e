"""Vocabulary: token <-> id mapping, loaded from an export's ``vocab.json``."""

from __future__ import annotations

import hashlib
import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Sequence, Union

import numpy as np

from code_intelligence_tpu_torch.text import rules as R

PathLike = Union[str, Path]


class Vocab:
    def __init__(self, itos: Sequence[str]):
        self.itos: List[str] = list(itos)
        self.stoi: Dict[str, int] = {tok: i for i, tok in enumerate(self.itos)}
        if R.TK_UNK not in self.stoi:
            raise ValueError(f"vocab must contain {R.TK_UNK!r}")
        self.unk_id = self.stoi[R.TK_UNK]
        self.pad_id = self.stoi.get(R.TK_PAD, self.unk_id)

    def __len__(self) -> int:
        return len(self.itos)

    @classmethod
    def from_counts(cls, counts: "Counter[str]", max_vocab: int = 60000,
                    min_freq: int = 2) -> "Vocab":
        """Most-frequent-first vocab with the special tokens pinned to the
        lowest ids, as the JAX package's ``Vocab.from_counts`` builds it."""
        itos = list(R.SPECIALS)
        seen = set(itos)
        for tok, c in counts.most_common():
            if len(itos) >= max_vocab:
                break
            if c < min_freq or tok in seen:
                continue
            itos.append(tok)
            seen.add(tok)
        return cls(itos)

    def numericalize(self, tokens: Sequence[str]) -> np.ndarray:
        unk = self.unk_id
        return np.asarray([self.stoi.get(t, unk) for t in tokens], dtype=np.int32)

    def content_hash(self) -> str:
        """Order-sensitive hash of the id->token table (equal to the JAX
        package's for the same table): two vocabs that numericalize any
        document differently hash differently."""
        h = hashlib.blake2b(digest_size=8)
        for tok in self.itos:
            h.update(tok.encode("utf-8", "replace"))
            h.update(b"\x00")
        return h.hexdigest()

    def save(self, path: PathLike) -> None:
        Path(path).write_text(json.dumps({"itos": self.itos}))

    @classmethod
    def load(cls, path: PathLike) -> "Vocab":
        return cls(json.loads(Path(path).read_text())["itos"])
