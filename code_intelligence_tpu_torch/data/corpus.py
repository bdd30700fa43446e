"""Sharded, memory-mappable tokenized corpus.

The port's copy of the JAX package's ``data/corpus.py``, writing and
reading the same files: N int32 ``.npy`` shards that
``np.load(mmap_mode='r')`` can stream, plus a JSON manifest carrying shard
sizes and the vocab path. Each document is stored already numericalized
with its ``xxbos`` prefix, as the LM loader concatenates documents into
one token stream. Tokenizing runs in this process (the JAX package's
process pool is not ported).
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np

from code_intelligence_tpu_torch.text.tokenizer import Tokenizer
from code_intelligence_tpu_torch.text.vocab import Vocab

PathLike = Union[str, Path]

MANIFEST_NAME = "corpus.json"


class CorpusWriter:
    """Streams numericalized documents into fixed-size token shards."""

    def __init__(self, out_dir: PathLike, shard_size_tokens: int = 32 * 1024 * 1024):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.shard_size = int(shard_size_tokens)
        self._buf: List[np.ndarray] = []
        self._buf_len = 0
        self._shards: List[dict] = []
        self._n_docs = 0

    def add_document(self, ids: np.ndarray) -> None:
        self._buf.append(np.asarray(ids, dtype=np.int32))
        self._buf_len += len(ids)
        self._n_docs += 1
        if self._buf_len >= self.shard_size:
            self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        arr = np.concatenate(self._buf)
        name = f"shard-{len(self._shards):05d}.npy"
        np.save(self.out_dir / name, arr)
        self._shards.append({"file": name, "tokens": int(arr.size)})
        self._buf, self._buf_len = [], 0

    def finalize(self, vocab: Vocab | None = None, meta: dict | None = None) -> "TokenCorpus":
        self._flush()
        if vocab is not None:
            vocab.save(self.out_dir / "vocab.json")
        manifest = {
            "shards": self._shards,
            "n_docs": self._n_docs,
            "total_tokens": int(sum(s["tokens"] for s in self._shards)),
            "vocab": "vocab.json" if vocab is not None else None,
            "meta": meta or {},
        }
        (self.out_dir / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
        return TokenCorpus(self.out_dir)


class ShardedTokenView:
    """A read-only, lazily memory-mapped view over N token shards that
    presents one logical 1-D int32 array (``len()`` + contiguous slicing).

    This is what keeps the training path O(window) in host RAM: the
    ``LMStreamLoader`` reads bounded ``view[start:end]`` slices and only
    those bytes are ever paged in.
    """

    def __init__(self, shard_files: Sequence[Path], shard_tokens: Sequence[int]):
        self._files = list(shard_files)
        self._mmaps: List[Optional[np.ndarray]] = [None] * len(self._files)
        self._starts = np.cumsum([0] + list(shard_tokens))
        self._len = int(self._starts[-1])

    def __len__(self) -> int:
        return self._len

    @property
    def dtype(self):
        return np.int32

    def _shard(self, i: int) -> np.ndarray:
        if self._mmaps[i] is None:
            self._mmaps[i] = np.load(self._files[i], mmap_mode="r")
        return self._mmaps[i]

    def __getitem__(self, sl: slice) -> np.ndarray:
        if not isinstance(sl, slice) or sl.step not in (None, 1):
            raise TypeError("ShardedTokenView supports contiguous slices only")
        start, stop, _ = sl.indices(self._len)
        if stop <= start:
            return np.zeros((0,), np.int32)
        lo = int(np.searchsorted(self._starts, start, side="right") - 1)
        out: List[np.ndarray] = []
        pos = start
        i = lo
        while pos < stop and i < len(self._files):
            shard = self._shard(i)
            s0 = int(self._starts[i])
            take = min(stop, s0 + len(shard)) - pos
            out.append(np.asarray(shard[pos - s0 : pos - s0 + take]))
            pos += take
            i += 1
        return out[0] if len(out) == 1 else np.concatenate(out)


class TokenCorpus:
    """Read side: lazily memory-maps shards; presents one logical stream."""

    def __init__(self, path: PathLike):
        self.dir = Path(path)
        manifest = json.loads((self.dir / MANIFEST_NAME).read_text())
        self.shard_files = [self.dir / s["file"] for s in manifest["shards"]]
        self.shard_tokens = [s["tokens"] for s in manifest["shards"]]
        self.total_tokens = manifest["total_tokens"]
        self.n_docs = manifest["n_docs"]
        self.meta = manifest.get("meta", {})
        self._vocab_file = manifest.get("vocab")

    @property
    def vocab(self) -> Vocab:
        if self._vocab_file is None:
            raise ValueError("corpus was written without a vocab")
        return Vocab.load(self.dir / self._vocab_file)

    def stream(self) -> ShardedTokenView:
        """Lazy mmap'd view of the whole stream — feed this (not
        :meth:`tokens`) to ``LMStreamLoader`` for large corpora."""
        return ShardedTokenView(self.shard_files, self.shard_tokens)

    def iter_shards(self) -> Iterator[np.ndarray]:
        for f in self.shard_files:
            yield np.load(f, mmap_mode="r")

    def tokens(self, max_tokens: int | None = None) -> np.ndarray:
        """Materialize up to ``max_tokens`` of the stream (loads shards lazily
        so a bounded read never touches later shards)."""
        out: List[np.ndarray] = []
        got = 0
        for shard in self.iter_shards():
            take = len(shard) if max_tokens is None else min(len(shard), max_tokens - got)
            if take <= 0:
                break
            out.append(np.asarray(shard[:take]))
            got += take
        if not out:
            return np.zeros((0,), dtype=np.int32)
        return np.concatenate(out)


def _iter_chunks(texts: Iterable[str], n: int) -> Iterator[List[str]]:
    chunk: List[str] = []
    for t in texts:
        chunk.append(t)
        if len(chunk) >= n:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def build_corpus(
    texts: Iterable[str],
    out_dir: PathLike,
    vocab: Vocab | None = None,
    max_vocab: int = 60000,
    min_freq: int = 2,
    valid_frac: float = 0.1,
    seed: int = 42,
    shard_size_tokens: int = 32 * 1024 * 1024,
    chunk_docs: int = 8192,
) -> tuple["TokenCorpus", "TokenCorpus"]:
    """Tokenize texts -> build/reuse vocab -> write train+valid corpora.

    Pre-rules + tokenize, shuffle + valid/train split, vocab (from the
    train split) + numericalize; the same corpora as the JAX package's
    ``build_corpus`` for the same texts and seed. Returns
    ``(train, valid)``.

    Streaming: ``texts`` is consumed once, ``chunk_docs`` documents at a
    time; tokenized docs are spooled to disk between the two passes, so
    host RAM stays O(chunk). Shuffling is therefore chunk-level (exact
    per-chunk valid/train balance via a carry accumulator) rather than one
    global permutation.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    spool_path = out_dir / "_spool.txt"

    counts: Counter | None = Counter() if vocab is None else None
    n_train = 0
    n_valid = 0
    tok = Tokenizer(add_bos=True)
    with spool_path.open("w", encoding="utf-8") as spool:
        for chunk_idx, chunk in enumerate(_iter_chunks(texts, chunk_docs)):
            docs = [tok.tokenize(t) for t in chunk]
            order = np.random.RandomState((seed, chunk_idx)).permutation(len(docs))
            # Carry accumulator keeps the global valid fraction exact.
            total = n_train + n_valid + len(docs)
            want_valid = int(round(total * valid_frac)) - n_valid
            want_valid = max(0, min(want_valid, len(docs)))
            valid_set = set(order[:want_valid].tolist())
            for j in order:
                doc = docs[int(j)]
                if int(j) in valid_set:
                    n_valid += 1
                    spool.write("v " + " ".join(doc) + "\n")
                else:
                    n_train += 1
                    if counts is not None:
                        counts.update(doc)  # vocab from train split only
                    spool.write("t " + " ".join(doc) + "\n")

    if vocab is None:
        assert counts is not None
        vocab = Vocab.from_counts(counts, max_vocab=max_vocab, min_freq=min_freq)

    writers = {
        "t": CorpusWriter(out_dir / "train", shard_size_tokens),
        "v": CorpusWriter(out_dir / "valid", shard_size_tokens),
    }
    with spool_path.open("r", encoding="utf-8") as spool:
        for line in spool:
            split, _, rest = line.rstrip("\n").partition(" ")
            toks = rest.split(" ") if rest else []
            writers[split].add_document(vocab.numericalize(toks))
    spool_path.unlink()
    train = writers["t"].finalize(vocab)
    valid = writers["v"].finalize(vocab)
    return train, valid
