"""Truncated-BPTT language-model stream loader.

The port's copy of the JAX package's ``data/lm_loader.py``, with the same
windows, offsets and seed: the whole corpus is one concatenated token
stream, sliced into ``bs`` parallel streams; each step yields an ``(x, y)``
pair of shape ``(bs, bptt)`` with ``y`` the one-token-shifted
continuation, and the recurrent hidden state is carried across
consecutive windows of an epoch. Windows are fixed-size; epochs > 0
rotate the stream by a seeded offset. The JAX loader's multi-host
slicing (``host_id``/``host_count``) waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class LMStreamLoader:
    def __init__(
        self,
        tokens: np.ndarray,
        batch_size: int,
        bptt: int,
        shuffle_offsets: bool = True,
        seed: int = 0,
    ):
        # Accept either an in-memory array or a lazy ShardedTokenView (both
        # support len() and contiguous slicing); never force materialization.
        self.tokens = (
            tokens
            if not isinstance(tokens, (np.ndarray, list, tuple))
            else np.asarray(tokens, dtype=np.int32)
        )
        self.local_bs = batch_size
        self.bptt = bptt
        self.shuffle_offsets = shuffle_offsets
        self.seed = seed

        # Need one extra token for the shifted target.
        self.stream_len = (len(self.tokens) - 1) // self.local_bs
        self.n_batches = self.stream_len // self.bptt
        if self.n_batches < 1:
            raise ValueError(
                f"corpus of {len(self.tokens)} tokens too small for "
                f"bs={batch_size} bptt={bptt}"
            )

    def __len__(self) -> int:
        return self.n_batches

    @property
    def tokens_per_epoch(self) -> int:
        return self.n_batches * self.bptt * self.local_bs

    def _circular_read(self, start: int, length: int) -> np.ndarray:
        """Read ``length`` tokens starting at ``start`` mod corpus length —
        at most two bounded slice reads, so a memory-mapped corpus is never
        materialized in host RAM."""
        n = len(self.tokens)
        start %= n
        end = start + length
        if end <= n:
            return np.asarray(self.tokens[start:end])
        return np.concatenate([self.tokens[start:], self.tokens[: end - n]])

    def epoch(self, epoch: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield ``(x, y)`` of shape ``(local_bs, bptt)`` int32 per step.

        Epochs > 0 circularly rotate the corpus by a deterministic per-epoch
        offset: cheap shuffling that keeps document continuity (the LM learns
        across doc boundaries, like the reference's concatenated stream).
        """
        off = 0
        if self.shuffle_offsets and epoch != 0:
            rng = np.random.RandomState((self.seed, epoch))
            off = int(rng.randint(0, len(self.tokens)))
        w = self.bptt + 1
        for b in range(self.n_batches):
            window = np.stack(
                [
                    self._circular_read(off + s * self.stream_len + b * self.bptt, w)
                    for s in range(self.local_bs)
                ]
            )
            yield window[:, :-1], window[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self.epoch(0)
