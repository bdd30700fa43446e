"""Continuous slot-based batching for the embedding serve path.

Port of the JAX package's dense ``inference/slots.py::SlotScheduler``:

* One ``(batch_size, chunk_len)`` step for the scheduler's lifetime. Rows
  are **slots**, each holding one in-flight document's carried LSTM state
  and pool accumulators.
* When a slot's document finishes (known from host-side offsets, with no
  device read), its pool row is gathered on the device and the slot is
  refilled from the queue on the next step.
* Each step moves ONE host->device block: tokens, per-slot chunk lengths
  and the refill-reset bits ride a packed ``(B, chunk_len + 2)`` int32
  staging buffer (double-buffered on the host). The pool rides one packed
  ``(B, 3*emb_sz + 1)`` float32 tensor.
* ``materialize`` fetches every finished row with ONE device->host copy.

Invariant: slot reuse never leaks state across documents. A refill sets
the slot's reset bit, and the step zeroes that slot's LSTM state and
re-initializes its pool row before the chunk runs.

The step runs eagerly; capturing it in a CUDA graph, and pinned staging
buffers, are later work.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np
import torch

from code_intelligence_tpu_torch.models import init_lstm_states

# occupancy / steps-per-doc histogram edges: small integers
_COUNT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


class _Ticket:
    """One submitted document: its ids and, once finished, a reference into
    its finish batch's gathered pool rows."""

    __slots__ = ("ids", "gathered", "row", "steps")

    def __init__(self, ids: np.ndarray):
        self.ids = np.asarray(ids, np.int32).reshape(-1)
        self.gathered: Optional[torch.Tensor] = None  # (m, 3E+1) rows
        self.row = 0  # this doc's row within that gather
        self.steps = 0

    @property
    def done(self) -> bool:
        return self.gathered is not None


class SlotScheduler:
    """Persistent continuous-batching step loop over an engine's encoder.

    The step's ``chunk_len`` is the engine's bucket nearest 64 tokens, as
    in the JAX package: short reports don't ride a 512-wide step, and long
    docs don't dissolve into per-step overhead.
    """

    _STAGING_EXTRA = 2  # [length, refill-reset] ride after the tokens

    def __init__(self, engine, registry=None):
        self.engine = engine
        self.device = engine.device
        self.batch_size = engine.batch_size
        self.chunk_len = engine._bucket_for_static(64, engine.buckets)
        self.registry = None
        self._lock = threading.Lock()  # serializes embed_ids callers
        B, C = self.batch_size, self.chunk_len
        self._slot_doc: List[Optional[_Ticket]] = [None] * B
        self._slot_off = np.zeros((B,), np.int64)
        self._queue: Deque[_Ticket] = deque()
        self._staging = [
            np.full((B, C + self._STAGING_EXTRA), engine.vocab.pad_id,
                    np.int32)
            for _ in range(2)
        ]
        self._parity = 0
        self._init_device_state()
        self.steps_run = 0
        self.docs_done = 0
        # lane accounting from the host staging buffer: stepped = every
        # lane-token a step paid for, valid = the ones carrying content
        self.tokens_stepped = 0
        self.tokens_valid = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        if registry is not None:
            self.bind_registry(registry)

    def _init_device_state(self) -> None:
        self._states = init_lstm_states(self.engine.config, self.batch_size,
                                        self.device)
        self._pool = self._pack_pool(
            self.engine._init_pool_state(self.batch_size))

    # -- metrics -----------------------------------------------------------

    def bind_registry(self, registry) -> None:
        """Attach a ``utils.metrics.Registry`` (idempotent)."""
        if registry is None or self.registry is registry:
            return
        registry.histogram(
            "slot_occupancy", "occupied slots per scheduler step",
            buckets=_COUNT_BUCKETS)
        registry.histogram(
            "slot_steps_per_doc", "chunk steps each document needed",
            buckets=_COUNT_BUCKETS)
        registry.gauge(
            "slot_refill_queue_depth", "documents waiting for a free slot")
        registry.gauge(
            "slots_wasted_lane_fraction",
            "masked tokens / stepped tokens over the scheduler lifetime")
        registry.gauge(
            "h2d_d2h_bytes",
            "bytes moved across the host-device boundary by the serve "
            "path, by direction")
        self.registry = registry
        self._export_transfer_gauges()

    def _export_transfer_gauges(self) -> None:
        if self.registry is None:
            return
        self.registry.set("h2d_d2h_bytes", self.h2d_bytes,
                          labels={"dir": "h2d"})
        self.registry.set("h2d_d2h_bytes", self.d2h_bytes,
                          labels={"dir": "d2h"})

    def wasted_lane_fraction(self) -> float:
        if self.tokens_stepped <= 0:
            return 0.0
        return 1.0 - self.tokens_valid / self.tokens_stepped

    # -- step ----------------------------------------------------------------

    @staticmethod
    def _pack_pool(pool_state) -> torch.Tensor:
        """4-tuple pool (engine layout) -> packed ``(B, 3E+1)``."""
        psum, pmax, plast, pcount = pool_state
        return torch.cat([psum, pmax, plast, pcount[:, None]], dim=1)

    def _unpack_pool(self, pool: torch.Tensor):
        E = self.engine.config.emb_sz
        return (pool[:, :E], pool[:, E:2 * E], pool[:, 2 * E:3 * E],
                pool[:, 3 * E])

    def _step(self, staged: torch.Tensor) -> None:
        """One ``(B, chunk_len)`` step on the device: reset refilled slots,
        run the encoder on the chunk, accumulate the pool."""
        C = self.chunk_len
        tokens = staged[:, :C]
        lengths = staged[:, C]
        reset = (staged[:, C + 1] > 0)[:, None]
        # refill reset: zero the slot's carried state and re-init its pool
        # row BEFORE the chunk runs, so nothing leaks across documents
        states = tuple((torch.where(reset, 0, h), torch.where(reset, 0, c))
                       for h, c in self._states)
        pool = torch.where(reset, self._pack_pool(
            self.engine._init_pool_state(1)), self._pool)
        raw, self._states = self.engine.encoder(tokens, states)
        self._pool = self._pack_pool(self.engine._accumulate_pool(
            raw, lengths, self._unpack_pool(pool)))

    # -- scheduling ------------------------------------------------------------

    def submit(self, ids: np.ndarray) -> _Ticket:
        """Queue one numericalized document; returns its ticket."""
        t = _Ticket(ids)
        self._queue.append(t)
        return t

    def _refill(self, staged: np.ndarray) -> int:
        """Fill free slots from the queue and stage every active slot's
        next chunk into ``staged``. Returns the occupancy."""
        B, C = self.batch_size, self.chunk_len
        staged[:, C:] = 0  # lengths + reset bits
        occupied = 0
        for s in range(B):
            if self._slot_doc[s] is None and self._queue:
                self._slot_doc[s] = self._queue.popleft()
                self._slot_off[s] = 0
                staged[s, C + 1] = 1
            doc = self._slot_doc[s]
            if doc is None:
                continue  # idle slot: length 0, stale tokens are masked out
            occupied += 1
            off = self._slot_off[s]
            chunk = doc.ids[off:off + C]
            staged[s, :len(chunk)] = chunk
            staged[s, C] = len(chunk)
            doc.steps += 1
        return occupied

    def _emit_finished(self) -> None:
        """Mark slots whose document's last chunk just ran, and gather
        their pool rows with one device gather (no host sync)."""
        done_slots = [
            s for s, doc in enumerate(self._slot_doc)
            if doc is not None
            and self._slot_off[s] + self.chunk_len >= len(doc.ids)
        ]
        if not done_slots:
            return
        idx = torch.tensor(done_slots, dtype=torch.long).to(self.device)
        gathered = self._pool.index_select(0, idx)
        for k, s in enumerate(done_slots):
            doc = self._slot_doc[s]
            doc.gathered, doc.row = gathered, k
            self._slot_doc[s] = None
            self.docs_done += 1
            if self.registry is not None:
                self.registry.observe("slot_steps_per_doc", doc.steps)

    def _advance(self) -> bool:
        """One scheduler step: refill, stage, dispatch, emit. Returns False
        when there is nothing left to run."""
        staged = self._staging[self._parity]
        self._parity ^= 1
        occupied = self._refill(staged)
        if occupied == 0:
            return False
        self.tokens_stepped += self.batch_size * self.chunk_len
        self.tokens_valid += int(staged[:, self.chunk_len].sum())
        if self.registry is not None:
            self.registry.observe("slot_occupancy", occupied)
            self.registry.set("slot_refill_queue_depth", len(self._queue))
            self.registry.set("slots_wasted_lane_fraction",
                              self.wasted_lane_fraction())
        self.h2d_bytes += int(staged.nbytes)  # the ONE h2d block per step
        with torch.inference_mode():
            self._step(torch.from_numpy(staged).to(self.device))
            self.steps_run += 1
            self._emit_finished()
        for s, doc in enumerate(self._slot_doc):
            if doc is not None:
                self._slot_off[s] += self.chunk_len
        return True

    def drain(self) -> None:
        """Run steps until every queued and in-flight document finished."""
        while self._advance():
            pass
        if self.registry is not None:
            self.registry.set("slot_refill_queue_depth", len(self._queue))

    def reset(self) -> None:
        """Rebuild the device state and empty the slot table. ``embed_ids``
        calls it on any failure: the failing call's documents are lost (the
        caller sees the error), and the next call gets a healthy
        scheduler."""
        self._slot_doc = [None] * self.batch_size
        self._slot_off[:] = 0
        self._queue.clear()
        self._parity = 0
        self._init_device_state()

    # -- results ---------------------------------------------------------------

    def materialize(self, tickets: Sequence[_Ticket]) -> np.ndarray:
        """Host embeddings of finished tickets, with ONE device->host copy
        of all their finish batches' rows."""
        offsets = {}  # id(gathered) -> row offset in the concatenation
        parts = []
        total = 0
        for t in tickets:
            if not t.done:
                raise RuntimeError("ticket not finished; call drain() first")
            key = id(t.gathered)
            if key not in offsets:
                offsets[key] = total
                parts.append(t.gathered)
                total += t.gathered.shape[0]
        host = torch.cat(parts, dim=0).cpu().numpy()
        self.d2h_bytes += int(host.nbytes)
        self._export_transfer_gauges()
        rows = np.stack([host[offsets[id(t.gathered)] + t.row]
                         for t in tickets])
        E = self.engine.config.emb_sz
        return self.engine._finalize(
            (rows[:, :E], rows[:, E:2 * E], rows[:, 2 * E:3 * E],
             rows[:, 3 * E]))

    # -- public API --------------------------------------------------------------

    def embed_ids(self, id_seqs: Sequence[np.ndarray]) -> np.ndarray:
        """Embed numericalized docs through the slot loop; returns
        ``(N, 3*emb_sz)`` float32 in input order."""
        if len(id_seqs) == 0:
            return np.zeros((0, self.engine.embed_dim), np.float32)
        with self._lock:
            tickets = [self.submit(ids) for ids in id_seqs]
            try:
                self.drain()
                return self.materialize(tickets)
            except Exception:
                self.reset()
                raise
