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

Ragged paged mode (:class:`RaggedSlotScheduler`, ``--scheduler ragged``),
the twin of the JAX package's: the dense step makes every row pay
``chunk_len`` steps whatever its valid tokens, so short reports pay for
long ones and idle slots burn full lanes. The ragged scheduler steps
``page_len`` tokens at a time, keeps the carried state and pool rows in
page arenas indexed by a page table that rides the staging block, and
hands the staged lengths to the encoder, whose layers then run the
length-aware kernels K2 (or K3 under int8): a step launches only as many
recurrence steps as its longest live row needs (``t_live``, read from the
host staging block, never from the device).

The step runs eagerly; capturing it in a CUDA graph, and pinned staging
buffers, are later work.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

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

    An int8 engine's layers run K3, which takes each row's valid length:
    the step passes the staged chunk lengths and their host-side maximum
    (``recurrence_steps`` counts those steps, so a run can predict K3's
    launches). An f32 engine's step runs K1 over the whole chunk.
    """

    _STAGING_EXTRA = 2  # [length, refill-reset] ride after the tokens

    def __init__(self, engine, registry=None,
                 chunk_len: Optional[int] = None):
        self.engine = engine
        self.device = engine.device
        self.batch_size = engine.batch_size
        self.chunk_len = chunk_len or engine._bucket_for_static(
            64, engine.buckets)
        # the encoder takes valid lengths (K2/K3) rather than running K1
        self._length_aware = engine.precision == "int8"
        self._t_live = 0  # this step's longest valid length, from the host
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
        # time steps the encoder's recurrence ran, summed over scheduler
        # steps (each layer launches its kernel once per such step)
        self.recurrence_steps = 0
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
        registry.gauge(
            "serve_precision_int8",
            "1 when the engine serves the int8-quantized encoder "
            "(--precision int8), 0 for f32")
        registry.gauge(
            "encoder_weight_bytes",
            "encoder weight bytes as loaded (int8 codes + f32 scales under "
            "--precision int8; the f32 checkpoint size otherwise)")
        registry.set("serve_precision_int8",
                     1 if self.engine.precision == "int8" else 0)
        registry.set("encoder_weight_bytes", self.engine.weight_bytes)
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

    def _run_chunk(self, staged: torch.Tensor, states, pool):
        """Reset the refilled rows, run the encoder on the staged chunk and
        accumulate the pool: ``(new_states, new_pool)`` for the rows given
        (the slots themselves, or the ragged scheduler's pages)."""
        C = self.chunk_len
        tokens = staged[:, :C]
        lengths = staged[:, C]
        reset = (staged[:, C + 1] > 0)[:, None]
        # refill reset: zero the slot's carried state and re-init its pool
        # row BEFORE the chunk runs, so nothing leaks across documents
        states = tuple((torch.where(reset, 0, h), torch.where(reset, 0, c))
                       for h, c in states)
        pool = torch.where(reset, self._pack_pool(
            self.engine._init_pool_state(1)), pool)
        kw = ({"valid_lens": lengths, "t_live": self._t_live}
              if self._length_aware else {})
        raw, new_states = self.engine.encoder(tokens, states, **kw)
        return new_states, self._pack_pool(self.engine._accumulate_pool(
            raw, lengths, self._unpack_pool(pool)))

    def _step(self, staged: torch.Tensor) -> None:
        """One ``(B, chunk_len)`` step on the device."""
        self._states, self._pool = self._run_chunk(staged, self._states,
                                                   self._pool)

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
        self._t_live = int(staged[:, self.chunk_len].max())
        self.recurrence_steps += (self._t_live if self._length_aware
                                  else self.chunk_len)
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


class RaggedSlotScheduler(SlotScheduler):
    """Ragged paged slot memory: length-aware continuous batching.

    Twin of the JAX package's ``RaggedSlotScheduler``, with the dense
    scheduler's API and invariants (one step shape, reset on refill,
    per-document completion, one packed staging block per step) and three
    changes:

    * the step is ``(batch, page_len)`` with ``page_len = max(8,
      chunk_len // 4)`` (16 for the 64-token dense chunk), so a row's cost
      tracks its own token count;
    * carried LSTM state and pool rows live in page arenas of ``n_pages =
      2 * batch`` rows; the staging block carries one more int32 column,
      each slot's page, and the step gathers and scatters state through
      that page table;
    * finishing a document retires its page instead of gathering it: the
      page stays untouched in the arena (the step writes only the pages
      of the slots in the table) until one batched ``index_select`` takes
      every retired page, when the free list runs dry or ``materialize``
      needs rows.

    Every step hands the staged lengths and their host maximum to the
    encoder, whose layers run K2 (K3 under int8).
    """

    _STAGING_EXTRA = 3  # [length, refill-reset, state page]

    def __init__(self, engine, registry=None):
        # B pages in the table + B retired awaiting their gather: at most
        # one finish per slot per step, so a flush always frees enough
        self.n_pages = 2 * engine.batch_size
        dense = engine._bucket_for_static(64, engine.buckets)
        super().__init__(engine, registry=registry,
                         chunk_len=max(8, dense // 4))
        self.page_len = self.chunk_len
        self._length_aware = True

    def _init_device_state(self) -> None:
        B = self.batch_size
        # slot s starts on page s; the other half feeds the free list
        self._slot_page = np.arange(B, dtype=np.int64)
        self._free_pages: Deque[int] = deque(range(B, self.n_pages))
        self._retired: List[Tuple[_Ticket, int]] = []
        self._states = init_lstm_states(self.engine.config, self.n_pages,
                                        self.device)
        self._pool = self._pack_pool(
            self.engine._init_pool_state(self.n_pages))

    # -- pages -----------------------------------------------------------------

    def pages_free(self) -> int:
        """Free-list depth (a host int)."""
        return len(self._free_pages)

    def pages_live(self) -> int:
        """Pages holding live document state: occupied slots' pages plus
        retired pages awaiting their gather."""
        return (sum(doc is not None for doc in self._slot_doc)
                + len(self._retired))

    def _export_page_gauges(self) -> None:
        if self.registry is None:
            return
        self.registry.set("slots_pages_free", self.pages_free())
        self.registry.set("slots_pages_live", self.pages_live())

    def bind_registry(self, registry) -> None:
        super().bind_registry(registry)
        if registry is None:
            return
        registry.gauge(
            "slots_pages_free",
            "ragged state-arena free-list depth (pages not bound to any "
            "slot and not awaiting emit)")
        registry.gauge(
            "slots_pages_live",
            "ragged state-arena pages holding live document state "
            "(occupied slots + retired awaiting emit)")
        self._export_page_gauges()

    # -- step ----------------------------------------------------------------

    def _step(self, staged: torch.Tensor) -> None:
        """Gather the slots' pages, run the chunk, scatter them back. The
        pages in the table are distinct, and retired pages are never in
        it, so the in-place scatter leaves them as they were."""
        pages = staged[:, self.chunk_len + 2].long()
        states = tuple((h.index_select(0, pages), c.index_select(0, pages))
                       for h, c in self._states)
        new_states, pool = self._run_chunk(
            staged, states, self._pool.index_select(0, pages))
        for (h, c), (nh, nc) in zip(self._states, new_states):
            h.index_copy_(0, pages, nh)
            c.index_copy_(0, pages, nc)
        self._pool.index_copy_(0, pages, pool)

    def _refill(self, staged: np.ndarray) -> int:
        occupied = super()._refill(staged)
        # the page table rides the same staging block: no second h2d copy
        staged[:, self.chunk_len + 2] = self._slot_page
        return occupied

    def _emit_finished(self) -> None:
        """Retire finished slots' pages (no device work here): the slot
        moves to a fresh page, and the finished one waits, untouched, for
        :meth:`_flush_retired`."""
        for s in range(self.batch_size):
            doc = self._slot_doc[s]
            if doc is None or self._slot_off[s] + self.chunk_len < len(doc.ids):
                continue
            if not self._free_pages:
                self._flush_retired()  # recycle before we run dry
            self._retired.append((doc, int(self._slot_page[s])))
            self._slot_page[s] = self._free_pages.popleft()
            self._slot_doc[s] = None
            self.docs_done += 1
            if self.registry is not None:
                self.registry.observe("slot_steps_per_doc", doc.steps)
        self._export_page_gauges()

    def _flush_retired(self) -> None:
        """One device gather of every retired page's pool row, then the
        pages go back to the free list. The gather is queued on the stream
        before any later step can write a recycled page."""
        if not self._retired:
            return
        idx = torch.tensor([p for _, p in self._retired],
                           dtype=torch.long).to(self.device)
        gathered = self._pool.index_select(0, idx)
        for k, (doc, page) in enumerate(self._retired):
            doc.gathered, doc.row = gathered, k
            self._free_pages.append(page)
        self._retired.clear()
        self._export_page_gauges()

    def materialize(self, tickets: Sequence[_Ticket]) -> np.ndarray:
        self._flush_retired()
        return super().materialize(tickets)
