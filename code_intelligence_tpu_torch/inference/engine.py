"""Pooled-embedding inference engine.

Port of the JAX package's ``inference/engine.py::InferenceEngine``:
tokenize -> encoder forward -> concat[mean, max, last] of the last
layer's hidden states -> a ``3*emb_sz`` (2400-d) float32 embedding.

* Three batching paths: ``"slots"`` (continuous batching,
  ``inference/slots.py``; the server's default), ``"ragged"`` (the same
  loop with paged state and a 16-token length-aware step,
  ``RaggedSlotScheduler``) and ``"groups"`` (the length-sorted lock-step
  path, kept as the parity reference).
* Docs longer than the largest bucket run in ``chunk_len`` windows whose
  LSTM state carries across chunks; pooling accumulates across chunks and
  masks padding, so it equals full-sequence pooling.

* ``precision="int8"`` quantizes the f32 export at load
  (``ops/quantize.py``): int8 codes plus f32 per-channel scales replace
  the embedding and every LSTM weight, as in the JAX engine.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``.
Every LSTM layer goes through a kernel of ``ops/fused_lstm.py``: K1 on
the dense paths, K2 on the ragged one, K3 on every path under int8;
``plain=True`` runs the kernels' plain PyTorch versions instead, as the
reference on the card. Mesh serving and the flight recorder are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from code_intelligence_tpu_torch.models import (
    AWDLSTMConfig,
    AWDLSTMEncoder,
    init_lstm_states,
)
from code_intelligence_tpu_torch.ops.quantize import (
    SCALE_SUFFIX,
    quantize_encoder_params,
    tree_bytes,
)
from code_intelligence_tpu_torch.text import (
    TK_UNK,
    Tokenizer,
    Vocab,
    build_issue_text,
)
from code_intelligence_tpu_torch.training.checkpoint import (
    load_encoder,
    params_from_numpy,
)
from code_intelligence_tpu_torch.utils.device import resolve_device


class InferenceEngine:
    """Batched pooled-embedding inference over a frozen encoder."""

    def __init__(
        self,
        params: dict,
        config: AWDLSTMConfig,
        vocab: Vocab,
        buckets: Sequence[int] = (32, 64, 128, 256, 512),
        batch_size: int = 32,
        scheduler: str = "groups",
        version: str = "unversioned",
        device="cuda",
        plain: bool = False,
        precision: str = "f32",
    ):
        self.device = resolve_device(device)
        if precision not in ("f32", "int8"):
            raise ValueError(
                f"precision must be 'f32' or 'int8', got {precision!r}")
        # the engine owns the serve precision; exports stay f32
        config = dataclasses.replace(config, precision=precision)
        self.precision = precision
        self.config = config
        self.vocab = vocab
        enc = params_from_numpy(params)
        # the footprint before quantization: the f32 baseline of the
        # encoder_weight_bytes gauge and of the int8 check's ratio
        self.weight_bytes_f32 = tree_bytes(enc)
        if precision == "int8" and "embedding" + SCALE_SUFFIX not in enc:
            enc = params_from_numpy(quantize_encoder_params(
                {k: v.numpy() for k, v in enc.items()}, config))
        self.weight_bytes = tree_bytes(enc)
        self.encoder = AWDLSTMEncoder(config, device=self.device, plain=plain)
        self.encoder.load_state_dict(enc)
        self.encoder.eval()
        self.buckets = tuple(sorted(buckets))
        self.batch_size = batch_size
        # the groups path's window for docs longer than the largest bucket
        self.chunk_len = self.buckets[-1]
        self.tokenizer = Tokenizer(backend="auto")
        self.embed_dim = 3 * config.emb_sz
        self.scheduler = self._check_scheduler(scheduler)
        self._slot_scheduler = None
        self._ragged_scheduler = None
        self.version = version
        self.vocab_hash = vocab.content_hash()

    @classmethod
    def from_export(cls, model_dir, **kw) -> "InferenceEngine":
        """Load an export directory (``encoder_params.npz``,
        ``model_config.json``, ``vocab.json``)."""
        params, config, vocab_path = load_encoder(model_dir)
        if vocab_path is None:
            raise FileNotFoundError(f"no vocab.json in {model_dir}")
        return cls(params, config, Vocab.load(vocab_path), **kw)

    def warmup(self) -> None:
        """Run one document through the default scheduler before traffic:
        builds and loads the kernels and warms the allocator."""
        self.embed_issues([{"title": "warmup", "body": "warmup body"}])

    # -- pooling -----------------------------------------------------------

    def _init_pool_state(self, batch: int):
        E = self.config.emb_sz
        kw = {"dtype": torch.float32, "device": self.device}
        return (torch.zeros((batch, E), **kw),
                torch.full((batch, E), -torch.inf, **kw),
                torch.zeros((batch, E), **kw),
                torch.zeros((batch,), **kw))

    @staticmethod
    def _accumulate_pool(raw: torch.Tensor, lengths: torch.Tensor, pool_state):
        """Masked [mean, max, last] accumulation of one chunk's hidden
        states ``raw (B, T, E)`` into the carried pool: the one copy of the
        pooling math that both batching paths run."""
        raw = raw.float()
        T = raw.shape[1]
        mask = torch.arange(T, device=raw.device)[None, :] < lengths[:, None]
        m3 = mask[:, :, None]
        psum, pmax, plast, pcount = pool_state
        psum = psum + (raw * m3).sum(dim=1)
        pmax = torch.maximum(
            pmax, torch.where(m3, raw, -torch.inf).amax(dim=1))
        # last valid position in THIS chunk (if any); else keep previous
        idx = (lengths.long() - 1).clamp(0, T - 1)
        last_here = raw.gather(
            1, idx[:, None, None].expand(-1, 1, raw.shape[2]))[:, 0]
        plast = torch.where((lengths > 0)[:, None], last_here, plast)
        pcount = pcount + lengths.float()
        return psum, pmax, plast, pcount

    @staticmethod
    def _finalize(pool_state) -> np.ndarray:
        """Host-side pool -> ``(B, 3E)`` embeddings; a max over no tokens
        (-inf) becomes 0."""
        psum, pmax, plast, pcount = (
            p.cpu().numpy() if isinstance(p, torch.Tensor) else p
            for p in pool_state)
        count = np.maximum(pcount, 1.0)[:, None]
        pmax = np.where(np.isfinite(pmax), pmax, 0.0)
        return np.concatenate([psum / count, pmax, plast],
                              axis=-1).astype(np.float32)

    # -- tokenization --------------------------------------------------------

    def numericalize(self, text: str) -> np.ndarray:
        toks = self.tokenizer.tokenize(text)
        if not toks:
            toks = [TK_UNK]
        return self.vocab.numericalize(toks)

    # -- public API ------------------------------------------------------------

    @staticmethod
    def _check_scheduler(scheduler: str) -> str:
        if scheduler not in ("groups", "slots", "ragged"):
            raise ValueError(
                f"scheduler must be 'groups', 'slots' or 'ragged', got "
                f"{scheduler!r}")
        return scheduler

    def slot_scheduler(self, registry=None):
        """The engine's continuous-batching scheduler, created on first use;
        one step shape for its lifetime."""
        from code_intelligence_tpu_torch.inference.slots import SlotScheduler

        if self._slot_scheduler is None:
            self._slot_scheduler = SlotScheduler(self, registry=registry)
        elif registry is not None:
            self._slot_scheduler.bind_registry(registry)
        return self._slot_scheduler

    def ragged_scheduler(self, registry=None):
        """The engine's ragged paged scheduler, created on first use; one
        ``(batch_size, page_len)`` step shape for its lifetime."""
        from code_intelligence_tpu_torch.inference.slots import (
            RaggedSlotScheduler)

        if self._ragged_scheduler is None:
            self._ragged_scheduler = RaggedSlotScheduler(self,
                                                         registry=registry)
        elif registry is not None:
            self._ragged_scheduler.bind_registry(registry)
        return self._ragged_scheduler

    def embed_ids_batch(self, id_seqs: Sequence[np.ndarray],
                        scheduler: Optional[str] = None) -> np.ndarray:
        """Embed numericalized docs; returns ``(N, 3*emb_sz)`` float32 on the
        host."""
        policy = self._check_scheduler(scheduler or self.scheduler)
        if policy == "slots":
            return self.slot_scheduler().embed_ids(id_seqs)
        if policy == "ragged":
            return self.ragged_scheduler().embed_ids(id_seqs)
        n = len(id_seqs)
        out = np.zeros((n, self.embed_dim), np.float32)
        # length-sorted grouping into fixed buckets
        order = np.argsort([len(s) for s in id_seqs], kind="stable")
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            pool = self._embed_group([id_seqs[i] for i in idx])
            out[idx] = self._finalize(pool)[:len(idx)]
        return out

    @staticmethod
    def _bucket_for_static(length: int, buckets) -> int:
        for b in buckets:
            if length <= b:
                return b
        return buckets[-1]

    def _embed_group(self, seqs: List[np.ndarray]):
        """One group's forward passes; returns its device pool state."""
        B = self.batch_size  # fixed batch shape; pad the remainder
        max_len = max(len(s) for s in seqs)
        # short groups run in one pass at the smallest fitting bucket; long
        # docs stream through chunk_len windows with carried state
        bucket = (self._bucket_for_static(max_len, self.buckets)
                  if max_len <= self.buckets[-1] else self.chunk_len)
        states = init_lstm_states(self.config, B, self.device)
        pool = self._init_pool_state(B)
        n_chunks = max(1, -(-max_len // bucket))
        with torch.inference_mode():
            for ci in range(n_chunks):
                tokens = np.full((B, bucket), self.vocab.pad_id, np.int32)
                lengths = np.zeros((B,), np.int32)
                for r, s in enumerate(seqs):
                    chunk = s[ci * bucket:(ci + 1) * bucket]
                    tokens[r, :len(chunk)] = chunk
                    lengths[r] = len(chunk)
                lengths_dev = torch.from_numpy(lengths).to(self.device)
                raw, states = self.encoder(
                    torch.from_numpy(tokens).to(self.device), states,
                    **self._length_aware_kw(lengths_dev, lengths))
                pool = self._accumulate_pool(raw, lengths_dev, pool)
        return pool

    def _length_aware_kw(self, lengths_dev: torch.Tensor,
                         lengths: np.ndarray) -> dict:
        """The encoder's ``valid_lens``/``t_live`` for one dense chunk of
        an int8 engine, whose layers run K3 on every path; none for f32,
        whose dense layers run K1. Exact: a row that goes on to a next
        chunk had a full one, and the pooling masks the zeroed tail."""
        if self.precision != "int8":
            return {}
        return {"valid_lens": lengths_dev, "t_live": int(lengths.max())}

    def embed_text(self, text: str) -> np.ndarray:
        """``(3*emb_sz,)`` embedding of one pre-processed document string."""
        return self.embed_ids_batch([self.numericalize(text)])[0]

    def embed_issue(self, title: str, body: str) -> np.ndarray:
        return self.embed_text(build_issue_text(title, body))

    def embed_issues(self, issues: Sequence[Dict[str, str]],
                     truncate: Optional[int] = None,
                     scheduler: Optional[str] = None) -> np.ndarray:
        """Bulk path; ``truncate=EMBED_TRUNCATE_DIM`` gives the downstream
        1600-d contract."""
        texts = [build_issue_text(d.get("title", ""), d.get("body", ""))
                 for d in issues]
        emb = self.embed_ids_batch([self.numericalize(t) for t in texts],
                                   scheduler=scheduler)
        return emb[:, :truncate] if truncate else emb
