#!/usr/bin/env python3
"""Drive the PyTorch port's serve and training paths on one NVIDIA card,
and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA. It imports nothing of JAX. Phases, each fatal
on failure (exit code 1, and no result line):

1. The card's name and power limit, as ``nvidia-smi`` gives them.
2. Build every kernel of the path from ``code_intelligence_tpu_torch/csrc``
   with ``nvcc`` (the build seconds and ptxas's resource usage are
   printed).
3. Each kernel against its plain PyTorch version on the card, on the same
   inputs, in f32 and bf16, at a small odd shape and at the shapes the
   serve paths give it, within the tolerances below: K1 at B=32, T=64
   (the slot step), H=2500 and H=800, and in bf16 at the validation
   window's T=67, B=104, H=2500 (the tensor-core step's 112-row tile); K2
   (ragged) and K3 (ragged, int8 W_hh) at B=32, T=16 (the ragged step),
   with valid lengths of 0, 1, mid-step and full, and a case whose second
   half of the batch is all dead; bf16 K1, K2 and K3 run on the tensor
   cores (K3 reading its int8 codes where they lie);
   K4 (forward with the training residuals) and K5 (its adjoint; both on
   the tensor cores in bf16) at T=7/B=5/H=40, at T=5/B=13/H=37 (B and H
   not multiples of 8) and at the training shapes T=67, B=104, H=2500 and
   H=800,
   and one layer's gradients through K4/K5 against autograd through the
   plain loop (T=67, B=104, H=800). The QRNN forget-mult kernels: K6
   (forward) and K7 (its adjoint) at T=7/B=5/H=40, at T=19/B=3/H=129
   (K6 there takes its per-lane walk: B*H is no whole number of 16-byte
   vectors), the slot step (T=64, B=32) and the training shape (T=67,
   B=104), H=2500 and H=800; K8 (ragged forward) at T=7/B=5/H=40, at
   T=16/B=1/H=8 (one block), T=16/B=8/H=129 (its two-lane chunks straddle
   rows of different lengths) and the ragged step (T=16, B=32,
   H=2500 and H=800) with the same valid lengths, a case with every row
   dead and one with every row full, its tail equal to the frozen carry;
   K6 and K8 must also equal their plain loops bit for bit (max |diff|
   0); and one QRNN layer's gradients
   (window 2, T=67, B=104, in 800, H=2500) through K6/K7 against autograd
   through the plain loop.
4. Three serve paths on one flagship-width export (60,000-token vocab,
   emb 800, hidden 2500/2500/2500/800, bf16) made from a numpy seed. For
   each, the port's server on the card answers POST /text for the same 8
   issues of mixed length, including an empty body and one longer than
   512 tokens; every response must be 2400 finite float32 values equal,
   within ``EMBED_REL`` of the largest plain value, to the same engine
   run on the card with the plain encoder. The launch counters are zeroed just before a path's
   requests and read just after: its kernel must have run ``n_layers``
   launches per recurrence step the scheduler counted from its host
   staging blocks, and the other kernels none.
   * ``--scheduler slots`` (K1, ``chunk_len`` steps per slot step);
   * ``--scheduler ragged`` (K2, the longest live row's steps per ragged
     step); its embeddings must also equal the slots server's;
   * ``--scheduler ragged --precision int8`` (K3); its weight footprint
     must be at least 3x smaller than f32, counted over its weights and
     over all the served encoder holds on the card (weights, scales and
     any W_hh pack), and its largest difference from the bf16 embeddings
     is printed.
   The same three paths then serve a flagship-width QRNN export (the
   same widths, ``qrnn=True``), whose layers launch once per scheduler
   step: K6 on slots, K8 on ragged and ragged + int8.
5. Training at flagship width (bf16 compute, f32 master weights, B=104,
   bptt 67, the reference's dropouts) on a synthetic corpus from a numpy
   seed: a 60,000-token vocab and a stream cycling through 16 tokens with
   10% noise, six training windows and one validation window. First, the
   first window's loss and every parameter's gradient on the kernels
   against the plain path on the same weights and masks. Then, with every
   launch counter zeroed just before, the port's training CLI
   (``training/cli.py``, three windows per host read): every window's
   loss must be finite and the last lower than the first, K4 must have
   run ``n_layers x 67`` launches a window, K5 ``n_layers x 68`` (a launch
   per step and one for dh0), K1 ``n_layers x 67`` for the one
   validation window, and K2, K3 none. The kernel-vs-plain window check
   runs again on the trained checkpoint, where the loss depends on the
   recurrence. The port's server then answers POST /text from the run's
   ``encoder_export/`` with 2400 finite floats. The same phase then
   trains the QRNN LM through the CLI with ``--qrnn``: ``n_layers`` K6
   and ``n_layers`` K7 launches a window, ``n_layers`` K6 for the
   validation window, and no K1-K5.
6. Timing with CUDA events, beside the least time the card could take
   and a library yardstick the port never calls: K1 at B=32, T=512,
   H=2500 in bf16 against cuDNN's ``torch.nn.LSTM`` on the same layer (it
   includes the input projection), and at the slot step (T=64); K2 and
   K3 at the ragged step (B=32, T=16, H=2500, bf16 activations, K3 with
   int8 W_hh) with mixed valid lengths, K2 against cuDNN's LSTM over a
   ``pack_padded_sequence`` of the same lengths. K3 has no single PyTorch
   call for the same function. K1 and K2 run on ``W_hh`` packed
   beforehand, as a served model holds it; the pack's own time is
   printed beside them.
   K4 and K5 at T=67, B=104, H=2500, bf16, against cuDNN's LSTM forward
   and its backward to the initial state only (no weight gradients; cuDNN
   still computes the input gradient), timed apart; ms per training
   window and tokens/s from the CLI run's second host read. K6 at the
   slot step and the training shape, K7 at the training shape and K8 at
   the ragged step, bf16, H=2500: their device time by ``torch.profiler``
   after a flush of the L2 cache (``ms``) and back to back (``ms_warm``),
   and a whole call by CUDA events, beside the bytes they must move over
   the HBM rate and the profiler's device time of a one-element fill, the
   floor under any single launch; no single PyTorch call computes a
   forget-mult, so they have no library yardstick. K6 and K8 stream
   through a TMA-fed ring of shared-memory stages, one block per SM; the
   ``notes`` of their entries say which shapes take the per-lane walk.

The line before the last is one JSON object ``{"kernels": [...]}``
(K1-K8; ``product`` says where K1-K5 multiply); the last is ``{"ok":
true, "device": {...}}``. Exits non-zero
without a result when there is no CUDA device.
"""

from __future__ import annotations

import dataclasses
import functools
import http.client
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from code_intelligence_tpu_torch.data import (
    CorpusWriter,
    LMStreamLoader,
    TokenCorpus,
)
from code_intelligence_tpu_torch.models import (
    AWDLSTMConfig,
    AWDLSTMLM,
    draw_dropout_masks,
    random_encoder_arrays,
)
from code_intelligence_tpu_torch.inference.engine import InferenceEngine
from code_intelligence_tpu_torch.ops import _build
from code_intelligence_tpu_torch.ops import forget_mult as FM
from code_intelligence_tpu_torch.ops import fused_lstm as K1
from code_intelligence_tpu_torch.ops.lstm import lstm_layer
from code_intelligence_tpu_torch.ops.qrnn import qrnn_layer
from code_intelligence_tpu_torch.ops.quantize import quantize_symmetric
from code_intelligence_tpu_torch.serving.server import build_server
from code_intelligence_tpu_torch.text import SPECIALS, Tokenizer, Vocab
from code_intelligence_tpu_torch.training import cli as train_cli
from code_intelligence_tpu_torch.training.checkpoint import (
    export_encoder,
    restore_checkpoint,
)
from code_intelligence_tpu_torch.training.loop import LMTrainer, TrainConfig

SEED = 0
REPO = Path(__file__).resolve().parent

# Kernel vs plain on the card, for K1, K2 and K3 alike. f32: both sides do
# the recurrent product in full f32 and differ only in summation order.
# bf16: h and c are rounded to bf16 after every step, so one step's order
# difference can move a carry by one bf16 ulp (2^-8 near 1), which later
# steps carry on.
K1_ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# Served embedding vs the plain encoder (and ragged vs slots), bf16
# export, as a share of the largest plain embedding value: a random-init
# export's embeddings are small (largest ~3e-2 LSTM, ~1e-3 QRNN on the
# H100), so an absolute bound could pass zeros. The bf16 carry
# differences above, through four layers and the pooling, came to about
# one bf16 step (2^-8) of that value; 2^-5 leaves eight.
EMBED_REL = 2.0 ** -5

# where K1-K5 take their recurrent product (the kernels line's "product")
TC_PRODUCT = "tensor cores in bf16 (the timed dtype); CUDA cores in f32"

# NVIDIA H100 SXM data sheet, dense: HBM rate and peak rate per input type
# (f32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

FLAGSHIP = AWDLSTMConfig(vocab_size=60000, emb_sz=800, n_hid=2500,
                         n_layers=4, dtype="bfloat16")
FLAGSHIP_QRNN = dataclasses.replace(FLAGSHIP, qrnn=True)

WORDS = ("pipeline notebook kubeflow katib tfjob pod crash error when "
         "running the operator fails with timeout after upgrade to version "
         "cluster gpu node memory leak in controller webhook returns "
         "permission denied for service account please help").split()


def issues(rng: np.random.Generator):
    """Issues of mixed length: empty body, short, markdown, unicode, and
    one well over the 512-token bucket."""
    long_body = " ".join(rng.choice(WORDS, 900))
    return [
        {"title": "Katib trial stuck in pending", "body": ""},
        {"title": "crash", "body": "pipeline crash on `kfp run`"},
        {"title": "TFJob fails after upgrade",
         "body": "## Steps\n1. upgrade\n2. run\n```\nTraceback: error\n```\n"
                 "- [ ] checked [docs](https://www.kubeflow.org/docs/)"},
        {"title": "Mémoire: fuite dans le contrôleur 🚀",
         "body": "Noeud GPU — 日本語 logs attached"},
        {"title": "Long log dump", "body": long_body},
        {"title": "", "body": " ".join(rng.choice(WORDS, 120))},
        {"title": "Webhook returns permission denied",
         "body": " ".join(rng.choice(WORDS, 40))},
        {"title": "Notebook server 500", "body": " ".join(rng.choice(WORDS, 300))},
    ]


def flagship_vocab(docs) -> Vocab:
    """60,000 tokens: the specials first, then the smoke issues' own
    tokens, then filler."""
    tok = Tokenizer(add_bos=False)
    itos = list(SPECIALS)
    seen = set(itos)
    for d in docs:
        for t in tok.tokenize(d["title"] + " " + d["body"]):
            if t not in seen:
                seen.add(t)
                itos.append(t)
    itos += [f"tok{i}" for i in range(FLAGSHIP.vocab_size - len(itos))]
    return Vocab(itos)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def k1_inputs(T, B, H, dtype, seed=SEED):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    s = 1.0 / H ** 0.5
    x_proj = torch.randn((T, B, 4 * H), generator=g, device=dev)
    w_hh = (torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1) * s
    h0 = torch.randn((B, H), generator=g, device=dev) * 0.5
    c0 = torch.randn((B, H), generator=g, device=dev) * 0.5
    return [t.to(dtype).contiguous() for t in (x_proj, w_hh, h0, c0)]


def check_k1(T, B, H, dtype) -> float:
    args = k1_inputs(T, B, H, dtype)
    out, (h, c) = K1.fused_lstm_forward(*args)
    torch.cuda.synchronize()
    ref_out, (ref_h, ref_c) = K1.fused_lstm_forward_plain(*args)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in ((out, ref_out), (h, ref_h), (c, ref_c)))
    if not all(torch.isfinite(t.float()).all().item() for t in (out, h, c)):
        raise AssertionError(f"K1 gave non-finite values at T={T} B={B} H={H}")
    if err > K1_ATOL[dtype]:
        raise AssertionError(
            f"K1 vs plain at T={T} B={B} H={H} {dtype}: max |diff| {err} "
            f"> {K1_ATOL[dtype]}")
    return err


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_bound_ms(T, B, H, dtype, valid=None, w_item=None):
    """The least time for one call: each input read once and each output
    written once over the HBM rate, or the recurrent product's operations
    over the peak rate for the activations' type, whichever is larger.
    With ``valid`` (K2, K3) the work is what these lengths need: x_proj
    and the product only for live (step, row) pairs, plus the lengths;
    ``w_item`` is W_hh's bytes per element (1 for K3, which also reads
    its 4H f32 scales)."""
    item = torch.tensor([], dtype=dtype).element_size()
    live = T * B if valid is None else sum(min(int(v), T) for v in valid)
    elems = (live * 4 * H + 2 * B * H       # x_proj (live part), h0, c0
             + T * B * H + 2 * B * H)       # out, h_T, c_T
    w_bytes = 4 * H * H * (item if w_item is None else w_item)
    extra = (0 if valid is None else 4 * B) + (16 * H if w_item == 1 else 0)
    bytes_ms = (elems * item + w_bytes + extra) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * live * 4 * H * H / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def valid_cases(T, B):
    """Valid lengths per row: ``mixed`` holds 0, 1, mid-step and full
    (t_live = T); ``short`` stops at mid-step and leaves the second half
    of the batch dead (t_live = T // 2): at B=32 a whole 16-row tile of
    the CUDA-core step, two n8 tiles of the tensor-core one."""
    mixed = [(0, 1, T // 2, T)[b % 4] for b in range(B)]
    short = [(0, 1, T // 2)[b % 3] if b < max(1, B // 2) else 0
             for b in range(B)]
    return {"mixed": mixed, "short": short}


def ragged_inputs(T, B, H, dtype, valid, int8: bool, seed=SEED):
    """K2's arguments, or K3's (int8 codes and scales of the same W_hh
    from the port's quantizer), with ``valid_lens`` on the card."""
    x_proj, w_hh, h0, c0 = k1_inputs(T, B, H, dtype, seed)
    valid_lens = torch.tensor(valid, dtype=torch.int32, device="cuda")
    if not int8:
        return [x_proj, w_hh, h0, c0, valid_lens]
    q, scale = quantize_symmetric(w_hh.float().cpu().numpy(), axis=0)
    return [x_proj, torch.from_numpy(q).cuda(),
            torch.from_numpy(scale).cuda(), h0, c0, valid_lens]


def check_ragged(T, B, H, dtype, valid, int8: bool) -> float:
    name = "K3" if int8 else "K2"
    kernel = (K1.fused_lstm_forward_ragged_int8 if int8
              else K1.fused_lstm_forward_ragged)
    plain = (K1.fused_lstm_forward_ragged_int8_plain if int8
             else K1.fused_lstm_forward_ragged_plain)
    args = ragged_inputs(T, B, H, dtype, valid, int8)
    out, (h, c) = kernel(*args, t_live=min(T, max(valid)))
    torch.cuda.synchronize()
    ref_out, (ref_h, ref_c) = plain(*args)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in ((out, ref_out), (h, ref_h), (c, ref_c)))
    dead = (torch.arange(T, device="cuda")[:, None]
            >= args[-1][None, :].long())
    if not all(torch.isfinite(t.float()).all().item() for t in (out, h, c)):
        raise AssertionError(f"{name} gave non-finite values at T={T} B={B} "
                             f"H={H}")
    if (out[dead] != 0).any().item():
        raise AssertionError(f"{name} wrote non-zero outputs past the valid "
                             f"lengths at T={T} B={B} H={H}")
    if err > K1_ATOL[dtype]:
        raise AssertionError(
            f"{name} vs plain at T={T} B={B} H={H} {dtype}: max |diff| {err} "
            f"> {K1_ATOL[dtype]}")
    return err


def kernel_checks() -> dict:
    """Phase 3: every kernel against its plain version; max |diff| by
    kernel and case."""
    errs = {"K1": {}, "K2": {}, "K3": {}}
    both = (torch.float32, torch.bfloat16)
    for T, B, H, dtypes in ((7, 5, 40, both), (64, 32, 2500, both),
                            (64, 32, 800, both),
                            (TRAIN_BPTT, TRAIN_BS, 2500, (torch.bfloat16,))):
        for dtype in dtypes:
            key = f"T{T}_B{B}_H{H}_{str(dtype).split('.')[-1]}"
            errs["K1"][key] = check_k1(T, B, H, dtype)
            print(f"K1 vs plain {key}: max |diff| {errs['K1'][key]:.3g} "
                  f"(atol {K1_ATOL[dtype]})", flush=True)
    for T, B, H in ((7, 5, 40), (16, 32, 2500), (16, 32, 800)):
        for dtype in (torch.float32, torch.bfloat16):
            for case, valid in valid_cases(T, B).items():
                key = f"T{T}_B{B}_H{H}_{str(dtype).split('.')[-1]}_{case}"
                for name in ("K2", "K3"):
                    errs[name][key] = check_ragged(T, B, H, dtype, valid,
                                                   int8=name == "K3")
                    print(f"{name} vs plain {key}: max |diff| "
                          f"{errs[name][key]:.3g} (atol {K1_ATOL[dtype]})",
                          flush=True)
    return errs


def post(port: int, issue: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/text", body=json.dumps(issue),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


# each serve path's kernel, by its launch counter: LSTM, then QRNN
PATH_KERNEL = {("slots", "f32"): "K1", ("ragged", "f32"): "K2",
               ("ragged", "int8"): "K3"}
QRNN_PATH_KERNEL = {("slots", "f32"): "K6", ("ragged", "f32"): "K8",
                    ("ragged", "int8"): "K8"}
COUNTERS = {"K1": K1.launches, "K2": K1.ragged_launches,
            "K3": K1.ragged_int8_launches, "K4": K1.gates_launches,
            "K5": K1.backward_launches, "K6": FM.forget_mult_launches,
            "K7": FM.forget_mult_backward_launches,
            "K8": FM.forget_mult_ragged_launches}


def serve_phase(model_dir: Path, docs, scheduler: str,
                precision: str = "f32", cfg: AWDLSTMConfig = FLAGSHIP):
    """Serve the docs through the port's server on one path; returns
    ``(summary, embeddings)``. An LSTM layer launches its kernel once per
    recurrence step, a QRNN layer once per scheduler step."""
    kernel = (QRNN_PATH_KERNEL if cfg.qrnn else PATH_KERNEL)[
        (scheduler, precision)]
    t0 = time.perf_counter()
    srv = build_server(model_dir, device="cuda", batch_size=32,
                       host="127.0.0.1", port=0, scheduler=scheduler,
                       precision=precision)
    boot_s = time.perf_counter() - t0
    engine = srv.engine
    sched = (engine.ragged_scheduler() if scheduler == "ragged"
             else engine.slot_scheduler())
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        steps0, rec0 = sched.steps_run, sched.recurrence_steps
        for c in COUNTERS.values():  # every count to 0 just before the path
            c.reset()
        got, request_ms = [], []
        for issue in docs:
            t = time.perf_counter()
            code, body = post(srv.port, issue)
            request_ms.append((time.perf_counter() - t) * 1e3)
            if code != 200:
                raise AssertionError(f"POST /text gave {code}: {body[:200]!r}")
            got.append(np.frombuffer(body, dtype="<f4"))
        launches = {k: c.count for k, c in COUNTERS.items()}
        steps = sched.steps_run - steps0
        rec_steps = sched.recurrence_steps - rec0
        step_len = sched.chunk_len
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    got = np.stack(got)
    if got.shape != (len(docs), 3 * cfg.emb_sz) \
            or not np.isfinite(got).all():
        raise AssertionError(f"bad embeddings: shape {got.shape}")
    per_layer = steps if cfg.qrnn else rec_steps
    want_launches = cfg.n_layers * per_layer
    others = {k: n for k, n in launches.items() if k != kernel and n}
    if steps == 0 or launches[kernel] != want_launches or others:
        raise AssertionError(
            f"{scheduler}/{precision}: launches {launches} over {steps} "
            f"steps; expected {want_launches} of {kernel} "
            f"({cfg.n_layers} layers x {per_layer}) and no other kernel")
    f32_bytes = engine.weight_bytes_f32
    weight_ratio = f32_bytes / engine.weight_bytes
    held = engine.encoder.held_bytes()  # with the packs the path built
    del srv, engine, sched
    plain = InferenceEngine.from_export(model_dir, batch_size=32,
                                        scheduler=scheduler, device="cuda",
                                        precision=precision, plain=True)
    want = plain.embed_issues(docs)
    del plain
    torch.cuda.empty_cache()
    err, scale, bound = embed_gate(f"{scheduler}/{precision} served vs "
                                   f"plain encoder", got, want)
    return {"scheduler": scheduler, "precision": precision, "kernel": kernel,
            "boot_s": boot_s, "requests": len(docs), "steps": steps,
            "step_len": step_len, "recurrence_steps": rec_steps,
            "launches": launches[kernel], "launches_expected": want_launches,
            "request_ms": request_ms, "embed_max_abs_err": err,
            "embed_plain_max_abs": scale, "embed_bound": bound,
            "weight_footprint_ratio": weight_ratio, "held_bytes": held,
            "held_footprint_ratio": f32_bytes / held}, got


def embed_gate(what, got, want):
    """``(max |got - want|, max |want|, bound)``; raises past the bound,
    ``EMBED_REL`` times the largest value of ``want``."""
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    bound = EMBED_REL * scale
    if not (scale > 0 and err <= bound):
        raise AssertionError(f"{what}: max |diff| {err} > {bound} (largest "
                             f"reference value {scale})")
    return err, scale, bound


def serve_paths(model_dir: Path, docs, cfg: AWDLSTMConfig = FLAGSHIP,
                tag: str = "") -> dict:
    """Phase 4: the three serve paths, each against its plain engine; the
    ragged one also against the slots one. Keyed by each path's kernel."""
    slots, emb_slots = serve_phase(model_dir, docs, "slots", cfg=cfg)
    print(json.dumps({f"serve{tag}_slots": slots}), flush=True)
    ragged, emb_ragged = serve_phase(model_dir, docs, "ragged", cfg=cfg)
    ragged["vs_slots_max_abs_err"] = float(np.abs(emb_ragged
                                                  - emb_slots).max())
    print(json.dumps({f"serve{tag}_ragged": ragged}), flush=True)
    embed_gate("ragged vs slots server", emb_ragged, emb_slots)
    int8, emb_int8 = serve_phase(model_dir, docs, "ragged", "int8", cfg)
    # quantization error, printed and not gated (int8_check.py gates its
    # band on the small engine)
    int8["vs_bf16_max_abs_diff"] = float(np.abs(emb_int8 - emb_slots).max())
    int8["vs_bf16_rel"] = (int8["vs_bf16_max_abs_diff"]
                           / float(np.abs(emb_slots).max()))
    print(json.dumps({f"serve{tag}_ragged_int8": int8}), flush=True)
    for key in ("weight_footprint_ratio", "held_footprint_ratio"):
        if int8[key] < 3.0:
            raise AssertionError(f"int8 {key} {int8[key]} < 3")
    return {"slots": slots, "ragged": ragged, "ragged_int8": int8}


def serve_pack(w_hh, B):
    """W_hh packed for the bf16 tensor-core K1/K2 at batch B, as a frozen
    encoder holds it, and the ms the pack takes."""
    lay = K1.tc_layout(B, w_hh.shape[1])
    pack_ms = cuda_ms(lambda: K1.pack_w_hh_fwd(w_hh, lay), reps=5)
    return K1.pack_w_hh_fwd(w_hh, lay), pack_ms


def timing_phase() -> dict:
    T, B, H, dtype = 512, 32, 2500, torch.bfloat16
    args = k1_inputs(T, B, H, dtype, seed=SEED + 1)
    w_pack, pack_ms = serve_pack(args[1], B)
    ms = cuda_ms(lambda: K1.fused_lstm_forward(*args, w_pack=w_pack), reps=3)
    plain_ms = cuda_ms(lambda: K1.fused_lstm_forward_plain(*args), reps=2)
    step_args = k1_inputs(64, B, H, dtype, seed=SEED + 2)
    step_pack, _ = serve_pack(step_args[1], B)
    step_ms = cuda_ms(lambda: K1.fused_lstm_forward(*step_args,
                                                    w_pack=step_pack), reps=5)
    lstm = torch.nn.LSTM(H, H).to("cuda", dtype)
    x = torch.randn((T, B, H), device="cuda", dtype=dtype)
    state = (args[2][None], args[3][None])
    try:
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: lstm(x, state), reps=3)
    except RuntimeError as e:  # a yardstick only: the port never calls it
        print(f"cuDNN LSTM yardstick unavailable: {e}", file=sys.stderr)
        library_ms = None
    bound_ms, bound_by = k1_bound_ms(T, B, H, dtype)
    item = 2
    return {"shape": {"T": T, "B": B, "H": H, "dtype": "bfloat16"},
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "pack_ms": pack_ms,
            # a design that streams W_hh from HBM every step can do no better
            "weight_stream_bound_ms": T * 4 * H * H * item
            / HBM_BYTES_PER_S * 1e3,
            "ms_T64": step_ms, "bound_ms_T64": k1_bound_ms(64, B, H, dtype)[0]}


def ragged_timing_phase() -> dict:
    """K2 and K3 at the ragged step's shape, with seeded valid lengths in
    [1, 16] and one full row (so all 16 steps launch)."""
    T, B, H, dtype = 16, 32, 2500, torch.bfloat16
    rng = np.random.default_rng(SEED + 3)
    valid = [int(v) for v in rng.integers(1, T + 1, B)]
    valid[0] = T
    out = {"shape": {"T": T, "B": B, "H": H, "dtype": "bfloat16",
                     "valid_lens": valid}}
    for name, int8 in (("K2", False), ("K3", True)):
        args = ragged_inputs(T, B, H, dtype, valid, int8, seed=SEED + 4)
        kernel = K1.fused_lstm_forward_ragged_int8
        if not int8:  # on W_hh packed once, as the served encoder holds it
            w_pack, out["K2_pack_ms"] = serve_pack(args[1], B)
            kernel = functools.partial(K1.fused_lstm_forward_ragged,
                                       w_pack=w_pack)
        plain = (K1.fused_lstm_forward_ragged_int8_plain if int8
                 else K1.fused_lstm_forward_ragged_plain)
        bound_ms, bound_by = k1_bound_ms(T, B, H, dtype, valid,
                                         w_item=1 if int8 else None)
        out[name] = {
            "ms": cuda_ms(lambda: kernel(*args, t_live=T), reps=10),
            "plain_ms": cuda_ms(lambda: plain(*args), reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by}
    out["K2"]["library_ms"] = packed_lstm_ms(T, B, H, dtype, valid)
    out["K3"]["library_ms"] = None
    out["K3"]["library_note"] = ("no single PyTorch call computes an LSTM "
                                 "over int8 recurrent weights")
    return out


def packed_lstm_ms(T, B, H, dtype, valid):
    """cuDNN's LSTM over a packed batch of the same lengths: a yardstick
    only, never on the port's path (it includes the input projection)."""
    from torch.nn.utils.rnn import pack_padded_sequence

    lstm = torch.nn.LSTM(H, H).to("cuda", dtype)
    x = torch.randn((T, B, H), device="cuda", dtype=dtype)
    packed = pack_padded_sequence(x, torch.tensor(valid),
                                  enforce_sorted=False)
    state = tuple(torch.zeros((1, B, H), device="cuda", dtype=dtype)
                  for _ in range(2))
    try:
        with torch.inference_mode():
            return cuda_ms(lambda: lstm(packed, state), reps=10)
    except RuntimeError as e:
        print(f"cuDNN packed LSTM yardstick unavailable: {e}",
              file=sys.stderr)
        return None


# ---------------------------------------------------------------------------
# The training slice: K4 and K5, and LM training at flagship width
# ---------------------------------------------------------------------------

# K4 vs plain: K1_ATOL (the same loop and rounding). K5 vs plain, as
# (atol, rtol): in bf16 dz is rounded to bf16 every step and feeds the next
# step's product, so the summation orders can leave a value a few bf16
# ulps apart (2^-7 relative each) at any magnitude.
K5_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (3e-2, 3e-2)}
# Gradients on the kernels vs autograd through the plain loop, by relative
# Frobenius norm, and the window's loss by relative difference. f32: only
# the summation order differs. bf16: the plain loop's autograd rounds its
# backward to bf16 where K5 carries f32, and both round h, c, the gates
# and dz to bf16 (2^-8) at every one of the 67 steps of four layers.
# The gradient bound is the real check. At init the loss is about ln(V)
# whatever the layers compute, so the loss bound only bites on the window
# checked after training, where the loss depends on the recurrence.
GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
LOSS_RTOL = 1e-2

TRAIN_BS, TRAIN_BPTT = 104, 67     # the JAX CLI's defaults
TRAIN_WINDOWS, PER_DISPATCH = 6, 3  # two host reads of the metrics
TRAIN_LR = 3e-3                    # one-cycle peak 6e-3 over 6 windows
PERIOD = 16                        # the synthetic corpus's token cycle


def k4_bound_ms(T, B, H, dtype):
    """K1's traffic plus the residuals written (gates, c_prev); the same
    recurrent product."""
    item = torch.tensor([], dtype=dtype).element_size()
    elems = (T * B * 4 * H + 4 * H * H + 2 * B * H     # x_proj, W_hh, h0, c0
             + T * B * H + T * B * 4 * H + T * B * H   # out, gates, c_prev
             + 2 * B * H)                              # h_T, c_T
    return _bound(elems * item, 2.0 * T * B * 4 * H * H, dtype)


def k5_bound_ms(T, B, H, dtype):
    """gates, c_prev, d_out, W_hh, dh_T, dc_T in; dz, dh0, dc0 out; T
    products dz[t] @ W_hh."""
    item = torch.tensor([], dtype=dtype).element_size()
    elems = (T * B * 4 * H + 2 * T * B * H + 4 * H * H + 2 * B * H
             + T * B * 4 * H + 2 * B * H)
    return _bound(elems * item, 2.0 * T * B * 4 * H * H, dtype)


def _bound(n_bytes, n_ops, dtype):
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def k5_inputs(T, B, H, dtype, seed=SEED):
    """K4's residuals (from K4 itself) and seeded cotangents."""
    x_proj, w_hh, h0, c0 = k1_inputs(T, B, H, dtype, seed)
    _, (gates, c_prev), _ = K1.fused_lstm_forward(x_proj, w_hh, h0, c0,
                                                  with_gates=True)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    d_out, dh, dc = (torch.randn(s, generator=g, device="cuda")
                     for s in ((T, B, H), (B, H), (B, H)))
    return [gates, c_prev, d_out, w_hh, dh, dc]


def check_k4(T, B, H, dtype) -> float:
    args = k1_inputs(T, B, H, dtype)
    out, (gates, c_prev), (h, c) = K1.fused_lstm_forward(*args,
                                                         with_gates=True)
    torch.cuda.synchronize()
    ref = K1.fused_lstm_forward_plain(*args, with_gates=True)
    got, want = (out, gates, c_prev, h, c), (ref[0], *ref[1], *ref[2])
    if not all(torch.isfinite(t.float()).all().item() for t in got):
        raise AssertionError(f"K4 gave non-finite values at T={T} B={B} "
                             f"H={H}")
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    if err > K1_ATOL[dtype]:
        raise AssertionError(f"K4 vs plain at T={T} B={B} H={H} {dtype}: "
                             f"max |diff| {err} > {K1_ATOL[dtype]}")
    return err


def check_k5(T, B, H, dtype) -> float:
    args = k5_inputs(T, B, H, dtype)
    got = K1.fused_lstm_backward(*args)
    torch.cuda.synchronize()
    want = K1.fused_lstm_backward_plain(*args)
    atol, rtol = K5_TOL[dtype]
    for a, b in zip(got, want):
        if not torch.isfinite(a.float()).all().item():
            raise AssertionError(f"K5 gave non-finite values at T={T} B={B} "
                                 f"H={H}")
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol)
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(got, want))


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def check_layer_grads(T, B, n_in, H, dtype) -> float:
    """``lstm_layer_fused`` (K4 forward, K5 backward) against autograd
    through the plain loop (``ops.lstm.lstm_layer``); the largest relative
    error over the six gradients."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    s = 1.0 / H ** 0.5
    shapes = {"x": (B, T, n_in), "h0": (B, H), "c0": (B, H),
              "w_ih": (4 * H, n_in), "w_hh": (4 * H, H), "bias": (4 * H,)}
    base = {k: ((torch.rand(v, generator=g, device="cuda") * 2 - 1) * s)
            .to(dtype) for k, v in shapes.items()}
    cot = [torch.randn(v, generator=g, device="cuda").to(dtype)
           for v in ((B, T, H), (B, H), (B, H))]
    grads = []
    for layer in (K1.lstm_layer_fused, lstm_layer):
        t = {k: v.clone().requires_grad_() for k, v in base.items()}
        out, (h, c) = layer(t["x"], (t["h0"], t["c0"]), t["w_ih"],
                            t["w_hh"], t["bias"])
        torch.autograd.backward((out, h, c), cot)
        grads.append({k: v.grad for k, v in t.items()})
    torch.cuda.synchronize()
    rel = max(_rel(grads[0][k], grads[1][k]) for k in shapes)
    if not rel <= GRAD_REL[dtype]:
        raise AssertionError(f"layer grads on K4/K5 vs plain autograd "
                             f"{dtype}: relative error {rel} > "
                             f"{GRAD_REL[dtype]}")
    return rel


def training_kernel_checks() -> dict:
    """Phase 5: K4 and K5 against their plain versions, at a small odd
    shape and at the training shapes, and the layer's gradients."""
    errs = {"K4": {}, "K5": {}, "layer_grad_rel": {}}
    for T, B, H in ((7, 5, 40), (5, 13, 37), (TRAIN_BPTT, TRAIN_BS, 2500),
                    (TRAIN_BPTT, TRAIN_BS, 800)):
        for dtype in (torch.float32, torch.bfloat16):
            key = f"T{T}_B{B}_H{H}_{str(dtype).split('.')[-1]}"
            errs["K4"][key] = check_k4(T, B, H, dtype)
            errs["K5"][key] = check_k5(T, B, H, dtype)
            print(f"K4/K5 vs plain {key}: max |diff| {errs['K4'][key]:.3g} "
                  f"/ {errs['K5'][key]:.3g}", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        key = f"T{TRAIN_BPTT}_B{TRAIN_BS}_in800_H800_{str(dtype).split('.')[-1]}"
        errs["layer_grad_rel"][key] = check_layer_grads(
            TRAIN_BPTT, TRAIN_BS, 800, 800, dtype)
        print(f"layer grads vs plain autograd {key}: relative "
              f"{errs['layer_grad_rel'][key]:.3g}", flush=True)
    return errs


def write_corpus(root: Path) -> Vocab:
    """A 60,000-token vocab and a stream that cycles through PERIOD
    random tokens with 10% noise: learnable in a few windows. The train
    corpus holds exactly TRAIN_WINDOWS windows, the valid corpus one."""
    rng = np.random.default_rng(SEED)
    itos = list(SPECIALS)
    itos += [f"tok{i}" for i in range(FLAGSHIP.vocab_size - len(itos))]
    vocab = Vocab(itos)
    pattern = rng.integers(len(SPECIALS), len(itos), PERIOD)
    for split, windows in (("train", TRAIN_WINDOWS), ("valid", 1)):
        n = windows * TRAIN_BS * TRAIN_BPTT + 1
        stream = np.resize(pattern, n).astype(np.int32)
        noise = rng.random(n) < 0.1
        stream[noise] = rng.integers(len(SPECIALS), len(itos), noise.sum())
        writer = CorpusWriter(root / split)
        writer.add_document(stream)
        writer.finalize(vocab)
    return vocab


def window_check(corpus_dir: Path, ckpt_dir: Path | None = None,
                 cfg: AWDLSTMConfig = FLAGSHIP) -> dict:
    """The first training window's loss and gradients at flagship width,
    bf16, with the reference's dropouts: the kernel path (K4 and K5, or
    for QRNN K6 and K7) against the plain path (autograd through the plain
    loops) on the same weights and the same masks. The weights are the
    seed's, or with ``ckpt_dir`` the trained checkpoint's (its carried
    states too)."""
    trainer = LMTrainer(cfg, TrainConfig(batch_size=TRAIN_BS,
                                         bptt=TRAIN_BPTT), device="cuda")
    state = trainer.init_state(SEED)
    if ckpt_dir is not None:
        state = restore_checkpoint(ckpt_dir, state)
    loader = LMStreamLoader(TokenCorpus(corpus_dir / "train").tokens(),
                            TRAIN_BS, TRAIN_BPTT, seed=SEED)
    x, y = (torch.as_tensor(a, dtype=torch.long, device="cuda")
            for a in next(loader.epoch(0)))
    masks = draw_dropout_masks(
        cfg, TRAIN_BS, torch.Generator(device="cuda").manual_seed(SEED),
        "cuda")
    out = {}
    for name, model in (("kernel", state.model),
                        ("plain", AWDLSTMLM(cfg, device="cuda", plain=True))):
        if name == "plain":
            model.load_state_dict(state.model.state_dict())
        loss, _ = trainer.loss(model, x, y, state.lstm_states, masks)
        loss.backward()
        torch.cuda.synchronize()
        out[name] = (loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()})
    loss_k, grads_k = out["kernel"]
    loss_p, grads_p = out["plain"]
    rel = {n: _rel(grads_k[n], grads_p[n]) for n in grads_p}
    result = {"loss_kernel": loss_k, "loss_plain": loss_p,
              "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
              "grad_rel": rel, "loss_rtol": LOSS_RTOL,
              "grad_rel_tol": GRAD_REL[torch.bfloat16]}
    if not (math.isfinite(loss_k) and result["loss_rel_diff"] <= LOSS_RTOL
            and max(rel.values()) <= GRAD_REL[torch.bfloat16]):
        raise AssertionError(f"first window on the kernels vs plain: "
                             f"{result}")
    del out, grads_k, grads_p, state
    torch.cuda.empty_cache()
    return result


def training_phase(root: Path, cfg: AWDLSTMConfig = FLAGSHIP) -> dict:
    """Phase 6: the port's training CLI at flagship width, then its
    export served. Every launch counter is zeroed just before the CLI."""
    corpus_dir, model_dir = root / "corpus", root / "run"
    write_corpus(corpus_dir)
    window = window_check(corpus_dir, cfg=cfg)
    print(json.dumps({"train_window_check_init": window}), flush=True)

    torch.cuda.reset_peak_memory_stats()
    for c in COUNTERS.values():  # every count to 0 just before the path
        c.reset()
    t0 = time.perf_counter()
    summary = train_cli.main([
        "--corpus_dir", str(corpus_dir), "--model_dir", str(model_dir),
        "--emb_sz", str(cfg.emb_sz), "--n_hid", str(cfg.n_hid),
        "--n_layers", str(cfg.n_layers),
        "--bf16", "--bs", str(TRAIN_BS), "--bptt", str(TRAIN_BPTT),
        "--lr", str(TRAIN_LR), "--steps_per_dispatch", str(PER_DISPATCH),
        "--seed", str(SEED), "--device", "cuda",
        *(["--qrnn"] if cfg.qrnn else [])])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k: c.count for k, c in COUNTERS.items()}
    steps = [json.loads(line) for line in
             (model_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in steps if r["kind"] == "step"]
    losses = [r["loss"] for r in steps]
    n_layers = cfg.n_layers
    want = dict.fromkeys(COUNTERS, 0)
    if cfg.qrnn:  # a launch per layer call: each window, and validation
        want.update(K6=n_layers * (TRAIN_WINDOWS + 1),
                    K7=n_layers * TRAIN_WINDOWS)
    else:
        want.update(K4=n_layers * TRAIN_BPTT * TRAIN_WINDOWS,
                    K5=n_layers * (TRAIN_BPTT + 1) * TRAIN_WINDOWS,
                    K1=n_layers * TRAIN_BPTT * 1)
    if len(losses) != TRAIN_WINDOWS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"window losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    # the second host read's windows: warm (the first paid the builds)
    window_s = float(np.mean([r["step_time_s"]
                              for r in steps[PER_DISPATCH:]]))
    result = {"windows": TRAIN_WINDOWS, "losses": losses,
              "val_loss": summary["val_loss"], "launches": launches,
              "launches_expected": want, "cli_wall_s": wall_s,
              "ms_per_window": window_s * 1e3,
              "tokens_per_s": TRAIN_BS * TRAIN_BPTT / window_s,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    result["window_check_trained"] = window_check(corpus_dir,
                                                  model_dir / "ckpt", cfg)
    result["served"] = serve_trained(model_dir / "encoder_export", cfg)
    return result


def serve_trained(export: Path, cfg: AWDLSTMConfig = FLAGSHIP) -> dict:
    """The port's server answers POST /text from the trained export."""
    srv = build_server(export, device="cuda", batch_size=32,
                       host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        docs = issues(np.random.default_rng(SEED + 6))[:3]
        got = []
        for issue in docs:
            code, body = post(srv.port, issue)
            if code != 200:
                raise AssertionError(f"POST /text gave {code}: {body[:200]!r}")
            got.append(np.frombuffer(body, dtype="<f4"))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    got = np.stack(got)
    if got.shape != (len(docs), 3 * cfg.emb_sz) \
            or not np.isfinite(got).all():
        raise AssertionError(f"trained export served bad embeddings: "
                             f"shape {got.shape}")
    return {"requests": len(docs), "floats": int(got.shape[1]),
            "finite": True}


def cuda_ms_each(setup, fn, reps: int) -> float:
    """Mean device time of ``fn(setup())``, timing only ``fn``."""
    fn(setup())  # warm
    total = 0.0
    for _ in range(reps):
        arg = setup()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def train_timing_phase() -> dict:
    """K4 and K5 per call at the training shape of an H=2500 layer, bf16,
    beside their bounds, their plain versions and cuDNN's LSTM (which the
    port never calls; its forward also does the input projection, its
    backward the input gradient)."""
    T, B, H, dtype = TRAIN_BPTT, TRAIN_BS, 2500, torch.bfloat16
    fwd_args = k1_inputs(T, B, H, dtype, seed=SEED + 7)
    bwd_args = k5_inputs(T, B, H, dtype, seed=SEED + 8)
    out = {"shape": {"T": T, "B": B, "H": H, "dtype": "bfloat16"},
           "library": {"K4": "cuDNN torch.nn.LSTM training forward",
                       "K5": "cuDNN torch.nn.LSTM backward to (h0, c0) "
                             "only; also computes dx"}}
    for name, kernel, plain, args, bound in (
            ("K4", lambda *a: K1.fused_lstm_forward(*a, with_gates=True),
             lambda *a: K1.fused_lstm_forward_plain(*a, with_gates=True),
             fwd_args, k4_bound_ms),
            ("K5", K1.fused_lstm_backward, K1.fused_lstm_backward_plain,
             bwd_args, k5_bound_ms)):
        bound_ms, bound_by = bound(T, B, H, dtype)
        out[name] = {"ms": cuda_ms(lambda: kernel(*args), reps=5),
                     "plain_ms": cuda_ms(lambda: plain(*args), reps=3),
                     "bound_ms": bound_ms, "bound_by": bound_by}
    # the backward yardstick asks only for the initial state's gradient,
    # the recurrent adjoint K5 computes: no weight gradients, though cuDNN
    # still computes dx (one more (T*B, 4H) x (4H, H) product than K5)
    lstm = torch.nn.LSTM(H, H).to("cuda", dtype).requires_grad_(False)
    lstm.flatten_parameters()  # one cuDNN weight buffer, as in training
    x = torch.randn((T, B, H), device="cuda", dtype=dtype)
    state = tuple(t[None].clone().requires_grad_() for t in fwd_args[2:])
    grad = torch.randn((T, B, H), device="cuda", dtype=dtype)
    try:
        out["K4"]["library_ms"] = cuda_ms(lambda: lstm(x, state), reps=5)
        out["K5"]["library_ms"] = cuda_ms_each(
            lambda: lstm(x, state)[0],
            lambda y: torch.autograd.backward(y, grad), reps=5)
    except RuntimeError as e:  # a yardstick only: the port never calls it
        print(f"cuDNN LSTM yardstick unavailable: {e}", file=sys.stderr)
        out["K4"]["library_ms"] = out["K5"]["library_ms"] = None
    return out


# ---------------------------------------------------------------------------
# The QRNN slice: the forget-mult kernels K6 (forward), K7 (adjoint) and K8
# (ragged forward)
# ---------------------------------------------------------------------------

# K6-K8 vs plain, as (atol, rtol): both sides compute each element with the
# same f32 operations in the same order (the kernels use unfused _rn
# intrinsics), so they should agree exactly; the bounds allow one f32 ulp,
# which in bf16 can tip one rounding of a stored value (2^-8 relative).
FM_TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (1e-6, 2.0 ** -7)}
QRNN_SERVE_STEP = (64, 32)  # the slot step (T, B); the ragged step is T=16
_WALK = ("B*H*item not a multiple of 16 bytes (of the checked shapes only "
         "T19_B3_H129), or a tensor off a 16-byte boundary, takes the "
         "per-lane walk")
FM_NOTES = {
    "K6": "ring: one block per SM on a contiguous run of the B*H plane; a "
          "producer warp fills shared-memory stages of 8 steps of (z, f), "
          "up to 128 KB, with TMA bulk copies, a lane a copy (mbarriers); "
          "each consumer thread advances 2 lanes and stores them. " + _WALK,
    "K7": "per-lane walk in reverse time, 8 steps of loads ahead; left "
          "alone: 54% of its bound",
    "K8": "K6's ring with a length per element; a block loads up to its "
          "longest live row (its first stage before the lengths are read). "
          + _WALK,
}


def fm_inputs(T, B, H, dtype, seed=SEED):
    """Time-major z in (-1, 1), f in (0, 1), h0 and a cotangent g."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    z = torch.tanh(torch.randn((T, B, H), generator=g, device=dev))
    f = torch.sigmoid(1.5 * torch.randn((T, B, H), generator=g, device=dev))
    h0 = torch.randn((B, H), generator=g, device=dev) * 0.5
    cot = torch.randn((T, B, H), generator=g, device=dev)
    return [t.to(dtype).contiguous() for t in (z, f, h0, cot)]


def _fm_err(got, want, dtype, what, exact=False) -> float:
    """The largest difference, within ``FM_TOL``; 0 when ``exact``."""
    atol, rtol = FM_TOL[dtype]
    for a, b in zip(got, want):
        if not torch.isfinite(a.float()).all().item():
            raise AssertionError(f"{what} gave non-finite values")
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol, msg=lambda m: f"{what}: {m}")
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    if exact and err != 0:
        raise AssertionError(f"{what}: max |diff| {err}, not bit for bit")
    return err


def check_qrnn_layer_grads(T, B, n_in, H, dtype) -> float:
    """``qrnn_layer`` (window 2, h0 and x_prev; K6 forward, K7 backward)
    against autograd through the plain loop; the largest relative error
    over the five gradients."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    s = 1.0 / H ** 0.5
    shapes = {"x": (B, T, n_in), "h0": (B, H), "x_prev": (B, n_in),
              "w": (3 * H, 2 * n_in), "b": (3 * H,)}
    base = {k: ((torch.rand(v, generator=g, device="cuda") * 2 - 1)
                * (s if k in ("w", "b") else 1)).to(dtype)
            for k, v in shapes.items()}
    cot = [torch.randn(v, generator=g, device="cuda").to(dtype)
           for v in ((B, T, H), (B, H))]
    grads = []
    for plain in (False, True):
        t = {k: v.clone().requires_grad_() for k, v in base.items()}
        out, h_t = qrnn_layer(t["x"], {"w": t["w"], "b": t["b"]},
                              h0=t["h0"], window=2, x_prev=t["x_prev"],
                              plain=plain)
        torch.autograd.backward((out, h_t), cot)
        grads.append({k: v.grad for k, v in t.items()})
    torch.cuda.synchronize()
    rel = max(_rel(grads[0][k], grads[1][k]) for k in shapes)
    if not rel <= GRAD_REL[dtype]:
        raise AssertionError(f"QRNN layer grads on K6/K7 vs plain autograd "
                             f"{dtype}: relative error {rel} > "
                             f"{GRAD_REL[dtype]}")
    return rel


def qrnn_kernel_checks() -> dict:
    """K6 and K7 against their plain versions at small odd shapes (one
    for K6's per-lane walk), the slot step and the training shapes; K8 at
    small shapes (one block; chunks straddling rows) and at the ragged
    step with valid lengths of 0, 1, mid and full, with every row dead and
    with every row full, its tail equal to
    the frozen carry; K6 and K8 bit for bit; one layer's gradients through
    K6/K7."""
    errs = {"K6": {}, "K7": {}, "K8": {}, "layer_grad_rel": {}}
    shapes = ((7, 5, 40), (19, 3, 129), (*QRNN_SERVE_STEP, 2500),
              (*QRNN_SERVE_STEP, 800), (TRAIN_BPTT, TRAIN_BS, 2500),
              (TRAIN_BPTT, TRAIN_BS, 800))
    for T, B, H in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            key = f"T{T}_B{B}_H{H}_{str(dtype).split('.')[-1]}"
            z, f, h0, cot = fm_inputs(T, B, H, dtype)
            out = FM.forget_mult_forward(z, f, h0)
            grads = FM.forget_mult_backward(z, f, out, h0, cot)
            torch.cuda.synchronize()
            errs["K6"][key] = _fm_err(
                [out], [FM.forget_mult_forward_plain(z, f, h0)], dtype,
                f"K6 {key}", exact=True)
            errs["K7"][key] = _fm_err(
                grads, FM.forget_mult_backward_plain(z, f, out, h0, cot),
                dtype, f"K7 {key}")
            print(f"K6/K7 vs plain {key}: max |diff| {errs['K6'][key]:.3g} "
                  f"/ {errs['K7'][key]:.3g}", flush=True)
    for T, B, H in ((7, 5, 40), (16, 1, 8), (16, 8, 129), (16, 32, 2500),
                    (16, 32, 800)):
        cases = {**valid_cases(T, B), "all_dead": [0] * B, "full": [T] * B}
        for dtype in (torch.float32, torch.bfloat16):
            z, f, h0, _ = fm_inputs(T, B, H, dtype)
            for case, valid in cases.items():
                key = f"T{T}_B{B}_H{H}_{str(dtype).split('.')[-1]}_{case}"
                vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
                out = FM.forget_mult_ragged(z, f, h0, vl)
                torch.cuda.synchronize()
                errs["K8"][key] = _fm_err(
                    [out], [FM.forget_mult_ragged_plain(z, f, h0, vl)],
                    dtype, f"K8 {key}", exact=True)
                for b, v in enumerate(valid):
                    frozen = out[v - 1, b] if v else h0[b]
                    if not torch.equal(out[v:, b], frozen.expand(T - v, H)):
                        raise AssertionError(f"K8 {key}: row {b}'s tail is "
                                             f"not its frozen carry")
                print(f"K8 vs plain {key}: max |diff| "
                      f"{errs['K8'][key]:.3g}", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        key = (f"T{TRAIN_BPTT}_B{TRAIN_BS}_in800_H2500_"
               f"{str(dtype).split('.')[-1]}")
        errs["layer_grad_rel"][key] = check_qrnn_layer_grads(
            TRAIN_BPTT, TRAIN_BS, 800, 2500, dtype)
        print(f"QRNN layer grads vs plain autograd {key}: relative "
              f"{errs['layer_grad_rel'][key]:.3g}", flush=True)
    return errs


def fm_bound_ms(T, B, H, dtype, kernel, valid=None):
    """The least time for one call. Bytes: K6 reads z, f and h0 and writes
    out; K8 reads z and f only for the live (step, row) pairs of these
    lengths, plus h0 and the lengths, and writes all of out; K7 reads z,
    f, out, g and h0 and writes dz, df and dh0. Operations: 4 f32
    operations per element and step forward, 7 backward, at the CUDA
    cores' f32 rate (they never reach it: the bytes bound them)."""
    item = torch.tensor([], dtype=dtype).element_size()
    tbh, bh = T * B * H, B * H
    if kernel == "K7":
        n_bytes, n_ops = (6 * tbh + 2 * bh) * item, 7 * tbh
    elif kernel == "K8":
        live = sum(min(int(v), T) for v in valid) * H
        n_bytes, n_ops = (2 * live + tbh + bh) * item + 4 * B, 4 * live
    else:
        n_bytes, n_ops = (3 * tbh + bh) * item, 4 * tbh
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_FLOPS[torch.float32] * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_mb": n_bytes / 1e6,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def device_ms(fn, kernel: str, reps: int, before=None) -> float:
    """Mean device time of the CUDA kernel whose name holds ``kernel`` over
    ``reps`` calls of ``fn``, read from ``torch.profiler``; ``before`` runs
    ahead of each call (an L2 flush) and is not counted."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then misses a launch: again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        seen = sum(e.count for e in events)
        if seen == reps:
            return sum(e.device_time_total for e in events) / reps / 1e3
    raise AssertionError(f"the profiler saw {seen} of {reps} launches of "
                         f"{kernel} ({[e.key for e in events]}), three times")


def qrnn_timing_phase() -> dict:
    """K6 at the slot step and the training shape, K7 at the training
    shape, K8 at the ragged step (seeded lengths in [1, 16], one full row),
    all bf16 at H=2500. A launch takes less time on the card than its
    wrapper takes on the host, so CUDA events around a call time the host:
    ``ms`` is the kernel's device time by the profiler, each launch after a
    256 MB write has pushed its inputs out of the 50 MB L2, as the bound
    assumes; ``ms_warm`` the same back to back on the same inputs;
    ``ms_call`` a whole call on an idle card by CUDA events, the wrapper's
    host time included. ``launch_floor_ms`` is the device time the
    profiler gives a one-element fill, the least any launch shows;
    ``same_bytes_ms`` (K6, K8) PyTorch's ``add(z, f, out=)`` after the
    same flush: the bytes of a K6 call, in its vectorized elementwise
    kernel, a yardstick of the HBM rate this access pattern gets (not the
    same function, so not ``library_ms``; K8 reads only live steps)."""
    dtype, H = torch.bfloat16, 2500
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(SEED + 3)
    valid = [int(v) for v in rng.integers(1, 17, 32)]
    valid[0] = 16
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    cases = {
        "K6_slot_step": ("K6", (*QRNN_SERVE_STEP, H), None),
        "K6_train": ("K6", (TRAIN_BPTT, TRAIN_BS, H), None),
        "K7_train": ("K7", (TRAIN_BPTT, TRAIN_BS, H), None),
        "K8_ragged_step": ("K8", (16, 32, H), valid),
    }
    one = torch.zeros(1, device="cuda")
    out = {"dtype": "bfloat16", "ragged_valid_lens": valid,
           "launch_floor_ms": device_ms(lambda: one.fill_(1.0),
                                        "elementwise", 50)}
    for name, (kernel, (T, B, Hh), lens) in cases.items():
        z, f, h0, cot = fm_inputs(T, B, Hh, dtype, seed=SEED + 10)
        h = FM.forget_mult_forward(z, f, h0)
        fn, plain = {
            "K6": (lambda: FM.forget_mult_forward(z, f, h0),
                   lambda: FM.forget_mult_forward_plain(z, f, h0)),
            "K7": (lambda: FM.forget_mult_backward(z, f, h, h0, cot),
                   lambda: FM.forget_mult_backward_plain(z, f, h, h0, cot)),
            "K8": (lambda: FM.forget_mult_ragged(z, f, h0, vl),
                   lambda: FM.forget_mult_ragged_plain(z, f, h0, vl)),
        }[kernel]
        cu_name = "forget_mult_bwd" if kernel == "K7" else "forget_mult_fwd"
        buf = torch.empty_like(z)
        out[name] = {
            "kernel": kernel, "shape": {"T": T, "B": B, "H": Hh},
            **({} if kernel == "K7" else {"same_bytes_ms": device_ms(
                lambda: torch.add(z, f, out=buf), "CUDAFunctor_add", 20,
                before=flush.zero_)}),
            "ms": device_ms(fn, cu_name, 20, before=flush.zero_),
            "ms_warm": device_ms(fn, cu_name, 50),
            "ms_call": cuda_ms_each(flush.zero_, lambda _: fn(), reps=20),
            "plain_ms": cuda_ms(plain, reps=3),
            **fm_bound_ms(T, B, Hh, dtype, kernel, lens),
            "library_ms": None}
    del flush
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = "card"
    try:
        print(card_line(), flush=True)

        phase = "build"
        for b in _build.build_all(verbose=True):
            print(f"built {b.name}.cu in {b.seconds:.2f} s", flush=True)
            print(b.log.strip(), file=sys.stderr)

        phase = "kernel vs plain"
        errs = kernel_checks()
        train_errs = training_kernel_checks()
        qrnn_errs = qrnn_kernel_checks()

        phase = "serve"
        rng = np.random.default_rng(SEED)
        docs = issues(rng)
        (REPO / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
            t0 = time.perf_counter()
            export_encoder(tmp, random_encoder_arrays(FLAGSHIP, SEED),
                           FLAGSHIP, flagship_vocab(docs))
            print(f"export written in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            serve = serve_paths(Path(tmp), docs)

        phase = "serve QRNN"
        with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
            export_encoder(tmp, random_encoder_arrays(FLAGSHIP_QRNN, SEED),
                           FLAGSHIP_QRNN, flagship_vocab(docs))
            qrnn_serve = serve_paths(Path(tmp), docs, FLAGSHIP_QRNN,
                                     "_qrnn")

        phase = "train"
        with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
            train = training_phase(Path(tmp))
        print(json.dumps({"train": train}), flush=True)

        phase = "train QRNN"
        with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
            qrnn_train = training_phase(Path(tmp), FLAGSHIP_QRNN)
        print(json.dumps({"train_qrnn": qrnn_train}), flush=True)

        phase = "timing"
        timing = timing_phase()
        print(json.dumps({"timing": timing}), flush=True)
        ragged_timing = ragged_timing_phase()
        print(json.dumps({"ragged_timing": ragged_timing}), flush=True)
        train_timing = train_timing_phase()
        print(json.dumps({"train_timing": train_timing}), flush=True)
        qrnn_timing = qrnn_timing_phase()
        print(json.dumps({"qrnn_timing": qrnn_timing}), flush=True)
    except Exception as e:  # any failed phase fails the run
        print(f"chip_smoke: phase '{phase}' failed: {e!r}", file=sys.stderr)
        raise
    source = "code_intelligence_tpu_torch/csrc/fused_lstm.cu"
    replaces = "code_intelligence_tpu/ops/pallas_lstm.py:"
    kernels = [{
        "name": "fused_lstm_forward",
        "route": "cuda",
        "product": TC_PRODUCT,
        "source": source,
        "replaces": replaces + "286",
        "launches": serve["slots"]["launches"],
        "max_abs_err": max(errs["K1"].values()),
        "max_abs_err_by_case": errs["K1"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "timed_shape": timing["shape"],
    }]
    for name, fn, line, path in (
            ("K2", "fused_lstm_forward_ragged", "457", "ragged"),
            ("K3", "fused_lstm_forward_ragged_int8", "661", "ragged_int8")):
        t = ragged_timing[name]
        kernels.append({
            "name": fn,
            "route": "cuda",
            "product": TC_PRODUCT,
            "source": source,
            "replaces": replaces + line,
            "launches": serve[path]["launches"],
            "max_abs_err": max(errs[name].values()),
            "max_abs_err_by_case": errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "timed_shape": ragged_timing["shape"],
        })
    for name, fn, line in (("K4", "fused_lstm_forward_gates", "265"),
                           ("K5", "fused_lstm_backward", "878")):
        t = train_timing[name]
        kernels.append({
            "name": fn,
            "route": "cuda",
            "product": TC_PRODUCT,
            "source": source,
            "replaces": replaces + line,
            "launches": train["launches"][name],
            "max_abs_err": max(train_errs[name].values()),
            "max_abs_err_by_case": train_errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": train_timing["library"][name],
            "timed_shape": train_timing["shape"],
        })
    # K6 runs on the QRNN slots path and in QRNN training (windows and
    # validation), K7 in training, K8 on both ragged paths
    qrnn_launches = {
        "K6": {"serve_slots": qrnn_serve["slots"]["launches"],
               "train": qrnn_train["launches"]["K6"]},
        "K7": {"train": qrnn_train["launches"]["K7"]},
        "K8": {"serve_ragged": qrnn_serve["ragged"]["launches"],
               "serve_ragged_int8": qrnn_serve["ragged_int8"]["launches"]}}
    slot = qrnn_timing["K6_slot_step"]
    for name, fn, line, timed in (
            ("K6", "forget_mult_forward", "207", "K6_train"),
            ("K7", "forget_mult_backward", "276", "K7_train"),
            ("K8", "forget_mult_forward_ragged", "239", "K8_ragged_step")):
        t = qrnn_timing[timed]
        kernels.append({
            "name": fn,
            "route": "cuda",
            "source": "code_intelligence_tpu_torch/csrc/forget_mult.cu",
            "replaces": f"code_intelligence_tpu/ops/pallas_qrnn.py:{line}",
            "launches": sum(qrnn_launches[name].values()),
            "launches_by_path": qrnn_launches[name],
            "max_abs_err": max(qrnn_errs[name].values()),
            "max_abs_err_by_case": qrnn_errs[name],
            "ms": t["ms"],
            "ms_warm": t["ms_warm"],
            **({"ms_slot_step": slot["ms"], "ms_warm_slot_step":
                slot["ms_warm"], "bound_ms_slot_step": slot["bound_ms"],
                "same_bytes_ms_slot_step": slot["same_bytes_ms"]}
               if name == "K6" else {}),
            "same_bytes_ms": t.get("same_bytes_ms"),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes a forget-mult",
            "timed_shape": {**t["shape"], "dtype": "bfloat16"},
            "launch_floor_ms": qrnn_timing["launch_floor_ms"],
            "notes": FM_NOTES[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
