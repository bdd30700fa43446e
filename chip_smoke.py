#!/usr/bin/env python3
"""Drive the PyTorch port's serve path on one NVIDIA card, and check it.

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
   serve path gives it (B=32, T=64, H=2500 and H=800), within the
   tolerances below.
4. The serve path: a flagship-width export (60,000-token vocab, emb 800,
   hidden 2500/2500/2500/800, bf16) made from a numpy seed; the port's
   server on the card answers POST /text for issues of mixed length,
   including an empty body and one longer than 512 tokens. Every response
   must be 2400 finite float32 values equal, within ``EMBED_ATOL``, to the
   same engine run on the card with the plain encoder. The kernel launch
   counters are zeroed just before the requests and read just after: K1
   must have run ``n_layers * chunk_len`` launches per slot step.
5. Timing at B=32, T=512, H=2500 in bf16 with CUDA events: the kernel,
   its plain version, and cuDNN's ``torch.nn.LSTM`` on the same layer as a
   yardstick only (the port never calls it; it includes the input
   projection), beside the least time the card could take.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when there is no CUDA device.
"""

from __future__ import annotations

import http.client
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from code_intelligence_tpu_torch.models import (
    AWDLSTMConfig,
    random_encoder_arrays,
)
from code_intelligence_tpu_torch.inference.engine import InferenceEngine
from code_intelligence_tpu_torch.ops import _build
from code_intelligence_tpu_torch.ops import fused_lstm as K1
from code_intelligence_tpu_torch.serving.server import build_server
from code_intelligence_tpu_torch.text import SPECIALS, Tokenizer, Vocab
from code_intelligence_tpu_torch.training.checkpoint import export_encoder

SEED = 0
REPO = Path(__file__).resolve().parent

# Kernel vs plain on the card. f32: both sides do the recurrent product in
# full f32 and differ only in summation order. bf16: h and c are rounded to
# bf16 after every step, so one step's order difference can move a carry
# by one bf16 ulp (2^-8 near 1), which later steps carry on.
K1_ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# Served embedding vs the plain encoder, bf16 export: the bf16 carry
# differences above, through four layers and the mean/max/last pooling.
EMBED_ATOL = 5e-2

# NVIDIA H100 SXM data sheet, dense: HBM rate and peak rate per input type
# (f32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

FLAGSHIP = AWDLSTMConfig(vocab_size=60000, emb_sz=800, n_hid=2500,
                         n_layers=4, dtype="bfloat16")

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


def k1_bound_ms(T, B, H, dtype):
    """The least time for one call: each input read once and each output
    written once over the HBM rate, or the recurrent product's operations
    over the peak rate for the input type, whichever is larger."""
    item = torch.tensor([], dtype=dtype).element_size()
    elems = (T * B * 4 * H + 4 * H * H + 2 * B * H  # x_proj, w_hh, h0, c0
             + T * B * H + 2 * B * H)               # out, h_T, c_T
    bytes_ms = elems * item / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * T * B * 4 * H * H / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def post(port: int, issue: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/text", body=json.dumps(issue),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def serve_phase(model_dir: Path, docs) -> dict:
    t0 = time.perf_counter()
    srv = build_server(model_dir, device="cuda", batch_size=32,
                       host="127.0.0.1", port=0)
    boot_s = time.perf_counter() - t0
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        sched = srv.engine.slot_scheduler()
        steps0 = sched.steps_run
        K1.launches.reset()  # every count to 0 just before the main path
        got, request_ms = [], []
        for issue in docs:
            t = time.perf_counter()
            code, body = post(srv.port, issue)
            request_ms.append((time.perf_counter() - t) * 1e3)
            if code != 200:
                raise AssertionError(f"POST /text gave {code}: {body[:200]!r}")
            got.append(np.frombuffer(body, dtype="<f4"))
        launches = K1.launches.count
        steps = sched.steps_run - steps0
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    for v in got:
        if v.shape != (3 * FLAGSHIP.emb_sz,) or not np.isfinite(v).all():
            raise AssertionError(f"bad embedding: shape {v.shape}")
    want_per_step = FLAGSHIP.n_layers * sched.chunk_len
    if steps == 0 or launches != want_per_step * steps:
        raise AssertionError(
            f"K1 launches {launches} over {steps} slot steps; expected "
            f"{want_per_step} per step")
    plain = InferenceEngine.from_export(model_dir, batch_size=32,
                                        scheduler="slots", device="cuda",
                                        plain=True)
    want = plain.embed_issues(docs)
    err = float(np.abs(np.stack(got) - want).max())
    if err > EMBED_ATOL:
        raise AssertionError(f"served vs plain encoder: max |diff| {err} > "
                             f"{EMBED_ATOL}")
    return {"boot_s": boot_s, "requests": len(docs), "slot_steps": steps,
            "chunk_len": sched.chunk_len, "launches": launches,
            "launches_per_step": want_per_step, "request_ms": request_ms,
            "embed_max_abs_err": err, "embed_atol": EMBED_ATOL}


def timing_phase() -> dict:
    T, B, H, dtype = 512, 32, 2500, torch.bfloat16
    args = k1_inputs(T, B, H, dtype, seed=SEED + 1)
    ms = cuda_ms(lambda: K1.fused_lstm_forward(*args), reps=3)
    plain_ms = cuda_ms(lambda: K1.fused_lstm_forward_plain(*args), reps=2)
    step_args = k1_inputs(64, B, H, dtype, seed=SEED + 2)
    step_ms = cuda_ms(lambda: K1.fused_lstm_forward(*step_args), reps=5)
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
            "bound_ms": bound_ms, "bound_by": bound_by,
            # a design that streams W_hh from HBM every step can do no better
            "weight_stream_bound_ms": T * 4 * H * H * item
            / HBM_BYTES_PER_S * 1e3,
            "ms_T64": step_ms, "bound_ms_T64": k1_bound_ms(64, B, H, dtype)[0]}


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
        errs = {}
        for T, B, H in ((7, 5, 40), (64, 32, 2500), (64, 32, 800)):
            for dtype in (torch.float32, torch.bfloat16):
                key = f"T{T}_B{B}_H{H}_{str(dtype).split('.')[-1]}"
                errs[key] = check_k1(T, B, H, dtype)
                print(f"K1 vs plain {key}: max |diff| {errs[key]:.3g} "
                      f"(atol {K1_ATOL[dtype]})", flush=True)

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
            serve = serve_phase(Path(tmp), docs)
        print(json.dumps({"serve": serve}), flush=True)

        phase = "timing"
        timing = timing_phase()
        print(json.dumps({"timing": timing}), flush=True)
    except Exception as e:  # any failed phase fails the run
        print(f"chip_smoke: phase '{phase}' failed: {e!r}", file=sys.stderr)
        raise
    kernels = [{
        "name": "fused_lstm_forward",
        "route": "cuda",
        "source": "code_intelligence_tpu_torch/csrc/fused_lstm.cu",
        "replaces": "code_intelligence_tpu/ops/pallas_lstm.py:286",
        "launches": serve["launches"],
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_case": errs,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "timed_shape": timing["shape"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
