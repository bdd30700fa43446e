"""Embedding REST server (reduced).

Carries the JAX package's ``serving/server.py`` wire contract over the
port's engine:

* ``POST /text`` with JSON ``{"title": ..., "body": ...}`` returns the
  pooled embedding as raw little-endian float32 bytes (2400 values at the
  flagship width); clients decode with ``np.frombuffer(body, '<f4')``.
  A bad body gives 400, a wrong ``X-Auth-Token`` 403, an unknown route
  404.
* ``GET /healthz`` gives 200 once the model is loaded and warmed.
* ``GET /metrics`` gives Prometheus text: request counts by route and
  code, request latency, and the scheduler's gauges (with
  ``serve_precision_int8`` and ``encoder_weight_bytes``).

``--scheduler`` picks the batching path (``slots``, the default;
``ragged``, the paged length-aware step; ``groups``) and ``--precision``
the weight precision (``f32``, or ``int8``, quantized at load), as in the
JAX server. Device work is serialized by one model lock around
``engine.embed_issues``. The micro-batcher,
canary rollout, embedding cache, SLO tracking, deadlines and load
shedding, profiling, the delivery loop and the memory ledger are not
ported yet.

    python -m code_intelligence_tpu_torch.serving.server --model_dir D \
        [--device cuda|cpu] [--scheduler slots|groups|ragged] \
        [--precision f32|int8] [--batch_size 32] [--port 8080] \
        [--auth_token T]
"""

from __future__ import annotations

import argparse
import hashlib
import hmac
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from code_intelligence_tpu_torch.inference.engine import InferenceEngine
from code_intelligence_tpu_torch.utils.metrics import Registry

log = logging.getLogger(__name__)

SCHEDULERS = ("slots", "groups", "ragged")


class EmbeddingServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, engine: InferenceEngine,
                 auth_token: Optional[str] = None, scheduler: str = "slots"):
        self.engine = engine
        self.auth_token = auth_token
        self.scheduler = engine._check_scheduler(scheduler)
        self.model_lock = threading.Lock()
        self.metrics = Registry()
        self.metrics.counter("embedding_requests_total",
                             "POST requests by route and status code")
        self.metrics.histogram("embedding_request_seconds",
                               "POST request latency")
        if scheduler == "slots":
            engine.slot_scheduler(registry=self.metrics)
        elif scheduler == "ragged":
            engine.ragged_scheduler(registry=self.metrics)
        super().__init__(addr, _Handler)

    @property
    def port(self) -> int:
        return self.server_address[1]

    def embed(self, title: str, body: str) -> np.ndarray:
        with self.model_lock:
            return self.engine.embed_issues(
                [{"title": title, "body": body}],
                scheduler=self.scheduler)[0]


class _Handler(BaseHTTPRequestHandler):
    server: EmbeddingServer

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.info("%s %s", self.address_string(), fmt % args)

    def _send(self, code: int, body: bytes,
              content_type: str = "application/octet-stream") -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    @staticmethod
    def _json(code: int, obj) -> tuple:
        return code, json.dumps(obj).encode(), "application/json"

    def do_GET(self):
        path = self.path.partition("?")[0]
        if path == "/healthz":
            self._send(*self._json(200, {"status": "ok"}))
        elif path == "/metrics":
            self._send(200, self.server.metrics.render().encode(),
                       "text/plain; version=0.0.4")
        else:
            self._send(*self._json(404, {"error": f"no route {self.path}"}))

    def _auth_ok(self) -> bool:
        """True when no token is configured or the header matches it. The
        stdlib parser decodes headers as latin-1; re-encoding recovers the
        wire bytes, compared with the token's UTF-8 bytes."""
        token = self.server.auth_token
        if token is None:
            return True
        received = self.headers.get("X-Auth-Token") or ""
        return hmac.compare_digest(
            received.encode("latin-1", "ignore"), token.encode("utf-8"))

    def _handle_post(self) -> tuple:
        if self.path != "/text":
            return self._json(404, {"error": f"no route {self.path}"})
        if not self._auth_ok():
            return self._json(403, {"error": "bad auth token"})
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("payload must be a JSON object")
            title = payload.get("title", "")
            body = payload.get("body", "")
        except ValueError as e:  # includes json.JSONDecodeError
            return self._json(400, {"error": f"bad request body: {e}"})
        try:
            emb = self.server.embed(title, body)
        except Exception:  # the server keeps serving; the client gets 500
            log.exception("embedding failed")
            return self._json(500, {"error": "embedding failed"})
        raw = np.ascontiguousarray(emb, dtype="<f4").tobytes()
        log.info("embedding md5=%s dim=%d title_len=%d",
                 hashlib.md5(raw).hexdigest(), emb.shape[-1], len(title))
        return 200, raw, "application/octet-stream"

    def do_POST(self):
        t0 = time.perf_counter()
        route = "/text" if self.path == "/text" else "other"
        code, body, ctype = self._handle_post()
        # metrics before the response goes out: a client that scrapes right
        # after its response must see its own request counted
        self.server.metrics.inc("embedding_requests_total",
                                labels={"route": route, "code": str(code)})
        self.server.metrics.observe("embedding_request_seconds",
                                    time.perf_counter() - t0)
        self._send(code, body, ctype)


def build_server(model_dir, device="cuda", batch_size: int = 32,
                 host: str = "0.0.0.0", port: int = 8080,
                 auth_token: Optional[str] = None, scheduler: str = "slots",
                 precision: str = "f32") -> EmbeddingServer:
    """Load the export (quantized at load under ``precision="int8"``), warm
    the serve path up, and bind the listener (``port=0`` picks a free
    one). The caller runs ``serve_forever``."""
    engine = InferenceEngine.from_export(model_dir, batch_size=batch_size,
                                         scheduler=scheduler, device=device,
                                         precision=precision)
    engine.warmup()
    return EmbeddingServer((host, port), engine, auth_token=auth_token,
                           scheduler=scheduler)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Serve POST /text embeddings from an export directory.")
    p.add_argument("--model_dir", required=True, help="export directory")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--scheduler", default="slots", choices=SCHEDULERS,
                   help="slots = continuous batching in (B, 64) steps; "
                        "ragged = the same loop with paged state and a "
                        "length-aware (B, 16) step; groups = the "
                        "length-sorted lock-step path")
    p.add_argument("--precision", default="f32", choices=("f32", "int8"),
                   help="int8 quantizes the encoder weights at load "
                        "(per-channel symmetric); the export stays f32")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--auth_token", default=None)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    srv = build_server(args.model_dir, device=args.device,
                       batch_size=args.batch_size, host=args.host,
                       port=args.port, auth_token=args.auth_token,
                       scheduler=args.scheduler, precision=args.precision)
    log.info("embedding server listening on %s:%d", args.host, srv.port)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
