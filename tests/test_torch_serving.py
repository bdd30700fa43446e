"""The port's serve slice against the JAX package: engine embeddings on
both schedulers, slot reuse, and the POST /text wire contract."""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from code_intelligence_tpu.inference import InferenceEngine as JaxEngine
from code_intelligence_tpu_torch.inference.engine import InferenceEngine
from code_intelligence_tpu_torch.serving import server as port_server
from torch_port_fixtures import MARKDOWN_DOCS, mixed_seqs, write_jax_export

ATOL = 1e-5  # the JAX suite's own bar (tests/test_slot_scheduler.py:53)
KW = {"buckets": (8, 16), "batch_size": 4}


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    d, _ = write_jax_export(tmp_path_factory.mktemp("export"), n_layers=3)
    return d


@pytest.fixture(scope="module")
def jax_engine(export_dir):
    return JaxEngine.from_export(export_dir, **KW)


@pytest.fixture(scope="module")
def engine(export_dir):
    return InferenceEngine.from_export(export_dir, device="cpu", **KW)


@pytest.mark.parametrize("scheduler", ["groups", "slots"])
def test_engine_matches_jax_on_mixed_lengths(engine, jax_engine, scheduler):
    seqs = mixed_seqs()
    want = jax_engine.embed_ids_batch(seqs, scheduler="groups")
    got = engine.embed_ids_batch(seqs, scheduler=scheduler)
    assert got.shape == (len(seqs), 3 * 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_embed_issues_match_jax_slots(engine, jax_engine):
    # the port's slots path against the JAX groups path: the JAX slot
    # scheduler fails at random in shared sessions (ROADMAP "Reference
    # health"), so it is no reference
    issues = [{"title": d[:20], "body": d} for d in MARKDOWN_DOCS]
    issues.append({"title": "w9", "body": "w10 " * 60})  # > largest bucket
    want = jax_engine.embed_issues(issues, scheduler="groups")
    got = engine.embed_issues(issues, scheduler="slots")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(engine.embed_issues(issues, truncate=5),
                               got[:, :5], atol=ATOL, rtol=0)


def test_slots_equal_groups_with_refill_churn(engine):
    seqs = mixed_seqs(n=25, seed=3)  # more docs than slots
    np.testing.assert_allclose(
        engine.embed_ids_batch(seqs, scheduler="slots"),
        engine.embed_ids_batch(seqs, scheduler="groups"), atol=ATOL, rtol=0)
    assert engine.embed_ids_batch([], scheduler="slots").shape == (0, 24)


def test_slot_reuse_leaks_no_state(export_dir):
    eng = InferenceEngine.from_export(export_dir, device="cpu",
                                      buckets=(8, 16), batch_size=1)
    short = np.arange(20, 25, dtype=np.int32)
    fresh = eng.embed_ids_batch([short], scheduler="slots")
    # one slot: the long doc's state and pool must not reach the short doc
    both = eng.embed_ids_batch([np.arange(30, 90, dtype=np.int32), short],
                               scheduler="slots")
    np.testing.assert_array_equal(both[1], fresh[0])
    sched = eng.slot_scheduler()
    assert sched.steps_run == 1 + 4 + 1 and sched.docs_done == 3


def test_scheduler_failure_heals(engine, monkeypatch):
    sched = engine.slot_scheduler()

    def boom(staged):
        raise RuntimeError("device fault")

    monkeypatch.setattr(sched, "_step", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        engine.embed_ids_batch(mixed_seqs(n=3), scheduler="slots")
    monkeypatch.undo()
    assert all(d is None for d in sched._slot_doc) and not sched._queue
    seqs = mixed_seqs(n=3)
    np.testing.assert_allclose(
        engine.embed_ids_batch(seqs, scheduler="slots"),
        engine.embed_ids_batch(seqs, scheduler="groups"), atol=ATOL, rtol=0)


def test_ragged_scheduler_is_not_ported(engine, jax_engine):
    # the name dates from when the port refused the ragged scheduler; the
    # same entry point now serves it
    seqs = mixed_seqs(n=2)
    np.testing.assert_allclose(
        engine.embed_ids_batch(seqs, scheduler="ragged"),
        jax_engine.embed_ids_batch(seqs, scheduler="groups"), atol=ATOL,
        rtol=0)
    with pytest.raises(ValueError, match="scheduler must be"):
        engine.embed_ids_batch(seqs, scheduler="paged")


@pytest.fixture(scope="module")
def served(export_dir):
    srv = port_server.build_server(export_dir, device="cpu", batch_size=4,
                                   host="127.0.0.1", port=0,
                                   auth_token="s3cret")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def _request(srv, method, path, body=None, token="s3cret"):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    headers = {"X-Auth-Token": token} if token else {}
    try:
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Content-Type")
    finally:
        conn.close()


def test_post_text_bytes_match_jax_embed_issue(served, jax_engine):
    for title, body in [("Crash on startup", MARKDOWN_DOCS[1]),
                        ("", ""), ("w9", "w10 " * 60)]:
        code, raw, ctype = _request(served, "POST", "/text",
                                    json.dumps({"title": title, "body": body}))
        assert code == 200 and ctype == "application/octet-stream"
        got = np.frombuffer(raw, dtype="<f4")
        assert got.shape == (24,)
        np.testing.assert_allclose(got, jax_engine.embed_issue(title, body),
                                   atol=ATOL, rtol=0)


def test_server_routes_and_errors(served):
    assert _request(served, "GET", "/healthz", token=None)[0] == 200
    assert _request(served, "POST", "/text", b"{not json")[0] == 400
    assert _request(served, "POST", "/text", b"[1, 2]")[0] == 400
    assert _request(served, "POST", "/text", b"{}", token="wrong")[0] == 403
    assert _request(served, "POST", "/nope", b"{}")[0] == 404
    assert _request(served, "GET", "/nope")[0] == 404
    code, text, _ = _request(served, "GET", "/metrics", token=None)
    assert code == 200
    text = text.decode()
    assert 'embedding_requests_total{code="400",route="/text"}' in text
    for name in ("slot_occupancy", "slot_steps_per_doc",
                 "slot_refill_queue_depth", "h2d_d2h_bytes"):
        assert name in text


def test_no_hidden_cpu(export_dir, monkeypatch):
    # without a card, asking for the default device raises; only an
    # explicit device="cpu" runs on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine.from_export(export_dir, **KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_server.build_server(export_dir, port=0)
    with pytest.raises(SystemExit):
        port_server.main(["--model_dir", str(export_dir), "--device", "tpu"])
