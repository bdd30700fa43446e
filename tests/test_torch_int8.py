"""The port's int8 serve path against the JAX package: the quantizer
(bitwise), K3's plain version against the JAX Pallas kernel in interpret
mode, the int8 encoder against the JAX int8 encoder on its Pallas branch,
and the int8 engine on every scheduler against the JAX int8 engine's
``groups`` path. The CUDA kernel itself is held against the plain version
on the card, by tests/test_torch_cuda.py and chip_smoke.py."""

import http.client
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code_intelligence_tpu.inference import InferenceEngine as JaxEngine
from code_intelligence_tpu.models import AWDLSTMConfig as JaxConfig
from code_intelligence_tpu.models import AWDLSTMEncoder as JaxEncoder
from code_intelligence_tpu.models import init_lstm_states as jax_init_states
from code_intelligence_tpu.ops import quantize as jax_quantize
from code_intelligence_tpu.ops.pallas_lstm import (
    fused_lstm_forward_ragged_int8 as jax_k3)
from code_intelligence_tpu_torch.inference.engine import InferenceEngine
from code_intelligence_tpu_torch.inference.int8_check import run_int8_check
from code_intelligence_tpu_torch.models import (
    AWDLSTMConfig,
    AWDLSTMEncoder,
    init_lstm_states,
)
from code_intelligence_tpu_torch.ops import fused_lstm as K
from code_intelligence_tpu_torch.ops import quantize
from code_intelligence_tpu_torch.serving import server as port_server
from code_intelligence_tpu_torch.training.checkpoint import params_from_numpy
from torch_port_fixtures import (
    MARKDOWN_DOCS,
    TINY,
    k1_inputs,
    mixed_seqs,
    write_jax_export,
)

# f32, same codes and scales on both sides: the kernels' bar. The port's
# K3 multiplies the (h . q) sum by the scale, while the JAX int8 scan (the
# engine's groups path off-TPU) multiplies the weight by the scale first;
# the two differ by float rounding only, well inside 1e-5 here
ATOL = 1e-5
KW = {"buckets": (8, 16), "batch_size": 4}


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, (12, 7)).astype(np.float32)
    w[3] = 0.0          # an all-zero channel: scale 1.0, codes 0
    w[5, 2] = 40.0      # an outlier channel: only its own scale grows
    w[7] = 1e-30        # a tiny channel
    # scale 1.0 and exact half steps: rint rounds them to even
    w[8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5]
    return w


@pytest.mark.parametrize("shape,axis", [((12, 7), 0), ((12, 7), 1),
                                        ((12,), 0), ((3, 4, 5), -1)],
                         ids=["rows", "columns", "vector", "3d-last"])
def test_quantize_symmetric_bitwise_equals_jax(shape, axis):
    w = _weights()
    if shape != w.shape:
        w = np.random.default_rng(1).normal(0, 1, shape).astype(np.float32)
        w[(0,) * len(shape)] = 0.0
    q, s = quantize.quantize_symmetric(w, axis=axis)
    jq, js = jax_quantize.quantize_symmetric(w, axis=axis)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.int32), js.view(np.int32))
    if shape == (12, 7) and axis == 0:
        assert s[3] == 1.0 and not q[3].any()
        assert s[5] > 100 * s[4]  # the outlier inflates only its own row
        assert np.abs(q[4]).max() == 127
    with pytest.raises(ValueError, match="axis"):
        quantize.quantize_symmetric(w, axis=len(shape))


def test_quantize_encoder_params_bitwise_equals_jax(tmp_path):
    _, arrays = write_jax_export(tmp_path, n_layers=3)
    arrays["lstm_1_w_hh"][5] = 0.0  # an all-zero channel in a real layer
    cfg = AWDLSTMConfig(n_layers=3, **TINY)
    got = quantize.quantize_encoder_params(arrays, cfg)
    want = jax_quantize.quantize_encoder_params(
        arrays, JaxConfig(n_layers=3, **TINY))
    assert got.keys() == want.keys()
    for k in got:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      w.view(np.uint8), err_msg=k)
    assert got["lstm_0_bias"] is arrays["lstm_0_bias"]  # biases pass through
    assert quantize.tree_bytes(got) == jax_quantize.tree_bytes(want)
    assert quantize.tree_bytes(params_from_numpy(got)) == \
        jax_quantize.tree_bytes(want)
    with pytest.raises(KeyError, match="lstm_2_w_hh"):
        quantize.quantize_encoder_params(
            {k: v for k, v in arrays.items() if k != "lstm_2_w_hh"}, cfg)


def _k3_inputs(T, B, H, seed):
    x_proj, w_hh, h0, c0 = k1_inputs(T, B, H, seed)
    q, s = quantize.quantize_symmetric(w_hh, axis=0)
    return x_proj, q, s, h0, c0


@pytest.mark.parametrize("T,B,H,valid", [
    (9, 4, 8, [0, 1, 9, 6]),
    (7, 5, 12, [3, 7, 1, 0, 5]),
    (6, 2, 8, [0, 0]),
], ids=["zero-one-full-mid", "odd-shape", "all-exhausted"])
def test_plain_matches_jax_ragged_int8_interpret(T, B, H, valid):
    arrs = _k3_inputs(T, B, H, seed=T * B)
    vl = np.asarray(valid, np.int32)
    want = jax_k3(*(jnp.asarray(a) for a in arrs), jnp.asarray(vl),
                  interpret=True)
    out, (h, c) = K.fused_lstm_forward_ragged_int8(
        *(torch.from_numpy(a) for a in arrs), torch.from_numpy(vl))
    want = [np.asarray(want[0]), *map(np.asarray, want[1])]
    for b, v in enumerate(valid):
        assert torch.all(out[v:, b] == 0), f"tail not zero, row {b}"
    for g, w in zip((out, h, c), want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


def test_k3_wrapper_checks():
    x, q, s, h, c = (torch.from_numpy(a) for a in _k3_inputs(3, 2, 8, 0))
    vl = torch.tensor([3, 1], dtype=torch.int32)
    with pytest.raises(TypeError, match="int8"):
        K.fused_lstm_forward_ragged_int8(x, q.float(), s, h, c, vl)
    with pytest.raises(ValueError, match="w_hh_scale"):
        K.fused_lstm_forward_ragged_int8(x, q, s[:-1], h, c, vl)
    with pytest.raises(TypeError, match="one dtype"):
        K.fused_lstm_forward_ragged_int8(x, q, s, h.to(torch.bfloat16), c, vl)
    before = K.ragged_int8_launches.count
    out, (hT, _) = K.fused_lstm_forward_ragged_int8(x, q, s, h, c, vl, 3)
    assert K.ragged_int8_launches.count == before  # CPU: the plain version
    assert torch.equal(out[2, 0], hT[0]) and torch.all(out[1:, 1] == 0)


@pytest.mark.parametrize("use_valid", [True, False],
                         ids=["valid-lens", "dense"])
def test_int8_encoder_matches_jax_int8_pallas(tmp_path, use_valid):
    _, arrays = write_jax_export(tmp_path, n_layers=3)
    jcfg = JaxConfig(n_layers=3, lstm_use_pallas=True, precision="int8",
                     **TINY)
    jparams = jax_quantize.quantize_encoder_params(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jcfg)
    cfg = AWDLSTMConfig(n_layers=3, precision="int8", **TINY)
    enc = AWDLSTMEncoder(cfg)
    enc.load_state_dict(params_from_numpy(
        quantize.quantize_encoder_params(arrays, cfg)))
    assert enc.lstm_1_w_hh.dtype == torch.int8
    assert enc.embedding.dtype == torch.int8
    B, T = 4, 10
    tokens = np.random.default_rng(8).integers(0, 200, (B, T), np.int32)
    valid = np.array([2, T, 0, 7] if use_valid else [T] * B, np.int32)
    raw_j, _, states_j = JaxEncoder(jcfg).apply(
        {"params": jparams}, jnp.asarray(tokens), jax_init_states(jcfg, B),
        deterministic=True, valid_lens=jnp.asarray(valid))
    kw = {"valid_lens": torch.from_numpy(valid)} if use_valid else {}
    with torch.inference_mode():
        raw, states = enc(torch.from_numpy(tokens), init_lstm_states(cfg, B),
                          **kw)
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_j), atol=ATOL,
                               rtol=0)
    for (h, c), (hj, cj) in zip(states, states_j):
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=ATOL,
                                   rtol=0)


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    d, _ = write_jax_export(tmp_path_factory.mktemp("export"), n_layers=3)
    return d


@pytest.fixture(scope="module")
def jax_int8(export_dir):
    return JaxEngine.from_export(export_dir, precision="int8", **KW)


@pytest.fixture(scope="module")
def engine(export_dir):
    return InferenceEngine.from_export(export_dir, device="cpu",
                                       precision="int8", **KW)


@pytest.mark.parametrize("scheduler", ["groups", "slots", "ragged"])
def test_int8_engine_matches_jax_int8_groups(engine, jax_int8, scheduler):
    seqs = mixed_seqs(n=17, seed=4)  # more docs than the 8 ragged pages
    want = jax_int8.embed_ids_batch(seqs, scheduler="groups")
    got = engine.embed_ids_batch(seqs, scheduler=scheduler)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_int8_engine_quantizes_at_load(engine, jax_int8, export_dir):
    assert engine.precision == "int8" and engine.config.precision == "int8"
    assert (engine.weight_bytes_f32, engine.weight_bytes) == \
        (jax_int8.weight_bytes_f32, jax_int8.weight_bytes)
    assert engine.weight_bytes_f32 / engine.weight_bytes >= 3.0
    # no dequantized weight is resident: every matrix is int8 codes
    for name, p in engine.encoder.named_parameters():
        if p.dim() == 2:
            assert p.dtype == torch.int8, name
    # the slots path passes its chunk lengths, so it counts the live steps
    sched = engine.slot_scheduler()
    rec0, steps0 = sched.recurrence_steps, sched.steps_run
    engine.embed_ids_batch([np.arange(20, 23, dtype=np.int32)],
                           scheduler="slots")
    assert (sched.steps_run - steps0, sched.recurrence_steps - rec0) == (1, 3)
    with pytest.raises(ValueError, match="precision"):
        InferenceEngine.from_export(export_dir, device="cpu",
                                    precision="fp8", **KW)


def test_int8_check_twin_is_green():
    result = run_int8_check(device="cpu")
    assert result["ok"], result
    assert result["footprint_ratio"] >= 3.0
    assert result["parity_max_abs_diff"] <= 0.05


@pytest.fixture(scope="module")
def served(export_dir):
    srv = port_server.build_server(export_dir, device="cpu", batch_size=4,
                                   host="127.0.0.1", port=0,
                                   scheduler="ragged", precision="int8")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def _request(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_post_text_ragged_int8_matches_port_engine(served, engine):
    assert served.scheduler == "ragged"
    assert served.engine.precision == "int8"
    for title, body in [("Crash on startup", MARKDOWN_DOCS[1]), ("", ""),
                        ("w9", "w10 " * 60)]:
        code, raw = _request(served, "POST", "/text",
                             json.dumps({"title": title, "body": body}))
        assert code == 200
        got = np.frombuffer(raw, dtype="<f4")
        assert got.shape == (24,)
        np.testing.assert_allclose(got, engine.embed_issue(title, body),
                                   atol=ATOL, rtol=0)
    code, text = _request(served, "GET", "/metrics")
    text = text.decode()
    assert code == 200 and "serve_precision_int8 1.0" in text
    assert f"encoder_weight_bytes {float(engine.weight_bytes)}" in text
    for name in ("slots_pages_free", "slots_pages_live", "slot_occupancy"):
        assert name in text


def test_server_cli_takes_scheduler_and_precision(export_dir, monkeypatch):
    seen = {}

    def fake_build(model_dir, **kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(port_server, "build_server", fake_build)
    with pytest.raises(SystemExit):
        port_server.main(["--model_dir", str(export_dir), "--device", "cpu",
                          "--scheduler", "ragged", "--precision", "int8"])
    assert (seen["scheduler"], seen["precision"]) == ("ragged", "int8")
    for bad in (["--scheduler", "paged"], ["--precision", "int4"]):
        with pytest.raises(SystemExit):
            port_server.main(["--model_dir", str(export_dir), *bad])
