"""K2 (ragged fused LSTM forward) and the ragged scheduler against the JAX
package: the port's plain version against the JAX Pallas kernel in
interpret mode, the encoder with ``valid_lens`` against the JAX encoder
on its Pallas branch, and the ragged scheduler against the JAX engine's
``groups`` path and the port's own ``slots``. The CUDA kernel itself is
held against the plain version on the card, by tests/test_torch_cuda.py
and chip_smoke.py.

No test here builds a JAX slot or ragged scheduler: those fail at random
in shared sessions (ROADMAP "Reference health")."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code_intelligence_tpu.inference import InferenceEngine as JaxEngine
from code_intelligence_tpu.models import AWDLSTMConfig as JaxConfig
from code_intelligence_tpu.models import AWDLSTMEncoder as JaxEncoder
from code_intelligence_tpu.models import init_lstm_states as jax_init_states
from code_intelligence_tpu.ops.lstm import lstm_layer as jax_lstm_layer
from code_intelligence_tpu.ops.pallas_lstm import (
    fused_lstm_forward_ragged as jax_ragged)
from code_intelligence_tpu_torch.inference.engine import InferenceEngine
from code_intelligence_tpu_torch.inference.ragged_check import (
    run_ragged_check)
from code_intelligence_tpu_torch.models import (
    AWDLSTMEncoder,
    init_lstm_states,
)
from code_intelligence_tpu_torch.ops import fused_lstm as K
from code_intelligence_tpu_torch.training.checkpoint import (
    load_encoder,
    params_from_numpy,
)
from code_intelligence_tpu_torch.utils.metrics import Registry
from torch_port_fixtures import TINY, k1_inputs, mixed_seqs, write_jax_export

# f32: the JAX suite's own bar (tests/test_pallas_lstm.py, ragged pins)
ATOL = 1e-5
KW = {"buckets": (8, 16), "batch_size": 4}  # dense chunk 16, page_len 8


def _jax_k2(arrs, valid, tiles=None):
    out, (h, c) = jax_ragged(*(jnp.asarray(a) for a in arrs),
                             jnp.asarray(np.asarray(valid, np.int32)),
                             interpret=True, tiles=tiles)
    return [np.asarray(x) for x in (out, h, c)]


def _port_k2(arrs, valid, t_live=None):
    out, (h, c) = K.fused_lstm_forward_ragged(
        *(torch.from_numpy(a) for a in arrs),
        torch.tensor(valid, dtype=torch.int32), t_live)
    return [x.numpy() for x in (out, h, c)]


def _assert_ragged_match(got, want, valid):
    out, h, c = got
    for b, v in enumerate(valid):
        assert np.all(out[v:, b] == 0.0), f"tail not zero, row {b}"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


# valid 0, 1, full and T-3 (test_pallas_lstm.py:88); zero, mid and full
# (:103); odd batch and width; every row exhausted (:126)
@pytest.mark.parametrize("T,B,H,valid", [
    (9, 4, 8, [0, 1, 9, 6]),
    (9, 3, 12, [0, 4, 9]),
    (7, 5, 7, [3, 7, 1, 0, 5]),
    (6, 2, 8, [0, 0]),
], ids=["zero-one-full-mid", "zero-mid-full", "odd-shape", "all-exhausted"])
def test_plain_matches_jax_ragged_interpret(T, B, H, valid):
    arrs = k1_inputs(T, B, H, seed=T + B)
    got = _port_k2(arrs, valid)
    _assert_ragged_match(got, _jax_k2(arrs, valid), valid)
    if max(valid) == 0:
        np.testing.assert_array_equal(got[1], arrs[2])
        np.testing.assert_array_equal(got[2], arrs[3])


# valid lengths before, on and after every JAX time-chunk boundary
# (tiles=(8, 2)), as test_pallas_lstm.py:137 walks them
@pytest.mark.parametrize("v", [1, 2, 3, 4, 7, 8])
def test_plain_matches_jax_across_time_chunks(v):
    arrs = k1_inputs(8, 4, 8, seed=9)
    valid = [v] * 4
    _assert_ragged_match(_port_k2(arrs, valid),
                         _jax_k2(arrs, valid, tiles=(8, 2)), valid)


def test_t_live_is_exact_and_checked():
    arrs = k1_inputs(6, 3, 8, seed=2)
    valid = [2, 4, 0]
    full = _port_k2(arrs, valid)
    for a, b in zip(_port_k2(arrs, valid, t_live=4), full):
        np.testing.assert_array_equal(a, b)
    x, w, h, c = (torch.from_numpy(a) for a in arrs)
    vl = torch.tensor(valid, dtype=torch.int32)
    with pytest.raises(ValueError, match="t_live"):
        K.fused_lstm_forward_ragged(x, w, h, c, vl, t_live=7)
    with pytest.raises(ValueError, match="valid_lens"):
        K.fused_lstm_forward_ragged(x, w, h, c, vl.long())
    with pytest.raises(ValueError, match="valid_lens"):
        K.fused_lstm_forward_ragged(x, w, h, c, vl[:2])
    # a CPU tensor runs the plain version and never counts a launch
    before = K.ragged_launches.count
    K.fused_lstm_forward_ragged(x, w, h, c, vl, t_live=4)
    assert K.ragged_launches.count == before
    out, (hT, cT) = K.fused_lstm_forward_ragged(x[:0], w, h, c, vl)
    assert out.shape == (0, 3, 8)
    assert torch.equal(hT, h) and torch.equal(cT, c)


def test_layer_matches_jax_scan_on_valid_prefix():
    rng = np.random.default_rng(10)
    B, T, n_in, H = 4, 11, 6, 10
    s = 1.0 / np.sqrt(H)
    x = rng.normal(0, 1, (B, T, n_in)).astype(np.float32)
    w_ih, w_hh = (rng.uniform(-s, s, (4 * H, n)).astype(np.float32)
                  for n in (n_in, H))
    bias = rng.uniform(-s, s, (4 * H,)).astype(np.float32)
    h0, c0 = (rng.normal(0, 0.5, (B, H)).astype(np.float32) for _ in "hc")
    want, _ = jax_lstm_layer(jnp.asarray(x), (jnp.asarray(h0),
                                             jnp.asarray(c0)),
                             jnp.asarray(w_ih), jnp.asarray(w_hh),
                             jnp.asarray(bias))
    valid = [3, T, 1, 0]
    t = torch.from_numpy
    for plain in (False, True):
        out, _ = K.lstm_layer_fused_ragged(
            t(x), (t(h0), t(c0)), t(w_ih), t(w_hh), t(bias),
            torch.tensor(valid, dtype=torch.int32), plain=plain)
        for b, v in enumerate(valid):
            np.testing.assert_allclose(out[b, :v].numpy(),
                                       np.asarray(want)[b, :v], atol=ATOL,
                                       rtol=0)
            assert torch.all(out[b, v:] == 0)


def test_encoder_valid_lens_match_jax_pallas(tmp_path):
    model_dir, arrays = write_jax_export(tmp_path, n_layers=3)
    params, cfg, _ = load_encoder(model_dir)
    enc = AWDLSTMEncoder(cfg)
    enc.load_state_dict(params_from_numpy(params))
    jcfg = JaxConfig(n_layers=3, lstm_use_pallas=True, **TINY)
    B, T = 4, 10
    tokens = np.random.default_rng(5).integers(0, 200, (B, T), np.int32)
    valid = np.array([0, 3, T, 7], np.int32)
    h0 = np.random.default_rng(6).normal(0, 0.3, (B, 12)).astype(np.float32)
    jstates = list(jax_init_states(jcfg, B))
    jstates[0] = (jnp.asarray(h0), jstates[0][1])
    raw_j, _, states_j = JaxEncoder(jcfg).apply(
        {"params": {k: jnp.asarray(v) for k, v in arrays.items()}},
        jnp.asarray(tokens), tuple(jstates), deterministic=True,
        valid_lens=jnp.asarray(valid))
    states = list(init_lstm_states(cfg, B))
    states[0] = (torch.from_numpy(h0), states[0][1])
    with torch.inference_mode():
        raw, new_states = enc(torch.from_numpy(tokens), tuple(states),
                              valid_lens=torch.from_numpy(valid), t_live=T)
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_j), atol=ATOL,
                               rtol=0)
    for (h, c), (hj, cj) in zip(new_states, states_j):
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=ATOL,
                                   rtol=0)


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    d, _ = write_jax_export(tmp_path_factory.mktemp("export"), n_layers=3)
    return d


@pytest.fixture(scope="module")
def jax_groups(export_dir):
    return JaxEngine.from_export(export_dir, **KW)


@pytest.fixture(scope="module")
def engine(export_dir):
    return InferenceEngine.from_export(export_dir, device="cpu", **KW)


def _churn_seqs():
    """More docs than the 2*B = 8 pages, a length-1 doc, lengths on and
    around the 8-token page (8, 9, 16, 17, 24), a doc past the 16-token
    dense chunk, an empty doc, and a mid-stream refill (the queue outlasts
    the first finishes)."""
    rng = np.random.RandomState(7)
    lengths = [1, 8, 9, 16, 17, 24, 40, 3, 8, 1, 33, 2, 15, 7, 64, 0, 5, 12]
    return [rng.randint(20, 150, n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("seqs", [_churn_seqs, mixed_seqs],
                         ids=["page-churn", "mixed"])
def test_ragged_scheduler_matches_jax_groups_and_port_slots(
        engine, jax_groups, seqs):
    seqs = seqs()
    got = engine.embed_ids_batch(seqs, scheduler="ragged")
    assert got.shape == (len(seqs), 24) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, jax_groups.embed_ids_batch(seqs, scheduler="groups"),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        got, engine.embed_ids_batch(seqs, scheduler="slots"), atol=ATOL,
        rtol=0)


def test_ragged_geometry_pages_and_gauges(export_dir):
    eng = InferenceEngine.from_export(export_dir, device="cpu", **KW)
    reg = Registry()
    rs = eng.ragged_scheduler(registry=reg)
    assert eng.ragged_scheduler() is rs
    assert (rs.page_len, rs.n_pages) == (8, 8)
    assert rs.chunk_len == 8 and eng.slot_scheduler().chunk_len == 16
    seqs = _churn_seqs()
    eng.embed_ids_batch(seqs, scheduler="ragged")
    # after materialize every retired page is back: the B slots are idle,
    # each parked on its own page, and the rest are free
    assert rs.pages_live() == 0 and rs.pages_free() == rs.n_pages - 4
    assert rs.docs_done == len(seqs)
    text = reg.render()
    assert "slots_pages_free 4.0" in text and "slots_pages_live 0.0" in text
    assert "serve_precision_int8 0.0" in text
    assert "encoder_weight_bytes" in text


def test_ragged_step_passes_host_t_live(export_dir, monkeypatch):
    eng = InferenceEngine.from_export(export_dir, device="cpu", **KW)
    rs = eng.ragged_scheduler()
    seen = []
    forward = eng.encoder.forward

    def spy(tokens, states, valid_lens=None, t_live=None):
        seen.append((int(valid_lens.max()), t_live))
        return forward(tokens, states, valid_lens=valid_lens, t_live=t_live)

    monkeypatch.setattr(eng.encoder, "forward", spy)
    eng.embed_ids_batch(_churn_seqs(), scheduler="ragged")
    # every step got the longest live row's length from the host block,
    # and the scheduler's count is their sum: the launches K2 makes per
    # layer on the card
    assert seen and all(mx == t for mx, t in seen)
    assert rs.recurrence_steps == sum(t for _, t in seen)
    # short docs: each step launches only the longest row's steps
    steps0, rec0 = rs.steps_run, rs.recurrence_steps
    eng.embed_ids_batch([np.arange(20, 20 + n, dtype=np.int32)
                         for n in (1, 3, 5, 2, 1)], scheduler="ragged")
    assert (rs.steps_run - steps0, rs.recurrence_steps - rec0) == (2, 5 + 1)


def test_ragged_failure_heals(export_dir, monkeypatch):
    eng = InferenceEngine.from_export(export_dir, device="cpu", **KW)
    rs = eng.ragged_scheduler()
    seqs = _churn_seqs()
    want = eng.embed_ids_batch(seqs, scheduler="ragged")

    def boom(staged):
        raise RuntimeError("device fault")

    monkeypatch.setattr(rs, "_step", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        eng.embed_ids_batch(seqs, scheduler="ragged")
    monkeypatch.undo()
    assert all(d is None for d in rs._slot_doc) and not rs._queue
    assert rs.pages_free() == rs.n_pages - 4 and not rs._retired
    np.testing.assert_allclose(eng.embed_ids_batch(seqs, scheduler="ragged"),
                               want, atol=ATOL, rtol=0)


def test_ragged_check_twin_is_green():
    result = run_ragged_check(device="cpu")
    assert result["ok"], result
    assert result["parity_max_abs_diff"] <= 1e-5
    assert result["lane_tokens_per_token_ratio"] <= 0.6
    assert (result["chunk_len"], result["page_len"]) == (64, 16)
