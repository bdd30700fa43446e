"""Port encoder, config and export loader against the JAX package."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code_intelligence_tpu.inference import InferenceEngine as JaxEngine
from code_intelligence_tpu.models import AWDLSTMConfig as JaxConfig
from code_intelligence_tpu.models import AWDLSTMEncoder as JaxEncoder
from code_intelligence_tpu.models import init_lstm_states as jax_init_states
from code_intelligence_tpu.training.checkpoint import (
    load_encoder as jax_load_encoder)
from code_intelligence_tpu_torch.models import (
    AWDLSTMConfig,
    AWDLSTMEncoder,
    init_lstm_states,
    random_encoder_arrays,
)
from code_intelligence_tpu_torch.inference.engine import InferenceEngine
from code_intelligence_tpu_torch.models import awd_lstm
from code_intelligence_tpu_torch.ops.fused_lstm import tc_layout
from code_intelligence_tpu_torch.text import Vocab
from code_intelligence_tpu_torch.training.checkpoint import (
    export_encoder,
    load_encoder,
    params_from_numpy,
)
from torch_port_fixtures import TINY, write_jax_export

F32_ATOL = 1e-5  # the JAX suite's own bar (tests/test_slot_scheduler.py:53)


def _port_encoder(model_dir, **kw):
    params, cfg, _ = load_encoder(model_dir)
    enc = AWDLSTMEncoder(cfg, **kw)
    enc.load_state_dict(params_from_numpy(params))
    return enc, cfg


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jax-scan", "jax-pallas-interpret"])
def test_encoder_raw_and_states_match_jax(tmp_path, use_pallas):
    model_dir, arrays = write_jax_export(tmp_path, n_layers=3)
    enc, cfg = _port_encoder(model_dir)
    jcfg = JaxConfig(n_layers=3, lstm_use_pallas=use_pallas, **TINY)
    B, T = 3, 10
    tokens = np.random.default_rng(4).integers(0, 200, (B, T), np.int32)
    raw_j, _, states_j = JaxEncoder(jcfg).apply(
        {"params": {k: jnp.asarray(v) for k, v in arrays.items()}},
        jnp.asarray(tokens), jax_init_states(jcfg, B), deterministic=True)
    with torch.inference_mode():
        raw, states = enc(torch.from_numpy(tokens), init_lstm_states(cfg, B))
    assert raw.shape == (B, T, cfg.emb_sz)
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_j), atol=F32_ATOL,
                               rtol=0)
    assert len(states) == cfg.n_layers
    for (h, c), (hj, cj) in zip(states, states_j):
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=F32_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=F32_ATOL,
                                   rtol=0)


def test_plain_and_fused_encoders_agree_on_cpu(tmp_path):
    model_dir, _ = write_jax_export(tmp_path, n_layers=2)
    fused, cfg = _port_encoder(model_dir)
    plain, _ = _port_encoder(model_dir, plain=True)
    tokens = torch.randint(0, 200, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        a, _ = fused(tokens, init_lstm_states(cfg, 2))
        b, _ = plain(tokens, init_lstm_states(cfg, 2))
    assert torch.equal(a, b)


def test_bf16_export_loads_in_compute_dtype(tmp_path):
    model_dir, arrays = write_jax_export(tmp_path, n_layers=2,
                                         dtype=jnp.bfloat16)
    enc, cfg = _port_encoder(model_dir)
    assert cfg.dtype == "bfloat16"
    assert enc.lstm_0_w_hh.dtype == torch.bfloat16
    want = torch.from_numpy(arrays["lstm_0_w_hh"]).to(torch.bfloat16)
    assert torch.equal(enc.lstm_0_w_hh, want)


def test_config_reads_every_jax_key(tmp_path):
    write_jax_export(tmp_path, n_layers=2)
    raw = json.loads((tmp_path / "model_config.json").read_text())
    cfg = AWDLSTMConfig(**raw)
    assert set(raw) == {f.name for f in dataclasses.fields(cfg)}
    assert [cfg.layer_size(i) for i in range(2)] == [12, 8]
    # QRNN is ported: the flag loads, with its window-2 first layer
    qcfg = AWDLSTMConfig(**{**raw, "qrnn": True})
    assert qcfg.qrnn and [qcfg.qrnn_window(i) for i in range(2)] == [2, 1]
    # int8 is the engine's serve precision now; an unknown one raises
    assert AWDLSTMConfig(**{**raw, "precision": "int8"}).precision == "int8"
    with pytest.raises(ValueError, match="precision"):
        AWDLSTMConfig(**{**raw, "precision": "int4"})
    with pytest.raises(ValueError, match="float16"):
        AWDLSTMConfig(**{**raw, "dtype": "float16"})
    # lstm_use_pallas is accepted and ignored
    assert AWDLSTMConfig(**{**raw, "lstm_use_pallas": True}).n_layers == 2


def test_params_from_numpy_accepts_nested_trees(tmp_path):
    _, arrays = write_jax_export(tmp_path, n_layers=2)
    flat = params_from_numpy(arrays)
    for tree in ({"encoder": arrays}, {"params": {"encoder": arrays}},
                 {"params": arrays}):
        nested = params_from_numpy(tree)
        assert nested.keys() == flat.keys()
    with pytest.raises(ValueError):
        params_from_numpy({"decoder_b": arrays["lstm_0_bias"]})


def test_port_written_export_loads_in_jax(tmp_path):
    cfg = AWDLSTMConfig(n_layers=2, **TINY)
    arrays = random_encoder_arrays(cfg, seed=3)
    vocab = Vocab(["xxunk", "xxpad", "xxbos"] + [f"w{i}" for i in range(197)])
    export_encoder(tmp_path, arrays, cfg, vocab)
    params, jcfg, _ = jax_load_encoder(tmp_path)
    assert jcfg.n_layers == 2 and jcfg.emb_sz == TINY["emb_sz"]
    np.testing.assert_array_equal(np.asarray(params["lstm_1_w_hh"]),
                                  arrays["lstm_1_w_hh"])
    issues = [{"title": "w1 w2", "body": "w3 " * 30}]
    want = JaxEngine.from_export(tmp_path, buckets=(8, 16),
                                 batch_size=2).embed_issues(issues)
    got = InferenceEngine.from_export(tmp_path, buckets=(8, 16), batch_size=2,
                                      device="cpu").embed_issues(issues)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_frozen_bf16_encoder_packs_w_hh_once_per_weight_version(monkeypatch):
    """A frozen bf16 encoder packs each layer's W_hh for the tensor-core
    K1/K2 on first use, reuses it across forwards (dense and ragged), and
    packs anew after load_state_dict and after an in-place update."""
    cfg = AWDLSTMConfig(n_layers=2, dtype="bfloat16", **TINY)
    enc = AWDLSTMEncoder(cfg)
    enc.load_state_dict(params_from_numpy(random_encoder_arrays(cfg, 0)))
    built = []
    pack = awd_lstm.pack_w_hh_fwd
    monkeypatch.setattr(awd_lstm, "pack_w_hh_fwd",
                        lambda w, lay: built.append(w) or pack(w, lay))
    B, T = 3, 6
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, 200, (B, T), np.int32))
    valid = torch.tensor([6, 2, 0], dtype=torch.int32)

    def run():
        with torch.inference_mode():
            enc(tokens, init_lstm_states(cfg, B))
            enc(tokens, init_lstm_states(cfg, B), valid_lens=valid, t_live=6)

    def held(li):
        w = getattr(enc, f"lstm_{li}_w_hh")
        want = pack(w.detach(), tc_layout(B, w.shape[1]))
        got = enc.w_hh_pack(li, B)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        return got

    run()
    run()
    assert len(built) == cfg.n_layers  # once a layer, not once a call
    first = [held(li) for li in range(cfg.n_layers)]
    assert enc.held_bytes() == sum(  # the packs count as held
        t.numel() * t.element_size() for t in [*enc.parameters(), *first])
    enc.load_state_dict(params_from_numpy(random_encoder_arrays(cfg, 1)))
    run()
    assert len(built) == 2 * cfg.n_layers
    second = [held(li) for li in range(cfg.n_layers)]
    assert not any(torch.equal(a, b) for a, b in zip(first, second))
    with torch.no_grad():
        enc.lstm_1_w_hh.mul_(0.5)
    run()
    assert len(built) == 2 * cfg.n_layers + 1  # layer 1 only
    assert held(0) is second[0] and not torch.equal(held(1), second[1])


def test_encoder_keeps_no_pack_where_no_kernel_takes_one():
    """f32 weights, a trainable encoder, the plain path and int8 take no
    pack: K1/K2 in f32 run the CUDA-core kernels, training packs per call,
    K3 reads its codes in place. Such an encoder holds its weights only."""
    bf16 = AWDLSTMConfig(n_layers=2, dtype="bfloat16", **TINY)
    int8 = dataclasses.replace(bf16, precision="int8")
    for cfg, kw in ((AWDLSTMConfig(n_layers=2, **TINY), {}),
                    (bf16, {"trainable": True}), (bf16, {"plain": True}),
                    (int8, {})):
        enc = AWDLSTMEncoder(cfg, **kw)
        assert all(enc.w_hh_pack(li, 4) is None
                   for li in range(cfg.n_layers))
        assert enc.held_bytes() == sum(t.numel() * t.element_size()
                                       for t in enc.parameters())
