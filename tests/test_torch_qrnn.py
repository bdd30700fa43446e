"""The port's QRNN slice against the JAX package: the plain versions of K6
(forget-mult forward), K7 (its adjoint) and K8 (ragged forward) against
the JAX scan and the Pallas kernels in interpret mode, ``qrnn_layer``
against the JAX layer on both of its branches, the QRNN encoder on a JAX
export, the port's three schedulers and the int8 engine against the JAX
``groups`` path, one LM window's loss and gradients against JAX
``LMTrainer._loss``, and the training CLI with ``--qrnn``. The CUDA
kernels themselves are held against the plain versions on the card, by
tests/test_torch_cuda.py and chip_smoke.py.

No test here builds a JAX slot or ragged scheduler: those fail at random
in shared sessions (ROADMAP "Reference health")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import code_intelligence_tpu.models.awd_lstm as jax_awd
from code_intelligence_tpu.inference import InferenceEngine as JaxEngine
from code_intelligence_tpu.models import AWDLSTMConfig as JaxConfig
from code_intelligence_tpu.models import AWDLSTMEncoder as JaxEncoder
from code_intelligence_tpu.models import init_lstm_states as jax_init_states
from code_intelligence_tpu.ops import qrnn as jax_qrnn
from code_intelligence_tpu.ops import quantize as jax_quantize
from code_intelligence_tpu.ops.pallas_qrnn import (
    _backward_tm as jax_k7,
    _forward_tm_ragged as jax_k8,
    forget_mult_pallas,
)
from code_intelligence_tpu.parallel import make_mesh
from code_intelligence_tpu.training import LMTrainer as JaxTrainer
from code_intelligence_tpu.training import TrainConfig as JaxTrainConfig
from code_intelligence_tpu.training.checkpoint import (
    export_encoder as jax_export)
from code_intelligence_tpu_torch.data import build_corpus
from code_intelligence_tpu_torch.inference.engine import InferenceEngine
from code_intelligence_tpu_torch.models import (
    AWDLSTMConfig,
    AWDLSTMEncoder,
    AWDLSTMLM,
    draw_dropout_masks,
    init_lstm_states,
    random_encoder_arrays,
)
from code_intelligence_tpu_torch.ops import forget_mult as FM
from code_intelligence_tpu_torch.ops import quantize
from code_intelligence_tpu_torch.ops.qrnn import qrnn_layer
from code_intelligence_tpu_torch.training import LMTrainer, TrainConfig
from code_intelligence_tpu_torch.training import checkpoint as ckpt
from torch_port_fixtures import TINY, mixed_seqs, tiny_vocab

# f32: the JAX suite's own bar (tests/test_slot_scheduler.py:53)
ATOL = 1e-5
# bf16 against Pallas interpret: both carry h in f32 with the same
# expression and round only the stored outputs, so they agree up to one
# bf16 rounding step (2^-8 relative) where an f32 ulp tips a rounding
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # sums over B*T positions, any order
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -9
KW = {"buckets": (8, 16), "batch_size": 4}  # dense chunk 16, page_len 8
t_ = torch.from_numpy


def _gates(T, B, H, seed=0, dtype=np.float32):
    """Time-major z in (-1, 1), f in (0, 1), h0 and a cotangent g."""
    rng = np.random.default_rng(seed)
    z = np.tanh(rng.normal(0, 1, (T, B, H)))
    f = 1 / (1 + np.exp(-rng.normal(0, 1.5, (T, B, H))))
    h0 = rng.normal(0, 0.5, (B, H))
    g = rng.normal(0, 1, (T, B, H))
    return [a.astype(dtype) for a in (z, f, h0, g)]


def _j(*arrays, dtype=None):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
def test_k6_plain_matches_jax_scan_and_pallas(with_h0):
    z, f, h0, _ = _gates(9, 3, 7, seed=1)
    if not with_h0:
        h0 = np.zeros_like(h0)
    got = FM.forget_mult_forward(t_(z), t_(f), t_(h0)).numpy()
    want_pallas = forget_mult_pallas(*_j(z, f), *(_j(h0) if with_h0 else ()),
                                     time_major=True, interpret=True)
    np.testing.assert_allclose(got, want_pallas, atol=ATOL, rtol=0)
    jz, jf = _j(z.swapaxes(0, 1), f.swapaxes(0, 1))
    want_scan = jax_qrnn.forget_mult(jz, jf, *(_j(h0) if with_h0 else ()))
    np.testing.assert_allclose(got, np.asarray(want_scan).swapaxes(0, 1),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
def test_k6_plain_bf16_matches_jax_pallas(with_h0):
    z, f, h0, _ = _gates(12, 4, 9, seed=2)
    if not with_h0:
        h0 = np.zeros_like(h0)
    bf = torch.bfloat16
    got = FM.forget_mult_forward(t_(z).to(bf), t_(f).to(bf), t_(h0).to(bf))
    assert got.dtype == bf
    want = forget_mult_pallas(*_j(z, f, dtype=jnp.bfloat16),
                              *(_j(h0, dtype=jnp.bfloat16) if with_h0
                                else ()),
                              time_major=True, interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_plain_matches_jax_backward_interpret(dtype):
    z, f, h0, g = _gates(8, 3, 6, seed=3)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tz, tf, th0, tg = (t_(a).to(tdt) for a in (z, f, h0, g))
    h = FM.forget_mult_forward(tz, tf, th0)
    got = FM.forget_mult_backward(tz, tf, h, th0, tg)
    want = jax_k7(*_j(z, f, dtype=jdt), jnp.asarray(h.float().numpy(), jdt),
                  *_j(h0, g, dtype=jdt), interpret=True)
    tol = ({"atol": ATOL, "rtol": 0} if dtype == "float32"
           else {"atol": BF16_ATOL, "rtol": BF16_RTOL})
    for a, b in zip(got, want):
        assert a.dtype == tdt and a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)), **tol)


def test_forget_mult_fused_grads_match_jax_grad():
    z, f, h0, g = _gates(10, 3, 5, seed=4)
    tz, tf, th0 = (t_(a).requires_grad_() for a in (z, f, h0))
    out = FM.forget_mult_fused(tz, tf, th0)
    torch.autograd.backward(out, t_(g))

    def loss(z, f, h0):
        h = forget_mult_pallas(z, f, h0, time_major=True, interpret=True)
        return jnp.sum(h * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*_j(z, f, h0))
    for a, b in zip((tz, tf, th0), want):
        np.testing.assert_allclose(a.grad.numpy(), b, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        out.detach().numpy(),
        forget_mult_pallas(*_j(z, f, h0), time_major=True, interpret=True),
        atol=ATOL, rtol=0)


def test_forget_mult_fused_gradcheck_f64():
    z, f, h0, _ = _gates(5, 2, 3, seed=5, dtype=np.float64)
    args = [t_(a).requires_grad_() for a in (z, f, h0)]
    assert torch.autograd.gradcheck(FM.forget_mult_fused, args)


@pytest.mark.parametrize("valid", [[0, 1, 4, 9], [9, 9, 9, 9], [0, 0, 0, 0],
                                   [3, 12, 1, 5]],
                         ids=["zero-one-mid-full", "full", "all-dead",
                              "past-T"])
def test_k8_plain_matches_jax_ragged_interpret(valid):
    z, f, h0, _ = _gates(9, 4, 6, seed=6)
    vl = np.asarray(valid, np.int32)
    got = FM.forget_mult_ragged(t_(z), t_(f), t_(h0), t_(vl)).numpy()
    want = np.asarray(jax_k8(*_j(z, f, h0, vl), interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)  # tail too
    dense = FM.forget_mult_forward(t_(z), t_(f), t_(h0)).numpy()
    for b, v in enumerate(valid):
        n = min(v, 9)
        np.testing.assert_array_equal(got[:n, b], dense[:n, b])
        frozen = dense[n - 1, b] if n else h0[b]
        assert np.all(got[n:, b] == frozen), f"row {b}: tail not the carry"


def test_wrappers_check_their_arguments():
    z, f, h0, g = (t_(a) for a in _gates(4, 2, 3))
    with pytest.raises(ValueError, match="f must be"):
        FM.forget_mult_forward(z, f[:3], h0)
    with pytest.raises(TypeError, match="h0 must be"):
        FM.forget_mult_forward(z, f, h0.double())
    with pytest.raises(ValueError, match="valid_lens"):
        FM.forget_mult_ragged(z, f, h0, torch.tensor([1, 2]))
    # CPU tensors run the plain versions and never count a launch
    counters = (FM.forget_mult_launches, FM.forget_mult_backward_launches,
                FM.forget_mult_ragged_launches)
    before = [c.count for c in counters]
    h = FM.forget_mult_forward(z, f, h0)
    FM.forget_mult_backward(z, f, h, h0, g)
    FM.forget_mult_ragged(z, f, h0, torch.tensor([1, 4], dtype=torch.int32))
    assert [c.count for c in counters] == before


def _layer_params(n_in, H, window, seed):
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(H)
    return {"w": rng.uniform(-s, s, (3 * H, window * n_in)).astype(np.float32),
            "b": rng.uniform(-s, s, (3 * H,)).astype(np.float32)}


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jax-scan", "jax-pallas-interpret"])
@pytest.mark.parametrize("window", [1, 2])
def test_qrnn_layer_matches_jax(window, use_pallas):
    B, T, n_in, H = 3, 7, 5, 6
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (B, T, n_in)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    x_prev = rng.normal(0, 1, (B, n_in)).astype(np.float32)
    params = _layer_params(n_in, H, window, seed=window)
    for carry in (False, True):
        kw = ({"h0": h0, "x_prev": x_prev if window == 2 else None}
              if carry else {})
        want_out, want_h = jax_qrnn.qrnn_layer(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
            window=window, use_pallas=use_pallas,
            **{k: (None if v is None else jnp.asarray(v))
               for k, v in kw.items()})
        for plain in (False, True):
            out, h_t = qrnn_layer(
                t_(x), {k: t_(v) for k, v in params.items()}, window=window,
                plain=plain, **{k: (None if v is None else t_(v))
                                for k, v in kw.items()})
            np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL,
                                       rtol=0)
            np.testing.assert_allclose(h_t.numpy(), want_h, atol=ATOL,
                                       rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jax-scan", "jax-pallas-interpret"])
def test_qrnn_layer_valid_lens_match_jax(use_pallas):
    """K8's layer: the valid prefix against both JAX branches (the scan
    ignores valid_lens), the whole output and h_T against the Pallas one."""
    B, T, n_in, H = 4, 8, 5, 6
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (B, T, n_in)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    x_prev = rng.normal(0, 1, (B, n_in)).astype(np.float32)
    params = _layer_params(n_in, H, 2, seed=9)
    valid = np.array([0, 1, 5, T], np.int32)
    want_out, want_h = jax_qrnn.qrnn_layer(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        h0=jnp.asarray(h0), window=2, x_prev=jnp.asarray(x_prev),
        use_pallas=use_pallas, valid_lens=jnp.asarray(valid))
    out, h_t = qrnn_layer(t_(x), {k: t_(v) for k, v in params.items()},
                          h0=t_(h0), window=2, x_prev=t_(x_prev),
                          valid_lens=t_(valid))
    want_out = np.asarray(want_out)
    for b, v in enumerate(valid):
        np.testing.assert_allclose(out[b, :v].numpy(), want_out[b, :v],
                                   atol=ATOL, rtol=0)
    if use_pallas:
        np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL, rtol=0)
        np.testing.assert_allclose(h_t.numpy(), want_h, atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", [0, 3])
def test_qrnn_layer_rejects_a_window_other_than_1_or_2(window):
    x = np.zeros((2, 3, 4), np.float32)
    params = _layer_params(4, 5, 1, seed=11)
    with pytest.raises(ValueError, match="window"):
        qrnn_layer(t_(x), {k: t_(v) for k, v in params.items()},
                   window=window)


def _qrnn_arrays(n_layers, seed=0):
    """Flat f32 QRNN encoder arrays for TINY widths, nonzero biases."""
    cfg = AWDLSTMConfig(n_layers=n_layers, qrnn=True, **TINY)
    rng = np.random.default_rng(seed)
    out = {"embedding": rng.uniform(-0.1, 0.1, (cfg.vocab_size, cfg.emb_sz))}
    for li in range(n_layers):
        H, n_in = cfg.layer_size(li), cfg.layer_in_dim(li)
        s = 1 / np.sqrt(H)
        out[f"qrnn_{li}_w"] = rng.uniform(
            -s, s, (3 * H, cfg.qrnn_window(li) * n_in))
        out[f"qrnn_{li}_b"] = rng.uniform(-s, s, (3 * H,))
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def qrnn_export(tmp_path_factory):
    """A tiny QRNN export written by the JAX package: (dir, arrays)."""
    d = tmp_path_factory.mktemp("qrnn_export")
    arrays = _qrnn_arrays(3)
    jax_export(d, {k: jnp.asarray(v) for k, v in arrays.items()},
               JaxConfig(n_layers=3, qrnn=True, **TINY), tiny_vocab())
    return d, arrays


def _port_encoder(model_dir):
    params, cfg, _ = ckpt.load_encoder(model_dir)
    enc = AWDLSTMEncoder(cfg)
    enc.load_state_dict(ckpt.params_from_numpy(params))
    return enc, cfg


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jax-scan", "jax-pallas-interpret"])
def test_encoder_on_jax_export_matches_and_carries_state(qrnn_export,
                                                         use_pallas):
    """Two chunks with the (h, x_prev) carry against ``encoder.apply`` on
    the same chunks, and against one pass over both."""
    model_dir, arrays = qrnn_export
    enc, cfg = _port_encoder(model_dir)
    assert cfg.qrnn and enc.qrnn_0_w.shape == (3 * 12, 2 * 8)
    jcfg = JaxConfig(n_layers=3, qrnn=True, qrnn_use_pallas=use_pallas,
                     **TINY)
    jparams = {"params": {k: jnp.asarray(v) for k, v in arrays.items()}}
    B, T = 3, 12
    tokens = np.random.default_rng(12).integers(0, 200, (B, T), np.int32)
    jstates = jax_init_states(jcfg, B)
    states = init_lstm_states(cfg, B)
    assert [s[1].shape for s in states] == [(B, 8), (B, 12), (B, 12)]
    raws = []
    with torch.inference_mode():
        for chunk in (tokens[:, :5], tokens[:, 5:]):
            raw_j, _, jstates = JaxEncoder(jcfg).apply(
                jparams, jnp.asarray(chunk), jstates, deterministic=True)
            raw, states = enc(t_(chunk), states)
            np.testing.assert_allclose(raw.numpy(), raw_j, atol=ATOL, rtol=0)
            for (h, xp), (hj, xpj) in zip(states, jstates):
                np.testing.assert_allclose(h.numpy(), hj, atol=ATOL, rtol=0)
                np.testing.assert_allclose(xp.numpy(), xpj, atol=ATOL,
                                           rtol=0)
            raws.append(raw)
        whole, _ = enc(t_(tokens), init_lstm_states(cfg, B))
    np.testing.assert_allclose(torch.cat(raws, 1).numpy(), whole.numpy(),
                               atol=ATOL, rtol=0)


def test_config_and_random_arrays_for_qrnn():
    cfg = AWDLSTMConfig(n_layers=2, qrnn=True, qrnn_use_pallas=True, **TINY)
    arrays = random_encoder_arrays(cfg, seed=1)
    assert sorted(arrays) == ["embedding", "qrnn_0_b", "qrnn_0_w", "qrnn_1_b",
                              "qrnn_1_w"]
    assert arrays["qrnn_0_w"].shape == (36, 16)
    assert arrays["qrnn_1_w"].shape == (24, 12)
    assert not arrays["qrnn_1_b"].any()
    assert np.abs(arrays["qrnn_1_w"]).max() <= 1 / np.sqrt(8)
    masks = draw_dropout_masks(cfg, 3, torch.Generator().manual_seed(0))
    assert masks["weight_0"].shape == (36, 16)
    assert masks["weight_1"].shape == (24, 12)
    enc = AWDLSTMEncoder(cfg)
    enc.load_state_dict(ckpt.params_from_numpy(arrays))  # keys agree


@pytest.fixture(scope="module")
def jax_groups(qrnn_export):
    return JaxEngine.from_export(qrnn_export[0], **KW)


@pytest.mark.parametrize("scheduler", ["groups", "slots", "ragged"])
def test_schedulers_match_jax_groups(qrnn_export, jax_groups, scheduler):
    seqs = mixed_seqs()
    want = jax_groups.embed_ids_batch(seqs, scheduler="groups")
    engine = InferenceEngine.from_export(qrnn_export[0], device="cpu", **KW)
    got = engine.embed_ids_batch(seqs, scheduler=scheduler)
    assert got.shape == (len(seqs), 24) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_quantizer_bitwise_equals_jax_for_qrnn(qrnn_export):
    arrays = dict(qrnn_export[1])
    arrays["qrnn_1_w"] = arrays["qrnn_1_w"].copy()
    arrays["qrnn_1_w"][5] = 0.0  # an all-zero channel
    got = quantize.quantize_encoder_params(
        arrays, AWDLSTMConfig(n_layers=3, qrnn=True, **TINY))
    want = jax_quantize.quantize_encoder_params(
        arrays, JaxConfig(n_layers=3, qrnn=True, **TINY))
    assert got.keys() == want.keys()
    assert "qrnn_2_w_scale" in got and "qrnn_2_b_scale" not in got
    for k in got:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].view(np.uint8), w.view(np.uint8),
                                      err_msg=k)


@pytest.fixture(scope="module")
def jax_int8_groups(qrnn_export):
    return JaxEngine.from_export(qrnn_export[0], precision="int8", **KW)


@pytest.mark.parametrize("scheduler", ["groups", "slots", "ragged"])
def test_int8_engine_matches_jax_int8_groups(qrnn_export, jax_int8_groups,
                                             scheduler):
    seqs = mixed_seqs()
    want = jax_int8_groups.embed_ids_batch(seqs, scheduler="groups")
    engine = InferenceEngine.from_export(qrnn_export[0], device="cpu",
                                         precision="int8", **KW)
    assert engine.encoder.qrnn_0_w.dtype == torch.int8
    got = engine.embed_ids_batch(seqs, scheduler=scheduler)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


SIZES = dict(vocab_size=40, emb_sz=8, n_hid=12, n_layers=3)
B, T = 3, 6
NO_DROPOUT = dict(output_p=0.0, hidden_p=0.0, input_p=0.0, embed_p=0.0,
                  weight_p=0.0)
# embed_p raised from the reference's 0.02 so that 40 rows drop some
DROPOUT = dict(output_p=0.1, hidden_p=0.15, input_p=0.25, embed_p=0.2,
               weight_p=0.2)


def _masks(cfg, seed=2):
    """Boolean keep masks for every dropout site, from numpy."""
    rng = np.random.default_rng(seed)

    def keep(p, *shape):
        return rng.random(shape) < 1 - p

    masks = {"embed": keep(cfg.embed_p, cfg.vocab_size, 1),
             "input": keep(cfg.input_p, B, 1, cfg.emb_sz),
             "output": keep(cfg.output_p, B, 1, cfg.emb_sz)}
    for li in range(cfg.n_layers):
        H = cfg.layer_size(li)
        masks[f"weight_{li}"] = keep(
            cfg.weight_p, 3 * H, cfg.qrnn_window(li) * cfg.layer_in_dim(li))
        if li < cfg.n_layers - 1:
            masks[f"hidden_{li}"] = keep(cfg.hidden_p, B, 1, H)
    return masks


def _inject_jax_masks(monkeypatch, masks, n):
    """Serve the masks to the JAX model in call order: its bernoulli draws
    (embedding rows, then each QRNN layer's weight drop) and its locked
    masks (input, each hidden, output)."""
    bern = [masks["embed"]] + [masks[f"weight_{li}"] for li in range(n)]
    locked = ([masks["input"]] + [masks[f"hidden_{li}"]
                                  for li in range(n - 1)] + [masks["output"]])

    def fake_bernoulli(key, p, shape):
        keep = bern.pop(0)
        assert keep.shape == tuple(shape)
        return jnp.asarray(keep)

    def fake_locked(rng, p, shape, dtype):
        keep = locked.pop(0)
        assert keep.shape == tuple(shape)
        return jnp.asarray(keep).astype(dtype) / (1.0 - p)

    monkeypatch.setattr(jax_awd, "_locked_dropout_mask", fake_locked)
    monkeypatch.setattr(jax.random, "bernoulli", fake_bernoulli)
    return bern, locked


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jax-scan", "jax-pallas-interpret"])
@pytest.mark.parametrize("rates", [NO_DROPOUT, DROPOUT],
                         ids=["dropout0", "injected_masks"])
def test_window_loss_and_grads_match_jax(monkeypatch, rates, use_pallas):
    cfg = AWDLSTMConfig(**SIZES, **rates, qrnn=True)
    jtrainer = JaxTrainer(
        JaxConfig(**SIZES, **rates, qrnn=True, qrnn_use_pallas=use_pallas),
        JaxTrainConfig(batch_size=B, bptt=T),
        mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))
    rng = np.random.default_rng(0)
    arrays = random_encoder_arrays(cfg, seed=1)
    for li in range(cfg.n_layers):  # nonzero biases
        arrays[f"qrnn_{li}_b"] = rng.uniform(-0.3, 0.3, (3 * cfg.layer_size(
            li),)).astype(np.float32)
    params = {"encoder": arrays,
              "decoder_b": rng.normal(0, 0.1, (40,)).astype(np.float32)}
    toks = rng.integers(0, 40, (B, T + 1)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    states = [(rng.normal(0, 0.3, (B, cfg.layer_size(li))),
               rng.normal(0, 0.3, (B, cfg.layer_in_dim(li))))
              for li in range(cfg.n_layers)]
    states = [tuple(a.astype(np.float32) for a in s) for s in states]
    masks = _masks(cfg) if rates is DROPOUT else {}
    if masks:
        queues = _inject_jax_masks(monkeypatch, masks, cfg.n_layers)
    (want_loss, (want_states, want_ce, _)), want_grads = \
        jax.value_and_grad(jtrainer._loss, has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x),
            jnp.asarray(y), jax.tree.map(jnp.asarray, tuple(states)),
            jax.random.PRNGKey(1))
    if masks:
        assert queues == ([], [])  # every injected mask was used

    model = AWDLSTMLM(cfg)
    model.load_state_dict(ckpt.lm_params_from_jax(params))
    loss, (new_states, ce, _) = LMTrainer(
        cfg, TrainConfig(batch_size=B, bptt=T), device="cpu").loss(
        model, t_(x).long(), t_(y).long(),
        tuple((t_(h), t_(xp)) for h, xp in states),
        {k: t_(v) for k, v in masks.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    np.testing.assert_allclose(ce.item(), float(want_ce), atol=ATOL)
    for got, want in zip(new_states, want_states):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), b, atol=ATOL,
                                       rtol=0)
    want = ckpt.lm_params_from_jax(jax.device_get(want_grads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_cli_trains_qrnn_on_cpu_and_the_export_serves(tmp_path):
    from code_intelligence_tpu_torch.training.cli import main

    rng = np.random.default_rng(0)
    words = "pipeline notebook katib tfjob pod crash error timeout".split()
    build_corpus([" ".join(rng.choice(words, rng.integers(3, 30)))
                  for _ in range(300)], tmp_path / "corpus", min_freq=1)
    args = ["--corpus_dir", str(tmp_path / "corpus"), "--device", "cpu",
            "--bs", "4", "--bptt", "8", "--emb_sz", "8", "--n_hid", "12",
            "--n_layers", "2", "--steps_per_dispatch", "3", "--lr", "1e-2"]
    summary = main(args + ["--model_dir", str(tmp_path / "run"), "--qrnn"])
    assert np.isfinite(summary["loss"]) and np.isfinite(summary["val_loss"])
    export = tmp_path / "run" / "encoder_export"
    params, cfg, _ = ckpt.load_encoder(export)
    assert cfg.qrnn and "qrnn_1_w" in params and "lstm_0_w_ih" not in params
    issues = [{"title": "Katib trial crash", "body": "pod error " * 12}]
    got = InferenceEngine.from_export(export, device="cpu", **KW) \
        .embed_issues(issues)
    assert got.shape == (1, 24) and np.isfinite(got).all()
    # the JAX engine serves the port's QRNN export alike
    np.testing.assert_allclose(
        got, JaxEngine.from_export(export, **KW).embed_issues(issues),
        atol=ATOL, rtol=0)
    # --qrnn_pallas implies --qrnn, as in the JAX CLI
    main(args + ["--model_dir", str(tmp_path / "run2"), "--qrnn_pallas"])
    _, cfg2, _ = ckpt.load_encoder(tmp_path / "run2" / "encoder_export")
    assert cfg2.qrnn and cfg2.qrnn_use_pallas
