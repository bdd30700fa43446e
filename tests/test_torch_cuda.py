"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips without one. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from code_intelligence_tpu_torch.ops import fused_lstm as K1

# f32 kernel vs f32 plain (full-f32 matmul): only the summation order
# differs. bf16: the carry is rounded to bf16 every step, so an order
# difference can move it one bf16 ulp (2^-8 near 1), which later steps
# carry on.
ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(T, B, H, device, dtype, seed=0):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(H)
    arrs = (rng.normal(0, 1, (T, B, 4 * H)), rng.uniform(-s, s, (4 * H, H)),
            rng.normal(0, 0.5, (B, H)), rng.normal(0, 0.5, (B, H)))
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype)
            for a in arrs]


# bf16 K1 and K2 run on the tensor cores: the serve tile at B <= 32 (the
# slot and ragged steps, B=32), the 112-row tile above (B=33: one tile
# with 33 live rows; B=104: the validation window); H=8, 37 and 130 pad
# W_hh's rows to the next multiple of 64
K1_SHAPES = [(7, 5, 40), (3, 33, 130), (1, 1, 8), (2, 17, 1030), (5, 13, 37),
             (64, 32, 2500), (64, 32, 800), (67, 104, 2500), (67, 104, 800)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T,B,H", K1_SHAPES)
def test_k1_matches_plain(cuda_device, dtype, T, B, H):
    args = _inputs(T, B, H, cuda_device, dtype)
    before = K1.launches.count
    out, (h, c) = K1.fused_lstm_forward(*args)
    torch.cuda.synchronize()
    assert K1.launches.count == before + T  # one launch per step
    ref_out, (ref_h, ref_c) = K1.fused_lstm_forward_plain(*args)
    for got, want in ((out, ref_out), (h, ref_h), (c, ref_c)):
        assert got.dtype == dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATOL[dtype], err
    if dtype == torch.bfloat16:  # a caller's pack: the same kernel, bitwise
        pack = K1.pack_w_hh_fwd(args[1], K1.tc_layout(B, H))
        out2, (h2, c2) = K1.fused_lstm_forward(*args, w_pack=pack)
        assert all(torch.equal(a, b) for a, b in
                   ((out2, out), (h2, h), (c2, c)))


@pytest.mark.cuda
def test_k1_zero_steps_and_non_contiguous(cuda_device):
    x, w, h, c = _inputs(0, 2, 8, cuda_device, torch.float32)
    out, (hT, cT) = K1.fused_lstm_forward(x, w, h, c)
    assert out.shape == (0, 2, 8)
    assert torch.equal(hT, h) and torch.equal(cT, c)
    x, w, h, c = _inputs(3, 4, 8, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        K1.fused_lstm_forward(x, w, h.t().contiguous().t(), c)


def _valid(T, B, device):
    """0, 1, mid-step and full, cycling over the rows."""
    return torch.tensor([(0, 1, T // 2, T)[b % 4] for b in range(B)],
                        dtype=torch.int32, device=device)


def _ragged_args(T, B, H, device, dtype, int8):
    from code_intelligence_tpu_torch.ops.quantize import quantize_symmetric

    x, w, h, c = _inputs(T, B, H, device, dtype)
    valid = _valid(T, B, device)
    if not int8:
        return [x, w, h, c, valid]
    q, s = quantize_symmetric(w.float().cpu().numpy(), axis=0)
    return [x, torch.from_numpy(q).to(device), torch.from_numpy(s).to(device),
            h, c, valid]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T,B,H", [(7, 5, 40), (3, 33, 130), (1, 1, 8),
                                   (16, 32, 2500), (16, 32, 800),
                                   (5, 13, 37), (16, 104, 2500),
                                   (16, 104, 800)])
def test_ragged_kernels_match_plain(cuda_device, kernel, dtype, T, B, H):
    int8 = kernel == "K3"
    fn, plain, counter = (
        (K1.fused_lstm_forward_ragged_int8,
         K1.fused_lstm_forward_ragged_int8_plain, K1.ragged_int8_launches)
        if int8 else
        (K1.fused_lstm_forward_ragged, K1.fused_lstm_forward_ragged_plain,
         K1.ragged_launches))
    args = _ragged_args(T, B, H, cuda_device, dtype, int8)
    t_live = int(args[-1].max())
    before = counter.count
    out, (h, c) = fn(*args, t_live=t_live)
    torch.cuda.synchronize()
    assert counter.count == before + t_live  # one launch per live step
    ref_out, (ref_h, ref_c) = plain(*args)
    dead = torch.arange(T, device=cuda_device)[:, None] >= args[-1][None, :]
    assert torch.all(out[dead] == 0)
    for got, want in ((out, ref_out), (h, ref_h), (c, ref_c)):
        assert got.dtype == dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATOL[dtype], err


# bf16 K3 reads its codes a byte at a time (H=37) and in 16-byte chunks
# shifted by rows 4 to 12 bytes (H=2500) or 0 bytes (H=800) past a 16-byte
# boundary, on the serve tile and (B=104) the 112-row one
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T,B,H", [(5, 13, 37), (16, 32, 2500),
                                   (16, 32, 800), (16, 104, 2500)])
def test_k3_extreme_codes_and_a_zero_row_match_plain(cuda_device, dtype, T,
                                                     B, H):
    """Codes of -127 and 127 only, a scale of its own for every row, and
    one W_hh row of zeros with scale 1.0 (the quantizer's zero-row guard):
    the widening of the codes and the per-row scale against the plain
    loop."""
    x, _, h, c = _inputs(T, B, H, cuda_device, dtype)
    rng = np.random.default_rng(1)
    q = np.where(rng.random((4 * H, H)) < 0.5, -127, 127).astype(np.int8)
    scale = (rng.uniform(0.5, 2.0, 4 * H) / (127 * np.sqrt(H))).astype(
        np.float32)
    q[H + H // 2], scale[H + H // 2] = 0, 1.0  # a forget-gate row
    args = [x, torch.from_numpy(q).to(cuda_device),
            torch.from_numpy(scale).to(cuda_device), h, c,
            _valid(T, B, cuda_device)]
    out, (hT, cT) = K1.fused_lstm_forward_ragged_int8(
        *args, t_live=int(args[-1].max()))
    ref_out, (ref_h, ref_c) = K1.fused_lstm_forward_ragged_int8_plain(*args)
    for got, want in ((out, ref_out), (hT, ref_h), (cT, ref_c)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T,B,H", [(16, 32, 2500), (16, 104, 800),
                                   (7, 40, 40)])
def test_k2_dead_tiles_match_plain(cuda_device, dtype, T, B, H):
    """Odd n8 batch tiles (8 rows each) are dead from step 0, and even
    ones after the first die at step T // 2: the bf16 kernel skips the dead
    tiles' MMAs and still zeroes their outputs and carries their state."""
    x, w, h, c = _inputs(T, B, H, cuda_device, dtype)

    def length(b):
        tile, row = divmod(b, 8)
        if tile % 2 or row > 2:
            return 0
        return (1, T // 2, T if tile == 0 else T // 2)[row]

    lens = [length(b) for b in range(B)]
    valid = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = K1.ragged_launches.count
    out, (hT, cT) = K1.fused_lstm_forward_ragged(x, w, h, c, valid,
                                                 t_live=max(lens))
    torch.cuda.synchronize()
    assert K1.ragged_launches.count == before + max(lens)
    ref_out, (ref_h, ref_c) = K1.fused_lstm_forward_ragged_plain(
        x, w, h, c, valid)
    dead = torch.arange(T, device=cuda_device)[:, None] >= valid[None, :]
    assert torch.all(out[dead] == 0)
    never = valid == 0  # rows never live keep h0 and c0 exactly
    assert torch.equal(hT[never], h[never]) and torch.equal(cT[never],
                                                            c[never])
    for got, want in ((out, ref_out), (hT, ref_h), (cT, ref_c)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATOL[dtype], err


@pytest.mark.cuda
def test_ragged_kernel_dead_steps_and_raises(cuda_device):
    x, w, h, c = _inputs(4, 3, 8, cuda_device, torch.float32)
    valid = torch.zeros((3,), dtype=torch.int32, device=cuda_device)
    out, (hT, cT) = K1.fused_lstm_forward_ragged(x, w, h, c, valid, t_live=0)
    assert torch.all(out == 0)
    assert torch.equal(hT, h) and torch.equal(cT, c)
    with pytest.raises(ValueError, match="contiguous"):
        K1.fused_lstm_forward_ragged(x, w, h.t().contiguous().t(), c, valid)
    with pytest.raises(ValueError, match="valid_lens"):
        K1.fused_lstm_forward_ragged(x, w, h, c, valid.cpu())


# A served bf16 embedding against the plain engine's, as a share of the
# plain engine's largest value (chip_smoke.py's EMBED_REL): the carries'
# bf16 rounding differences, through the layers and the pooling, come to
# about one bf16 step (2^-8) of it.
EMBED_REL = 2.0 ** -5


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler,precision,dtype", [
    pytest.param("ragged", "f32", "float32", id="ragged-f32"),
    pytest.param("ragged", "int8", "float32", id="ragged-int8"),
    pytest.param("slots", "int8", "float32", id="slots-int8"),
    pytest.param("groups", "int8", "float32", id="groups-int8"),
    pytest.param("slots", "f32", "bfloat16", id="slots-bf16"),
    pytest.param("ragged", "f32", "bfloat16", id="ragged-bf16")])
def test_engines_match_plain_engine(cuda_device, tmp_path, scheduler,
                                    precision, dtype):
    from code_intelligence_tpu_torch.inference.engine import InferenceEngine
    from code_intelligence_tpu_torch.models import (
        AWDLSTMConfig, random_encoder_arrays)
    from code_intelligence_tpu_torch.text import SPECIALS, Vocab
    from code_intelligence_tpu_torch.training.checkpoint import export_encoder

    cfg = AWDLSTMConfig(vocab_size=200, emb_sz=16, n_hid=40, n_layers=3,
                        dtype=dtype)
    export_encoder(tmp_path, random_encoder_arrays(cfg, seed=1), cfg,
                   Vocab(SPECIALS + [f"w{i}" for i in range(190)]))
    rng = np.random.RandomState(0)
    seqs = [rng.randint(5, 199, n).astype(np.int32)
            for n in (1, 8, 9, 16, 17, 40, 3, 70, 0, 5, 12, 33)]
    kw = {"buckets": (8, 16), "batch_size": 4, "precision": precision,
          "device": "cuda"}
    got = InferenceEngine.from_export(tmp_path, **kw).embed_ids_batch(
        seqs, scheduler=scheduler)
    want = InferenceEngine.from_export(tmp_path, plain=True, **kw) \
        .embed_ids_batch(seqs, scheduler=scheduler)
    atol = 1e-4 if dtype == "float32" else EMBED_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# K5 in bf16: dz is rounded to bf16 every step and feeds the next step's
# product, so the two sides' summation orders can leave a value a few bf16
# ulps apart (2^-7 relative each) at any magnitude: a relative bound too.
K5_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (3e-2, 3e-2)}
# The layer's gradients on the kernels against autograd through the plain
# loop, by relative Frobenius norm: in f32 only the summation order
# differs; in bf16 the plain loop's autograd also rounds its backward to
# bf16 where K5 carries f32, so the two differ by a few bf16 ulps (2^-8).
LAYER_GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}

# then: B and H not multiples of 8, more batch rows than a bf16 block
# takes (112), and the training shapes, where the bf16 kernels run on the
# tensor cores
SHAPES = [(7, 5, 40), (3, 33, 130), (1, 1, 8), (2, 17, 1030), (5, 13, 37),
          (3, 150, 72), (67, 104, 2500), (67, 104, 800)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T,B,H", SHAPES)
def test_k4_matches_plain(cuda_device, dtype, T, B, H):
    args = _inputs(T, B, H, cuda_device, dtype)
    before = K1.gates_launches.count
    out, (gates, c_prev), (h, c) = K1.fused_lstm_forward(*args,
                                                         with_gates=True)
    torch.cuda.synchronize()
    assert K1.gates_launches.count == before + T
    ref = K1.fused_lstm_forward_plain(*args, with_gates=True)
    got = (out, gates, c_prev, h, c)
    want = (ref[0], *ref[1], *ref[2])
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        assert err <= ATOL[dtype], err
    # K1 gives K4's outputs without the residuals: the same kernel in f32.
    # In bf16 K4 sums on the tensor cores in another order, so a step may
    # round h one bf16 ulp apart, and the recurrence carries that on: held
    # to two bf16 ulps (2 * 2^-7 relative) of each tensor's largest value
    out1, (h1, c1) = K1.fused_lstm_forward(*args)
    for a, b in ((out1, out), (h1, h), (c1, c)):
        a, b = a.float(), b.float()
        top = torch.floor(torch.log2(b.abs().max())).item()
        tol = 0.0 if dtype == torch.float32 else 2 * 2.0 ** (top - 7)
        assert (a - b).abs().max().item() <= tol


def _k5_args(T, B, H, device, dtype, seed=0):
    """K4's residuals from the plain version, and seeded cotangents."""
    x, w, h, c = _inputs(T, B, H, device, dtype, seed)
    _, (gates, c_prev), _ = K1.fused_lstm_forward_plain(x, w, h, c,
                                                        with_gates=True)
    rng = np.random.default_rng(seed + 1)
    d_out, dh, dc = (torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32)).to(device) for s in ((T, B, H), (B, H), (B, H)))
    return gates, c_prev, d_out, w, dh, dc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T,B,H", SHAPES)
def test_k5_matches_plain(cuda_device, dtype, T, B, H):
    args = _k5_args(T, B, H, cuda_device, dtype)
    dc_t = args[5].clone()
    before = K1.backward_launches.count
    got = K1.fused_lstm_backward(*args)
    torch.cuda.synchronize()
    assert K1.backward_launches.count == before + T + 1
    assert torch.equal(args[5], dc_t)  # the caller's dc_T is not written
    want = K1.fused_lstm_backward_plain(*args)
    atol, rtol = K5_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                   rtol=rtol)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_layer_grads_on_the_kernels_match_plain_autograd(cuda_device, dtype):
    from code_intelligence_tpu_torch.ops.lstm import lstm_layer

    B, T, n_in, H = 19, 9, 24, 130
    rng = np.random.default_rng(3)
    s = 1 / np.sqrt(H)
    shapes = {"x": (B, T, n_in), "h0": (B, H), "c0": (B, H),
              "w_ih": (4 * H, n_in), "w_hh": (4 * H, H), "bias": (4 * H,)}
    base = {k: torch.from_numpy(rng.uniform(-s, s, v).astype(np.float32))
            .to(cuda_device, dtype) for k, v in shapes.items()}
    cot = [torch.from_numpy(rng.normal(0, 1, v).astype(np.float32))
           .to(cuda_device, dtype) for v in ((B, T, H), (B, H), (B, H))]
    grads = []
    counts = []
    for layer in (K1.lstm_layer_fused, lstm_layer):
        t = {k: v.clone().requires_grad_() for k, v in base.items()}
        before = (K1.gates_launches.count, K1.backward_launches.count)
        out, (h, c) = layer(t["x"], (t["h0"], t["c0"]), t["w_ih"],
                            t["w_hh"], t["bias"])
        torch.autograd.backward((out, h, c), cot)
        torch.cuda.synchronize()
        counts.append((K1.gates_launches.count - before[0],
                       K1.backward_launches.count - before[1]))
        grads.append({k: v.grad for k, v in t.items()})
    assert counts == [(T, T + 1), (0, 0)]
    for k in shapes:
        assert _rel(grads[0][k], grads[1][k]) <= LAYER_GRAD_REL[dtype], k


# K6-K8 compute each element with the same f32 operations as their plain
# versions, in the same order and unfused, so they should agree exactly;
# the bounds allow one f32 ulp of difference, which in bf16 can tip one
# rounding of the stored output (2^-8 relative).
FM_TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (1e-6, 2.0 ** -7)}
# (19, 3, 129) is no whole number of 16-byte vectors: K6/K8's per-lane walk
FM_SHAPES = [(7, 5, 40), (1, 1, 8), (19, 3, 129), (64, 32, 2500),
             (64, 32, 800), (67, 104, 800), (67, 104, 2500)]


def _fm_args(T, B, H, device, dtype, seed=0):
    """z in (-1, 1), f in (0, 1), h0 and a cotangent, time-major."""
    rng = np.random.default_rng(seed)
    arrs = (np.tanh(rng.normal(0, 1, (T, B, H))),
            1 / (1 + np.exp(-rng.normal(0, 1.5, (T, B, H)))),
            rng.normal(0, 0.5, (B, H)), rng.normal(0, 1, (T, B, H)))
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype)
            for a in arrs]


def _assert_fm_close(got, want, dtype):
    atol, rtol = FM_TOL[dtype]
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T,B,H", FM_SHAPES)
def test_k6_k7_match_plain(cuda_device, dtype, T, B, H):
    from code_intelligence_tpu_torch.ops import forget_mult as FM

    z, f, h0, g = _fm_args(T, B, H, cuda_device, dtype)
    before = (FM.forget_mult_launches.count,
              FM.forget_mult_backward_launches.count)
    out = FM.forget_mult_forward(z, f, h0)
    grads = FM.forget_mult_backward(z, f, out, h0, g)
    torch.cuda.synchronize()
    assert (FM.forget_mult_launches.count,
            FM.forget_mult_backward_launches.count) == (before[0] + 1,
                                                        before[1] + 1)
    _assert_fm_close(out, FM.forget_mult_forward_plain(z, f, h0), dtype)
    for a, b in zip(grads, FM.forget_mult_backward_plain(z, f, out, h0, g)):
        _assert_fm_close(a, b, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
# at (16, 8, 129) _valid's lengths make K8's 2-lane chunks straddle two rows
@pytest.mark.parametrize("T,B,H", [(7, 5, 40), (16, 1, 8), (16, 8, 129),
                                   (16, 32, 2500), (16, 32, 800),
                                   (16, 104, 2500)])
def test_k8_matches_plain_and_freezes_the_carry(cuda_device, dtype, T, B, H):
    from code_intelligence_tpu_torch.ops import forget_mult as FM

    z, f, h0, _ = _fm_args(T, B, H, cuda_device, dtype)
    for fill in (None, 0, T):
        valid = (_valid(T, B, cuda_device) if fill is None else
                 torch.full((B,), fill, dtype=torch.int32, device=cuda_device))
        before = FM.forget_mult_ragged_launches.count
        out = FM.forget_mult_ragged(z, f, h0, valid)
        torch.cuda.synchronize()
        assert FM.forget_mult_ragged_launches.count == before + 1
        _assert_fm_close(out, FM.forget_mult_ragged_plain(z, f, h0, valid),
                         dtype)
        for b, v in enumerate(valid.tolist()):
            frozen = out[v - 1, b] if v else h0[b]
            assert torch.equal(out[v:, b], frozen.expand(T - v, H))


@pytest.mark.cuda
def test_forget_mult_wrappers_raise_on_strided_views(cuda_device):
    from code_intelligence_tpu_torch.ops import forget_mult as FM

    z, f, h0, _ = _fm_args(4, 3, 8, cuda_device, torch.float32)
    gates = torch.cat([z, f], dim=-1)
    with pytest.raises(ValueError, match="contiguous"):
        FM.forget_mult_forward(gates[..., :8], gates[..., 8:], h0)
    with pytest.raises(TypeError, match="h0"):
        FM.forget_mult_forward(z, f, h0.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qrnn_layer_grads_on_the_kernels_match_plain_autograd(cuda_device,
                                                              dtype):
    from code_intelligence_tpu_torch.ops import forget_mult as FM
    from code_intelligence_tpu_torch.ops.qrnn import qrnn_layer

    B, T, n_in, H = 19, 9, 24, 130
    rng = np.random.default_rng(4)
    s = 1 / np.sqrt(H)
    shapes = {"x": (B, T, n_in), "h0": (B, H), "x_prev": (B, n_in),
              "w": (3 * H, 2 * n_in), "b": (3 * H,)}
    base = {k: torch.from_numpy(rng.uniform(-1, 1, v).astype(np.float32)
                                * (s if k in "wb" else 1))
            .to(cuda_device, dtype) for k, v in shapes.items()}
    cot = [torch.from_numpy(rng.normal(0, 1, v).astype(np.float32))
           .to(cuda_device, dtype) for v in ((B, T, H), (B, H))]
    grads, counts = [], []
    for plain in (False, True):
        t = {k: v.clone().requires_grad_() for k, v in base.items()}
        before = (FM.forget_mult_launches.count,
                  FM.forget_mult_backward_launches.count)
        out, h_t = qrnn_layer(t["x"], {"w": t["w"], "b": t["b"]},
                              h0=t["h0"], window=2, x_prev=t["x_prev"],
                              plain=plain)
        torch.autograd.backward((out, h_t), cot)
        torch.cuda.synchronize()
        counts.append((FM.forget_mult_launches.count - before[0],
                       FM.forget_mult_backward_launches.count - before[1]))
        grads.append({k: v.grad for k, v in t.items()})
    assert counts == [(1, 1), (0, 0)]
    for k in shapes:
        assert _rel(grads[0][k], grads[1][k]) <= LAYER_GRAD_REL[dtype], k


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler,precision",
                         [("slots", "f32"), ("ragged", "f32"),
                          ("ragged", "int8"), ("groups", "int8")])
def test_qrnn_engines_match_plain_engine(cuda_device, tmp_path, scheduler,
                                         precision):
    from code_intelligence_tpu_torch.inference.engine import InferenceEngine
    from code_intelligence_tpu_torch.models import (
        AWDLSTMConfig, random_encoder_arrays)
    from code_intelligence_tpu_torch.text import SPECIALS, Vocab
    from code_intelligence_tpu_torch.training.checkpoint import export_encoder

    cfg = AWDLSTMConfig(vocab_size=200, emb_sz=16, n_hid=40, n_layers=3,
                        qrnn=True)
    export_encoder(tmp_path, random_encoder_arrays(cfg, seed=1), cfg,
                   Vocab(SPECIALS + [f"w{i}" for i in range(190)]))
    rng = np.random.RandomState(0)
    seqs = [rng.randint(5, 199, n).astype(np.int32)
            for n in (1, 8, 9, 16, 17, 40, 3, 70, 0, 5, 12, 33)]
    kw = {"buckets": (8, 16), "batch_size": 4, "precision": precision,
          "device": "cuda"}
    got = InferenceEngine.from_export(tmp_path, **kw).embed_ids_batch(
        seqs, scheduler=scheduler)
    want = InferenceEngine.from_export(tmp_path, plain=True, **kw) \
        .embed_ids_batch(seqs, scheduler=scheduler)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
