"""K1 (fused LSTM forward): the port's plain version against the JAX
package's Pallas kernel in interpret mode and its XLA scan layer, and the
wrapper's checks. The CUDA kernel itself is held against the plain version
on the card, by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code_intelligence_tpu.ops.lstm import lstm_layer as jax_lstm_layer
from code_intelligence_tpu.ops.pallas_lstm import (
    fused_lstm_forward as jax_fused_lstm_forward)
from code_intelligence_tpu_torch.ops import fused_lstm as K1
from code_intelligence_tpu_torch.ops.lstm import lstm_layer
from torch_port_fixtures import k1_inputs

# f32: the JAX suite's own bar (tests/test_slot_scheduler.py:53)
F32_ATOL = 1e-5
# bf16: h and c are rounded to bf16 after every step, and the two sides sum
# the f32 dot products in different orders, so a carry can land one bf16
# ulp apart (2^-8 near 1) and carry that difference on; 1e-2 is ~2.5 ulps
BF16_ATOL = 1e-2


def _jax_k1(arrs, jdtype):
    out, _, (h, c) = jax_fused_lstm_forward(
        *(jnp.asarray(a, jdtype) for a in arrs), interpret=True)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, h, c)]


def _port_k1(arrs, tdtype):
    out, (h, c) = K1.fused_lstm_forward(
        *(torch.from_numpy(a).to(tdtype) for a in arrs))
    return [x.float().numpy() for x in (out, h, c)]


# T=7 and T=13 are not multiples of the JAX time tile, so the JAX side pads
# and freezes its carry on the tail; the port pads nothing
@pytest.mark.parametrize("T,B,H", [(4, 3, 8), (7, 5, 12), (13, 2, 16)])
def test_plain_matches_jax_pallas_interpret_f32(T, B, H):
    arrs = k1_inputs(T, B, H)
    for got, want in zip(_port_k1(arrs, torch.float32),
                         _jax_k1(arrs, jnp.float32)):
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_plain_matches_jax_pallas_interpret_bf16():
    arrs = k1_inputs(9, 4, 16, seed=1)
    got = _port_k1(arrs, torch.bfloat16)
    want = _jax_k1(arrs, jnp.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=BF16_ATOL, rtol=0)
    # the carry really is bf16: every output sits on the bf16 grid
    out = torch.from_numpy(got[0])
    assert torch.equal(out, out.to(torch.bfloat16).float())


@pytest.mark.parametrize("layer", [lstm_layer, K1.lstm_layer_fused],
                         ids=["plain", "fused"])
def test_layer_matches_jax_scan_layer(layer):
    rng = np.random.default_rng(2)
    B, T, n_in, H = 3, 11, 6, 10
    s = 1.0 / np.sqrt(H)
    x = rng.normal(0, 1, (B, T, n_in)).astype(np.float32)
    w_ih = rng.uniform(-s, s, (4 * H, n_in)).astype(np.float32)
    w_hh = rng.uniform(-s, s, (4 * H, H)).astype(np.float32)
    bias = rng.uniform(-s, s, (4 * H,)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    c0 = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    want_out, (want_h, want_c) = jax_lstm_layer(
        jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)),
        jnp.asarray(w_ih), jnp.asarray(w_hh), jnp.asarray(bias))
    t = torch.from_numpy
    out, (h, c) = layer(t(x), (t(h0), t(c0)), t(w_ih), t(w_hh), t(bias))
    assert out.shape == (B, T, H)
    for g, w in ((out, want_out), (h, want_h), (c, want_c)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_ATOL,
                                   rtol=0)


def test_wrapper_checks_and_cpu_dispatch():
    x, w, h, c = (torch.from_numpy(a) for a in k1_inputs(3, 2, 4))
    with pytest.raises(ValueError, match="x_proj"):
        K1.fused_lstm_forward(x[..., :-1], w, h, c)
    with pytest.raises(ValueError, match="w_hh"):
        K1.fused_lstm_forward(x, w.t(), h, c)
    with pytest.raises(ValueError, match="h0"):
        K1.fused_lstm_forward(x, w, h[:1], c)
    with pytest.raises(TypeError, match="one dtype"):
        K1.fused_lstm_forward(x, w.to(torch.bfloat16), h, c)
    with pytest.raises(TypeError, match="not supported"):
        K1.fused_lstm_forward(*(a.half() for a in (x, w, h, c)))
    # a CPU tensor runs the plain version and never counts a launch
    before = K1.launches.count
    out, (hT, cT) = K1.fused_lstm_forward(x, w, h, c)
    assert K1.launches.count == before
    assert torch.equal(out[-1], hT)
    ref_out, (ref_h, ref_c) = K1.fused_lstm_forward_plain(x, w, h, c)
    assert torch.equal(out, ref_out) and torch.equal(cT, ref_c)


def test_zero_steps_returns_the_carry():
    x, w, h, c = (torch.from_numpy(a) for a in k1_inputs(0, 2, 4))
    out, (hT, cT) = K1.fused_lstm_forward(x, w, h, c)
    assert out.shape == (0, 2, 4)
    assert torch.equal(hT, h) and torch.equal(cT, c)


def test_wrapper_checks_a_callers_w_hh_pack():
    """K1 and K2 take W_hh already packed for the bf16 tensor-core step; a
    pack of another shape or type, or one handed to f32 or K4, is refused.
    On the CPU the plain version runs and the pack changes nothing."""
    x, w, h, c = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in k1_inputs(3, 2, 4))
    pack = K1.pack_w_hh_fwd(w, K1.tc_layout(2, 4))
    valid = torch.tensor([3, 1], dtype=torch.int32)
    got = K1.fused_lstm_forward(x, w, h, c, w_pack=pack)
    want = K1.fused_lstm_forward(x, w, h, c)
    assert all(torch.equal(a, b) for a, b in
               zip((got[0], *got[1]), (want[0], *want[1])))
    got = K1.fused_lstm_forward_ragged(x, w, h, c, valid, w_pack=pack)
    want = K1.fused_lstm_forward_ragged(x, w, h, c, valid)
    assert all(torch.equal(a, b) for a, b in
               zip((got[0], *got[1]), (want[0], *want[1])))
    for bad in (pack[:-1], pack.float(), pack[:, :32]):
        with pytest.raises(ValueError, match="w_pack"):
            K1.fused_lstm_forward(x, w, h, c, w_pack=bad)
        with pytest.raises(ValueError, match="w_pack"):
            K1.fused_lstm_forward_ragged(x, w, h, c, valid, w_pack=bad)
    with pytest.raises(ValueError, match="w_pack"):
        K1.fused_lstm_forward(*(a.float() for a in (x, w, h, c)),
                              w_pack=pack)
    with pytest.raises(ValueError, match="K4"):
        K1.fused_lstm_forward(x, w, h, c, with_gates=True, w_pack=pack)


@pytest.mark.parametrize("H,copy", [(800, 16), (2500, 16), (40, 16),
                                    (130, 16), (37, 1)])
def test_k3_reads_the_int8_codes_in_place(H, copy):
    """bf16 K3's host side: the copy width follows H (the card tests' H
    take both, and rows at every even offset from a 16-byte boundary),
    and its tensor-core operands are the h scratch and the layout's ints,
    with no pack of the codes."""
    assert K1.int8_copy_bytes(H) == copy
    B = 5
    w_q = torch.ones((4 * H, H), dtype=torch.int8)
    h0 = torch.randn((B, H)).to(torch.bfloat16)
    lay = K1.tc_layout(B, H)
    w_pack, h_pad, ints = K1._tc_operands(w_q, h0, lay, None)
    assert w_pack is None
    assert h_pad.shape == (2, B, lay.hp) and lay.hp % K1.TC_K == 0
    assert torch.equal(h_pad[0, :, :H], h0) and not h_pad[0, :, H:].any()
    assert not h_pad[1].any()
    assert ints == [lay.hp, *lay.fwd_grid, lay.batch]
