"""K4 (fused LSTM forward with the training residuals) and K5 (its adjoint):
the port's plain versions against the JAX package's Pallas kernels in
interpret mode, and the port's ``lstm_layer_fused`` autograd against
``jax.grad`` through the JAX ``lstm_layer_fused`` custom_vjp. The CUDA
kernels themselves are held against the plain versions on the card, by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code_intelligence_tpu.ops.pallas_lstm import (
    fused_lstm_backward as jax_fused_lstm_backward,
    fused_lstm_forward as jax_fused_lstm_forward,
    lstm_layer_fused as jax_lstm_layer_fused,
)
from code_intelligence_tpu_torch.ops import fused_lstm as K
from code_intelligence_tpu_torch.ops.lstm import lstm_layer
from torch_port_fixtures import k1_inputs

# f32 on states, gates, dz, dh0 and dc0: the JAX suite's own bar
F32_ATOL = 1e-5
# weight and bias grads are sums over T*B terms of magnitude up to ~1,
# taken in another order on each side
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4
# bf16: every stored value is rounded to bf16, and the two sides sum the
# f32 products in different orders, so one value can land one bf16 ulp
# apart (2^-8 near 1) and carry that on; 1e-2 is ~2.5 ulps
BF16_ATOL = 1e-2

DTYPES = {"f32": (jnp.float32, torch.float32, F32_ATOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_ATOL)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got, want, atol, rtol=0.0):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=atol, rtol=rtol)


# T=7 and T=13 are not multiples of the JAX time tile, so the JAX side pads
# and freezes its carry on the tail; the port pads nothing
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T,B,H", [(4, 3, 8), (7, 5, 12), (13, 2, 16)])
def test_k4_plain_matches_jax_pallas_interpret(dtype, T, B, H):
    jdt, tdt, atol = DTYPES[dtype]
    arrs = k1_inputs(T, B, H, seed=T)
    want_out, (want_g, want_c), (want_h, want_cT) = jax_fused_lstm_forward(
        *(jnp.asarray(a, jdt) for a in arrs), with_gates=True, interpret=True)
    out, (gates, c_prev), (h, c) = K.fused_lstm_forward(
        *(torch.from_numpy(a).to(tdt) for a in arrs), with_gates=True)
    assert gates.shape == (T, B, 4 * H) and c_prev.shape == (T, B, H)
    assert gates.dtype == c_prev.dtype == tdt
    _assert_close((out, gates, c_prev, h, c),
                  (want_out, want_g, want_c, want_h, want_cT), atol)
    # c_prev[t] is the carry each step read: c0, then c after each step
    assert torch.equal(c_prev[0], torch.from_numpy(arrs[3]).to(tdt))
    # K1's outputs are K4's, without the residuals
    out1, (h1, c1) = K.fused_lstm_forward(
        *(torch.from_numpy(a).to(tdt) for a in arrs))
    assert torch.equal(out1, out) and torch.equal(h1, h)
    assert torch.equal(c1, c)


def _k5_inputs(T, B, H, jdt, tdt, seed):
    """K4's residuals from the JAX kernel, plus seeded cotangents."""
    x, w, h0, c0 = k1_inputs(T, B, H, seed=seed)
    _, (gates, c_prev), _ = jax_fused_lstm_forward(
        *(jnp.asarray(a, jdt) for a in (x, w, h0, c0)), with_gates=True,
        interpret=True)
    rng = np.random.default_rng(seed + 100)
    d_out = rng.normal(0, 1, (T, B, H)).astype(np.float32)
    dh_t, dc_t = (rng.normal(0, 1, (B, H)).astype(np.float32)
                  for _ in range(2))
    jax_args = (gates, c_prev, jnp.asarray(d_out), jnp.asarray(w, jdt),
                jnp.asarray(dh_t), jnp.asarray(dc_t))
    port_args = (torch.from_numpy(_np(gates)).to(tdt),
                 torch.from_numpy(_np(c_prev)).to(tdt),
                 torch.from_numpy(d_out), torch.from_numpy(w).to(tdt),
                 torch.from_numpy(dh_t), torch.from_numpy(dc_t))
    return jax_args, port_args


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T,B,H", [(5, 3, 8), (7, 5, 12)])
def test_k5_plain_matches_jax_pallas_interpret(dtype, T, B, H):
    jdt, tdt, atol = DTYPES[dtype]
    jax_args, port_args = _k5_inputs(T, B, H, jdt, tdt, seed=T)
    want = jax_fused_lstm_backward(*jax_args, interpret=True)
    before = K.backward_launches.count
    got = K.fused_lstm_backward(*port_args)
    assert K.backward_launches.count == before  # a CPU tensor: plain
    assert got[0].shape == (T, B, 4 * H)
    assert all(g.dtype == tdt for g in got)
    _assert_close(got, want, atol)


def test_k5_zero_steps_rounds_the_cotangents():
    _, port_args = _k5_inputs(2, 3, 4, jnp.bfloat16, torch.bfloat16, seed=0)
    gates, c_prev, d_out = (a[:0] for a in port_args[:3])
    dz, dh0, dc0 = K.fused_lstm_backward(gates, c_prev, d_out,
                                         *port_args[3:])
    assert dz.shape == (0, 3, 16)
    assert torch.equal(dh0, port_args[4].to(torch.bfloat16))
    assert torch.equal(dc0, port_args[5].to(torch.bfloat16))


def test_k5_wrapper_checks():
    _, (g, c, d, w, dh, dc) = _k5_inputs(3, 2, 4, jnp.float32,
                                         torch.float32, seed=1)
    with pytest.raises(ValueError, match="gates"):
        K.fused_lstm_backward(g[..., :-1], c, d, w, dh, dc)
    with pytest.raises(ValueError, match="d_out"):
        K.fused_lstm_backward(g, c, d[:1], w, dh, dc)
    with pytest.raises(ValueError, match="w_hh"):
        K.fused_lstm_backward(g, c, d, w.t(), dh, dc)
    with pytest.raises(TypeError, match="one dtype"):
        K.fused_lstm_backward(g, c, d, w.to(torch.bfloat16), dh, dc)
    with pytest.raises(TypeError, match="not supported"):
        K.fused_lstm_backward(*(a.half() for a in (g, c, d, w, dh, dc)))


# the bf16 tensor-core kernels on the card read W_hh packed by these
# helpers; their blocks: the forward step 20 hidden units (80 W_hh rows) x
# 112 batch rows (K4 always; K1 and K2 above 32 rows) or the serve tile
# (TC_SERVE_ROWS x 32 rows, K1 and K2 at B <= 32), K5 96 units x 4 gate
# slabs, so at H=2500 the grids fit the H100's 132 SMs, a block each
@pytest.mark.parametrize("B,H,gates,fwd_grid,bwd_grid", [
    pytest.param(104, 40, False, (2, 1), (4, 1, 1),
                 id="40-fwd_grid0-bwd_grid0"),
    pytest.param(104, 800, False, (40, 1), (4, 9, 1),
                 id="800-fwd_grid1-bwd_grid1"),
    pytest.param(104, 2500, False, (125, 1), (4, 27, 1),
                 id="2500-fwd_grid2-bwd_grid2"),
    pytest.param(32, 2500, False, (125, 1), (4, 27, 1), id="serve-B32-H2500"),
    pytest.param(32, 800, False, (40, 1), (4, 9, 1), id="serve-B32-H800"),
    pytest.param(5, 37, False, (2, 1), (4, 1, 1), id="serve-B5-H37"),
    pytest.param(33, 800, False, (40, 1), (4, 9, 1), id="B33-H800"),
    pytest.param(8, 2500, True, (125, 1), (4, 27, 1), id="k4-B8-H2500")])
def test_tensor_core_layout_packs_w_hh(B, H, gates, fwd_grid, bwd_grid):
    lay = K.tc_layout(B, H, gates=gates)
    assert lay.hp % 64 == 0 and H <= lay.hp < H + 64
    # K5's clusters are the 4 gate slabs, along the grid's x
    assert (lay.fwd_grid, lay.bwd_grid) == (fwd_grid, bwd_grid)
    serve = B <= K.TC_SERVE_BATCH and not gates
    assert (lay.rows, lay.batch) == ((K.TC_SERVE_ROWS, 32) if serve
                                     else (K.TC_FWD_ROWS, 112))
    assert K.tc_layout(113, H).fwd_grid[1] == 2  # 112 batch rows a block
    rng = np.random.default_rng(H)
    w = torch.from_numpy(rng.standard_normal((4 * H, H), dtype=np.float32)
                         ).to(torch.bfloat16)
    fwd, bwd = K.pack_w_hh_fwd(w, lay), K.pack_w_hh_bwd(w, lay)
    assert fwd.dtype == bwd.dtype == torch.bfloat16
    rows, units = lay.rows, lay.rows // 4
    assert fwd.shape == (fwd_grid[0] * rows, lay.hp)
    assert bwd.shape == (bwd_grid[1] * K.TC_BWD_ROWS, 4 * lay.hp)
    # W_hh once, zeros elsewhere
    assert fwd.count_nonzero() == bwd.count_nonzero() == w.count_nonzero()
    # forward: row rows*u + units*g + jj is W_hh row g*H + units*u + jj
    r = torch.arange(fwd.shape[0])
    unit, gate = units * (r // rows) + r % units, (r % rows) // units
    live = unit < H
    assert torch.equal(fwd[live, :H], w[(gate * H + unit)[live]])
    # K5: row j, column g*Hp + k is W_hh[g*H + k, j]
    assert torch.equal(bwd[:H].view(H, 4, lay.hp)[..., :H],
                       w.view(4, H, H).permute(2, 0, 1))


def _layer_inputs(B, T, n_in, H, seed):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(H)
    return {"x": rng.normal(0, 1, (B, T, n_in)),
            "h0": rng.normal(0, 0.5, (B, H)), "c0": rng.normal(0, 0.5, (B, H)),
            "w_ih": rng.uniform(-s, s, (4 * H, n_in)),
            "w_hh": rng.uniform(-s, s, (4 * H, H)),
            "bias": rng.uniform(-s, s, (4 * H,)),
            # cotangents of out, h_T and c_T
            "r_out": rng.normal(0, 1, (B, T, H)),
            "r_h": rng.normal(0, 1, (B, H)), "r_c": rng.normal(0, 1, (B, H))}


NAMES = ("x", "h0", "c0", "w_ih", "w_hh", "bias")


def test_layer_autograd_matches_jax_grad():
    a = {k: v.astype(np.float32) for k, v in _layer_inputs(3, 9, 6, 10,
                                                           seed=3).items()}

    def jax_objective(x, h0, c0, w_ih, w_hh, bias):
        out, (h, c) = jax_lstm_layer_fused(x, (h0, c0), w_ih, w_hh, bias,
                                           True)
        return (jnp.sum(out * a["r_out"]) + jnp.sum(h * a["r_h"])
                + jnp.sum(c * a["r_c"]))

    want = jax.grad(jax_objective, argnums=tuple(range(6)))(
        *(jnp.asarray(a[k]) for k in NAMES))
    t = {k: torch.from_numpy(a[k]).requires_grad_() for k in NAMES}
    before = (K.launches.count, K.gates_launches.count,
              K.backward_launches.count)
    out, (h, c) = K.lstm_layer_fused(t["x"], (t["h0"], t["c0"]), t["w_ih"],
                                     t["w_hh"], t["bias"])
    (torch.sum(out * torch.from_numpy(a["r_out"]))
     + torch.sum(h * torch.from_numpy(a["r_h"]))
     + torch.sum(c * torch.from_numpy(a["r_c"]))).backward()
    # CPU tensors ran the plain versions: no kernel launch counted
    assert (K.launches.count, K.gates_launches.count,
            K.backward_launches.count) == before
    for name, w in zip(NAMES, want):
        if name in ("x", "h0", "c0"):
            np.testing.assert_allclose(t[name].grad.numpy(), np.asarray(w),
                                       atol=F32_ATOL, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(t[name].grad.numpy(), np.asarray(w),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=name)


def test_layer_function_gradcheck_f64():
    """The Function's K4/K5 pair (plain versions, float64) against
    finite differences, and against autograd through the plain loop."""
    a = _layer_inputs(2, 4, 3, 5, seed=4)
    args = tuple(torch.from_numpy(a[k]).requires_grad_() for k in NAMES)

    def layer_fn(layer):
        def fn(x, h0, c0, w_ih, w_hh, bias):
            out, (h, c) = layer(x, (h0, c0), w_ih, w_hh, bias)
            return out, h, c
        return fn

    assert torch.autograd.gradcheck(layer_fn(K.lstm_layer_fused), args)
    outs = [layer_fn(layer)(*args) for layer in (K.lstm_layer_fused,
                                                 lstm_layer)]
    g = torch.Generator().manual_seed(0)
    cot = [torch.randn(o.shape, generator=g, dtype=o.dtype)
           for o in outs[0]]
    g_fused, g_plain = (torch.autograd.grad(o, args, cot) for o in outs)
    for gf, gp in zip(g_fused, g_plain):
        torch.testing.assert_close(gf, gp, atol=1e-12, rtol=1e-10)


def test_no_grad_forward_runs_k1_and_keeps_nothing():
    a = {k: torch.from_numpy(v.astype(np.float32))
         for k, v in _layer_inputs(2, 5, 3, 4, seed=5).items()}
    w_hh = a["w_hh"].requires_grad_()
    with torch.no_grad():
        out, (h, c) = K.lstm_layer_fused(a["x"], (a["h0"], a["c0"]),
                                         a["w_ih"], w_hh, a["bias"])
    assert out.grad_fn is None
    want, (want_h, want_c) = lstm_layer(a["x"], (a["h0"], a["c0"]),
                                        a["w_ih"], a["w_hh"].detach(),
                                        a["bias"])
    assert torch.equal(out, want) and torch.equal(h, want_h)
    assert torch.equal(c, want_c)


def test_dropconnect_before_the_layer_matches_jax_layer_mask():
    """The port applies DropConnect once, to ``w_hh`` before the layer
    (``AWDLSTMEncoder``); the JAX scan layer takes the mask as an argument.
    Both give the same outputs and the same gradient of the unmasked
    ``w_hh``."""
    from code_intelligence_tpu.ops.lstm import lstm_layer as jax_lstm_layer

    a = _layer_inputs(2, 5, 3, 4, seed=6)
    mask = ((np.random.default_rng(0).random((16, 4)) < 0.8) / 0.8)
    args = [a[k].astype(np.float32) for k in NAMES]
    x, h0, c0, w_ih, w_hh, bias = args

    def jax_loss(w):
        out, (h, c) = jax_lstm_layer(x, (h0, c0), w_ih, w, bias,
                                     jnp.asarray(mask, jnp.float32))
        return (jnp.sum(out * a["r_out"]) + jnp.sum(h * a["r_h"])
                + jnp.sum(c * a["r_c"])), out

    (_, want_out), want_g = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(w_hh))
    t = [torch.from_numpy(v) for v in args]
    w = t[4].requires_grad_()
    out, (h, c) = K.lstm_layer_fused(
        t[0], (t[1], t[2]), t[3], w * torch.from_numpy(mask).float(), t[5])
    loss = (torch.sum(out * torch.from_numpy(a["r_out"]).float())
            + torch.sum(h * torch.from_numpy(a["r_h"]).float())
            + torch.sum(c * torch.from_numpy(a["r_c"]).float()))
    loss.backward()
    _assert_close([out.detach()], [want_out], F32_ATOL)
    _assert_close([w.grad], [want_g], GRAD_ATOL, GRAD_RTOL)
