"""QRNN forget-mult kernels K6-K8 and their plain PyTorch versions.

Ports of the JAX package's ``ops/pallas_qrnn.py`` kernels, over time-major
``(T, B, H)`` tensors:

* K6 :func:`forget_mult_forward` (``_forward_tm``): ``h_t = f_t * h_{t-1}
  + (1 - f_t) * z_t`` with an f32 carry, each output stored in the input
  dtype;
* K7 :func:`forget_mult_backward` (``_backward_tm``): its adjoint in
  reverse time;
* K8 :func:`forget_mult_ragged` (``_forward_tm_ragged``): K6 with per-row
  valid lengths, for the ragged scheduler (inference only, as in JAX).

:func:`forget_mult_fused` pairs K6 and K7 in one ``torch.autograd.Function``,
as the JAX package pairs them in one ``custom_vjp``. The kernels are
hand-written CUDA in ``csrc/forget_mult.cu``, one launch per call; its
header says what bounds them. K6 and K8 stream z and f through a ring of
shared-memory stages fed by TMA bulk copies, one block per SM, when the
``B * H`` plane is whole 16-byte vectors and every tensor starts on a
16-byte boundary (every flagship shape), and walk one thread per lane
otherwise; the C entry chooses from the shape and the pointers. Each
wrapper runs its plain version on CPU tensors; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from code_intelligence_tpu_torch.ops import _build
from code_intelligence_tpu_torch.ops.fused_lstm import (
    _DTYPE_CODES,
    LaunchCounter,
    _acc,
    _check_dtype,
)

# launches in this process, one counter per kernel (one launch per call);
# read by chip_smoke.py to show that each path went through its kernel
forget_mult_launches = LaunchCounter()           # K6
forget_mult_backward_launches = LaunchCounter()  # K7
forget_mult_ragged_launches = LaunchCounter()    # K8


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.forget_mult_forward.argtypes = [i, p, p, p, p, i, i, i, p]
    lib.forget_mult_forward_ragged.argtypes = [i, p, p, p, p, p, i, i, i, p]
    lib.forget_mult_backward.argtypes = [i, *[p] * 8, i, i, i, p]
    for fn in (lib.forget_mult_forward, lib.forget_mult_forward_ragged,
               lib.forget_mult_backward):
        fn.restype = i
    lib.forget_mult_error_string.argtypes = [i]
    lib.forget_mult_error_string.restype = ctypes.c_char_p


def _check(z, f, h0, **seqs) -> Tuple[int, int, int]:
    """``z``, ``f`` and ``seqs`` are ``(T, B, H)``, ``h0`` is ``(B, H)``, all
    of one dtype (f32 or bf16) on one device."""
    if z.dim() != 3:
        raise ValueError(f"z must be (T, B, H), got {tuple(z.shape)}")
    T, B, H = z.shape
    want = {"f": (f, (T, B, H)), "h0": (h0, (B, H)),
            **{k: (v, (T, B, H)) for k, v in seqs.items()}}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != z.device or t.dtype != z.dtype:
            raise TypeError(f"{name} must be {z.dtype} on {z.device}, got "
                            f"{t.dtype} on {t.device}")
    _check_dtype(z)
    return T, B, H


def _check_valid(z: torch.Tensor, valid_lens: torch.Tensor) -> None:
    B = z.shape[1]
    if (tuple(valid_lens.shape) != (B,) or valid_lens.dtype != torch.int32
            or valid_lens.device != z.device):
        raise ValueError(f"valid_lens must be ({B},) int32 on z's device, got "
                         f"{tuple(valid_lens.shape)} {valid_lens.dtype} on "
                         f"{valid_lens.device}")


def _launch(kernel: str, entry: str, counter: LaunchCounter, tensors,
            T: int, B: int, H: int) -> None:
    """One launch of the C function ``entry`` on ``tensors`` (its pointer
    arguments, in order; the first sets the dtype and the device)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel} takes contiguous tensors, not strided "
                         "views")
    if B * H == 0:
        return
    lib = _build.load("forget_mult", _bind)
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            _DTYPE_CODES[tensors[0].dtype], *(t.data_ptr() for t in tensors),
            T, B, H, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.forget_mult_error_string(err).decode()
        raise RuntimeError(f"{kernel} {entry} launch failed: {msg} "
                           f"(cudaError {err}) at T={T} B={B} H={H}")
    counter.add(1)


def forget_mult_forward(z: torch.Tensor, f: torch.Tensor,
                        h0: torch.Tensor) -> torch.Tensor:
    """K6: ``z, f (T, B, H)`` and ``h0 (B, H)``, one dtype -> ``out (T, B,
    H)``. CPU tensors run the plain version; CUDA tensors launch K6."""
    T, B, H = _check(z, f, h0)
    if z.device.type == "cpu":
        return forget_mult_forward_plain(z, f, h0)
    out = torch.empty_like(z)
    _launch("K6", "forget_mult_forward", forget_mult_launches,
            (z, f, h0, out), T, B, H)
    return out


def forget_mult_forward_plain(z: torch.Tensor, f: torch.Tensor,
                              h0: torch.Tensor) -> torch.Tensor:
    """K6's function as a T-step loop written like ``_fwd_kernel``: the
    carry in f32 (float64 for float64 inputs), ``f * h + (1 - f) * z``,
    each output stored in the input dtype. Differentiable, so autograd
    through it is the reference for K6 and K7 together."""
    T, B, H = _check(z, f, h0)
    acc = _acc(z.dtype)
    h = h0.to(acc)
    outs = []
    for t in range(T):
        ft = f[t].to(acc)
        h = ft * h + (1.0 - ft) * z[t].to(acc)
        outs.append(h.to(z.dtype))
    return torch.stack(outs) if outs else z.new_empty((0, B, H))


def forget_mult_backward(z: torch.Tensor, f: torch.Tensor, h: torch.Tensor,
                         h0: torch.Tensor, g: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """K7: the adjoint of K6 over ``z, f``, K6's output ``h (T, B, H)``,
    ``h0 (B, H)`` and the output cotangent ``g (T, B, H)``, one dtype ->
    ``(dz, df, dh0)`` in that dtype, with an f32 carry. CPU tensors run the
    plain version; CUDA tensors launch K7."""
    T, B, H = _check(z, f, h0, h=h, g=g)
    if z.device.type == "cpu":
        return forget_mult_backward_plain(z, f, h, h0, g)
    dz, df = torch.empty_like(z), torch.empty_like(z)
    dh0 = torch.empty_like(h0)
    _launch("K7", "forget_mult_backward", forget_mult_backward_launches,
            (z, f, h, h0, g, dz, df, dh0), T, B, H)
    return dz, df, dh0


def forget_mult_backward_plain(z: torch.Tensor, f: torch.Tensor,
                               h: torch.Tensor, h0: torch.Tensor,
                               g: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """K7's function as a reverse loop written like ``_bwd_kernel``: ``s =
    c + g_t``, ``dz_t = s (1 - f_t)``, ``df_t = s (h_{t-1} - z_t)``, ``c =
    f_t s`` in f32, with ``h_{t-1}`` the stored output (``h0`` at t = 0)."""
    T, B, H = _check(z, f, h0, h=h, g=g)
    acc = _acc(z.dtype)
    c = torch.zeros((B, H), dtype=acc, device=z.device)
    dz, df = torch.empty_like(z), torch.empty_like(z)
    for t in reversed(range(T)):
        s = c + g[t].to(acc)
        ft = f[t].to(acc)
        h_prev = (h[t - 1] if t > 0 else h0).to(acc)
        dz[t] = s * (1.0 - ft)
        df[t] = s * (h_prev - z[t].to(acc))
        c = ft * s
    return dz, df, c.to(z.dtype)


def forget_mult_ragged(z: torch.Tensor, f: torch.Tensor, h0: torch.Tensor,
                       valid_lens: torch.Tensor) -> torch.Tensor:
    """K8: K6 plus ``valid_lens (B,) int32``. Row b runs ``min(valid, T)``
    steps; its outputs from there on hold its frozen carry, so ``out[-1]``
    is its state after those steps. CPU tensors run the plain version;
    CUDA tensors launch K8."""
    T, B, H = _check(z, f, h0)
    _check_valid(z, valid_lens)
    if z.device.type == "cpu":
        return forget_mult_ragged_plain(z, f, h0, valid_lens)
    out = torch.empty_like(z)
    _launch("K8", "forget_mult_forward_ragged", forget_mult_ragged_launches,
            (z, f, h0, valid_lens, out), T, B, H)
    return out


def forget_mult_ragged_plain(z: torch.Tensor, f: torch.Tensor,
                             h0: torch.Tensor,
                             valid_lens: torch.Tensor) -> torch.Tensor:
    """K8's function as a T-step loop written like ``_fwd_kernel_ragged``:
    a row's carry is kept where ``t >= valid``, and every step stores it."""
    T, B, H = _check(z, f, h0)
    _check_valid(z, valid_lens)
    acc = _acc(z.dtype)
    valid = valid_lens.long()[:, None]
    h = h0.to(acc)
    out = torch.empty_like(z)
    for t in range(T):
        ft = f[t].to(acc)
        h = torch.where(t < valid, ft * h + (1.0 - ft) * z[t].to(acc), h)
        out[t] = h
    return out


class _ForgetMultFused(torch.autograd.Function):
    """K6 forward, K7 backward: the JAX package's ``forget_mult_fused``
    ``custom_vjp``, saving ``(z, f, h0, out)`` as its ``_fused_fwd`` does."""

    @staticmethod
    def forward(ctx, z, f, h0):
        out = forget_mult_forward(z, f, h0)
        ctx.save_for_backward(z, f, h0, out)
        return out

    @staticmethod
    def backward(ctx, g):
        z, f, h0, out = ctx.saved_tensors
        return forget_mult_backward(z, f, out, h0,
                                    g.to(z.dtype).contiguous())


def forget_mult_fused(z: torch.Tensor, f: torch.Tensor,
                      h0: torch.Tensor) -> torch.Tensor:
    """The differentiable forget-mult over time-major ``z, f (T, B, H)``
    from ``h0 (B, H)`` (cast to their dtype): K6, and K7 in the backward
    when autograd needs a gradient; otherwise K6 alone."""
    h0 = h0.to(z.dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z, f, h0)):
        return _ForgetMultFused.apply(z, f, h0)
    return forget_mult_forward(z, f, h0)
