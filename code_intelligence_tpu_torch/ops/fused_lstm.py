"""Fused LSTM recurrence (kernel K1) and its plain PyTorch version.

Port of the JAX package's ``ops/pallas_lstm.py::fused_lstm_forward``
(inference variant, ``with_gates=False``). The kernel is hand-written CUDA
in ``csrc/fused_lstm.cu``; its header says what bounds it on an H100 and
how it is laid out. The TPU's residency gate and tile choice
(``fits_resident``, ``_pick_tiles``, sublane padding) are VMEM budgets and
have no counterpart here: every shape runs the kernel, and nothing is
padded, so all T steps are real.

:func:`fused_lstm_forward` dispatches on where its tensors lie: on the CPU
it runs :func:`fused_lstm_forward_plain`; on a CUDA device it launches the
kernel or raises. The input projection ``x @ W_ih^T + b`` stays a
``torch.matmul`` outside the kernel, time-major, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from code_intelligence_tpu_torch.ops import _build

LSTMState = Tuple[torch.Tensor, torch.Tensor]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCounter:
    """Kernel launches made by a wrapper (one per time step)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self, n: int) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._n


# K1 launches in this process; read by chip_smoke.py to show that the serve
# path went through the kernel
launches = LaunchCounter()


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_lstm_forward.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, p]
    lib.fused_lstm_forward.restype = i
    lib.fused_lstm_error_string.argtypes = [i]
    lib.fused_lstm_error_string.restype = ctypes.c_char_p


def _check(x_proj, w_hh, h0, c0) -> Tuple[int, int, int]:
    if x_proj.dim() != 3 or x_proj.shape[2] % 4:
        raise ValueError(f"x_proj must be (T, B, 4H), got {tuple(x_proj.shape)}")
    T, B, G = x_proj.shape
    H = G // 4
    if tuple(w_hh.shape) != (G, H):
        raise ValueError(f"w_hh must be {(G, H)}, got {tuple(w_hh.shape)}")
    for name, t in (("h0", h0), ("c0", c0)):
        if tuple(t.shape) != (B, H):
            raise ValueError(f"{name} must be {(B, H)}, got {tuple(t.shape)}")
    tensors = (x_proj, w_hh, h0, c0)
    if any(t.device != x_proj.device for t in tensors):
        raise ValueError("x_proj, w_hh, h0 and c0 must be on one device")
    if x_proj.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {x_proj.dtype} is not supported "
                        "(float32 or bfloat16)")
    if any(t.dtype != x_proj.dtype for t in tensors):
        raise TypeError("x_proj, w_hh, h0 and c0 must share one dtype")
    return T, B, H


def fused_lstm_forward(x_proj: torch.Tensor, w_hh: torch.Tensor,
                       h0: torch.Tensor, c0: torch.Tensor
                       ) -> Tuple[torch.Tensor, LSTMState]:
    """``(x_proj (T, B, 4H), w_hh (4H, H), h0, c0 (B, H))`` ->
    ``(out (T, B, H), (h_T, c_T))``, all in one dtype (f32 or bf16).

    CPU tensors run the plain version; CUDA tensors launch K1."""
    T, B, H = _check(x_proj, w_hh, h0, c0)
    if x_proj.device.type == "cpu":
        return fused_lstm_forward_plain(x_proj, w_hh, h0, c0)
    if x_proj.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {x_proj.device}")
    if not all(t.is_contiguous() for t in (x_proj, w_hh, h0, c0)):
        raise ValueError("K1 takes contiguous x_proj, w_hh, h0 and c0")
    kw = {"dtype": x_proj.dtype, "device": x_proj.device}
    out = torch.empty((T, B, H), **kw)
    h_t = torch.empty((B, H), **kw)
    c_t = torch.empty((B, H), **kw)
    if T == 0:
        return out, (h_t.copy_(h0), c_t.copy_(c0))
    c_scratch = torch.empty((B, H), **kw)
    lib = _build.load("fused_lstm", _bind)
    with torch.cuda.device(x_proj.device):
        err = lib.fused_lstm_forward(
            _DTYPE_CODES[x_proj.dtype], x_proj.data_ptr(), w_hh.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), out.data_ptr(), h_t.data_ptr(),
            c_t.data_ptr(), c_scratch.data_ptr(), T, B, H,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.fused_lstm_error_string(err).decode()
        raise RuntimeError(f"K1 fused_lstm_forward launch failed: {msg} "
                           f"(cudaError {err}) at T={T} B={B} H={H}")
    launches.add(T)
    return out, (h_t, c_t)


def fused_lstm_forward_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                             h0: torch.Tensor, c0: torch.Tensor
                             ) -> Tuple[torch.Tensor, LSTMState]:
    """K1's function as a per-step PyTorch loop, with the kernel's
    rounding: gates and cell math in f32, h and c stored in the input
    dtype after every step."""
    _check(x_proj, w_hh, h0, c0)
    if x_proj.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the plain K1 reference needs full-f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    T, B, _ = x_proj.shape
    dtype = x_proj.dtype
    w_t = w_hh.float().t()  # (H, 4H)
    h, c = h0, c0
    out = torch.empty((T, B, w_hh.shape[1]), dtype=dtype,
                      device=x_proj.device)
    for t in range(T):
        gates = x_proj[t].float() + h.float() @ w_t
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h, c = h_new.to(dtype), c_new.to(dtype)
        out[t] = h
    return out, (h, c)


def project_time_major(x: torch.Tensor, w_ih: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """``x (B, T, in)`` -> ``x @ W_ih^T + b`` as ``(T, B, 4H)``. When ``x``
    is the batch-major view of a time-major tensor (the previous layer's
    output) the reshape is free."""
    B, T, n_in = x.shape
    x_tm = x.transpose(0, 1).reshape(T * B, n_in)
    return (x_tm @ w_ih.t()).view(T, B, -1) + bias


def lstm_layer_fused(x: torch.Tensor, state: LSTMState, w_ih: torch.Tensor,
                     w_hh: torch.Tensor, bias: torch.Tensor
                     ) -> Tuple[torch.Tensor, LSTMState]:
    """One LSTM layer through K1: ``x (B, T, in)`` -> ``(out (B, T, H),
    (h_T, c_T))``; ``out`` is a batch-major view of the kernel's
    time-major output."""
    x_proj = project_time_major(x, w_ih, bias)
    dtype = x_proj.dtype
    h0, c0 = state
    out, st = fused_lstm_forward(x_proj, w_hh, h0.to(dtype).contiguous(),
                                 c0.to(dtype).contiguous())
    return out.transpose(0, 1), st
