"""Fused LSTM recurrence kernels K1-K3 and their plain PyTorch versions.

Ports of the JAX package's ``ops/pallas_lstm.py`` inference kernels:

* K1 :func:`fused_lstm_forward` (``fused_lstm_forward``,
  ``with_gates=False``): the dense recurrence of the ``slots`` and
  ``groups`` paths;
* K2 :func:`fused_lstm_forward_ragged` (``fused_lstm_forward_ragged``):
  K1 plus per-row valid lengths, for the ragged scheduler;
* K3 :func:`fused_lstm_forward_ragged_int8`
  (``fused_lstm_forward_ragged_int8``): K2 with an int8 ``W_hh`` and one
  f32 scale per output row, for ``precision="int8"``.

The kernels are hand-written CUDA in ``csrc/fused_lstm.cu``; its header
says what bounds them on an H100 and how they are laid out. The TPU's
residency gates and tile choice (``fits_resident``,
``fits_resident_int8``, ``_pick_tiles*``, sublane padding) are VMEM
budgets and have no counterpart here: every shape runs its kernel, and
nothing is padded.

Each wrapper dispatches on where its tensors lie: on the CPU it runs its
plain version; on a CUDA device it launches its kernel or raises. The
input projection ``x @ W_ih^T + b`` stays a ``torch.matmul`` outside the
kernel, time-major, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

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


# launches in this process, one counter per kernel; read by chip_smoke.py
# to show that each serve path went through its kernel
launches = LaunchCounter()               # K1
ragged_launches = LaunchCounter()        # K2
ragged_int8_launches = LaunchCounter()   # K3


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_lstm_forward.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, p]
    lib.fused_lstm_forward.restype = i
    lib.fused_lstm_forward_ragged.argtypes = [i, p, p, p, p, p, p, p, p, p, p,
                                              i, i, i, i, p]
    lib.fused_lstm_forward_ragged.restype = i
    lib.fused_lstm_forward_ragged_int8.argtypes = [i, p, p, p, p, p, p, p, p,
                                                   p, p, p, i, i, i, i, p]
    lib.fused_lstm_forward_ragged_int8.restype = i
    lib.fused_lstm_error_string.argtypes = [i]
    lib.fused_lstm_error_string.restype = ctypes.c_char_p


def _check(x_proj, w_hh, h0, c0, w_dtype=None) -> Tuple[int, int, int]:
    """Shapes, one device, and the types: f32 or bf16 activations, and
    ``w_hh`` of the activations' type or of ``w_dtype`` when given."""
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
    if w_dtype is None:
        if any(t.dtype != x_proj.dtype for t in tensors):
            raise TypeError("x_proj, w_hh, h0 and c0 must share one dtype")
    else:
        if w_hh.dtype != w_dtype:
            raise TypeError(f"w_hh must be {w_dtype}, got {w_hh.dtype}")
        if h0.dtype != x_proj.dtype or c0.dtype != x_proj.dtype:
            raise TypeError("x_proj, h0 and c0 must share one dtype")
    return T, B, H


def _check_ragged(x_proj, valid_lens, t_live: Optional[int]) -> int:
    """``valid_lens`` is ``(B,)`` int32 beside ``x_proj``; returns the
    steps to launch: ``t_live``, or every step when it is None."""
    T, B = x_proj.shape[0], x_proj.shape[1]
    if tuple(valid_lens.shape) != (B,) or valid_lens.dtype != torch.int32:
        raise ValueError(f"valid_lens must be ({B},) int32, got "
                         f"{tuple(valid_lens.shape)} {valid_lens.dtype}")
    if valid_lens.device != x_proj.device:
        raise ValueError("valid_lens must be on x_proj's device")
    if t_live is None:
        return T
    if not 0 <= t_live <= T:
        raise ValueError(f"t_live must be in [0, {T}], got {t_live}")
    return int(t_live)


def _check_launchable(name: str, tensors) -> None:
    """The kernels read h and W_hh four elements at a time: contiguous
    tensors on 16-byte boundaries."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} takes tensors aligned to 16 bytes")


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
    _require_full_f32(x_proj, "K1")
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


def fused_lstm_forward_ragged(x_proj: torch.Tensor, w_hh: torch.Tensor,
                              h0: torch.Tensor, c0: torch.Tensor,
                              valid_lens: torch.Tensor,
                              t_live: Optional[int] = None
                              ) -> Tuple[torch.Tensor, LSTMState]:
    """K2: ``fused_lstm_forward`` plus ``valid_lens (B,) int32``. Row b's
    outputs equal the dense recurrence's for ``t < valid_lens[b]`` and are
    exactly 0 after; ``(h_T, c_T)`` is each row's carry after
    ``min(valid, T)`` steps.

    ``t_live`` is a host int ``>= min(T, max(valid_lens))`` known to the
    caller (the scheduler has the lengths in its host staging block): the
    kernel launches only that many steps and zero-fills the rest, without
    reading ``valid_lens`` back. ``None`` launches all T steps, which is
    exact too. CPU tensors run the plain version; CUDA tensors launch K2."""
    _check(x_proj, w_hh, h0, c0)
    steps = _check_ragged(x_proj, valid_lens, t_live)
    if x_proj.device.type == "cpu":
        return fused_lstm_forward_ragged_plain(x_proj, w_hh, h0, c0,
                                               valid_lens)
    return _launch_ragged("K2", "fused_lstm_forward_ragged", ragged_launches,
                          x_proj, (w_hh,), h0, c0, valid_lens, steps)


def fused_lstm_forward_ragged_int8(x_proj: torch.Tensor,
                                   w_hh_q: torch.Tensor,
                                   w_hh_scale: torch.Tensor,
                                   h0: torch.Tensor, c0: torch.Tensor,
                                   valid_lens: torch.Tensor,
                                   t_live: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, LSTMState]:
    """K3: K2 with ``w_hh_q (4H, H) int8`` and ``w_hh_scale (4H,) f32``,
    one scale per output row, applied to the product ``h @ w_hh_q^T``
    before ``x_proj`` is added. Activations are f32 or bf16. CPU tensors
    run the plain version; CUDA tensors launch K3."""
    _, _, H = _check(x_proj, w_hh_q, h0, c0, w_dtype=torch.int8)
    if (tuple(w_hh_scale.shape) != (4 * H,)
            or w_hh_scale.dtype != torch.float32
            or w_hh_scale.device != x_proj.device):
        raise ValueError(f"w_hh_scale must be ({4 * H},) float32 on "
                         f"x_proj's device")
    steps = _check_ragged(x_proj, valid_lens, t_live)
    if x_proj.device.type == "cpu":
        return fused_lstm_forward_ragged_int8_plain(
            x_proj, w_hh_q, w_hh_scale, h0, c0, valid_lens)
    return _launch_ragged("K3", "fused_lstm_forward_ragged_int8",
                          ragged_int8_launches, x_proj, (w_hh_q, w_hh_scale),
                          h0, c0, valid_lens, steps)


def _launch_ragged(kernel: str, entry: str, counter: LaunchCounter,
                   x_proj: torch.Tensor, weights, h0: torch.Tensor,
                   c0: torch.Tensor, valid_lens: torch.Tensor, steps: int
                   ) -> Tuple[torch.Tensor, LSTMState]:
    """Launch K2 or K3 (the C function ``entry``, whose weight arguments
    are ``weights``) for ``steps`` live steps on the tensors' card."""
    if x_proj.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {x_proj.device}")
    _check_launchable(kernel, (x_proj, *weights, h0, c0, valid_lens))
    T, B, _ = x_proj.shape
    H = h0.shape[1]
    kw = {"dtype": x_proj.dtype, "device": x_proj.device}
    out = torch.empty((T, B, H), **kw)
    h_t, c_t, h_scr, c_scr = (torch.empty((B, H), **kw) for _ in range(4))
    if T == 0:
        return out, (h_t.copy_(h0), c_t.copy_(c0))
    lib = _build.load("fused_lstm", _bind)
    with torch.cuda.device(x_proj.device):
        err = getattr(lib, entry)(
            _DTYPE_CODES[x_proj.dtype], x_proj.data_ptr(),
            *(w.data_ptr() for w in weights), valid_lens.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), out.data_ptr(), h_t.data_ptr(),
            c_t.data_ptr(), h_scr.data_ptr(), c_scr.data_ptr(), T, steps, B,
            H, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.fused_lstm_error_string(err).decode()
        raise RuntimeError(f"{kernel} {entry} launch failed: {msg} "
                           f"(cudaError {err}) at T={T} B={B} H={H}")
    counter.add(steps)
    return out, (h_t, c_t)


def _ragged_plain(x_proj, h0, c0, valid_lens, recurrent):
    """The per-step loop of K2 and K3 with their rounding; ``recurrent(h)``
    is the f32 ``(B, 4H)`` recurrent term of one step."""
    T, B, _ = x_proj.shape
    dtype = x_proj.dtype
    valid = valid_lens.to(x_proj.device).long()
    h, c = h0, c0
    out = torch.zeros((T, B, h0.shape[1]), dtype=dtype, device=x_proj.device)
    for t in range(T):
        live = (t < valid)[:, None]
        gates = x_proj[t].float() + recurrent(h)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = torch.where(live, h_new.to(dtype), h)
        c = torch.where(live, c_new.to(dtype), c)
        out[t] = torch.where(live, h, torch.zeros_like(h))
    return out, (h, c)


def _require_full_f32(x_proj: torch.Tensor, name: str) -> None:
    if x_proj.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"the plain {name} reference needs full-f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def fused_lstm_forward_ragged_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                                    h0: torch.Tensor, c0: torch.Tensor,
                                    valid_lens: torch.Tensor,
                                    t_live: Optional[int] = None
                                    ) -> Tuple[torch.Tensor, LSTMState]:
    """K2's function as a per-step PyTorch loop over all T steps, with the
    kernel's rounding (f32 gates, h and c stored in the input dtype).
    ``t_live`` is accepted for the kernel's signature and not needed."""
    _check(x_proj, w_hh, h0, c0)
    _check_ragged(x_proj, valid_lens, t_live)
    _require_full_f32(x_proj, "K2")
    w_t = w_hh.float().t()  # (H, 4H)
    return _ragged_plain(x_proj, h0, c0, valid_lens,
                         lambda h: h.float() @ w_t)


def fused_lstm_forward_ragged_int8_plain(x_proj: torch.Tensor,
                                         w_hh_q: torch.Tensor,
                                         w_hh_scale: torch.Tensor,
                                         h0: torch.Tensor, c0: torch.Tensor,
                                         valid_lens: torch.Tensor,
                                         t_live: Optional[int] = None
                                         ) -> Tuple[torch.Tensor, LSTMState]:
    """K3's function as a per-step PyTorch loop: ``(h @ q^T) * scale`` in
    f32, then ``x_proj`` added, as the kernel does. The codes are widened
    to f32 for the product; that copy lives for the call only."""
    _check(x_proj, w_hh_q, h0, c0, w_dtype=torch.int8)
    _check_ragged(x_proj, valid_lens, t_live)
    _require_full_f32(x_proj, "K3")
    q_t = w_hh_q.float().t()  # (H, 4H) codes as f32
    scale = w_hh_scale.float()
    return _ragged_plain(x_proj, h0, c0, valid_lens,
                         lambda h: (h.float() @ q_t) * scale)


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


def lstm_layer_fused_ragged(x: torch.Tensor, state: LSTMState,
                            w_ih: torch.Tensor, w_hh: torch.Tensor,
                            bias: torch.Tensor, valid_lens: torch.Tensor,
                            t_live: Optional[int] = None, plain: bool = False
                            ) -> Tuple[torch.Tensor, LSTMState]:
    """One LSTM layer through K2 (``plain=True``: its plain version):
    ``x (B, T, in)`` and ``valid_lens (B,) int32`` -> ``(out (B, T, H),
    (h_T, c_T))``, with zeros past each row's valid length."""
    x_proj = project_time_major(x, w_ih, bias)
    dtype = x_proj.dtype
    h0, c0 = state
    fwd = fused_lstm_forward_ragged_plain if plain else \
        fused_lstm_forward_ragged
    out, st = fwd(x_proj, w_hh, h0.to(dtype).contiguous(),
                  c0.to(dtype).contiguous(), valid_lens, t_live)
    return out.transpose(0, 1), st


def lstm_layer_fused_ragged_int8(x: torch.Tensor, state: LSTMState,
                                 w_ih_q: torch.Tensor,
                                 w_ih_scale: torch.Tensor,
                                 w_hh_q: torch.Tensor,
                                 w_hh_scale: torch.Tensor, bias: torch.Tensor,
                                 valid_lens: torch.Tensor,
                                 t_live: Optional[int] = None,
                                 plain: bool = False
                                 ) -> Tuple[torch.Tensor, LSTMState]:
    """One int8 LSTM layer through K3 (``plain=True``: its plain version).
    The input projection runs in the activations' dtype on the int8
    ``w_ih_q`` widened to that dtype, and its per-row scale multiplies the
    ``(T, B, 4H)`` product before the bias, as the JAX layer does."""
    dtype = x.dtype
    B, T, n_in = x.shape
    x_tm = x.transpose(0, 1).reshape(T * B, n_in)
    x_proj = (x_tm @ w_ih_q.to(dtype).t()).view(T, B, -1) \
        * w_ih_scale.to(dtype) + bias
    h0, c0 = state
    fwd = fused_lstm_forward_ragged_int8_plain if plain else \
        fused_lstm_forward_ragged_int8
    out, st = fwd(x_proj, w_hh_q, w_hh_scale, h0.to(dtype).contiguous(),
                  c0.to(dtype).contiguous(), valid_lens, t_live)
    return out.transpose(0, 1), st
