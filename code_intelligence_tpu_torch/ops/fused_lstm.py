"""Fused LSTM recurrence kernels K1-K5 and their plain PyTorch versions.

Ports of the JAX package's ``ops/pallas_lstm.py`` kernels:

* K1 :func:`fused_lstm_forward` (``fused_lstm_forward``,
  ``with_gates=False``): the dense recurrence of the ``slots`` and
  ``groups`` paths;
* K2 :func:`fused_lstm_forward_ragged` (``fused_lstm_forward_ragged``):
  K1 plus per-row valid lengths, for the ragged scheduler;
* K3 :func:`fused_lstm_forward_ragged_int8`
  (``fused_lstm_forward_ragged_int8``): K2 with an int8 ``W_hh`` and one
  f32 scale per output row, for ``precision="int8"``;
* K4 :func:`fused_lstm_forward` with ``with_gates=True``: K1 plus the
  training residuals (the gates and the pre-step cell state);
* K5 :func:`fused_lstm_backward` (``fused_lstm_backward``): the adjoint
  of the recurrence over those residuals.

:func:`lstm_layer_fused` pairs K4 and K5 in one ``torch.autograd.Function``,
as the JAX package pairs them in one ``custom_vjp``; without a gradient to
take, it runs K1.

The kernels are hand-written CUDA in ``csrc/fused_lstm.cu``; its header
says what bounds them on an H100 and how they are laid out. The TPU's
residency gates and tile choice (``fits_resident``,
``fits_resident_int8``, ``_pick_tiles*``, sublane padding) are VMEM
budgets and have no counterpart here: every shape runs its kernel. In
bf16, K1-K5 run on the tensor cores. K1, K2, K4 and K5 take ``W_hh`` in a
padded copy laid out for them (:func:`tc_layout`, :func:`pack_w_hh_fwd`,
:func:`pack_w_hh_bwd`): K4 and K5 pack it per call, K1 and K2 take the
copy a frozen encoder keeps (``w_pack``) or pack per call without one. K3
reads its int8 codes where they lie, :func:`int8_copy_bytes` at a time,
so an int8 model holds no copy. In f32 they run the CUDA-core kernels:
the dtype picks the kernel, never the shape.

Each wrapper dispatches on where its tensors lie: on the CPU it runs its
plain version; on a CUDA device it launches its kernel or raises. The
input projection ``x @ W_ih^T + b`` stays a ``torch.matmul`` outside the
kernel, time-major, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

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
gates_launches = LaunchCounter()         # K4
backward_launches = LaunchCounter()      # K5


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_lstm_forward.argtypes = [i, *[p] * 10, *[i] * 7, p]
    lib.fused_lstm_forward.restype = i
    lib.fused_lstm_forward_gates.argtypes = [i, *[p] * 12, *[i] * 6, p]
    lib.fused_lstm_forward_gates.restype = i
    lib.fused_lstm_backward.argtypes = [i, *[p] * 11, *[i] * 7, p]
    lib.fused_lstm_backward.restype = i
    lib.fused_lstm_forward_ragged.argtypes = [i, *[p] * 12, *[i] * 8, p]
    lib.fused_lstm_forward_ragged.restype = i
    lib.fused_lstm_forward_ragged_int8.argtypes = [i, *[p] * 12, *[i] * 9, p]
    lib.fused_lstm_forward_ragged_int8.restype = i
    lib.fused_lstm_error_string.argtypes = [i]
    lib.fused_lstm_error_string.restype = ctypes.c_char_p
    built = (i * 7)()
    lib.fused_lstm_tc_config(built)
    ours = (TC_FWD_ROWS, TC_BWD_ROWS, TC_BATCH, TC_K, TC_CLUSTER,
            TC_SERVE_ROWS, TC_SERVE_BATCH)
    if tuple(built) != ours:
        raise RuntimeError(f"csrc/fused_lstm.cu's tile constants "
                           f"{tuple(built)} differ from the layout's {ours}")


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
    _check_dtype(x_proj)
    if w_dtype is None:
        if any(t.dtype != x_proj.dtype for t in tensors):
            raise TypeError("x_proj, w_hh, h0 and c0 must share one dtype")
    else:
        if w_hh.dtype != w_dtype:
            raise TypeError(f"w_hh must be {w_dtype}, got {w_hh.dtype}")
        if h0.dtype != x_proj.dtype or c0.dtype != x_proj.dtype:
            raise TypeError("x_proj, h0 and c0 must share one dtype")
    return T, B, H


def _check_dtype(t: torch.Tensor) -> None:
    """f32 or bf16; float64 too on the CPU, where the plain versions run
    (``torch.autograd.gradcheck`` takes float64)."""
    if t.dtype not in _DTYPE_CODES and not (
            t.dtype == torch.float64 and t.device.type == "cpu"):
        raise TypeError(f"dtype {t.dtype} is not supported "
                        "(float32 or bfloat16)")


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic type: f32, as in the kernels, or
    float64 for float64 inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


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


# The bf16 tensor-core blocks (csrc/fused_lstm.cu, kTc*; checked against
# the library's when it is loaded): TC_FWD_ROWS W_hh rows (the forward step:
# TC_FWD_ROWS / 4 hidden units x 4 gates) or TC_BWD_ROWS of its columns
# (K5) times up to TC_BATCH batch rows, K in slices of TC_K, and K5's 4H sum
# split over a cluster of 4 blocks. K1 and K2 at B <= TC_SERVE_BATCH (the
# serve batch) take the serve tile: TC_SERVE_ROWS W_hh rows times up to
# TC_SERVE_BATCH batch rows.
TC_FWD_ROWS, TC_BWD_ROWS, TC_BATCH, TC_K, TC_CLUSTER = 80, 96, 112, 64, 4
TC_SERVE_ROWS, TC_SERVE_BATCH = 80, 32


class TensorCoreLayout(NamedTuple):
    """Where the bf16 tensor-core kernels put ``W_hh`` and their grids,
    for a batch of ``B`` rows and hidden size ``H``."""
    hp: int                         # padded row length, a multiple of TC_K
    fwd_grid: Tuple[int, int]       # forward step: (unit tiles, batch tiles)
    bwd_grid: Tuple[int, int, int]  # K5: (gate slabs = cluster, unit tiles,
    #                                      batch tiles)
    rows: int                       # forward step: W_hh rows a block
    batch: int                      # forward step: batch rows a block


def tc_layout(B: int, H: int, gates: bool = False) -> TensorCoreLayout:
    """The layout at batch ``B``: the forward step takes the serve tile
    at ``B <= TC_SERVE_BATCH`` and the TC_BATCH-row tile above it, or
    always with ``gates`` (K4)."""
    rows, batch = ((TC_SERVE_ROWS, TC_SERVE_BATCH)
                   if B <= TC_SERVE_BATCH and not gates
                   else (TC_FWD_ROWS, TC_BATCH))
    return TensorCoreLayout(
        hp=-(-H // TC_K) * TC_K,
        fwd_grid=(-(-H * 4 // rows), -(-B // batch)),
        bwd_grid=(TC_CLUSTER, -(-H // TC_BWD_ROWS), -(-B // TC_BATCH)),
        rows=rows, batch=batch)


def pack_w_hh_fwd(w_hh: torch.Tensor, layout: TensorCoreLayout
                  ) -> torch.Tensor:
    """The forward step's ``W_hh``: ``(fwd_grid[0] * rows, Hp)``, zero
    past H. With n = rows / 4 units a block, block u's rows are ``W_hh``
    rows ``g * H + n * u + jj`` in order ``(g, jj)``: all four gates of
    its n units."""
    H, n = w_hh.shape[1], layout.rows // 4
    out = w_hh.new_zeros((layout.fwd_grid[0] * n, 4, layout.hp))
    out[:H, :, :H] = w_hh.view(4, H, H).transpose(0, 1)  # [unit][gate][k]
    return out.view(-1, n, 4, layout.hp).transpose(1, 2) \
        .reshape(-1, layout.hp)


def pack_w_hh_bwd(w_hh: torch.Tensor, layout: TensorCoreLayout
                  ) -> torch.Tensor:
    """K5's ``W_hh^T``: ``(bwd_grid[1] * TC_BWD_ROWS, 4 * Hp)``, zero past
    H: row j, column ``g * Hp + k`` holds ``W_hh[g * H + k, j]``."""
    H = w_hh.shape[1]
    out = w_hh.new_zeros((layout.bwd_grid[1] * TC_BWD_ROWS, 4,
                          layout.hp))
    out[:H, :, :H] = w_hh.view(4, H, H).permute(2, 0, 1)
    return out.view(-1, 4 * layout.hp)


def _check_pack(w_pack: Optional[torch.Tensor], x_proj: torch.Tensor,
                w_hh: torch.Tensor) -> None:
    """A caller's ``w_pack`` (K1, K2) is bf16, on ``w_hh``'s device, in
    the shape :func:`pack_w_hh_fwd` gives for ``tc_layout(B, H)``."""
    if w_pack is None:
        return
    B, H = x_proj.shape[1], w_hh.shape[1]
    lay = tc_layout(B, H)
    want = (lay.fwd_grid[0] * lay.rows, lay.hp)
    if (x_proj.dtype != torch.bfloat16 or w_pack.dtype != torch.bfloat16
            or tuple(w_pack.shape) != want or w_pack.device != w_hh.device
            or not w_pack.is_contiguous()):
        raise ValueError(
            f"w_pack must be pack_w_hh_fwd(w_hh, tc_layout({B}, {H})) for "
            f"bf16 inputs: contiguous bf16 {want} on {w_hh.device}, got "
            f"{w_pack.dtype} {tuple(w_pack.shape)} on {w_pack.device}")


def int8_copy_bytes(H: int) -> int:
    """The bytes bf16 K3 copies at a time from a row of the int8 ``W_hh``
    it reads in place (rows H bytes apart): for even H, the aligned
    16-byte chunks around a row's columns by cp.async (its 2-byte fragment
    reads then land on even offsets); for odd H, 1 by ordinary loads."""
    return 16 if H % 2 == 0 else 1


def _tc_operands(w_hh: torch.Tensor, h0: torch.Tensor,
                 layout: TensorCoreLayout, w_pack: Optional[torch.Tensor]):
    """The tensor-core forward step's ``W_hh`` (``w_pack``, or packed
    now; None for K3's int8 codes, read in place), its zero-padded ``(2,
    B, Hp)`` h scratch with ``h0`` in the first half, and the layout's ints
    for the C entry."""
    if w_pack is None and w_hh.dtype != torch.int8:
        w_pack = pack_w_hh_fwd(w_hh, layout)
    B, H = h0.shape
    h_pad = h0.new_zeros((2, B, layout.hp))
    h_pad[0, :, :H] = h0
    return w_pack, h_pad, [layout.hp, *layout.fwd_grid, layout.batch]


def fused_lstm_forward(x_proj: torch.Tensor, w_hh: torch.Tensor,
                       h0: torch.Tensor, c0: torch.Tensor,
                       with_gates: bool = False,
                       w_pack: Optional[torch.Tensor] = None):
    """``(x_proj (T, B, 4H), w_hh (4H, H), h0, c0 (B, H))`` ->
    ``(out (T, B, H), (h_T, c_T))``, all in one dtype (f32 or bf16).

    ``with_gates=True`` (K4) returns ``(out, (gates, c_prev), (h_T,
    c_T))``: the post-activation gates ``(T, B, 4H)`` in order i, f, g, o
    and the cell state each step read ``(T, B, H)``, in the input dtype.

    ``w_pack`` (bf16 K1 only): ``pack_w_hh_fwd(w_hh, tc_layout(B, H))``,
    held by the caller across calls (a frozen encoder keeps one); without
    it a bf16 call packs its own.

    CPU tensors run the plain version; CUDA tensors launch K1 or K4."""
    T, B, H = _check(x_proj, w_hh, h0, c0)
    if with_gates and w_pack is not None:
        raise ValueError("K4 packs W_hh itself: w_pack is K1's")
    _check_pack(w_pack, x_proj, w_hh)
    if x_proj.device.type == "cpu":
        return fused_lstm_forward_plain(x_proj, w_hh, h0, c0, with_gates)
    name = "K4" if with_gates else "K1"
    if x_proj.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {x_proj.device}")
    if not all(t.is_contiguous() for t in (x_proj, w_hh, h0, c0)):
        raise ValueError(f"{name} takes contiguous x_proj, w_hh, h0 and c0")
    kw = {"dtype": x_proj.dtype, "device": x_proj.device}
    out = torch.empty((T, B, H), **kw)
    h_t = torch.empty((B, H), **kw)
    c_t = torch.empty((B, H), **kw)
    gates = torch.empty((T, B, 4 * H), **kw) if with_gates else None
    c_seq = torch.empty((T, B, H), **kw) if with_gates else None
    if T == 0:
        h_t.copy_(h0)
        c_t.copy_(c0)
    else:
        c_scratch = torch.empty((B, H), **kw)
        lib = _build.load("fused_lstm", _bind)
        h_pad, tc = None, [0, 0, 0, 0]
        if x_proj.dtype == torch.bfloat16:  # the tensor-core step
            w_pack, h_pad, tc = _tc_operands(
                w_hh, h0, tc_layout(B, H, gates=with_gates), w_pack)
        if with_gates:  # K4's tile is fixed: no batch-rows argument
            entry, args, tc = lib.fused_lstm_forward_gates, [
                x_proj, w_hh, w_pack, h0, h_pad, c0, out, gates, c_seq,
                h_t, c_t, c_scratch], tc[:3]
        else:
            entry, args = lib.fused_lstm_forward, [
                x_proj, w_hh, w_pack, h0, h_pad, c0, out, h_t, c_t,
                c_scratch]
        with torch.cuda.device(x_proj.device):
            err = entry(_DTYPE_CODES[x_proj.dtype], *_ptrs(args), T, B, H,
                        *tc, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            msg = lib.fused_lstm_error_string(err).decode()
            raise RuntimeError(f"{name} fused_lstm_forward launch failed: "
                               f"{msg} (cudaError {err}) at T={T} B={B} "
                               f"H={H}")
        (gates_launches if with_gates else launches).add(T)
    if with_gates:
        return out, (gates, c_seq), (h_t, c_t)
    return out, (h_t, c_t)


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def fused_lstm_forward_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                             h0: torch.Tensor, c0: torch.Tensor,
                             with_gates: bool = False):
    """K1's (``with_gates=True``: K4's) function as a per-step PyTorch
    loop, with the kernel's rounding: gates and cell math in f32, h and c
    stored in the input dtype after every step, and K4's gates and
    pre-step cell state stored in the input dtype too. Differentiable, so
    autograd through it is the reference for K4 and K5 together."""
    _check(x_proj, w_hh, h0, c0)
    _require_full_f32(x_proj, "K1")
    T, B, _ = x_proj.shape
    dtype = x_proj.dtype
    acc = _acc(dtype)
    w_t = w_hh.to(acc).t()  # (H, 4H)
    h, c = h0, c0
    outs, gates_seq, c_seq = [], [], []
    for t in range(T):
        gates = x_proj[t].to(acc) + h.to(acc) @ w_t
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c_new = f * c.to(acc) + i * g
        h_new = o * torch.tanh(c_new)
        if with_gates:
            gates_seq.append(torch.cat([i, f, g, o], dim=-1).to(dtype))
            c_seq.append(c)
        h, c = h_new.to(dtype), c_new.to(dtype)
        outs.append(h)
    out = (torch.stack(outs) if outs else
           x_proj.new_empty((0, B, w_hh.shape[1])))
    if not with_gates:
        return out, (h, c)
    if T == 0:
        return (out, (x_proj.new_empty((0, B, w_hh.shape[0])),
                      x_proj.new_empty((0, B, w_hh.shape[1]))), (h, c))
    return out, (torch.stack(gates_seq), torch.stack(c_seq)), (h, c)


def _check_bwd(gates, c_prev, d_out, w_hh, dh_t, dc_t) -> Tuple[int, int, int]:
    if gates.dim() != 3 or gates.shape[2] % 4:
        raise ValueError(f"gates must be (T, B, 4H), got {tuple(gates.shape)}")
    T, B, G = gates.shape
    H = G // 4
    want = {"c_prev": (c_prev, (T, B, H)), "d_out": (d_out, (T, B, H)),
            "w_hh": (w_hh, (G, H)), "dh_t": (dh_t, (B, H)),
            "dc_t": (dc_t, (B, H))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    tensors = (gates, c_prev, d_out, w_hh, dh_t, dc_t)
    if any(t.device != gates.device for t in tensors):
        raise ValueError("K5's tensors must be on one device")
    _check_dtype(gates)
    if any(t.dtype != gates.dtype for t in (c_prev, w_hh)):
        raise TypeError("gates, c_prev and w_hh must share one dtype")
    return T, B, H


def fused_lstm_backward(gates: torch.Tensor, c_prev: torch.Tensor,
                        d_out: torch.Tensor, w_hh: torch.Tensor,
                        dh_t: torch.Tensor, dc_t: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: the adjoint of K4's recurrence over a window, in reverse time.

    ``gates (T, B, 4H)`` and ``c_prev (T, B, H)`` are K4's residuals,
    ``d_out (T, B, H)`` the output cotangent, ``w_hh (4H, H)`` the
    recurrent weights the forward ran with, ``dh_t, dc_t (B, H)`` the
    final-state cotangents. ``d_out``, ``dh_t`` and ``dc_t`` are rounded to
    the gates' dtype on entry. Returns ``(dz (T, B, 4H), dh0, dc0)`` in
    that dtype: the pre-activation gradients and the initial-state
    cotangents. The carry is f32 throughout.

    CPU tensors run the plain version; CUDA tensors launch K5."""
    T, B, H = _check_bwd(gates, c_prev, d_out, w_hh, dh_t, dc_t)
    if gates.device.type == "cpu":
        return fused_lstm_backward_plain(gates, c_prev, d_out, w_hh, dh_t,
                                         dc_t)
    if gates.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {gates.device}")
    dtype = gates.dtype
    d_out, dh_t = (t.to(dtype).contiguous() for t in (d_out, dh_t))
    if not all(t.is_contiguous() for t in (gates, c_prev, w_hh)):
        raise ValueError("K5 takes contiguous gates, c_prev and w_hh")
    # the f32 carry, a buffer of its own that the kernel updates in place
    dc = torch.empty((B, H), dtype=torch.float32, device=gates.device)
    dc.copy_(dc_t.to(dtype))
    if T == 0:
        return gates.new_empty((0, B, 4 * H)), dh_t, dc.to(dtype)
    kw = {"dtype": dtype, "device": gates.device}
    dz = torch.empty((T, B, 4 * H), **kw)
    dh0 = torch.empty((B, H), **kw)
    dc0 = torch.empty((B, H), **kw)
    w_pack, dz_pad, tc = None, None, [0, 0, 0, 0]
    if dtype == torch.bfloat16:  # the tensor-core step
        lay = tc_layout(B, H)
        w_pack = pack_w_hh_bwd(w_hh, lay)
        dz_pad = torch.zeros((2, B, 4 * lay.hp), **kw)
        tc = [lay.hp, *lay.bwd_grid]
    lib = _build.load("fused_lstm", _bind)
    with torch.cuda.device(gates.device):
        err = lib.fused_lstm_backward(
            _DTYPE_CODES[dtype], *_ptrs([gates, c_prev, d_out, w_hh, w_pack,
                                         dh_t, dc, dz, dz_pad, dh0, dc0]),
            T, B, H, *tc, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.fused_lstm_error_string(err).decode()
        raise RuntimeError(f"K5 fused_lstm_backward launch failed: {msg} "
                           f"(cudaError {err}) at T={T} B={B} H={H}")
    backward_launches.add(T + 1)  # a launch per step, and one for dh0
    return dz, dh0, dc0


def fused_lstm_backward_plain(gates: torch.Tensor, c_prev: torch.Tensor,
                              d_out: torch.Tensor, w_hh: torch.Tensor,
                              dh_t: torch.Tensor, dc_t: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """K5's function as a reverse-time PyTorch loop with the kernel's
    rounding: an f32 carry, ``dz`` stored in the gates' dtype, and the
    product ``dz @ W_hh`` taken on that stored ``dz`` with f32 sums."""
    T, B, H = _check_bwd(gates, c_prev, d_out, w_hh, dh_t, dc_t)
    _require_full_f32(gates, "K5")
    dtype = gates.dtype
    acc = _acc(dtype)
    w = w_hh.to(acc)
    dh, dc = (t.to(dtype).to(acc) for t in (dh_t, dc_t))
    d_out = d_out.to(dtype)
    dz = torch.empty((T, B, 4 * H), dtype=dtype, device=gates.device)
    for t in reversed(range(T)):
        i, f, g, o = gates[t].to(acc).chunk(4, dim=-1)
        cp = c_prev[t].to(acc)
        tanh_c = torch.tanh(f * cp + i * g)
        dh = dh + d_out[t].to(acc)
        do = dh * tanh_c
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        dz[t] = torch.cat([(dc * g) * i * (1.0 - i),
                           (dc * cp) * f * (1.0 - f),
                           (dc * i) * (1.0 - g * g),
                           do * o * (1.0 - o)], dim=-1).to(dtype)
        dh = dz[t].to(acc) @ w
        dc = dc * f
    return dz, dh.to(dtype), dc.to(dtype)


def fused_lstm_forward_ragged(x_proj: torch.Tensor, w_hh: torch.Tensor,
                              h0: torch.Tensor, c0: torch.Tensor,
                              valid_lens: torch.Tensor,
                              t_live: Optional[int] = None,
                              w_pack: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, LSTMState]:
    """K2: ``fused_lstm_forward`` plus ``valid_lens (B,) int32``. Row b's
    outputs equal the dense recurrence's for ``t < valid_lens[b]`` and are
    exactly 0 after; ``(h_T, c_T)`` is each row's carry after
    ``min(valid, T)`` steps.

    ``t_live`` is a host int ``>= min(T, max(valid_lens))`` known to the
    caller (the scheduler has the lengths in its host staging block): the
    kernel launches only that many steps and zero-fills the rest, without
    reading ``valid_lens`` back. ``None`` launches all T steps, which is
    exact too. ``w_pack`` as for K1. CPU tensors run the plain version;
    CUDA tensors launch K2."""
    _check(x_proj, w_hh, h0, c0)
    steps = _check_ragged(x_proj, valid_lens, t_live)
    _check_pack(w_pack, x_proj, w_hh)
    if x_proj.device.type == "cpu":
        return fused_lstm_forward_ragged_plain(x_proj, w_hh, h0, c0,
                                               valid_lens)
    return _launch_ragged("K2", "fused_lstm_forward_ragged", ragged_launches,
                          x_proj, (w_hh,), h0, c0, valid_lens, steps,
                          w_pack=w_pack)


def fused_lstm_forward_ragged_int8(x_proj: torch.Tensor,
                                   w_hh_q: torch.Tensor,
                                   w_hh_scale: torch.Tensor,
                                   h0: torch.Tensor, c0: torch.Tensor,
                                   valid_lens: torch.Tensor,
                                   t_live: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, LSTMState]:
    """K3: K2 with ``w_hh_q (4H, H) int8`` and ``w_hh_scale (4H,) f32``,
    one scale per output row, applied to the product ``h @ w_hh_q^T``
    before ``x_proj`` is added. Activations are f32 or bf16 (bf16: on the
    tensor cores, reading the codes in place). CPU tensors run the plain
    version; CUDA tensors launch K3."""
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
                   c0: torch.Tensor, valid_lens: torch.Tensor, steps: int,
                   w_pack: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, LSTMState]:
    """Launch K2 or K3 (the C function ``entry``, whose weight arguments
    are ``weights``) for ``steps`` live steps on the tensors' card. The
    entry ends with the tensor-core step's operands, which bf16 fills and
    f32 leaves null and 0: K2's ``w_pack`` (or ``W_hh`` packed now) and
    the h scratch; K3's h scratch and its copy width."""
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
    h_pad, tc = None, [0, 0, 0, 0]
    if x_proj.dtype == torch.bfloat16:
        w_pack, h_pad, tc = _tc_operands(weights[0], h0, tc_layout(B, H),
                                         w_pack)
    int8 = weights[0].dtype == torch.int8
    tail = [h_pad] if int8 else [w_pack, h_pad]
    if int8:
        tc.append(int8_copy_bytes(H))
    lib = _build.load("fused_lstm", _bind)
    with torch.cuda.device(x_proj.device):
        err = getattr(lib, entry)(
            _DTYPE_CODES[x_proj.dtype],
            *_ptrs([x_proj, *weights, valid_lens, h0, c0, out, h_t, c_t,
                    h_scr, c_scr, *tail]),
            T, steps, B, H, *tc, torch.cuda.current_stream().cuda_stream)
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


class _LSTMLayerFused(torch.autograd.Function):
    """One LSTM layer whose forward is K4 and whose backward is K5, then
    the weight, bias and input gradients as ``torch.matmul`` in f32: the
    JAX package's ``lstm_layer_fused`` ``custom_vjp`` (``_fwd``/``_bwd``)."""

    @staticmethod
    def forward(ctx, x, h0, c0, w_ih, w_hh, bias):
        x_proj = project_time_major(x, w_ih, bias)
        out, (gates, c_prev), (h_t, c_t) = fused_lstm_forward(
            x_proj, w_hh, h0, c0, with_gates=True)
        ctx.save_for_backward(x, h0, w_ih, w_hh, out, gates, c_prev)
        ctx.dtypes = (c0.dtype, bias.dtype)
        return out, h_t, c_t

    @staticmethod
    def backward(ctx, d_out, d_h_t, d_c_t):
        x, h0, w_ih, w_hh, out, gates, c_prev = ctx.saved_tensors
        c0_dtype, bias_dtype = ctx.dtypes
        dz, dh0, dc0 = fused_lstm_backward(gates, c_prev, d_out, w_hh,
                                           d_h_t, d_c_t)
        T, B, G = dz.shape
        acc = _acc(gates.dtype)
        dz = dz.to(acc).reshape(T * B, G)
        h_prev = torch.cat([h0.to(acc)[None], out[:-1].to(acc)])
        x_tm = x.transpose(0, 1).reshape(T * B, -1).to(acc)
        d_w_hh = dz.t() @ h_prev.reshape(T * B, -1)
        d_w_ih = dz.t() @ x_tm
        d_x = (dz @ w_ih.to(acc)).view(T, B, -1).transpose(0, 1)
        return (d_x.to(x.dtype), dh0.to(h0.dtype), dc0.to(c0_dtype),
                d_w_ih.to(w_ih.dtype), d_w_hh.to(w_hh.dtype),
                dz.sum(0).to(bias_dtype))


def lstm_layer_fused(x: torch.Tensor, state: LSTMState, w_ih: torch.Tensor,
                     w_hh: torch.Tensor, bias: torch.Tensor,
                     w_pack: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, LSTMState]:
    """One LSTM layer: ``x (B, T, in)`` -> ``(out (B, T, H), (h_T,
    c_T))``; ``out`` is a batch-major view of the kernel's time-major
    output. When autograd needs a gradient of any input, the forward is
    K4 and the backward K5; otherwise the forward is K1, on ``w_pack`` when
    given (see :func:`fused_lstm_forward`), and nothing is kept for a
    backward. DropConnect, if any, is already in ``w_hh``."""
    dtype = torch.result_type(x, w_ih)
    h0, c0 = (s.to(dtype).contiguous() for s in state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, h0, c0, w_ih, w_hh, bias)):
        out, h_t, c_t = _LSTMLayerFused.apply(x, h0, c0, w_ih, w_hh, bias)
        return out.transpose(0, 1), (h_t, c_t)
    x_proj = project_time_major(x, w_ih, bias)
    out, st = fused_lstm_forward(x_proj, w_hh, h0, c0, w_pack=w_pack)
    return out.transpose(0, 1), st


def lstm_layer_fused_ragged(x: torch.Tensor, state: LSTMState,
                            w_ih: torch.Tensor, w_hh: torch.Tensor,
                            bias: torch.Tensor, valid_lens: torch.Tensor,
                            t_live: Optional[int] = None, plain: bool = False,
                            w_pack: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, LSTMState]:
    """One LSTM layer through K2 (``plain=True``: its plain version):
    ``x (B, T, in)`` and ``valid_lens (B,) int32`` -> ``(out (B, T, H),
    (h_T, c_T))``, with zeros past each row's valid length. K2 takes
    ``w_pack`` as :func:`fused_lstm_forward` does."""
    x_proj = project_time_major(x, w_ih, bias)
    dtype = x_proj.dtype
    h0, c0 = state
    h0, c0 = h0.to(dtype).contiguous(), c0.to(dtype).contiguous()
    if plain:
        out, st = fused_lstm_forward_ragged_plain(x_proj, w_hh, h0, c0,
                                                  valid_lens, t_live)
    else:
        out, st = fused_lstm_forward_ragged(x_proj, w_hh, h0, c0, valid_lens,
                                            t_live, w_pack=w_pack)
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
