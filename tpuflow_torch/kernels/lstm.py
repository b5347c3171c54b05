"""Fused LSTM recurrence: the hand-written Hopper kernel and its plain version.

Counterpart of ``tpuflow/kernels/lstm.py::lstm_scan`` (forward only: the
serving path). The surrounding layer (``tpuflow_torch.models.lstm``) hoists
the input projection ``x @ W_x`` out of the recurrence as one matmul; what
remains, ``h @ W_h`` plus the gate math for every step, runs here.

Kernel: ``csrc/lstm_fwd.cu``, which replaces the Pallas TPU kernel
``tpuflow/kernels/lstm.py::_fwd_kernel`` (launched by ``_fwd``). On an H100
it is bound by operations: at the serving shape (T=24, B=4096, H=64) the
recurrent product is 3.2 GFLOP on the f32 CUDA cores against 125 MB of
``xw`` read and ``hs`` written. Its design keeps ``W_h`` in shared memory
for all steps, ``h`` in shared memory, ``c`` in registers, and gives each
thread the four gate columns of one hidden unit so the gate math needs no
exchange between threads (the source says more).

``lstm_scan`` on a CUDA tensor launches that kernel or raises; on a CPU
tensor it runs ``lstm_scan_reference``, the plain PyTorch version. There is
no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpuflow_torch.kernels import _build

_STEM = "lstm_fwd"
_count_lock = threading.Lock()
_lib = None


def _check_shapes(xw, wh, b, cs_out) -> tuple[int, int, int]:
    if xw.dim() != 3 or xw.shape[2] % 4:
        raise ValueError(f"lstm_scan: xw must be [T, B, 4H], got {tuple(xw.shape)}")
    T, B, H4 = xw.shape
    H = H4 // 4
    if tuple(wh.shape) != (H, H4) or tuple(b.shape) != (H4,):
        raise ValueError(
            f"lstm_scan: xw {tuple(xw.shape)} needs wh [{H}, {H4}] and "
            f"b [{H4}], got {tuple(wh.shape)} and {tuple(b.shape)}"
        )
    if cs_out is not None and tuple(cs_out.shape) != (T, B, H):
        raise ValueError(
            f"lstm_scan: cs_out must be [{T}, {B}, {H}], got "
            f"{tuple(cs_out.shape)}"
        )
    return T, B, H


def lstm_scan_reference(
    xw: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``(hs, cs)``, both ``[T, B, H]`` in
    ``xw``'s dtype. The cell state is carried in f32 and ``h`` in ``xw``'s
    dtype, as in the TPU kernel."""
    T, B, H = _check_shapes(xw, wh, b, None)
    f32 = torch.float32
    wh32, b32 = wh.to(f32), b.to(f32)
    h = torch.zeros((B, H), dtype=xw.dtype, device=xw.device)
    c = torch.zeros((B, H), dtype=f32, device=xw.device)
    hs = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    cs = torch.empty_like(hs)
    for t in range(T):
        z = xw[t].to(f32) + h.to(f32) @ wh32 + b32
        i, f, g, o = z.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(xw.dtype)
        hs[t] = h
        cs[t] = c.to(xw.dtype)
    return hs, cs


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_STEM)
        fn = lib.tpuflow_lstm_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def lstm_scan(
    xw: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    cs_out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused LSTM recurrence: ``xw [T, B, 4H] -> hs [T, B, H]`` (time-major,
    gate order i, f, g, o, zero initial state). ``wh [H, 4H]`` is the
    recurrent weight, ``b [4H]`` the bias. When ``cs_out`` is given, the
    cell states are written into it too.

    CUDA tensors go through ``csrc/lstm_fwd.cu`` (f32, contiguous, one
    device) and count one launch in ``lstm_scan.launches``; CPU tensors go
    through ``lstm_scan_reference``.
    """
    T, B, H = _check_shapes(xw, wh, b, cs_out)
    if xw.device.type == "cpu":
        hs, cs = lstm_scan_reference(xw, wh, b)
        if cs_out is not None:
            cs_out.copy_(cs)
        return hs
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_scan runs on cuda or cpu, got {xw.device}")
    args = [xw, wh, b] + ([] if cs_out is None else [cs_out])
    for name, t in zip(("xw", "wh", "b", "cs_out"), args):
        if t.device != xw.device:
            raise ValueError(f"lstm_scan: {name} is on {t.device}, xw on {xw.device}")
        if t.dtype != torch.float32:
            raise TypeError(
                f"lstm_scan: the CUDA kernel takes float32, {name} is {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"lstm_scan: {name} must be contiguous")
    hs = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    if T == 0 or B == 0:
        return hs
    lib = _library()
    with torch.cuda.device(xw.device):
        code = lib.tpuflow_lstm_fwd_f32(
            xw.data_ptr(), wh.data_ptr(), b.data_ptr(), hs.data_ptr(),
            None if cs_out is None else cs_out.data_ptr(),
            T, B, H, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(
        lib, code,
        f"lstm_fwd launch (T={T}, B={B}, H={H}; H must be a multiple of 4 "
        "and W_h plus the h tile must fit in shared memory)",
    )
    with _count_lock:
        lstm_scan.launches += 1
    return hs


lstm_scan.launches = 0
