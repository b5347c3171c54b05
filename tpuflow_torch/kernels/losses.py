"""Fused clipped-MAE reduction: the hand-written Hopper kernel and its plain version.

Counterpart of ``tpuflow/kernels/losses.py::mae_clip_pallas``:
``mean(clip(|y_true - y_pred|, 0, clip))``, the reference's loss with clip 6.

Kernel: ``csrc/mae_clip.cu``, which replaces the Pallas TPU kernel
``tpuflow/kernels/losses.py::_sum_kernel`` (launched by
``_clipped_abs_sum``). It gains a row axis, ``[R, N] -> sums [R]`` in f32,
so one launch gives both the train loss (one row over the flattened batch)
and the eval step's per-example losses (one row per example). It is bound
by bytes (8 read for 4 operations per element), and at the training shapes
by the launch. The forward is one pass of per-block partials and, for rows
wider than one block's chunk, a second pass that sums them in a fixed order.
The backward is the JAX package's closed-form subgradient in plain torch
(``losses.py:99-106``): elementwise, no kernel there either.

``mae_clip_rows`` on a CUDA tensor launches the kernel or raises; on a CPU
tensor it runs ``mae_clip_reference``. There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpuflow_torch.kernels import _build

_count_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("mae_clip")
        fn = lib.tpuflow_mae_clip_sums_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.tpuflow_mae_clip_chunks.argtypes = [ctypes.c_int64]
        lib.tpuflow_mae_clip_chunks.restype = ctypes.c_int64
        _lib = lib
    return _lib


def _check_rows(y_true: torch.Tensor, y_pred: torch.Tensor) -> tuple[int, int]:
    if y_true.dim() != 2 or y_true.shape != y_pred.shape:
        raise ValueError(
            "mae_clip_rows: y_true and y_pred must both be [R, N], got "
            f"{tuple(y_true.shape)} and {tuple(y_pred.shape)}"
        )
    return y_true.shape[0], y_true.shape[1]


def mae_clip_reference(
    y_true: torch.Tensor, y_pred: torch.Tensor, clip: float
) -> torch.Tensor:
    """The plain PyTorch version: per-row ``mean(clip(|y_true - y_pred|, 0,
    clip))`` of ``[R, N]`` operands, ``[R]`` in f32."""
    _check_rows(y_true, y_pred)
    diff = torch.abs(y_true.to(torch.float32) - y_pred.to(torch.float32))
    return torch.clamp(diff, 0.0, clip).sum(dim=1) / y_true.shape[1]


def mae_clip_rows(
    y_true: torch.Tensor, y_pred: torch.Tensor, clip: float
) -> torch.Tensor:
    """Per-row clipped MAE of ``[R, N]`` operands: ``[R]`` f32, the sums
    accumulated in f32 and divided by N.

    CUDA tensors go through ``csrc/mae_clip.cu`` (f32, contiguous, one
    device, R <= 65535) and count one launch in ``mae_clip_rows.launches``;
    CPU tensors go through ``mae_clip_reference``. Not differentiable: the
    loss with its gradient is ``mae_clip``.
    """
    R, N = _check_rows(y_true, y_pred)
    if y_pred.device != y_true.device:
        raise ValueError(
            f"mae_clip_rows: y_pred is on {y_pred.device}, y_true on {y_true.device}"
        )
    if y_true.device.type == "cpu":
        return mae_clip_reference(y_true, y_pred, clip)
    if y_true.device.type != "cuda":
        raise ValueError(f"mae_clip_rows runs on cuda or cpu, got {y_true.device}")
    for name, t in (("y_true", y_true), ("y_pred", y_pred)):
        if t.dtype != torch.float32:
            raise TypeError(f"mae_clip_rows: the CUDA kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mae_clip_rows: {name} must be contiguous")
    if R > 65535 or N == 0:
        raise ValueError(
            f"mae_clip_rows: the CUDA kernel takes 1..65535 rows of at least "
            f"one element, got [{R}, {N}]"
        )
    sums = torch.empty(R, dtype=torch.float32, device=y_true.device)
    if R == 0:
        return sums
    lib = _library()
    chunks = lib.tpuflow_mae_clip_chunks(N)
    partials = torch.empty(
        (R, chunks if chunks > 1 else 0), dtype=torch.float32, device=y_true.device
    )
    with torch.cuda.device(y_true.device):
        code = lib.tpuflow_mae_clip_sums_f32(
            y_true.data_ptr(), y_pred.data_ptr(), partials.data_ptr(),
            sums.data_ptr(), R, N, float(clip),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, f"mae_clip launch (R={R}, N={N})")
    with _count_lock:
        mae_clip_rows.launches += 1
    return sums / N


mae_clip_rows.launches = 0


class _MaeClip(torch.autograd.Function):
    """``mean(clip(|y_true - y_pred|, 0, clip))`` with the JAX package's
    subgradient: ``sign(d) * (|d| < clip) * g / n`` for ``y_true`` and its
    negation for ``y_pred`` (zero where saturated, zero at d = 0)."""

    @staticmethod
    def forward(ctx, y_true, y_pred, clip):
        ctx.save_for_backward(y_true, y_pred)
        ctx.clip = clip
        return mae_clip_rows(
            y_true.reshape(1, -1).contiguous(),
            y_pred.reshape(1, -1).contiguous(),
            clip,
        )[0]

    @staticmethod
    def backward(ctx, g):
        y_true, y_pred = ctx.saved_tensors
        diff = y_true.to(torch.float32) - y_pred.to(torch.float32)
        inner = torch.sign(diff) * (torch.abs(diff) < ctx.clip)
        dyt = (g / y_true.numel() * inner).to(y_true.dtype)
        return dyt, (-dyt).to(y_pred.dtype), None


def mae_clip(
    y_true: torch.Tensor, y_pred: torch.Tensor, clip: float
) -> torch.Tensor:
    """Fused ``mean(clip(|y_true - y_pred|, 0, clip))`` over all elements,
    a differentiable scalar: one row of the kernel over the flattened
    operands, divided by n, as ``mae_clip_pallas`` does."""
    if y_true.shape != y_pred.shape:
        raise ValueError(
            f"mae_clip: shapes differ, {tuple(y_true.shape)} and {tuple(y_pred.shape)}"
        )
    return _MaeClip.apply(y_true, y_pred, clip)
