"""Fused clipped-MAE loss: the hand-written Hopper kernels and their plain versions.

Counterpart of ``tpuflow/kernels/losses.py::mae_clip_pallas``:
``mean(clip(|y_true - y_pred|, 0, clip))``, the reference's loss with clip 6,
and its closed-form subgradient.

Kernels, both in ``csrc/mae_clip.cu`` and both bound by bytes (and at the
training shapes by the launch), so each call is one launch:
- ``mae_clip`` replaces the Pallas TPU kernel
  ``tpuflow/kernels/losses.py::_sum_kernel`` (launched by
  ``_clipped_abs_sum``). It gains a row axis, ``[R, N] -> means [R]`` in
  f32, so one launch gives both the train loss (one row over the flattened
  batch) and the eval step's per-example losses (one row per example). Rows
  of up to 1024 elements take a warp each; wider rows take blocks of 4096
  elements, whose partials the last block of the row (by an integer ticket
  from a counter in the call's own partials) sums in a fixed order.
- ``mae_clip_grad`` is the loss's backward, the JAX package's plain ``_bwd``
  (``losses.py:99``) that XLA fuses into one pass: ``dyt = (g / n) *
  sign(d) * (|d| < clip)`` and ``dyp = -dyt`` in one elementwise pass, ``g``
  read on the device.

``mae_clip_rows`` and ``mae_clip_grad`` on CUDA tensors launch their kernel
or raise; on CPU tensors they run ``mae_clip_reference`` and
``mae_clip_grad_reference``. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpuflow_torch.kernels import _build

MAX_ROWS = 65535

_count_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("mae_clip")
        ptr = ctypes.c_void_p
        fn = lib.tpuflow_mae_clip_means_f32
        fn.argtypes = [ptr] * 4 + [ctypes.c_int, ctypes.c_int64, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        lib.tpuflow_mae_clip_chunks.argtypes = [ctypes.c_int64]
        lib.tpuflow_mae_clip_chunks.restype = ctypes.c_int64
        fn = lib.tpuflow_mae_clip_grad_f32
        fn.argtypes = [ptr] * 5 + [ctypes.c_int64, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _runs_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA tensor
    (the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"mae_clip runs on cuda or cpu, got {t.device}")


def _launch(entry: str, what: str, *args) -> None:
    """Call C entry point ``entry`` of ``csrc/mae_clip.cu`` on the current
    stream of the first tensor's device (tensors pass as pointers) and raise
    if it returns a CUDA error."""
    lib = _library()
    device = next(a for a in args if torch.is_tensor(a)).device
    with torch.cuda.device(device):
        code = getattr(lib, entry)(
            *(a.data_ptr() if torch.is_tensor(a) else a for a in args),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, what)


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


def _check_card(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the CUDA kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


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

    CUDA tensors go through ``mae_clip`` in ``csrc/mae_clip.cu`` (f32,
    contiguous, one device, R <= 65535) and count one launch in
    ``mae_clip_rows.launches``; CPU tensors go through
    ``mae_clip_reference``. Not differentiable: the loss with its gradient
    is ``mae_clip``. Calls may run at once on several streams: a row wider
    than one block draws its tickets from a counter in the call's own
    partials.
    """
    R, N = _check_rows(y_true, y_pred)
    if y_pred.device != y_true.device:
        raise ValueError(
            f"mae_clip_rows: y_pred is on {y_pred.device}, y_true on {y_true.device}"
        )
    if _runs_plain(y_true):
        return mae_clip_reference(y_true, y_pred, clip)
    _check_card("mae_clip_rows", y_true=y_true, y_pred=y_pred)
    if R > MAX_ROWS or N == 0:
        raise ValueError(
            f"mae_clip_rows: the CUDA kernel takes 1..{MAX_ROWS} rows of at least "
            f"one element, got [{R}, {N}]"
        )
    means = torch.empty(R, dtype=torch.float32, device=y_true.device)
    if R == 0:
        return means
    # A row's partials, as many as its blocks, and its ticket counter, all
    # zeroed on this stream before the launch; none for a row that one warp
    # or one block sums, which then launches nothing else.
    chunks = _library().tpuflow_mae_clip_chunks(N)
    if chunks > 1:
        partials = torch.zeros((R, chunks + 1), dtype=torch.float32, device=y_true.device)
    else:
        partials = torch.empty((R, 0), dtype=torch.float32, device=y_true.device)
    _launch("tpuflow_mae_clip_means_f32", f"mae_clip launch (R={R}, N={N})",
            y_true, y_pred, partials, means, R, N, float(clip))
    _count(mae_clip_rows)
    return means


def mae_clip_grad_reference(
    y_true: torch.Tensor, y_pred: torch.Tensor, g: torch.Tensor, clip: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the loss's backward (``losses.py::_bwd`` of the
    JAX package): ``(dyt, dyp)`` in f32, ``dyt = (g / n) * (sign(d) * (|d| <
    clip))`` for ``d = y_true - y_pred`` and ``dyp = -dyt``: zero where
    saturated, at d = 0 and where d is NaN (``|NaN| < clip`` is false, and
    ``torch.sign(NaN)`` is 0), as JAX's gradient is. ``g / n`` is a true
    division on every device (a CUDA tensor divided by a Python number is
    multiplied by its reciprocal instead)."""
    d = y_true.to(torch.float32) - y_pred.to(torch.float32)
    g32 = g.to(torch.float32)
    scale = g32 / torch.full_like(g32, float(y_true.numel()))
    dyt = scale * (torch.sign(d) * (torch.abs(d) < clip))
    return dyt, -dyt


def mae_clip_grad(
    y_true: torch.Tensor, y_pred: torch.Tensor, g: torch.Tensor, clip: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dyt, dyp)``, the gradients of ``mae_clip``'s mean for the upstream
    scalar ``g``, each shaped like its operand, in f32.

    CUDA tensors go through ``mae_clip_grad`` in ``csrc/mae_clip.cu`` (f32,
    contiguous, one device; ``g`` one element, read on the device) and count
    one launch in ``mae_clip_grad.launches``; CPU tensors go through
    ``mae_clip_grad_reference``."""
    if y_true.shape != y_pred.shape:
        raise ValueError(
            f"mae_clip_grad: shapes differ, {tuple(y_true.shape)} and {tuple(y_pred.shape)}"
        )
    for name, t in (("y_pred", y_pred), ("g", g)):
        if t.device != y_true.device:
            raise ValueError(f"mae_clip_grad: {name} is on {t.device}, y_true on {y_true.device}")
    if g.numel() != 1:
        raise ValueError(f"mae_clip_grad: g must hold one element, got {tuple(g.shape)}")
    if _runs_plain(y_true):
        return mae_clip_grad_reference(y_true, y_pred, g, clip)
    _check_card("mae_clip_grad", y_true=y_true, y_pred=y_pred, g=g)
    dyt, dyp = torch.empty_like(y_true), torch.empty_like(y_pred)
    n = y_true.numel()
    if n:
        _launch("tpuflow_mae_clip_grad_f32", f"mae_clip_grad launch (n={n})",
                y_true, y_pred, g, dyt, dyp, n, float(clip))
        _count(mae_clip_grad)
    return dyt, dyp


mae_clip_rows.launches = 0
mae_clip_grad.launches = 0


class _MaeClip(torch.autograd.Function):
    """``mean(clip(|y_true - y_pred|, 0, clip))`` with the JAX package's
    subgradient: ``sign(d) * (|d| < clip) * g / n`` for ``y_true`` and its
    negation for ``y_pred`` (zero where saturated, zero at d = 0), one
    ``mae_clip_grad`` launch on the card."""

    @staticmethod
    def forward(ctx, y_true, y_pred, clip):
        yt = y_true.reshape(1, -1).contiguous()
        yp = y_pred.reshape(1, -1).contiguous()
        ctx.save_for_backward(yt, yp)
        ctx.clip = clip
        ctx.dtypes = (y_true.dtype, y_pred.dtype)
        ctx.shape = y_true.shape
        return mae_clip_rows(yt, yp, clip)[0]

    @staticmethod
    def backward(ctx, g):
        yt, yp = ctx.saved_tensors
        dyt, dyp = mae_clip_grad(yt, yp, g, ctx.clip)
        return (dyt.view(ctx.shape).to(ctx.dtypes[0]),
                dyp.view(ctx.shape).to(ctx.dtypes[1]), None)


def mae_clip(
    y_true: torch.Tensor, y_pred: torch.Tensor, clip: float
) -> torch.Tensor:
    """Fused ``mean(clip(|y_true - y_pred|, 0, clip))`` over all elements,
    a differentiable scalar: one row of the kernel over the flattened
    operands, as ``mae_clip_pallas`` does."""
    if y_true.shape != y_pred.shape:
        raise ValueError(
            f"mae_clip: shapes differ, {tuple(y_true.shape)} and {tuple(y_pred.shape)}"
        )
    return _MaeClip.apply(y_true, y_pred, clip)
