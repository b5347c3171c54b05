"""Sequence windowing for the LSTM family.

Counterpart of ``tpuflow/data/windows.py``, the numpy path: windows are
materialized host-side as static-shape float32 arrays, byte-identical to
the JAX package's. The native ``csv.cc`` windowing binding is not ported
yet (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import numpy as np

DEFAULT_WINDOW = 24


def _validate(series, targets, length, stride):
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if length < 1:
        raise ValueError(f"window length must be >= 1, got {length}")
    if targets.shape[0] != series.shape[0]:
        raise ValueError(
            f"targets length {targets.shape[0]} != series length "
            f"{series.shape[0]}"
        )


def _strided_view(arr: np.ndarray, length: int, stride: int) -> np.ndarray:
    """All length-windows of ``arr`` along axis 0 at ``stride``, from a
    zero-copy stride-trick view indexed once; time becomes axis 1
    (``[N, length, F]`` / ``[N, length]``)."""
    view = np.lib.stride_tricks.sliding_window_view(arr, length, axis=0)
    idx = np.arange(0, arr.shape[0] - length + 1, stride)
    return np.ascontiguousarray(np.moveaxis(view[idx], -1, 1))


def sliding_windows(
    series: np.ndarray,
    targets: np.ndarray,
    length: int = DEFAULT_WINDOW,
    stride: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Windows over one well's log: ``series [T, F]``, ``targets [T]`` ->
    ``(windows [N, length, F], y [N])``, ``y[i]`` the target at the window's
    last step."""
    _validate(series, targets, length, stride)
    T = series.shape[0]
    if T < length:
        return (
            np.zeros((0, length, series.shape[1]), dtype=np.float32),
            np.zeros((0,), dtype=np.float32),
        )
    starts = np.arange(0, T - length + 1, stride)
    windows = _strided_view(series, length, stride)
    y = targets[starts + length - 1]
    return windows.astype(np.float32, copy=False), y.astype(np.float32, copy=False)


def teacher_forcing_pairs(
    series: np.ndarray,
    targets: np.ndarray,
    length: int = DEFAULT_WINDOW,
    stride: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Teacher-forced sequence pairs for LSTM training: ``(windows [N,
    length, F], y [N, length])``, a target for every step."""
    _validate(series, targets, length, stride)
    T = series.shape[0]
    if T < length:
        return (
            np.zeros((0, length, series.shape[1]), dtype=np.float32),
            np.zeros((0, length), dtype=np.float32),
        )
    windows = _strided_view(series, length, stride)
    y = _strided_view(targets, length, stride)
    return windows.astype(np.float32, copy=False), y.astype(np.float32, copy=False)
