"""Training losses.

Counterpart of ``tpuflow/core/losses.py``. The reference's loss is the
clipped MAE with CLIP_VALUE = 6 (reference cnn.py:29-32, 37):

    mae_clip(y_true, y_pred) = mean(clip(|y_true - y_pred|, 0, 6))

It runs through the kernel wrapper ``tpuflow_torch.kernels.losses.mae_clip``
(``csrc/mae_clip.cu`` on the card, its plain version on the CPU). The
registry accepts both JAX names, ``mae_clip`` and ``mae_clip_pallas``; they
mean the same math, as ``backend`` does for the LSTM. ``mae``, ``mse`` and
``huber`` are plain torch, as they are plain ``jnp`` in JAX.

Every registered loss carries ``rows``, its per-example form over ``[B,
...]`` operands in one call: what ``jax.vmap(loss_fn)(y, pred)`` gives the
eval step (``per_example``).
"""

from __future__ import annotations

import torch

from tpuflow_torch.kernels import losses as _kernels

CLIP_VALUE = 6.0


def _rows(y_true: torch.Tensor, y_pred: torch.Tensor):
    return y_true.reshape(y_true.shape[0], -1), y_pred.reshape(y_pred.shape[0], -1)


def mae_clip(
    y_true: torch.Tensor, y_pred: torch.Tensor, clip_value: float = CLIP_VALUE
) -> torch.Tensor:
    """Clipped MAE: mean(clip(|y_true - y_pred|, 0, clip_value))."""
    return _kernels.mae_clip(y_true, y_pred, clip_value)


def mae(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Mean absolute error."""
    return torch.mean(torch.abs(y_true - y_pred))


def mse(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Mean squared error."""
    return torch.mean(torch.square(y_true - y_pred))


def _huber_terms(err: torch.Tensor, delta: float) -> torch.Tensor:
    quad = torch.clamp(err, max=delta)
    return 0.5 * quad**2 + delta * (err - quad)


def huber(
    y_true: torch.Tensor, y_pred: torch.Tensor, delta: float = 1.0
) -> torch.Tensor:
    """Huber loss: quadratic within ``delta``, linear outside."""
    return torch.mean(_huber_terms(torch.abs(y_true - y_pred), delta))


mae_clip.rows = lambda yt, yp: _kernels.mae_clip_rows(
    *(t.contiguous() for t in _rows(yt, yp)), CLIP_VALUE
)
mae.rows = lambda yt, yp: torch.abs(yt - yp).reshape(yt.shape[0], -1).mean(dim=1)
mse.rows = lambda yt, yp: torch.square(yt - yp).reshape(yt.shape[0], -1).mean(dim=1)
huber.rows = lambda yt, yp: _huber_terms(torch.abs(yt - yp), 1.0).reshape(
    yt.shape[0], -1
).mean(dim=1)


def per_example(loss_fn, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """``[B]`` per-example losses, as ``jax.vmap(loss_fn)(y_true, y_pred)``:
    the loss's ``rows`` form in one call, or one call per example for a
    loss without one."""
    rows = getattr(loss_fn, "rows", None)
    if rows is not None:
        return rows(y_true, y_pred)
    return torch.stack([loss_fn(t, p) for t, p in zip(y_true, y_pred)])


LOSSES = {
    "mae_clip": mae_clip,
    "mae": mae,
    "mse": mse,
    "huber": huber,
    "mae_clip_pallas": mae_clip,
}
