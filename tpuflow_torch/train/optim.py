"""Optimizers.

Counterpart of ``tpuflow/train/optim.py``. The reference's optimizer
(reference cnn.py:117-118) is ``SGD(lr=0.001, momentum=0.99, decay=1e-6,
nesterov=True)``; Keras-era ``decay`` is a per-update learning-rate decay,
``lr_k = lr / (1 + decay * k)`` before update k, counting from 0 as optax's
schedule counts.

A torch optimizer needs its parameters when it is built, so the port splits
an optax transformation in two: an ``OptimizerSpec`` (what to build, the
schedule, the clip) and ``Optimizer``, the spec bound to a model's
parameters, whose ``step()`` applies the update rules optax puts around the
base optimizer:
- the global gradient norm, returned as a device tensor (``steps.py:82``);
- ``clip_by_global_norm`` as optax writes it: ``g / ||g|| * max`` when
  ``||g|| >= max``, with no epsilon (``torch.nn.utils.clip_grad_norm_``
  adds 1e-6 and differs);
- the learning rate of the schedule, set before each update.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

@dataclass(frozen=True)
class OptimizerSpec:
    """A base torch optimizer, its learning-rate schedule and the global-norm
    clip: ``bind(params)`` builds it."""

    make: Callable[[list], torch.optim.Optimizer]
    schedule: Callable[[int], float] | None = None  # lr before update k
    clip_norm: float = 0.0

    def bind(self, params) -> "Optimizer":
        return Optimizer(self, list(params))


class Optimizer:
    """An ``OptimizerSpec`` bound to parameters. ``step()`` updates them from
    their ``.grad`` and returns the global norm of the raw gradients as a
    device tensor (no host sync)."""

    def __init__(self, spec: OptimizerSpec, params: list):
        self.spec = spec
        self.params = params
        self.base = spec.make(params)
        self.count = 0  # updates applied, optax's schedule count

    def zero_grad(self) -> None:
        self.base.zero_grad(set_to_none=True)

    def global_norm(self) -> torch.Tensor:
        return torch.sqrt(sum(torch.sum(torch.square(p.grad)) for p in self.params))

    def step(self) -> torch.Tensor:
        gnorm = self.global_norm()
        if self.spec.clip_norm:
            keep = gnorm < self.spec.clip_norm
            for p in self.params:
                p.grad.copy_(torch.where(keep, p.grad, p.grad / gnorm * self.spec.clip_norm))
        if self.spec.schedule is not None:
            lr = self.spec.schedule(self.count)
            for group in self.base.param_groups:
                group["lr"] = lr
        self.base.step()
        self.count += 1
        return gnorm


def keras_sgd(
    learning_rate: float = 1e-3,
    momentum: float = 0.99,
    decay: float = 1e-6,
    nesterov: bool = True,
) -> OptimizerSpec:
    """SGD with Keras-style inverse-time lr decay (reference defaults).
    torch's Nesterov SGD (buffer ``b = m*b + g``, update ``g + m*b``) is
    optax's ``trace(nesterov=True)`` update for update."""

    def schedule(step: int) -> float:
        return learning_rate / (1.0 + decay * step)

    return OptimizerSpec(
        make=lambda params: torch.optim.SGD(
            params, lr=learning_rate, momentum=momentum, nesterov=nesterov
        ),
        schedule=schedule,
    )


def _adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8) -> OptimizerSpec:
    return OptimizerSpec(
        make=lambda params: torch.optim.Adam(
            params, lr=learning_rate, betas=(b1, b2), eps=eps
        )
    )


def _adamw(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8, weight_decay: float = 1e-4) -> OptimizerSpec:
    # optax.adamw's weight decay defaults to 1e-4 (torch's to 1e-2), so it
    # is passed explicitly.
    return OptimizerSpec(
        make=lambda params: torch.optim.AdamW(
            params, lr=learning_rate, betas=(b1, b2), eps=eps,
            weight_decay=weight_decay,
        )
    )


OPTIMIZERS = {
    "keras_sgd": keras_sgd,
    "adam": _adam,
    "adamw": _adamw,
}


def build_optimizer(name: str = "keras_sgd", **kwargs) -> OptimizerSpec:
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; known: {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](**kwargs)


def wrap_optimizer(
    spec: OptimizerSpec, clip_norm: float = 0.0, accumulate_steps: int = 1
) -> OptimizerSpec:
    """Optional global-norm gradient clipping around any base optimizer."""
    if clip_norm < 0:
        # A negative max norm would flip the sign of every clipped update.
        raise ValueError(f"clip_norm must be >= 0, got {clip_norm}")
    if accumulate_steps < 1:
        raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
    if accumulate_steps > 1:
        raise NotImplementedError(
            "accumulate_steps > 1 (optax.MultiSteps gradient accumulation) is "
            "not ported yet to tpuflow_torch (ROADMAP.md Queue 1 item 6)"
        )
    return dataclasses.replace(spec, clip_norm=float(clip_norm))
