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
- the learning rate of the schedule, computed before each update on the
  device from the update count, which is a device tensor too.

Nothing in ``step()`` reads a tensor back to the host, so a CUDA graph that
captures one step replays the schedule as it advances
(``tpuflow_torch/train/steps.py::make_epoch_step``): the Nesterov SGD is
written here as ``torch._foreach_*`` ops that take the learning rate as a
device tensor, and Adam and AdamW are built ``capturable`` on the card.
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
    # lr before update k, a device f32 scalar from the device count k.
    schedule: Callable[[torch.Tensor], torch.Tensor] | None = None
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
        # Updates applied, optax's schedule count, on the parameters' device.
        self.steps = torch.zeros((), dtype=torch.int32, device=params[0].device)

    @property
    def count(self) -> int:
        """Updates applied (a read-back from the device)."""
        return int(self.steps)

    def zero_grad(self) -> None:
        self.base.zero_grad(set_to_none=True)

    def global_norm(self) -> torch.Tensor:
        norms = torch._foreach_norm([p.grad for p in self.params])
        return torch.linalg.vector_norm(torch.stack(norms))

    def step(self) -> torch.Tensor:
        gnorm = self.global_norm()
        if self.spec.clip_norm:
            keep = gnorm < self.spec.clip_norm
            for p in self.params:
                p.grad.copy_(torch.where(keep, p.grad, p.grad / gnorm * self.spec.clip_norm))
        if self.spec.schedule is not None:
            lr = self.spec.schedule(self.steps)
            for group in self.base.param_groups:
                group["lr"] = lr
        self.base.step()
        self.steps.add_(1)
        return gnorm


class NesterovSGD(torch.optim.Optimizer):
    """optax's ``sgd(lr, momentum, nesterov)``: the trace ``b = m*b + g``
    (zero before the first update), the update ``g + m*b`` (``b`` without
    Nesterov), scaled by ``-lr`` and added to the parameters. ``lr`` may be
    a device tensor: every op is a ``torch._foreach_*`` op on the
    parameters' device, none reads a value back."""

    def __init__(self, params, lr, momentum: float, nesterov: bool):
        super().__init__(params, {"lr": lr, "momentum": momentum, "nesterov": nesterov})
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["trace"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            grads = [p.grad for p in params]
            traces = [self.state[p]["trace"] for p in params]
            m, neg_lr = group["momentum"], -group["lr"]
            torch._foreach_mul_(traces, m)
            torch._foreach_add_(traces, grads)
            if group["nesterov"]:
                updates = torch._foreach_mul(traces, m)
                torch._foreach_add_(updates, grads)
                torch._foreach_mul_(updates, neg_lr)
            else:
                updates = torch._foreach_mul(traces, neg_lr)
            torch._foreach_add_(params, updates)


def keras_sgd(
    learning_rate: float = 1e-3,
    momentum: float = 0.99,
    decay: float = 1e-6,
    nesterov: bool = True,
) -> OptimizerSpec:
    """SGD with Keras-style inverse-time lr decay (reference defaults), as
    optax builds it: ``NesterovSGD`` with the schedule's lr before each
    update, computed in f32 as optax computes it."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        denom = 1.0 + decay * step.to(torch.float32)
        return torch.full_like(denom, learning_rate) / denom

    return OptimizerSpec(
        make=lambda params: NesterovSGD(
            params, lr=learning_rate, momentum=momentum, nesterov=nesterov
        ),
        schedule=schedule,
    )


def _adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8) -> OptimizerSpec:
    # capturable on the card: the step count stays on the device, so a
    # CUDA graph can replay the update.
    return OptimizerSpec(
        make=lambda params: torch.optim.Adam(
            params, lr=learning_rate, betas=(b1, b2), eps=eps,
            capturable=params[0].is_cuda,
        )
    )


def _adamw(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8, weight_decay: float = 1e-4) -> OptimizerSpec:
    # optax.adamw's weight decay defaults to 1e-4 (torch's to 1e-2), so it
    # is passed explicitly.
    return OptimizerSpec(
        make=lambda params: torch.optim.AdamW(
            params, lr=learning_rate, betas=(b1, b2), eps=eps,
            weight_decay=weight_decay, capturable=params[0].is_cuda,
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
