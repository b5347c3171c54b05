"""Train and eval steps.

Counterpart of ``tpuflow/train/steps.py`` for the per-batch program. The
contract is the JAX package's: a train step returns the loss and the global
gradient norm as device tensors, never host floats, so the batch loop
enqueues work without waiting for the card (``steps.py:82-91``); an eval
step returns masked per-example sums, so a padded tail batch still gives
exact dataset metrics (``steps.py:144-165``). The loss is reduced in f32.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpuflow_torch.core.losses import per_example
from tpuflow_torch.train.optim import Optimizer

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_train_step(model: torch.nn.Module, optimizer: Optimizer, loss_fn: LossFn):
    """``step(x, y) -> {"loss", "grad_norm"}``, both f32 device scalars;
    updates ``model``'s parameters in place."""

    def step(x: torch.Tensor, y: torch.Tensor) -> dict:
        model.train()  # dropout on
        optimizer.zero_grad()
        loss = loss_fn(y, model(x).to(torch.float32))
        loss.backward()
        gnorm = optimizer.step()
        return {"loss": loss.detach(), "grad_norm": gnorm.detach()}

    return step


def make_eval_step(model: torch.nn.Module, loss_fn: LossFn):
    """``step(x, y, mask) -> {"loss_sum", "mae_sum", "count"}``, device
    scalars summed over the rows where ``mask`` is 1."""

    @torch.no_grad()
    def step(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> dict:
        model.eval()  # deterministic: dropout off
        pred = model(x).to(torch.float32)
        per_loss = per_example(loss_fn, y, pred)  # [B]: per-example mean loss
        per_mae = torch.abs(y - pred).reshape(y.shape[0], -1).mean(dim=1)
        return {
            "loss_sum": torch.sum(per_loss * mask),
            "mae_sum": torch.sum(per_mae * mask),
            "count": torch.sum(mask),
        }

    return step
