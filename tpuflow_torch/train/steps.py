"""Train, epoch and eval steps.

Counterpart of ``tpuflow/train/steps.py``. The contract is the JAX
package's: a train step returns the loss and the global gradient norm as
device tensors, never host floats, so the batch loop enqueues work without
waiting for the card (``steps.py:82-91``); the epoch step (``steps.py:96``,
a ``lax.scan`` over the epoch's batches in JAX) returns the epoch's mean
train loss and nothing else; an eval step returns masked per-example sums,
so a padded tail batch still gives exact dataset metrics
(``steps.py:144-165``). The loss is reduced in f32.

On a GPU the epoch step is one train step captured as a CUDA graph, once,
and replayed once a batch: the step picks its batch from the epoch's order
by a step counter on the device, so a replay needs nothing from the host.
On the CPU the same step runs in a Python loop.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpuflow_torch.core.losses import per_example
from tpuflow_torch.kernels import count_captured
from tpuflow_torch.train.optim import Optimizer

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_train_step(
    model: torch.nn.Module,
    optimizer: Optimizer,
    loss_fn: LossFn,
    reduce: Callable[[torch.Tensor], torch.Tensor] | None = None,
):
    """``step(x, y) -> {"loss", "grad_norm"}``, both f32 device scalars;
    updates ``model``'s parameters in place. ``reduce(loss) -> loss``, when
    given, runs between the backward and the update, on the loss and the
    parameters' ``.grad`` (the data-parallel all-reduce,
    ``parallel/dp.py``)."""

    def step(x: torch.Tensor, y: torch.Tensor) -> dict:
        model.train()  # dropout on
        optimizer.zero_grad()
        loss = loss_fn(y, model(x).to(torch.float32))
        loss.backward()
        loss = loss.detach()
        if reduce is not None:
            loss = reduce(loss)
        gnorm = optimizer.step()
        return {"loss": loss, "grad_norm": gnorm.detach()}

    return step


def make_epoch_step(
    model: torch.nn.Module,
    optimizer: Optimizer,
    loss_fn: LossFn,
    x: torch.Tensor,
    y: torch.Tensor,
):
    """``epoch(order) -> mean loss``, an f32 device scalar: one update of
    ``model`` for each row of ``order``, an ``[n_batches, B]`` index tensor
    into the training data ``x``, ``y`` (on the model's device), in order.

    On a GPU the first call trains the epoch's first batch eagerly on a
    side stream (creating the optimizer's state), captures one step as a
    CUDA graph and replays it for the other batches; later calls copy the
    order into the graph's buffer and replay it for every batch. ``order``
    keeps its shape from call to call. A failed capture or replay raises.
    The graph replays the dropout masks of ``model.dropout_generator`` (or
    of torch's default generator) as that generator advances."""
    device = x.device
    train_step = make_train_step(model, optimizer, loss_fn)
    k = torch.zeros(1, dtype=torch.int64, device=device)  # the next step's batch
    total = torch.zeros((), dtype=torch.float32, device=device)
    rows: torch.Tensor | None = None  # the epoch's order, [n_batches, B]
    replay = None

    def batch_step() -> None:
        idx = rows.index_select(0, k).view(-1)
        total.add_(train_step(x.index_select(0, idx), y.index_select(0, idx))["loss"])
        k.add_(1)

    def capture():
        """The eager first update, then the graph of one step; returns the
        graph and ``count_captured``'s ``replayed``."""
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            batch_step()  # the epoch's first update, eager
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        generator = getattr(model, "dropout_generator", None)
        if generator is not None:
            graph.register_generator_state(generator)

        def record() -> None:
            with torch.cuda.graph(graph):
                batch_step()

        return graph, count_captured(record)

    def epoch(order: torch.Tensor) -> torch.Tensor:
        nonlocal rows, replay
        if rows is None:
            rows = torch.empty(order.shape, dtype=torch.int64, device=device)
        if order.shape != rows.shape:
            raise ValueError(
                f"epoch order {tuple(order.shape)} differs from the captured "
                f"{tuple(rows.shape)}")
        rows.copy_(order)
        k.zero_()
        total.zero_()
        n = order.shape[0]
        if device.type == "cuda":
            done = 0
            if replay is None:
                replay, done = capture(), 1
            graph, replayed = replay
            for _ in range(n - done):
                graph.replay()
            replayed(n - done)
        else:
            for _ in range(n):
                batch_step()
        return total / n

    return epoch


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
