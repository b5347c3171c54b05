"""The fit loop: epochs, early stopping, save-best, timing.

Counterpart of ``tpuflow/train/loop.py``, with both of its epoch programs
(``loop.py:479-531``):

- per-batch (``FitConfig.jit_epoch=False``, the default): minibatch steps
  over ``batches(train_ds, batch, seed=seed + epoch)``, each launched from
  Python, their losses and gradient norms read back once per epoch;
- ``jit_epoch``: the scanned epoch, ``make_epoch_step`` over the same
  drop-remainder batches (``_stacked_epoch``, ``loop.py:736``); on a GPU
  one train step captured as a CUDA graph and replayed once a batch, on
  the CPU the same step in a loop. It reads back the epoch's mean loss and
  nothing else, and the watchdog sees that mean and no gradient norms, as
  in JAX.

Then validation, early stopping on val loss with patience, save-best into
the store layout the port's ``Predictor`` and the JAX package's
``StoreCheckpointer`` both read, and the numerics watchdog's ``warn``
policy after each epoch (``tpuflow_torch/obs/health.py``).

Under data parallelism each rank runs this loop over the same global batch
order with the injected steps (``fit``); its caller saves best on rank 0
alone, and ``samples_per_sec`` counts the global rows.

The datasets are copied to the model's device once, and each epoch's batch
order once per epoch, so the batch loop moves no host data and never waits
for the card. What the JAX loop does beyond this (run-state checkpoints and
resume, the watchdog's ``abort`` and ``halve_lr`` policies, the autotuner,
fault drills, metrics files, profiler traces) is not ported yet (ROADMAP.md
Queue 1 items 6 and 12). Eager PyTorch compiles nothing, so there is no
recompile to detect: ``FitResult.recompiles`` is always None, as the JAX
detector reports when no recompile happened.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from tpuflow_torch.convert import model_leaves
from tpuflow_torch.core.losses import mae_clip
from tpuflow_torch.data.pipeline import ArrayDataset, epoch_order
from tpuflow_torch.obs.health import HEALTH_OFF, NumericsWatchdog
from tpuflow_torch.storage.checkpoint import StoreCheckpointer
from tpuflow_torch.train.callbacks import EarlyStopping
from tpuflow_torch.train.optim import OptimizerSpec, keras_sgd
from tpuflow_torch.train.steps import make_epoch_step, make_eval_step, make_train_step


@dataclass
class FitConfig:
    # Reference defaults: cnn.py:121 (patience), cnn.py:128 (epochs, batch).
    max_epochs: int = 1000
    batch_size: int = 20
    patience: int = 10
    seed: int = 0
    loss: Callable = mae_clip
    storage_path: str | None = None  # enables save-best checkpointing
    model_name: str = "model"
    verbose: bool = True
    # Numerics watchdog policy: "warn", or one of HEALTH_OFF.
    health: str | None = "warn"
    # The scanned epoch program (a CUDA graph of the train step on a GPU).
    jit_epoch: bool = False


@dataclass
class FitResult:
    model: torch.nn.Module
    history: list = field(default_factory=list)
    time_elapsed: float = 0.0
    best_val_loss: float = float("inf")
    epochs_ran: int = 0
    samples_per_sec: float = 0.0
    # The watchdog's trail ({"epoch", "kind", "value"} dicts; empty when
    # healthy), and the recompile summary: always None in eager PyTorch.
    anomalies: list = field(default_factory=list)
    recompiles: dict | None = None


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def fit(
    model: torch.nn.Module,
    train_ds: ArrayDataset,
    val_ds: ArrayDataset,
    config: FitConfig = FitConfig(),
    optimizer: OptimizerSpec | None = None,
    train_step=None,
    eval_step=None,
) -> FitResult:
    """Train ``model`` in place on its device with early stopping and
    optional save-best checkpointing; ``optimizer`` defaults to the
    reference's ``keras_sgd``.

    ``train_step``/``eval_step`` may be injected, as in JAX's ``fit``
    (``loop.py:206-226``): the data-parallel steps of
    ``tpuflow_torch.parallel.make_process_fed_steps`` take each global
    batch and return the loss averaged and the eval sums summed over the
    ranks, so every rank records the same history and stops at the same
    epoch. An injected ``train_step`` brings its own optimizer, and runs
    per-batch only: the scanned epoch is a single-card program."""
    if config.jit_epoch and train_step is not None:
        raise ValueError(
            "jit_epoch's epoch program is single-card and would ignore the "
            "injected train_step; use per-batch stepping (jit_epoch=False)"
        )
    device = _device_of(model)
    if train_step is None:
        opt = (optimizer or keras_sgd()).bind(model.parameters())
        train_step = make_train_step(model, opt, config.loss)
    eval_step = eval_step or make_eval_step(model, config.loss)
    x_train = torch.from_numpy(train_ds.x).to(device)
    y_train = torch.from_numpy(train_ds.y).to(device)
    epoch_step = (make_epoch_step(model, opt, config.loss, x_train, y_train)
                  if config.jit_epoch else None)
    ckpt = (
        StoreCheckpointer(config.storage_path, config.model_name)
        if config.storage_path else None
    )
    stopper = EarlyStopping(patience=config.patience)
    watchdog = None
    if config.health not in HEALTH_OFF:
        watchdog = NumericsWatchdog(model_name=config.model_name, verbose=config.verbose)
    result = FitResult(model=model)
    samples_seen = 0
    t0 = time.monotonic()
    for epoch in range(1, config.max_epochs + 1):
        te = time.monotonic()
        order = epoch_order(train_ds.n, config.batch_size, seed=config.seed + epoch)
        if not len(order):
            raise ValueError(
                f"epoch {epoch} yielded zero batch_size={config.batch_size} "
                "batches — training would be a silent no-op reporting NaN loss "
                "(split smaller than one batch?)"
            )
        if epoch_step is not None:
            # The epoch's one read-back: its mean loss (the scanned
            # program returns no per-step values).
            mean = epoch_step(torch.from_numpy(order).view(-1, config.batch_size))
            epoch_losses, epoch_grads = [float(mean)], []
            train_loss = epoch_losses[0]
        else:
            epoch_losses, epoch_grads = _per_batch_epoch(
                train_step, x_train, y_train, order, config.batch_size, device)
            train_loss = float(np.mean(epoch_losses))
        samples_seen += len(order)
        if watchdog is not None:
            watchdog.observe_epoch(epoch, epoch_losses, epoch_grads)
            result.anomalies = watchdog.anomalies
        val = _eval_dataset(eval_step, val_ds, config.batch_size, device)
        epoch_time = time.monotonic() - te
        result.history.append(
            {"epoch": epoch, "loss": train_loss, "val_loss": val["loss"],
             "val_mae": val["mae"], "time": epoch_time}
        )
        if config.verbose:
            print(
                f"Epoch {epoch}/{config.max_epochs} - {epoch_time:.2f}s"
                f" - loss: {train_loss:.4f} - val_loss: {val['loss']:.4f}"
            )
        if val["loss"] < result.best_val_loss:
            result.best_val_loss = val["loss"]
        should_stop = stopper.update(val["loss"])
        if ckpt is not None and stopper.improved:
            ckpt.maybe_save(epoch, model_leaves(model), val["loss"])
        result.epochs_ran = epoch
        if should_stop:
            break
    result.time_elapsed = time.monotonic() - t0
    result.samples_per_sec = samples_seen / max(result.time_elapsed, 1e-9)
    return result


def _per_batch_epoch(train_step, x_train, y_train, order, batch_size, device):
    """One epoch of steps launched from Python; returns the steps' losses
    and gradient norms as host floats, read back together."""
    idx = torch.from_numpy(order).to(device)
    losses, grad_norms = [], []
    for s in range(0, len(order), batch_size):
        rows = idx[s : s + batch_size]
        # Device tensors only inside the batch loop: reading one back
        # here would wait for the card once per step.
        out = train_step(x_train[rows], y_train[rows])
        losses.append(out["loss"])
        grad_norms.append(out["grad_norm"])
    return torch.stack([torch.stack(losses), torch.stack(grad_norms)]).cpu().tolist()


def evaluate(
    model: torch.nn.Module, ds: ArrayDataset, batch_size: int = 256, loss=mae_clip,
    eval_step=None,
) -> dict:
    """Full-dataset eval: mean loss and MAE over fixed-size batches, through
    ``eval_step`` when one is injected (the data-parallel one)."""
    step = eval_step or make_eval_step(model, loss)
    return _eval_dataset(step, ds, batch_size, _device_of(model))


def _eval_dataset(eval_step, ds: ArrayDataset, batch_size: int, device) -> dict:
    """Fixed-size batches in order; the tail batch is padded by repeating its
    last row and masked out of the sums, as the JAX loop pads to one
    compiled shape. One read-back for the whole dataset."""
    x = torch.from_numpy(ds.x).to(device)
    y = torch.from_numpy(ds.y).to(device)
    ones = torch.ones(batch_size, dtype=torch.float32, device=device)
    sums = []
    for s in range(0, ds.n, batch_size):
        xb, yb, mask = x[s : s + batch_size], y[s : s + batch_size], ones
        n = len(xb)
        if n < batch_size:
            pad = batch_size - n
            xb = torch.cat([xb, xb[-1:].expand(pad, *xb.shape[1:])])
            yb = torch.cat([yb, yb[-1:].expand(pad, *yb.shape[1:])])
            mask = torch.cat([ones[:n], torch.zeros_like(ones[n:])])
        m = eval_step(xb, yb, mask)
        sums.append(torch.stack([m["loss_sum"], m["mae_sum"], m["count"]]))
    loss_sum, mae_sum, count = torch.stack(sums).double().sum(dim=0).tolist()
    return {"loss": loss_sum / count, "mae": mae_sum / count}
