"""The fit loop: epochs, early stopping, save-best, timing.

Counterpart of the per-batch program of ``tpuflow/train/loop.py``
(``loop.py:493-531`` and ``:561-591``): up to ``max_epochs`` epochs of
minibatch steps over ``batches(train_ds, batch, seed=seed + epoch)``, the
losses read back once per epoch, validation, early stopping on val loss
with patience, and save-best into the store layout the port's ``Predictor``
and the JAX package's ``StoreCheckpointer`` both read.

The datasets are copied to the model's device once, and each epoch's batch
order once per epoch, so the batch loop moves no host data and never waits
for the card. What the JAX loop does beyond this (run-state checkpoints and
resume, the numerics watchdog, recompile detection, the autotuner, fault
drills, metrics files, profiler traces) is not ported yet (ROADMAP.md
Queue 1 items 6 and 12).
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
from tpuflow_torch.storage.checkpoint import StoreCheckpointer
from tpuflow_torch.train.callbacks import EarlyStopping
from tpuflow_torch.train.optim import OptimizerSpec, keras_sgd
from tpuflow_torch.train.steps import make_eval_step, make_train_step


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


@dataclass
class FitResult:
    model: torch.nn.Module
    history: list = field(default_factory=list)
    time_elapsed: float = 0.0
    best_val_loss: float = float("inf")
    epochs_ran: int = 0
    samples_per_sec: float = 0.0


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def fit(
    model: torch.nn.Module,
    train_ds: ArrayDataset,
    val_ds: ArrayDataset,
    config: FitConfig = FitConfig(),
    optimizer: OptimizerSpec | None = None,
) -> FitResult:
    """Train ``model`` in place on its device with early stopping and
    optional save-best checkpointing; ``optimizer`` defaults to the
    reference's ``keras_sgd``."""
    device = _device_of(model)
    opt = (optimizer or keras_sgd()).bind(model.parameters())
    train_step = make_train_step(model, opt, config.loss)
    eval_step = make_eval_step(model, config.loss)
    x_train = torch.from_numpy(train_ds.x).to(device)
    y_train = torch.from_numpy(train_ds.y).to(device)
    ckpt = (
        StoreCheckpointer(config.storage_path, config.model_name)
        if config.storage_path else None
    )
    stopper = EarlyStopping(patience=config.patience)
    result = FitResult(model=model)
    samples_seen = 0
    t0 = time.monotonic()
    for epoch in range(1, config.max_epochs + 1):
        te = time.monotonic()
        order = epoch_order(train_ds.n, config.batch_size, seed=config.seed + epoch)
        idx = torch.from_numpy(order).to(device)
        losses = []
        for s in range(0, len(order), config.batch_size):
            rows = idx[s : s + config.batch_size]
            # Device tensors only inside the batch loop: reading one back
            # here would wait for the card once per step.
            losses.append(train_step(x_train[rows], y_train[rows])["loss"])
        if not losses:
            raise ValueError(
                f"epoch {epoch} yielded zero batch_size={config.batch_size} "
                "batches — training would be a silent no-op reporting NaN loss "
                "(split smaller than one batch?)"
            )
        samples_seen += len(order)
        train_loss = float(np.mean(torch.stack(losses).cpu().tolist()))
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


def evaluate(
    model: torch.nn.Module, ds: ArrayDataset, batch_size: int = 256, loss=mae_clip
) -> dict:
    """Full-dataset eval: mean loss and MAE over fixed-size batches."""
    return _eval_dataset(make_eval_step(model, loss), ds, batch_size, _device_of(model))


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
