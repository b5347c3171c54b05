"""The train(config) entry point for the LSTM and attention families.

Counterpart of ``tpuflow/api/train_api.py`` for ``lstm``, ``stacked_lstm``
and ``attention``: ingest (CSV or synthetic wells) under a dynamic schema,
window and split 64/16/20, normalise with train statistics, build the model,
train with early stopping and save-best, evaluate on the held-out test split,
write the serving sidecar, and report elapsed time, test loss, throughput and
MAE against the Gilbert baseline.

One card by default. With ``model_kwargs={"backend": "ring", "mesh": mesh}``
the attention regressor splits each window's attention over the mesh's
ranks, and ``train`` runs on every rank of the mesh's group: each rank
trains the same replicated model on the same batches, so their losses,
early stopping and final parameters agree; only the group's rank 0 writes
the checkpoints and the sidecar, and the ranks meet at a barrier after it.

The model is initialised by the port (flax's initialisers in distribution,
numbers from ``torch.Generator().manual_seed(seed)``), so a seed does not
give the JAX package's initial weights; the data, the split and the
batch order are the same. Every field of ``TrainJobConfig`` whose machinery
is not ported yet raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from tpuflow_torch import resolve_device
from tpuflow_torch.api.config import TrainJobConfig
from tpuflow_torch.core.gilbert import gilbert_flow
from tpuflow_torch.core.losses import LOSSES
from tpuflow_torch.data.csv_io import read_csv
from tpuflow_torch.data.pipeline import prepare_windowed, prepare_windowed_table
from tpuflow_torch.data.schema import Schema
from tpuflow_torch.data.synthetic import (
    SYNTHETIC_COLUMN_NAMES,
    SYNTHETIC_COLUMN_TYPES,
    SYNTHETIC_TARGET,
    generate_wells,
)
from tpuflow_torch.models import build_model
from tpuflow_torch.models.registry import MODELS
from tpuflow_torch.parallel.mesh import DATA_AXIS
from tpuflow_torch.train.loop import FitConfig, FitResult, evaluate, fit
from tpuflow_torch.train.optim import build_optimizer, wrap_optimizer

# (field, is it set?, where it is ported): each raises NotImplementedError.
_NOT_PORTED = (
    ("stream", lambda c: c.stream, "item 10 (streaming ingest)"),
    ("tp", lambda c: c.tp != 1, "item 11 (TP/PP/EP trainers)"),
    ("pp", lambda c: c.pp != 1, "item 11 (TP/PP/EP trainers)"),
    ("ep", lambda c: c.ep != 1, "item 11 (TP/PP/EP trainers)"),
    ("n_devices", lambda c: c.n_devices not in (None, 1), "item 8 (data parallel)"),
    ("elastic", lambda c: c.elastic is not None, "item 13 (elastic gang)"),
    ("online", lambda c: c.online is not None, "item 13 (online loop)"),
    ("autotune", lambda c: c.autotune is not None, "item 12 (autotuner)"),
    ("warm_start", lambda c: c.warm_start is not None, "item 6 (train/resume.py)"),
    ("resume", lambda c: c.resume, "item 6 (train/resume.py)"),
    ("save_every", lambda c: c.save_every != 0, "item 6 (train/resume.py)"),
    ("faults", lambda c: bool(c.faults), "item 13 (resilience drills)"),
    ("fault_epoch", lambda c: c.fault_epoch is not None, "item 13 (resilience drills)"),
    ("progress_path", lambda c: c.progress_path is not None, "item 12 (supervisor)"),
    ("trace_dir", lambda c: c.trace_dir is not None, "item 12 (profiling)"),
    ("metrics_path", lambda c: c.metrics_path is not None, "item 12 (metrics logging)"),
    ("precision", lambda c: c.precision != "f32", "item 6 (bf16 policy)"),
    ("health", lambda c: c.health not in ("warn", "off", None), "item 12 (numerics watchdog)"),
)


def _refuse_not_ported(config: TrainJobConfig) -> None:
    for name, is_set, item in _NOT_PORTED:
        if is_set(config):
            raise NotImplementedError(
                f"TrainJobConfig.{name}={getattr(config, name)!r} is not ported "
                f"yet to tpuflow_torch (ROADMAP.md Queue 1 {item})"
            )
    if config.model not in MODELS:
        raise NotImplementedError(
            f"model {config.model!r} is not ported yet to tpuflow_torch "
            f"(ported: {sorted(MODELS)}; ROADMAP.md Queue 1 item 10)"
        )


def _refuse_every_card(config: TrainJobConfig, mesh, device) -> None:
    """``n_devices=None`` means every visible device, as in the JAX package
    (data parallel over them when there are several). One card trains as
    one device; more than one would need data parallel, which is not
    ported, so raise rather than train on one of them. A ring's mesh names
    its own devices."""
    on_card = device is None or torch.device(device).type == "cuda"
    if config.n_devices is None and mesh is None and on_card and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"TrainJobConfig.n_devices=None means every visible card "
            f"({torch.cuda.device_count()}), and data parallel is not ported yet "
            f"to tpuflow_torch (ROADMAP.md Queue 1 item 8 (data parallel)); "
            f"pass n_devices=1"
        )


@dataclass
class TrainReport:
    result: FitResult
    test_loss: float
    test_mae: float
    gilbert_mae: float | None  # physical-baseline MAE on the same test rows
    time_elapsed: float
    samples_per_sec: float
    # Which epoch program ran and why: always "per_batch" in the port.
    epoch_program: str = ""
    epoch_program_reason: str = ""
    device: str = ""  # torch.cuda.get_device_name, or "cpu"

    def summary(self) -> str:
        lines = [
            f"Time elapsed: {self.time_elapsed:.2f}s",
            f"Testing set loss: {self.test_loss:.4f}",
            f"Testing set MAE: {self.test_mae:.4f}",
            f"Throughput: {self.samples_per_sec:.0f} samples/sec/chip ({self.device})",
            f"Epoch program: {self.epoch_program}",
        ]
        if self.gilbert_mae is not None:
            beat = "beats" if self.test_mae <= self.gilbert_mae else "trails"
            lines.append(
                f"Gilbert-baseline MAE: {self.gilbert_mae:.4f} (model {beat} baseline)"
            )
        return "\n".join(lines)


def _sidecar_kwargs(model_kwargs: dict) -> dict:
    """model_kwargs as the serving sidecar records them
    (``tpuflow/api/train_api.py::_sidecar_kwargs``): a ring backend serves as
    ``"full"`` (checkpoints are backend-interchangeable), and the mesh and
    the compute dtype are dropped (artifacts hold f32 params)."""
    kwargs = dict(model_kwargs)
    if kwargs.get("backend") == "ring":
        kwargs["backend"] = "full"
    kwargs.pop("mesh", None)
    kwargs.pop("dtype", None)
    return kwargs


def _gilbert_mae(pressure, choke, glr, y_raw) -> float:
    """MAE of the closed-form Gilbert baseline against RAW-unit targets."""
    return float(np.mean(np.abs(y_raw - np.asarray(gilbert_flow(pressure, choke, glr)))))


def _gilbert_mae_last_step(names, raw_last, y_raw) -> float | None:
    """Sequence-family baseline: Gilbert on each window's FINAL step.
    ``raw_last [N, F]`` are the un-standardized final-step channels named by
    ``names``; None when the physical channels are absent."""
    if not {"pressure", "choke", "glr"} <= set(names):
        return None
    ip, ic, ig = names.index("pressure"), names.index("choke"), names.index("glr")
    return _gilbert_mae(raw_last[:, ip], raw_last[:, ic], raw_last[:, ig], y_raw)


def _epoch_program(config: TrainJobConfig) -> tuple[str, str]:
    if config.jit_epoch:
        return "per_batch", (
            "jit_epoch=True asks for the scanned epoch, which is not ported "
            "(ROADMAP.md Queue 1 item 12); per-batch steps run the same math "
            "(dropout masks come from the port's own generator either way)"
        )
    if config.jit_epoch is None:
        return "per_batch", "auto: per-batch steps are the port's one epoch program"
    return "per_batch", "explicitly set in config"


def _prepare_data(config: TrainJobConfig, schema: Schema):
    """The windowed ingest: splits and the Gilbert baseline on the test
    windows' final step, from the un-standardized channels."""
    if config.data_path is not None:
        splits = prepare_windowed_table(
            schema,
            read_csv(config.data_path, schema),
            well_column=config.well_column,
            window=config.window,
            stride=config.stride,
            seed=config.seed,
            teacher_forcing=config.teacher_forcing,
        )
    else:
        splits = prepare_windowed(
            generate_wells(
                n_wells=config.synthetic_wells,
                steps=config.synthetic_steps,
                seed=config.seed,
            ),
            window=config.window,
            stride=config.stride,
            seed=config.seed,
            teacher_forcing=config.teacher_forcing,
        )
    test = splits.test
    raw_last = test.x[:, -1, :] * splits.norm_std + splits.norm_mean
    y_ref = splits.inverse_target(test.y[:, -1] if config.teacher_forcing else test.y)
    return splits, _gilbert_mae_last_step(splits.feature_names, raw_last, y_ref)


def train(config: TrainJobConfig, device=None) -> TrainReport:
    """Run the whole pipeline for one job config on ``device`` (``None``:
    the GPU, raising when there is none; ``"cpu"`` runs the kernels' plain
    versions)."""
    _refuse_not_ported(config)
    mesh = config.model_kwargs.get("mesh") if config.model_kwargs.get("backend") == "ring" else None
    _refuse_every_card(config, mesh, device)
    dev = resolve_device(mesh.device if device is None and mesh is not None else device)
    if config.loss not in LOSSES:
        raise ValueError(f"unknown loss {config.loss!r}; known: {sorted(LOSSES)}")
    if config.storage_path:
        json.dumps(_sidecar_kwargs(config.model_kwargs))  # the sidecar must serialize them
    if mesh is not None and config.window % mesh.size:
        raise ValueError(
            f"sequence length {config.window} not divisible by {DATA_AXIS}={mesh.size}")
    # On a ring, rank 0 alone writes the artifact.
    writes = mesh is None or mesh.rank == 0
    t0 = time.monotonic()
    names = config.column_names or SYNTHETIC_COLUMN_NAMES
    types = config.column_types or SYNTHETIC_COLUMN_TYPES
    target = config.target or SYNTHETIC_TARGET
    schema = Schema.from_cli(names, types, target)
    loss_fn = LOSSES[config.loss]
    program, reason = _epoch_program(config)
    spec = wrap_optimizer(
        build_optimizer(config.optimizer, **config.optimizer_kwargs),
        clip_norm=config.clip_norm,
        accumulate_steps=config.accumulate_steps,
    )

    splits, gilbert_test = _prepare_data(config, schema)
    train_ds, val_ds, test_ds = splits.train, splits.val, splits.test
    model = build_model(
        config.model, train_ds.x.shape[-1], window=train_ds.x.shape[-2],
        **config.model_kwargs,
    )
    model.reset_parameters(torch.Generator().manual_seed(config.seed))
    model.to(dev)
    if hasattr(model, "dropout_generator"):
        model.dropout_generator = torch.Generator(device=dev).manual_seed(config.seed)

    result = fit(
        model,
        train_ds,
        val_ds,
        FitConfig(
            max_epochs=config.max_epochs,
            batch_size=config.batch_size,
            patience=config.patience,
            seed=config.seed,
            loss=loss_fn,
            storage_path=config.storage_path if writes else None,
            model_name=config.model,
            verbose=config.verbose,
        ),
        optimizer=spec,
    )
    # Final evaluation (cnn.py:132-134): the fit loop's eval batch unless the
    # test split is larger than a few of them (train_api.py:1128-1130).
    eval_bs = config.batch_size
    if test_ds.n > 4 * config.batch_size:
        eval_bs = max(config.batch_size, 256)
    test = evaluate(result.model, test_ds, batch_size=eval_bs, loss=loss_fn)

    if config.storage_path and writes:
        from tpuflow_torch.api.predict_api import save_artifact_meta

        pre = {
            "feature_names": list(splits.feature_names),
            "window": config.window,
            "stride": config.stride,
            "well_column": config.well_column,
            "append_gilbert": False,
            "mean": splits.norm_mean.tolist(),
            "std": splits.norm_std.tolist(),
            "target_mean": splits.target_mean,
            "target_std": splits.target_std,
            "schema_columns": [{"name": c.name, "kind": c.kind} for c in schema.columns],
            "target": schema.target,
        }
        save_artifact_meta(
            config.storage_path, config.model, config.model,
            _sidecar_kwargs(config.model_kwargs), "windowed", pre,
            tuple(train_ds.x.shape),
        )
    if mesh is not None:
        dist.barrier(group=mesh.group)  # the artifact is complete for every rank

    report = TrainReport(
        result=result,
        test_loss=test["loss"],
        # Training runs in standardized target units (clip=6 discipline);
        # MAE is reported in RAW flow units for the Gilbert comparison.
        test_mae=test["mae"] * splits.target_std,
        gilbert_mae=gilbert_test,
        time_elapsed=time.monotonic() - t0,
        samples_per_sec=result.samples_per_sec,
        epoch_program=program,
        epoch_program_reason=reason,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )
    if config.verbose:
        print(report.summary())
    return report
