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

Data parallel (``n_devices`` of None or N, called on every rank of an
initialised group of N ranks, one process per card: ``torchrun
--nproc-per-node N`` or ``tpuflow_torch.parallel.spawn``) trains rank 0's
replicated model on each rank's slice of every global batch, with one
gradient all-reduce a step (``tpuflow_torch/parallel/dp.py``); the
arithmetic is one process's on the whole batch. The same rank-0 writes and
barrier apply, and ``samples_per_sec`` is the global rate over N, as in
JAX.

The epoch program is resolved as in the JAX package: ``jit_epoch=None``
("auto") through ``tpuflow_torch.train.autotune.choose_epoch_program``
(the scanned epoch, a CUDA graph of the train step on a GPU, at every
batch on a card whose sweep measured it faster, as the H100's did, else
below the heuristic crossover batch of 256; per-batch steps on a ring and
under data parallel), an explicit
True/False as given; the choice is ``TrainReport.epoch_program``.

The model is initialised by the port (flax's initialisers in distribution,
numbers from ``torch.Generator().manual_seed(seed)``), so a seed does not
give the JAX package's initial weights; the data, the split and the
batch order are the same. Every field of ``TrainJobConfig`` whose machinery
is not ported yet raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

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
from tpuflow_torch.obs.health import HEALTH_OFF, HEALTH_POLICIES
from tpuflow_torch.parallel.dp import (
    make_dp_eval_step,
    make_dp_train_step,
    make_process_fed_steps,
    rank_seed,
    replicate,
)
from tpuflow_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh
from tpuflow_torch.parallel.placement import device_count
from tpuflow_torch.train.autotune import ProgramChoice, choose_epoch_program
from tpuflow_torch.train.loop import FitConfig, FitResult, evaluate, fit
from tpuflow_torch.train.optim import build_optimizer, wrap_optimizer

# (field, is it set?, where it is ported): each raises NotImplementedError.
_NOT_PORTED = (
    ("stream", lambda c: c.stream, "item 10 (streaming ingest)"),
    ("tp", lambda c: c.tp != 1, "item 11 (TP/PP/EP trainers)"),
    ("pp", lambda c: c.pp != 1, "item 11 (TP/PP/EP trainers)"),
    ("ep", lambda c: c.ep != 1, "item 11 (TP/PP/EP trainers)"),
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
    ("health", lambda c: c.health not in HEALTH_POLICIES + HEALTH_OFF,
     "item 12 (numerics watchdog)"),
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


def _dp_mesh(config: TrainJobConfig, ring, device) -> Mesh | None:
    """The data-parallel mesh of this job, or None when it trains on one
    rank. The port runs one process per card: inside an initialised
    ``torch.distributed`` group of N > 1 ranks, ``n_devices`` of None or N
    trains data parallel over it (JAX's ``n_devices > 1``,
    ``tpuflow/api/train_api.py:987-1027``). ``n_devices=None`` means every
    visible card, as in JAX, so a single process on a host with several
    raises rather than train on one of them. A ring's ranks split each
    window and train no data parallel."""
    n = config.n_devices
    if n is not None and n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if ring is not None:
        if n not in (None, 1):
            raise ValueError(
                f"n_devices={n} with backend='ring': the ring splits each window "
                "over its mesh's ranks and trains no data parallel; leave "
                "n_devices None")
        return None
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    launch = ("start them with torchrun --nproc-per-node {n} (the CLI joins them "
              "through tpuflow_torch.parallel.init_distributed) or "
              "tpuflow_torch.parallel.spawn, and call train on every rank")
    if ranks > 1:
        if n not in (None, ranks):
            raise ValueError(
                f"n_devices={n} differs from the process group's {ranks} ranks: "
                f"data parallel runs one process per rank; pass n_devices={ranks}")
        if config.batch_size % ranks:
            raise ValueError(
                f"batch_size {config.batch_size} not divisible by {ranks} devices")
        return make_mesh(device=device)
    if n is not None and n > 1:
        raise ValueError(
            f"n_devices={n} needs {n} processes joined in a torch.distributed "
            f"group, one per card, and none is initialised: " + launch.format(n=n))
    cards = device_count()
    on_card = device is None or torch.device(device).type == "cuda"
    if n is None and on_card and cards > 1:
        raise ValueError(
            f"TrainJobConfig.n_devices=None means every visible card ({cards}), "
            f"and the port runs one process per card: for data parallel over "
            f"them, " + launch.format(n=cards) + "; or pass n_devices=1 to "
            "train on one card")
    return None


@dataclass
class TrainReport:
    result: FitResult
    test_loss: float
    test_mae: float
    gilbert_mae: float | None  # physical-baseline MAE on the same test rows
    time_elapsed: float
    samples_per_sec: float
    # Which epoch program ran ("jit_epoch" or "per_batch") and why.
    epoch_program: str = ""
    epoch_program_reason: str = ""
    device: str = ""  # torch.cuda.get_device_name, or "cpu"
    # The numerics watchdog's anomaly trail, and the recompile summary:
    # always None in eager PyTorch, which compiles nothing.
    anomalies: list = field(default_factory=list)
    recompiles: dict | None = None

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
        if self.anomalies:
            kinds: dict[str, int] = {}
            for a in self.anomalies:
                kinds[a["kind"]] = kinds.get(a["kind"], 0) + 1
            lines.append(
                "Numerics anomalies: "
                + ", ".join(f"{k}={v}" for k, v in sorted(kinds.items()))
                + " (numerics watchdog, policy=warn)"
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


def _epoch_program(config: TrainJobConfig, mesh, dev: torch.device,
                   dp: Mesh | None = None) -> ProgramChoice:
    """Resolve ``jit_epoch`` as ``tpuflow/api/train_api.py:651-667`` does:
    an explicit True/False is honoured, None ("auto") is
    ``choose_epoch_program``'s. A ring (``mesh``) and data parallel (``dp``)
    cannot run the scanned program."""
    if config.jit_epoch is None:
        return choose_epoch_program(
            config.batch_size, stream=config.stream, tp=config.tp, pp=config.pp,
            ep=config.ep, ring=mesh is not None, data_parallel=dp is not None,
            device_kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            compute_dtype=config.precision,
        )
    if config.jit_epoch and mesh is not None:
        raise ValueError(
            "jit_epoch=True cannot train a ring (backend='ring'): the scanned "
            "epoch is a CUDA graph of the train step, and the ring's "
            "torch.distributed collectives cannot be captured in one; pass "
            "jit_epoch=False or None"
        )
    if config.jit_epoch and dp is not None:
        raise ValueError(
            f"jit_epoch=True cannot train data parallel over {dp.size} ranks: the "
            "scanned epoch is a CUDA graph of the train step, a gloo group's "
            "gradient all-reduce cannot be captured in one, and the graphed "
            "data-parallel epoch over NCCL is not ported (ROADMAP.md Queue 1 "
            "item 8); pass jit_epoch=False or None"
        )
    return ProgramChoice(bool(config.jit_epoch), "explicitly set in config", "explicit")


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
    dp = _dp_mesh(config, mesh, device)
    group = mesh or dp
    dev = resolve_device(group.device if device is None and group is not None else device)
    program = _epoch_program(config, mesh, dev, dp)
    if config.loss not in LOSSES:
        raise ValueError(f"unknown loss {config.loss!r}; known: {sorted(LOSSES)}")
    if config.storage_path:
        json.dumps(_sidecar_kwargs(config.model_kwargs))  # the sidecar must serialize them
    if mesh is not None and config.window % mesh.size:
        raise ValueError(
            f"sequence length {config.window} not divisible by {DATA_AXIS}={mesh.size}")
    # On a ring or data parallel, rank 0 alone writes the artifact.
    writes = group is None or group.rank == 0
    t0 = time.monotonic()
    names = config.column_names or SYNTHETIC_COLUMN_NAMES
    types = config.column_types or SYNTHETIC_COLUMN_TYPES
    target = config.target or SYNTHETIC_TARGET
    schema = Schema.from_cli(names, types, target)
    loss_fn = LOSSES[config.loss]
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
    if dp is not None:
        replicate(dp, model)
    if hasattr(model, "dropout_generator"):
        # The epoch program's CUDA graph registers this generator, so each
        # replay draws new masks; each data-parallel rank draws its own.
        seed = config.seed if dp is None else rank_seed(config.seed, dp.rank)
        model.dropout_generator = torch.Generator(device=dev).manual_seed(seed)
    steps = {}
    if dp is not None:
        steps = dict(zip(("train_step", "eval_step"), make_process_fed_steps(
            dp, make_dp_train_step(model, spec.bind(model.parameters()), loss_fn, dp),
            make_dp_eval_step(model, loss_fn, dp))))

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
            health=config.health,
            jit_epoch=program.jit_epoch,
        ),
        optimizer=spec,
        **steps,
    )
    # Final evaluation (cnn.py:132-134): the fit loop's eval batch unless the
    # test split is larger than a few of them on one card (train_api.py:
    # 1128-1130); data parallel evaluates through its own step.
    eval_bs = config.batch_size
    if dp is None and test_ds.n > 4 * config.batch_size:
        eval_bs = max(config.batch_size, 256)
    test = evaluate(result.model, test_ds, batch_size=eval_bs, loss=loss_fn,
                    eval_step=steps.get("eval_step"))

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
    if group is not None:
        dist.barrier(group=group.group)  # the artifact is complete for every rank

    report = TrainReport(
        result=result,
        test_loss=test["loss"],
        # Training runs in standardized target units (clip=6 discipline);
        # MAE is reported in RAW flow units for the Gilbert comparison.
        test_mae=test["mae"] * splits.target_std,
        gilbert_mae=gilbert_test,
        time_elapsed=time.monotonic() - t0,
        # Samples/s a chip: the global rate over the data-parallel ranks.
        samples_per_sec=result.samples_per_sec / (dp.size if dp is not None else 1),
        epoch_program=program.name,
        epoch_program_reason=program.reason,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        anomalies=result.anomalies,
        recompiles=result.recompiles,
    )
    if config.verbose:
        print(report.summary())
    return report
