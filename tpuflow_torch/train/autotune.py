"""Which epoch program a training job runs.

Counterpart of the offline half of ``tpuflow/train/autotune.py``. The fit
loop has two epoch programs (``tpuflow_torch/train/loop.py``): per-batch
steps, each launched from Python, and ``jit_epoch``, the scanned whole
epoch, which on a GPU is one train step captured as a CUDA graph and
replayed once a batch (``tpuflow_torch/train/steps.py::make_epoch_step``).
``train(config)`` resolves ``jit_epoch=None`` ("auto") through
:func:`choose_epoch_program`: constraints first, then the batch size
against a crossover, the measured one of the device kind where a sweep
was recorded, else the heuristic.

The JAX package reads its sweeps from ``benchmarks/program_sweep.json``;
the port's are ``MEASURED_SWEEPS``, in the same records under the same
keys, measured by ``python3 chip_smoke.py --program-sweep``. The online
occupancy autotuner (``TrainJobConfig.autotune``) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

# Batch sizes below this are dispatch-bound: the scanned epoch program
# wins. The JAX package's fallback for a device with no measured sweep.
HEURISTIC_CROSSOVER_BATCH = 256

# Sweeps of both programs by ``chip_smoke.py --program-sweep`` (LSTM-64, the
# stacked LSTM and attention at batch 20, 256, 1024 and 4096), keyed
# "<device kind>@<dtype>". The crossover is the smallest batch at which
# per-batch steps beat the graph by more than 3%; none means the graph won
# at every batch (``scan_always``). Host-clock ms a step, per-batch /
# graphed, at batch 4096 on a 700 W card: LSTM-64 2.8215 / 1.2982, stacked
# LSTM 4.9835 / 2.6313, attention 11.9386 / 7.5008.
MEASURED_SWEEPS = {
    "NVIDIA H100 80GB HBM3@f32": {
        "crossover_batch": None,
        "scan_always": True,
        "compute_dtype": "f32",
    },
}


def load_measured_crossover(
    device_kind: str, compute_dtype: str | None = None
) -> tuple[float, str] | None:
    """The measured crossover batch for ``device_kind`` and, when given,
    ``compute_dtype``, if ``MEASURED_SWEEPS`` has one: ``(crossover,
    key)``, ``inf`` for ``scan_always``. The exact ``kind@dtype`` key is
    tried first, then the plain kind, whose record must not name another
    dtype, as the JAX package matches them."""
    candidates = [(f"{device_kind}@{compute_dtype}", True)] if compute_dtype else []
    candidates.append((device_kind, False))
    for key, exact in candidates:
        rec = MEASURED_SWEEPS.get(key)
        if rec is None:
            continue
        if not exact and compute_dtype and rec.get("compute_dtype") not in (None, compute_dtype):
            continue
        if rec.get("scan_always") is True:
            return float("inf"), key
        crossover = rec.get("crossover_batch")
        if isinstance(crossover, (int, float)) and crossover > 0:
            return float(crossover), key
    return None


@dataclass(frozen=True)
class ProgramChoice:
    """The resolved epoch program and why it was chosen."""

    jit_epoch: bool
    reason: str
    # "constraint" | "measured" | "heuristic" from choose_epoch_program;
    # "explicit" when train() honours a caller-set jit_epoch instead.
    source: str

    @property
    def name(self) -> str:
        return "jit_epoch" if self.jit_epoch else "per_batch"


def choose_epoch_program(
    batch_size: int,
    *,
    stream: bool = False,
    tp: int = 1,
    pp: int = 1,
    ep: int = 1,
    ring: bool = False,
    data_parallel: bool = False,
    device_kind: str = "cpu",
    compute_dtype: str | None = None,
) -> ProgramChoice:
    """Resolve ``jit_epoch=None`` ("auto") for one training job.
    ``device_kind`` is ``torch.cuda.get_device_name`` of the card, or
    ``"cpu"``; ``compute_dtype`` the precision token ("f32");
    ``data_parallel`` stands for JAX's ``multi_host``: the port runs one
    process per rank.

    ``train()`` refuses ``stream``, ``tp``, ``pp`` and ``ep`` before it
    asks (ROADMAP.md Queue 1 items 10 and 11), so their branches are
    reached from the tests alone: they keep the choice equal to the JAX
    package's until those trainers are ported."""
    if stream:
        return ProgramChoice(
            False, "streaming ingest requires per-batch stepping "
            "(bounded memory)", "constraint",
        )
    if tp > 1:
        return ProgramChoice(
            False, "tensor parallelism trains through the per-batch "
            "GSPMD step", "constraint",
        )
    if pp > 1:
        return ProgramChoice(
            False, "pipeline parallelism trains through the per-batch "
            "GPipe step", "constraint",
        )
    if ep > 1:
        return ProgramChoice(
            False, "expert parallelism trains through the per-batch "
            "routed step", "constraint",
        )
    if ring:
        return ProgramChoice(
            False, "ring attention trains through per-batch steps: its "
            "torch.distributed collectives cannot be captured in a CUDA graph",
            "constraint",
        )
    if data_parallel:
        # The port's data parallelism is JAX's multi-process case, which
        # AUTO also keeps per-batch.
        return ProgramChoice(
            False, "data parallelism trains through per-batch steps: a gloo "
            "group's collectives cannot be captured in a CUDA graph, and the "
            "graphed data-parallel epoch over NCCL is not ported", "constraint",
        )
    measured = load_measured_crossover(device_kind, compute_dtype)
    dtype_tag = f" [{compute_dtype}]" if compute_dtype else ""
    if measured is not None:
        crossover = measured[0]
        jit = batch_size < crossover
        if crossover == float("inf"):
            desc = (f"scanned program measured faster at every swept batch "
                    f"on {device_kind!r}{dtype_tag}")
        else:
            desc = (f"batch_size {batch_size} {'<' if jit else '>='} measured "
                    f"crossover {int(crossover)} for {device_kind!r}{dtype_tag}")
        return ProgramChoice(jit, desc, "measured")
    jit = batch_size < HEURISTIC_CROSSOVER_BATCH
    return ProgramChoice(
        jit,
        f"batch_size {batch_size} {'<' if jit else '>='} heuristic "
        f"crossover {HEURISTIC_CROSSOVER_BATCH} (no sweep recorded for "
        f"{device_kind!r}{dtype_tag})",
        "heuristic",
    )
