"""Job configuration.

Counterpart of ``tpuflow/api/config.py``: the same ``TrainJobConfig`` field
set with the same defaults, so one spec JSON drives both packages. The first
four fields are the reference's positional CLI contract (reference cnn.py:2,
41-44). Fields whose machinery is not ported yet are accepted here and
refused by ``train()`` with the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TrainJobConfig:
    # --- the reference's dynamic-schema contract (runtime inputs) ---
    column_names: str = ""  # "pressure,choke,...", comma-separated
    column_types: str = ""  # "float,float,...,string", comma-separated
    target: str = "flow"
    storage_path: str | None = None  # checkpoint root ({storage}/models/...)

    # --- data source: a headerless CSV, or synthetic wells ---
    data_path: str | None = None
    well_column: str | None = None  # groups CSV rows into per-well logs
    synthetic_wells: int = 8
    synthetic_steps: int = 512
    # Out-of-core ingest (not ported yet).
    stream: bool = False
    stream_chunk_rows: int = 65536
    stream_shuffle_buffer: int = 8192
    stream_sample_rows: int = 100_000
    stream_eval_rows: int = 100_000

    # --- model ---
    model: str = "lstm"  # key into tpuflow_torch.models.MODELS
    model_kwargs: dict = field(default_factory=dict)
    window: int = 24  # sequence window (BASELINE configs)
    stride: int = 1

    # --- training (reference defaults: cnn.py:121,128) ---
    max_epochs: int = 1000
    batch_size: int = 20
    patience: int = 10
    loss: str = "mae_clip"
    optimizer: str = "keras_sgd"
    optimizer_kwargs: dict = field(default_factory=dict)
    clip_norm: float = 0.0  # 0 = off; global-norm clipping otherwise
    precision: str = "f32"  # "bf16" is not ported yet
    accumulate_steps: int = 1  # > 1 is not ported yet
    seed: int = 0
    verbose: bool = True
    # Epoch program: the port runs per-batch steps whatever this says; the
    # scanned epoch becomes CUDA-graph work (ROADMAP.md Queue 1 item 12).
    jit_epoch: bool | None = None

    # --- fault tolerance (not ported yet) ---
    save_every: int = 0
    resume: bool = False
    warm_start: str | None = None
    fault_epoch: int | None = None
    fault_hard: bool = False
    ckpt_async: bool = True
    faults: list = field(default_factory=list)
    progress_path: str | None = None
    # --- elastic membership, online loop, autotuning (not ported yet) ---
    elastic: dict | None = None
    online: dict | None = None
    autotune: dict | None = None

    # --- observability ---
    trace_dir: str | None = None  # not ported yet
    metrics_path: str | None = None  # not ported yet
    # Numerics watchdog: "warn" and "off"/None run without it (under "warn"
    # the JAX watchdog only logs); the other policies are not ported yet.
    health: str | None = "warn"

    # --- parallelism (not ported yet beyond one device) ---
    n_devices: int | None = None
    tp: int = 1
    pp: int = 1
    pp_microbatches: int = 0
    ep: int = 1

    @property
    def is_sequence_model(self) -> bool:
        return self.model in (
            "dynamic_mlp", "cnn1d", "lstm", "stacked_lstm", "lstm_residual",
            "attention",
        )

    @property
    def teacher_forcing(self) -> bool:
        """Sequence-target training for the recurrent/causal families."""
        return self.model in (
            "lstm", "stacked_lstm", "lstm_residual", "attention",
        )
