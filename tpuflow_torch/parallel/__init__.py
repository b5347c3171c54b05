"""Parallelism over ``torch.distributed``: data parallel, the ring, and
their pieces.

Counterpart of ``tpuflow/parallel``: data-parallel training (``dp.py``),
ring attention and the sequence-parallel LSTM ring, the process group they
run over, the collectives they use, and the placement seam that counts the
cards. See ``ring_attention.py`` for the rule that maps JAX's sharded arrays
onto one process per rank.
"""

from tpuflow_torch.parallel.collectives import (
    all_gather,
    local_chunk,
    pmean,
    ppermute_ring,
    psum,
    pvary,
)
from tpuflow_torch.parallel.distributed import init_distributed, spawn
from tpuflow_torch.parallel.dp import (
    make_dp_eval_step,
    make_dp_train_step,
    make_process_fed_steps,
    process_batch_bounds,
    rank_seed,
    replicate,
)
from tpuflow_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh
from tpuflow_torch.parallel.placement import (
    device_count,
    device_kind,
    device_put,
    local_devices,
    place,
    replica_devices,
)
from tpuflow_torch.parallel.ring_attention import (
    full_attention,
    ring_attention,
    ring_attention_spmd,
)
from tpuflow_torch.parallel.sp import make_sp_forward, ring_lstm_scan

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "all_gather",
    "device_count",
    "device_kind",
    "device_put",
    "full_attention",
    "init_distributed",
    "local_chunk",
    "local_devices",
    "make_dp_eval_step",
    "make_dp_train_step",
    "make_mesh",
    "make_process_fed_steps",
    "make_sp_forward",
    "place",
    "pmean",
    "ppermute_ring",
    "process_batch_bounds",
    "psum",
    "pvary",
    "rank_seed",
    "replica_devices",
    "replicate",
    "ring_attention",
    "ring_attention_spmd",
    "ring_lstm_scan",
    "spawn",
]
