"""Context parallelism over ``torch.distributed``: the ring and its pieces.

Counterpart of the ring half of ``tpuflow/parallel``: ring attention and the
sequence-parallel LSTM ring, the process group they run over, and the
collectives they use. See ``ring_attention.py`` for the rule that maps
JAX's sharded arrays onto one process per rank.
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
from tpuflow_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh
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
    "full_attention",
    "init_distributed",
    "local_chunk",
    "make_mesh",
    "make_sp_forward",
    "pmean",
    "ppermute_ring",
    "psum",
    "pvary",
    "ring_attention",
    "ring_attention_spmd",
    "ring_lstm_scan",
    "spawn",
]
