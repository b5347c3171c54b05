"""Hand-written CUDA kernels of the port, each beside its plain version.

``KERNELS`` lists every wrapper with its launch counter, for runs that must
show that a path went through the kernels.
"""

from tpuflow_torch.kernels.losses import mae_clip, mae_clip_reference, mae_clip_rows
from tpuflow_torch.kernels.lstm import (
    lstm_scan,
    lstm_scan_backward,
    lstm_scan_backward_reference,
    lstm_scan_reference,
)

KERNELS = {
    "lstm_fwd": lstm_scan,
    "lstm_bwd": lstm_scan_backward,
    "mae_clip": mae_clip_rows,
}

__all__ = [
    "KERNELS",
    "lstm_scan",
    "lstm_scan_backward",
    "lstm_scan_backward_reference",
    "lstm_scan_reference",
    "mae_clip",
    "mae_clip_reference",
    "mae_clip_rows",
]
