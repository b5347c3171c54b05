"""Hand-written CUDA kernels of the port, each beside its plain version.

``KERNELS`` lists every wrapper with its launch counter, for runs that must
show that a path went through the kernels.
"""

from tpuflow_torch.kernels.attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_forward,
    flash_attention_reference,
    ring_round_bwd,
    ring_round_bwd_reference,
    ring_round_fwd,
    ring_round_fwd_reference,
)
from tpuflow_torch.kernels.losses import (
    mae_clip,
    mae_clip_grad,
    mae_clip_grad_reference,
    mae_clip_reference,
    mae_clip_rows,
)
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
    "mae_clip_grad": mae_clip_grad,
    "flash_fwd": flash_attention_forward,
    "flash_dq": flash_attention_dq,
    "flash_dkv": flash_attention_dkv,
    "ring_round_fwd": ring_round_fwd,
    "ring_round_bwd": ring_round_bwd,
}

__all__ = [
    "KERNELS",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_backward_reference",
    "flash_attention_dkv",
    "flash_attention_dq",
    "flash_attention_forward",
    "flash_attention_reference",
    "lstm_scan",
    "lstm_scan_backward",
    "lstm_scan_backward_reference",
    "lstm_scan_reference",
    "mae_clip",
    "mae_clip_grad",
    "mae_clip_grad_reference",
    "mae_clip_reference",
    "mae_clip_rows",
    "ring_round_bwd",
    "ring_round_bwd_reference",
    "ring_round_fwd",
    "ring_round_fwd_reference",
]
