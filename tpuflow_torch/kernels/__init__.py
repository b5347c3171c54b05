"""Hand-written CUDA kernels of the port, each beside its plain version.

``KERNELS`` lists every wrapper with its launch counter, for runs that must
show that a path went through the kernels. A wrapper counts in Python when
it launches; under a CUDA graph that is when the launch is captured, not
when it runs, so ``count_captured`` moves those counts to the replays.
"""

from typing import Callable

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


def count_captured(capture: Callable[[], None]) -> Callable[[int], None]:
    """Run ``capture()``, which captures calls of the wrappers into a CUDA
    graph, and return ``replayed(n)``. A capture runs no kernel: the
    launches the wrappers counted during it are taken back out (also when
    it raises), and ``replayed(n)`` adds them once for each of ``n``
    replays, so that each counter stays the number of kernel executions."""
    before = {name: fn.launches for name, fn in KERNELS.items()}
    captured = {}
    try:
        capture()
    finally:
        for name, fn in KERNELS.items():
            captured[name] = fn.launches - before[name]
            fn.launches -= captured[name]

    def replayed(n: int) -> None:
        for name, fn in KERNELS.items():
            fn.launches += captured[name] * n

    return replayed


__all__ = [
    "KERNELS",
    "count_captured",
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
