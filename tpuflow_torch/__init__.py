"""tpuflow_torch — the PyTorch/CUDA port of tpuflow.

The JAX package ``tpuflow`` is the reference; this package is its port to
PyTorch with hand-written CUDA kernels for an NVIDIA H100 (sm_90a). It
imports ``torch`` and ``numpy`` only, never ``jax`` or anything of
``tpuflow``: what it needs of the reference's host code is copied here.

Device rule: entry points take ``device=None``, which means the GPU. When no
GPU is present they raise; only an explicit ``device="cpu"`` runs on the CPU,
where each kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device, raising when there is none; ``"cpu"`` /
    ``"cuda[:n]"`` / a ``torch.device`` pass through after a check. Never
    falls back from the GPU to the CPU."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpuflow_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(
            f"tpuflow_torch runs on 'cuda' or 'cpu', got device {device!r}"
        )
    return dev
