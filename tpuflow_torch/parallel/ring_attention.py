"""Exact softmax attention on one device, materialising the [T, T] scores.

Counterpart of ``tpuflow/parallel/ring_attention.py::full_attention``, the
second oracle that the flash kernels are held to in the tests. The ring
itself (``ring_attention`` over ``torch.distributed``) is not ported yet
(ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

import torch

NEG = -1e30  # finite mask value, as in the JAX package


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """``q, k, v [B, T, D] -> [B, T, D]`` (heads folded into B by the
    caller): ``softmax(scale * q k^T) v``, masked to keys at or before each
    query when ``causal``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    if causal:
        T = q.shape[1]
        pos = torch.arange(T, device=q.device)
        s = torch.where(pos[None, :] <= pos[:, None], s, NEG)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1), v)
