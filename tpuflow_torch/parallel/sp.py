"""Sequence (context) parallelism for the LSTM: the time axis over the ring.

Counterpart of ``tpuflow/parallel/sp.py``. Each rank owns a contiguous time
chunk of the input projections ``xw`` and keeps only that chunk's
activations; the carry ``(h, c)`` is handed around the ring with
``ppermute_ring``. The recurrence stays sequential, so the wall-clock stays
O(T): this trades idle compute for activation memory, as in JAX.

The translation rule is ``parallel/ring_attention.py``'s: the public
functions take and return full tensors on every rank; ``xw`` enters through
``local_chunk``, the replicated ``wh`` and ``b`` through ``pvary`` (their
gradients summed over the ranks), and the hidden states leave through
``all_gather``.

As in JAX, every rank scans its chunk in every round and keeps only the
active round's result (round r is rank r's), selecting with ``torch.where``
rather than a branch: every rank then holds every round's ``ppermute_ring``
in its autograd graph, so the ranks run the same backward collectives in the
same order. The chunk scan is a loop over ``models.lstm.lstm_step`` in
torch, because the JAX package runs no kernel here either (``lax.scan``).
"""

from __future__ import annotations

from typing import Callable

import torch

from tpuflow_torch.parallel.collectives import all_gather, local_chunk, ppermute_ring, pvary
from tpuflow_torch.parallel.mesh import DATA_AXIS, Mesh


def _lstm_chunk_scan(carry, xw_chunk, wh, b):
    """A loop of ``lstm_step`` over one time chunk ``xw_chunk [t, B, 4H]``;
    returns ``((h, c), hs [t, B, H])``."""
    from tpuflow_torch.models.lstm import lstm_step

    hs = []
    for t in range(xw_chunk.shape[0]):
        carry, h = lstm_step(carry, xw_chunk[t], wh, b)
        hs.append(h)
    return carry, torch.stack(hs)


def ring_lstm_scan(mesh: Mesh, xw: torch.Tensor, wh: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Time-split LSTM scan over the ring: ``xw [T, B, 4H] -> hs [T, B, H]``,
    the full tensors on every rank; ``T`` must divide by the ring's size.
    Rank ``k`` scans timesteps ``[k*T/n, (k+1)*T/n)``; in round ``r`` rank
    ``r``'s chunk is the active one and its end carry passes to rank
    ``r + 1``. Differentiable through ``ppermute_ring``."""
    n = mesh.size
    T = xw.shape[0]
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by {DATA_AXIS}={n}")
    (xw_l,) = local_chunk(mesh, 0, xw)
    wh, b = pvary(mesh, wh, b)
    B, H = xw.shape[1], wh.shape[0]
    zero = torch.zeros((B, H), dtype=xw.dtype, device=xw.device)
    hs_out = torch.zeros((xw_l.shape[0], B, H), dtype=xw.dtype, device=xw.device)
    received = (zero, zero)
    for r in range(n):
        active = torch.tensor(mesh.rank == r, device=xw.device)
        carry_in = tuple(torch.where(active, s, zero) for s in received)
        (h_end, c_end), hs = _lstm_chunk_scan(carry_in, xw_l, wh, b)
        hs_out = torch.where(active, hs, hs_out)
        if r + 1 < n:
            # The active rank's end carry goes to its right neighbour.
            hc = ppermute_ring(torch.stack([h_end, c_end]), mesh)
            received = (hc[0], hc[1])
    return all_gather(hs_out, mesh, dim=0)


def make_sp_forward(mesh: Mesh, hidden: int) -> Callable:
    """Long-sequence LSTM forward: ``(w_x, w_h, b, x [B, T, F]) -> [B, T, H]``.
    The input projection is one matmul over the whole (replicated) ``x``,
    then the ring scan. The params are an ``LSTMLayer``'s ``w_x``, ``w_h``
    and ``b``."""

    def forward(w_x, w_h, b, x):
        B, T, F = x.shape
        xw = (x.reshape(B * T, F) @ w_x).reshape(B, T, 4 * hidden)
        hs = ring_lstm_scan(mesh, xw.transpose(0, 1), w_h, b)  # [T, B, H]
        return hs.transpose(0, 1)

    return forward
