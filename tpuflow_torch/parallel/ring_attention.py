"""Ring attention: context parallelism for the attention family.

Counterpart of ``tpuflow/parallel/ring_attention.py``. Each rank owns a
contiguous time chunk of Q, K and V and computes exact softmax attention
blockwise: the online-softmax running max ``m``, normaliser ``l`` and
output accumulator are updated as each K/V block arrives over the
``ppermute_ring``, so no rank holds the [T, T] scores or the whole K/V
sequence. ``full_attention`` is the single-device oracle.

One translation rule, followed by every ring module of the port. JAX runs
the ranks as devices of one process under ``shard_map``; the port runs one
process per rank, every rank the same program on the same replicated
inputs. A JAX global array sharded over the ring's time axis is, at the
port's public functions (``ring_attention``, ``ring_lstm_scan``,
``make_sp_forward``), the **full tensor on every rank**; the ``_spmd``
bodies take and return the **local chunk**. A replicated input enters
through a slice whose backward all-gathers the chunks' gradients, which
equals an all-reduce of zero-padded ones (``local_chunk``). A replicated
parameter (SP's ``wh``, ``b``) enters through an identity whose backward
sums its gradient over the ranks (``pvary``), as ``shard_map``'s transpose
does for ``P()`` inputs. An output leaves through an all-gather whose
backward takes this rank's slice (``all_gather``), not a reduce-scatter sum:
every rank already holds the same upstream gradient, so a sum over the
ranks would make it ``size`` times too large.

Training memory is flash-grade across the ring: ``ring_attention_spmd`` is
an autograd Function that saves only (q, k, v, out, lse) of the chunk, and
its backward recomputes each round's probabilities from the log-sum-exp
while the dK/dV accumulators ride the ring home with their blocks.

Every causal ring on the card runs each round in the hand-written round
kernels (``kernels.attention.ring_round_fwd`` / ``ring_round_bwd``),
whatever ``impl`` says, as ``backend="full"`` runs the flash kernels on the
card. On the CPU ``impl="flash"`` runs their plain versions and
``impl="jnp"`` the materialised block math ``_block_update``, which is also
what a ``causal=False`` ring runs on any device (no TPU kernel computes it).
"""

from __future__ import annotations

import torch

from tpuflow_torch.kernels.attention import ring_round_bwd, ring_round_fwd
from tpuflow_torch.parallel.collectives import all_gather, local_chunk, rotate
from tpuflow_torch.parallel.mesh import DATA_AXIS, Mesh

NEG = -1e30  # finite mask value, as in the JAX package
IMPLS = ("jnp", "flash")


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


def _block_update(q, k, v, m, l, o, allowed, scale):
    """One online-softmax update with the K/V block ``(k, v)``
    (``ring_attention.py:49-66``): q ``[B, Tq, D]``, ``allowed [Tq, Tk]``;
    returns the new ``(m, l, o)``. Masked pairs contribute exactly 0."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    s = torch.where(allowed[None], s, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None]) * allowed[None]
    correction = torch.exp(m - m_new)
    l = l * correction + p.sum(dim=-1)
    o = o * correction[..., None] + torch.einsum("bqk,bkd->bqd", p, v)
    return m_new, l, o


def _round_mask(idx: int, r: int, n: int, Tl: int, causal: bool, device) -> torch.Tensor:
    """``[Tq, Tk]`` allowed-mask of ring round ``r`` on rank ``idx``: after
    ``r`` rotations the held block started on rank ``(idx - r) % n``."""
    if not causal:
        return torch.ones((Tl, Tl), dtype=torch.bool, device=device)
    q_pos = idx * Tl + torch.arange(Tl, device=device)
    k_pos = ((idx - r) % n) * Tl + torch.arange(Tl, device=device)
    return k_pos[None, :] <= q_pos[:, None]


def _round_kernels(q: torch.Tensor, causal: bool, impl: str) -> bool:
    """Whether the rounds run ``ring_round_fwd``/``_bwd``: every causal ring
    on the card, and ``impl="flash"`` on the CPU (their plain versions)."""
    return causal and (impl == "flash" or q.device.type == "cuda")


def _ring_fwd_core(q, k, v, mesh: Mesh, causal: bool, scale: float, impl: str):
    """The forward ring on the local chunks; returns ``(out, lse)`` with
    ``lse = m + log(l)`` in f32 (``ring_attention.py:137-177``)."""
    n, idx = mesh.size, mesh.rank
    B, Tl, D = q.shape
    k_cur, v_cur = k, v
    if _round_kernels(q, causal, impl):
        m = torch.full((B, Tl), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Tl), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Tl, D), dtype=torch.float32, device=q.device)
        q_off = idx * Tl
        for r in range(n):
            k_off = ((idx - r) % n) * Tl
            m, l, acc = ring_round_fwd(q, k_cur, v_cur, m, l, acc, q_off, k_off, scale)
            if r + 1 < n:
                k_cur, v_cur = rotate((k_cur, v_cur), mesh)
        l_safe = torch.where(l == 0, 1.0, l)
        return (acc / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)
    m = torch.full((B, Tl), NEG, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, Tl), dtype=q.dtype, device=q.device)
    o = torch.zeros((B, Tl, D), dtype=q.dtype, device=q.device)
    for r in range(n):
        allowed = _round_mask(idx, r, n, Tl, causal, q.device)
        m, l, o = _block_update(q, k_cur, v_cur, m, l, o, allowed, scale)
        if r + 1 < n:
            k_cur, v_cur = rotate((k_cur, v_cur), mesh)
    # Causal attention guarantees l > 0 (each position sees itself); the
    # guard keeps a fully-masked row finite rather than NaN.
    l_safe = torch.where(l == 0, 1.0, l)
    return o / l_safe[..., None], m + torch.log(l_safe)


def _ring_bwd(q, k, v, out, lse, do, mesh: Mesh, causal: bool, scale: float, impl: str):
    """The backward ring (``ring_attention.py:231-304``): each rank adds its
    q chunk's contribution to the dK/dV accumulators of the block it holds,
    and the accumulators travel with their block; after the last round one
    more hop brings them home to the block's owner."""
    n, idx = mesh.size, mesh.rank
    B, Tl, D = q.shape
    do = do.to(q.dtype).contiguous()
    delta = torch.sum(do.to(torch.float32) * out.to(torch.float32), dim=-1)
    kernels = _round_kernels(q, causal, impl)
    q_off = idx * Tl
    dq = torch.zeros_like(q)
    k_cur, v_cur = k, v
    dk_cur, dv_cur = torch.zeros_like(k), torch.zeros_like(v)
    for r in range(n):
        if kernels:
            k_off = ((idx - r) % n) * Tl
            dq_p, dk_p, dv_p = ring_round_bwd(q, k_cur, v_cur, do, lse, delta, q_off, k_off, scale)
        else:
            allowed = _round_mask(idx, r, n, Tl, causal, q.device)[None]
            s = torch.where(allowed, torch.einsum("bqd,bkd->bqk", q, k_cur) * scale, NEG)
            # exp(s - lse) is the final softmax, not a running partial, so
            # every round's contribution is already normalised.
            p = torch.exp(s - lse[..., None]) * allowed
            ds = p * (torch.einsum("bqd,bkd->bqk", do, v_cur) - delta[..., None])
            dq_p = scale * torch.einsum("bqk,bkd->bqd", ds, k_cur)
            dk_p = scale * torch.einsum("bqk,bqd->bkd", ds, q)
            dv_p = torch.einsum("bqk,bqd->bkd", p, do)
        dq = dq + dq_p
        dk_cur, dv_cur = dk_cur + dk_p, dv_cur + dv_p
        if r + 1 < n:
            k_cur, v_cur, dk_cur, dv_cur = rotate((k_cur, v_cur, dk_cur, dv_cur), mesh)
        else:
            dk_cur, dv_cur = rotate((dk_cur, dv_cur), mesh)
    return dq, dk_cur, dv_cur


class _RingSpmd(torch.autograd.Function):
    """The ring on the local chunks; saves only ``(q, k, v, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal, scale, impl):
        q, k, v = (t.contiguous() for t in (q, k, v))
        out, lse = _ring_fwd_core(q, k, v, mesh, causal, scale, impl)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, causal, scale, impl)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def ring_attention_spmd(
    q_local: torch.Tensor,
    k_local: torch.Tensor,
    v_local: torch.Tensor,
    mesh: Mesh,
    *,
    causal: bool = True,
    scale: float | None = None,
    impl: str = "jnp",
) -> torch.Tensor:
    """The ring body on this rank's chunks ``[B, T/n, D]``: every rank calls
    it together, and gets its chunk of the attention output. Differentiable,
    with the backward ring described in ``_ring_bwd``."""
    if scale is None:
        scale = q_local.shape[-1] ** -0.5
    if impl not in IMPLS:
        # A silent fallback would report the materialised path as the kernels.
        raise ValueError(f'unknown impl {impl!r}; choose "jnp" or "flash"')
    if impl == "flash" and not causal:
        raise ValueError('impl="flash" supports causal attention only')
    return _RingSpmd.apply(q_local, k_local, v_local, mesh, causal, float(scale), impl)


def ring_attention(
    mesh: Mesh,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    impl: str = "jnp",
) -> torch.Tensor:
    """Exact attention with the time axis split over the ring.

    ``q, k, v [B, T, D]`` (heads folded into B), the full tensors on every
    rank; ``T`` must divide by the ring's size. Rank ``i`` attends its
    chunk ``[i*T/n, (i+1)*T/n)`` of the queries to each K/V block as it
    passes; the chunks' outputs are all-gathered, so every rank returns the
    full ``[B, T, D]``, equal to single-device (causal) attention."""
    n = mesh.size
    T = q.shape[1]
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by {DATA_AXIS}={n}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q_l, k_l, v_l = local_chunk(mesh, 1, q, k, v)
    out = ring_attention_spmd(q_l, k_l, v_l, mesh, causal=causal, scale=scale, impl=impl)
    return all_gather(out, mesh, dim=1)
