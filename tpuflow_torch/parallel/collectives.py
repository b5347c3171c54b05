"""The ring's collectives over ``torch.distributed``: counterpart of
``tpuflow/parallel/collectives.py``.

Each is differentiable, with the backward that the port's boundary rule
(``parallel/ring_attention.py``) gives: every rank holds the same upstream
gradient of a replicated value, so

- ``ppermute_ring`` sends rank i's tensor to rank i + shift; its backward
  rotates the gradient by -shift;
- ``all_gather`` concatenates the ranks' chunks along a dim; its backward
  takes this rank's slice of the gradient (not a reduce-scatter sum, which
  would make it ``size`` times too large);
- ``local_chunk`` is its transpose: this rank's chunk of a replicated
  tensor, whose backward all-gathers the chunks' gradients;
- ``pvary`` enters a replicated parameter into per-rank work: the identity,
  whose backward sums the ranks' gradients (what ``shard_map`` does for a
  ``P()`` input);
- ``psum`` and ``pmean`` reduce over the ranks; their result is replicated,
  so the backward is the identity (``pmean``: divided by ``size``).

On a gloo group a tensor on the card is copied to the host before it is
sent and back after it arrives; on NCCL it goes directly. Sends and receives
are posted together (``batch_isend_irecv``), so a ring of any size cannot
deadlock on their order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpuflow_torch.parallel.mesh import Mesh


def _staged(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` as the group's backend takes it: contiguous, and on the host
    for a gloo group."""
    x = x.detach()
    if mesh.backend == "gloo" and x.device.type == "cuda":
        return x.cpu()
    return x.contiguous()


def rotate(tensors, mesh: Mesh, shift: int = 1) -> list[torch.Tensor]:
    """Send each tensor to rank ``rank + shift`` and receive its
    counterpart from rank ``rank - shift`` (modulo the ring), all in one
    batch of point-to-point operations. Not differentiable: the ring's
    autograd Functions call it inside their forward and backward."""
    tensors = list(tensors)
    n = mesh.size
    if n == 1 or shift % n == 0:
        return tensors
    dst = mesh.global_rank((mesh.rank + shift) % n)
    src = mesh.global_rank((mesh.rank - shift) % n)
    sends = [_staged(t, mesh) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = []
    for tag, (s, r) in enumerate(zip(sends, recvs)):
        ops.append(dist.P2POp(dist.isend, s, dst, mesh.group, tag))
        ops.append(dist.P2POp(dist.irecv, r, src, mesh.group, tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


def _gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    staged = _staged(x, mesh)
    parts = [torch.empty_like(staged) for _ in range(mesh.size)]
    dist.all_gather(parts, staged, group=mesh.group)
    return torch.cat(parts, dim=dim).to(x.device)


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    staged = _staged(x, mesh).clone()
    dist.all_reduce(staged, op=dist.ReduceOp.SUM, group=mesh.group)
    return staged.to(x.device)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, shift):
        ctx.mesh, ctx.shift = mesh, shift
        return rotate([x], mesh, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return rotate([g], ctx.mesh, -ctx.shift)[0], None, None


def ppermute_ring(x: torch.Tensor, mesh: Mesh, shift: int = 1) -> torch.Tensor:
    """Rank i's ``x`` arrives at rank i + shift (``collectives.py:36-41``);
    a ring of one is the identity."""
    if mesh.size == 1:
        return x
    return _PPermute.apply(x, mesh, shift)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        return _gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        start = ctx.mesh.rank * ctx.size
        return g.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (JAX's
    tiled ``all_gather``); the backward takes this rank's slice."""
    if mesh.size == 1:
        return x
    return _AllGather.apply(x, mesh, dim)


class _LocalChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dim, *xs):
        ctx.mesh, ctx.dim = mesh, dim
        ctx.shapes = [x.shape for x in xs]
        chunks = []
        for x in xs:
            size = x.shape[dim] // mesh.size
            chunks.append(x.narrow(dim, mesh.rank * size, size).contiguous())
        return tuple(chunks)

    @staticmethod
    def backward(ctx, *grads):
        # One all-gather for all the chunks' gradients, flattened together.
        mesh, dim = ctx.mesh, ctx.dim
        flat = torch.cat([g.reshape(-1) for g in grads])
        staged = _staged(flat, mesh)
        parts = [torch.empty_like(staged) for _ in range(mesh.size)]
        dist.all_gather(parts, staged, group=mesh.group)
        parts = [p.to(flat.device) for p in parts]
        out, offset = [], 0
        for g in grads:
            n = g.numel()
            out.append(torch.cat([p[offset : offset + n].view(g.shape) for p in parts], dim=dim))
            offset += n
        return (None, None, *out)


def local_chunk(mesh: Mesh, dim: int, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """This rank's chunk along ``dim`` of each replicated tensor (whose
    size there must divide by the ring's); the backward all-gathers the
    chunks' gradients into the full gradient, on every rank."""
    for x in xs:
        if x.shape[dim] % mesh.size:
            raise ValueError(
                f"dim {dim} of {tuple(x.shape)} does not divide by the ring's {mesh.size} ranks")
    if mesh.size == 1:
        return tuple(xs)
    return _LocalChunk.apply(mesh, dim, *xs)


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), ctx.mesh)
        out, offset = [], 0
        for g in grads:
            out.append(flat[offset : offset + g.numel()].view(g.shape))
            offset += g.numel()
        return (None, *out)


def pvary(mesh: Mesh, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Replicated parameters entering per-rank work: the identity forward,
    and a backward that sums each gradient over the ranks (one
    all-reduce for all of them)."""
    if mesh.size == 1:
        return tuple(xs)
    return _PVary.apply(mesh, *xs)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, mean):
        ctx.scale = 1.0 / mesh.size if mean else 1.0
        return _all_reduce(x, mesh) * ctx.scale

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the ranks' ``x``, on every rank."""
    return _PSum.apply(x, mesh, False)


def pmean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of the ranks' ``x``, on every rank."""
    return _PSum.apply(x, mesh, True)
