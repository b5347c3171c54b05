"""Data-parallel train and eval steps over ``torch.distributed``.

Counterpart of ``tpuflow/parallel/dp.py``. JAX holds a replica of the
parameters on each device of a mesh and a shard of every batch, and
all-reduces the gradients with ``lax.pmean`` inside one compiled step. The
port runs one process per rank (``parallel/mesh.py``), which is JAX's
multi-process recipe (``make_process_fed_steps``):

- every rank builds the same seeded global batch order and keeps its
  contiguous ``process_batch_bounds`` rows of each batch;
- ``replicate`` broadcasts rank 0's parameters, so the replicas start equal;
- the train step runs the forward and backward on this rank's rows, then
  one all-reduce (mean) of every gradient and the loss, packed in one flat
  buffer, then the optimizer's step: global-norm clipping acts on the
  averaged gradient, as optax does after JAX's ``pmean``;
- the eval step sums the masked ``loss_sum``, ``mae_sum`` and ``count``
  over the ranks, so every rank sees the same validation loss and stops at
  the same epoch.

The all-reduce is an explicit collective of the step (``collectives.pmean``:
staged through host memory on a gloo group), not ``DistributedDataParallel``,
whose bucket hooks would hide it from the step. All-reduced values are
equal on every rank, so the replicas' parameters stay bitwise equal.

``shard_batch``, ``shard_epoch`` and ``epoch_sharding`` assemble per-process
slices into global ``jax.Array``s; the port has no global array, so they
have no counterpart beyond the slicing in ``make_process_fed_steps``.
``make_dp_epoch_step``, the scanned data-parallel epoch, is not ported: a
gloo group's collectives cannot be captured in a CUDA graph, so data
parallelism trains through per-batch steps (ROADMAP.md Queue 1 item 8).
Dropout draws different masks on each rank: ``rank_seed`` gives each rank's
generator its own seed, as JAX folds the device index into the key.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from tpuflow_torch.parallel.collectives import _staged, pmean, psum
from tpuflow_torch.parallel.mesh import Mesh
from tpuflow_torch.train.optim import Optimizer
from tpuflow_torch.train.steps import make_eval_step, make_train_step

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of ``rank`` in a job seeded ``seed``: distinct for
    each rank, the same on every run (JAX's ``fold_in`` of the device index,
    ``dp.py:42-44``)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def process_batch_bounds(
    global_batch: int, rank: int | None = None, size: int | None = None
) -> tuple[int, int]:
    """``[start, stop)`` rows of the global batch that ``rank`` of ``size``
    ranks trains on (None: this process's rank and the default group's
    size, or 0 of 1 without a group): a contiguous slice, as in JAX."""
    grouped = dist.is_available() and dist.is_initialized()
    rank = (dist.get_rank() if grouped else 0) if rank is None else rank
    size = (dist.get_world_size() if grouped else 1) if size is None else size
    if global_batch % size:
        raise ValueError(f"global batch {global_batch} not divisible by {size} processes")
    per = global_batch // size
    return rank * per, (rank + 1) * per


@torch.no_grad()
def replicate(mesh: Mesh, model: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers, broadcast over the mesh's group into
    ``model`` on every rank (one broadcast per dtype); returns ``model``."""
    tensors = list(model.parameters()) + list(model.buffers())
    if mesh.size == 1 or not tensors:
        return model
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _staged(torch.cat([t.reshape(-1) for t in group]), mesh)
        dist.broadcast(flat, src=mesh.global_rank(0), group=mesh.group)
        flat = flat.to(group[0].device)
        offset = 0
        for t in group:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()
    return model


def make_dp_train_step(
    model: torch.nn.Module, optimizer: Optimizer, loss_fn: LossFn, mesh: Mesh
):
    """``step(x, y) -> {"loss", "grad_norm"}`` on this rank's rows ``x``,
    ``y``: the loss and the global norm of the averaged gradient, f32 device
    scalars equal on every rank. One all-reduce a step carries every
    gradient and the loss; ``optimizer`` (bound to ``model``'s parameters)
    then updates the parameters in place."""
    params = optimizer.params

    def all_reduce(loss: torch.Tensor) -> torch.Tensor:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        flat = pmean(torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)]), mesh)
        offset = 0
        for p in params:
            p.grad = flat[offset : offset + p.numel()].view_as(p)
            offset += p.numel()
        return flat[-1]

    return make_train_step(model, optimizer, loss_fn, reduce=all_reduce)


def make_dp_eval_step(model: torch.nn.Module, loss_fn: LossFn, mesh: Mesh):
    """``step(x, y, mask) -> {"loss_sum", "mae_sum", "count"}`` on this
    rank's rows, each summed over the ranks (one all-reduce)."""
    local = make_eval_step(model, loss_fn)

    def step(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> dict:
        m = local(x, y, mask)
        sums = psum(torch.stack([m["loss_sum"], m["mae_sum"], m["count"]]), mesh)
        return {"loss_sum": sums[0], "mae_sum": sums[1], "count": sums[2]}

    return step


def make_process_fed_steps(mesh: Mesh, train_fn, eval_fn):
    """Steps that take the global batch, as every rank builds it, and pass
    this rank's ``process_batch_bounds`` rows to ``train_fn(x, y)`` and
    ``eval_fn(x, y, mask)``."""

    def rows(n: int) -> slice:
        return slice(*process_batch_bounds(n, mesh.rank, mesh.size))

    def train_step(x, y):
        s = rows(len(x))
        return train_fn(x[s], y[s])

    def eval_step(x, y, mask):
        s = rows(len(x))
        return eval_fn(x[s], y[s], mask[s])

    return train_step, eval_step
