"""Joining the ranks of a ring: counterpart of ``tpuflow/parallel/distributed.py``.

``init_distributed`` brings up the default ``torch.distributed`` group on
every rank, from explicit arguments or torchrun's environment variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); it does nothing
in a single process, as the JAX function does. The backend is NCCL when
each rank has a card of its own and gloo otherwise; gloo also serves ranks
that share one card, with the tensors the ring passes staged through host
memory (``collectives.py``). The group's timeout is finite, so a rank that
raises does not leave the others blocked in a receive for half an hour.

``spawn`` runs one function on the ranks of a fresh group on this host, one
process each, and returns their results: the CPU tests run the ring in four
gloo processes with it, and ``chip_smoke.py`` four ranks on the card.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from tpuflow_torch.parallel.placement import device_count

log = logging.getLogger(__name__)

TIMEOUT_S = 300.0  # the process group's, and spawn's for the whole run


def default_backend(world_size: int, device=None) -> str:
    """``"nccl"`` when every rank can have a card of its own, else
    ``"gloo"`` (ranks on the CPU, or sharing cards)."""
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available() and device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed(
    backend: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    init_method: str | None = None,
    timeout_s: float = TIMEOUT_S,
) -> bool:
    """Initialise the default process group; returns True when it is (or
    already was) initialised, False in a single process (no ``world_size``
    given and no ``WORLD_SIZE`` set). Unset arguments come from torchrun's
    environment; ``init_method`` defaults to ``env://``."""
    if dist.is_initialized():
        return True
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None:
        return False
    if rank is None:
        raise ValueError("init_distributed: world_size is set but rank is not (RANK)")
    backend = backend or default_backend(world_size)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s),
    )
    log.info("rank %d of %d joined a %s group", rank, world_size, backend)
    return True


def _rank_main(fn, args, rank, world_size, init_method, backend, device, timeout_s, results):
    try:
        from tpuflow_torch.parallel.mesh import make_mesh

        if device is not None and torch.device(device).type == "cpu":
            # The ranks share this host's cores: one default-sized thread
            # pool each would oversubscribe it world_size times over.
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        init_distributed(backend, rank, world_size, init_method, timeout_s)
        try:
            value = fn(make_mesh(device=device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, *args, backend: str | None = None, device=None,
          timeout_s: float = TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` new processes, joined in
    one group over a file store, and return the results in rank order.

    ``fn`` must be importable by name and its results picklable (numpy
    arrays, not tensors). Processes start with ``spawn``: a parent that
    holds a CUDA context cannot fork. ``device`` is each rank's (None: its
    card); ``backend`` defaults to ``default_backend``. Raises, with the
    rank's traceback, when a rank raises or dies, and raises TimeoutError
    when the ranks are not done in ``timeout_s``; every process is ended
    before it returns."""
    backend = backend or default_backend(world_size, device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    done: dict[int, object] = {}
    with tempfile.TemporaryDirectory(prefix="tpuflow_ring_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [
            ctx.Process(
                target=_rank_main, daemon=True,
                args=(fn, args, rank, world_size, init_method, backend, device,
                      timeout_s, results),
            )
            for rank in range(world_size)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(done) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn: {world_size - len(done)} of {world_size} ranks "
                        f"not done after {timeout_s:.0f} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in done]
                    if dead:
                        raise RuntimeError(
                            f"spawn: rank(s) {dead} died (exit codes "
                            f"{[procs[r].exitcode for r in dead]}) without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} of {world_size} failed:\n{value}")
                done[rank] = value
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 5.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join(5)
    return [done[r] for r in range(world_size)]
