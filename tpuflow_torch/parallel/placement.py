"""Device placement seam: the one place that asks how many cards exist.

Counterpart of ``tpuflow/parallel/placement.py``. JAX asks ``jax.devices()``;
the port asks ``torch.cuda``. Mesh construction (``parallel/mesh.py``), the
process-group backend (``parallel/distributed.py``) and ``train``'s
``n_devices`` rule route through here, so "how many cards, and which one"
is answered in one file. A process sees the cards of its host; the port runs
one process per rank, so a data-parallel job over N cards is N processes
(``torchrun --nproc-per-node N`` or ``tpuflow_torch.parallel.spawn``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch import resolve_device


def local_devices() -> list[torch.device]:
    """The cards this process can launch on, in index order (the order every
    mesh and replica index refers to); empty without a card."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_count() -> int:
    """How many cards :func:`local_devices` returns."""
    return len(local_devices())


def device_kind(default: str = "cpu") -> str:
    """``torch.cuda.get_device_name`` of card 0, or ``default`` without a
    card (the epoch program's sweeps are keyed by it)."""
    return torch.cuda.get_device_name(0) if device_count() else default


def replica_devices(n: int, devices=None) -> list[torch.device]:
    """The first ``n`` cards, one replica each, never oversubscribed.
    Raises a ValueError naming the available count, so a replica count the
    host cannot place fails as configuration advice."""
    devices = local_devices() if devices is None else list(devices)
    if n < 1:
        raise ValueError(f"replica count must be >= 1, got {n}")
    if n > len(devices):
        raise ValueError(
            f"cannot place {n} replicas on {len(devices)} available card(s); "
            "lower the replica count or add cards"
        )
    return devices[:n]


def place(tree, device):
    """``tree`` (a tensor, a numpy array, a module, or dicts, lists and
    tuples of them) on ``device``; modules move in place."""
    if isinstance(tree, (torch.Tensor, torch.nn.Module)):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    if isinstance(tree, dict):
        return {k: place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, device) for v in tree)
    return tree


def device_put(x, where=None):
    """:func:`place` on ``where``, or on the default device (the card,
    raising when there is none) when ``where`` is None."""
    return place(x, resolve_device(where))
