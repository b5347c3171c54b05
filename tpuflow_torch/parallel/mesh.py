"""The ring's process group: counterpart of ``tpuflow/parallel/mesh.py``.

JAX drives several devices from one process and names an axis of a device
mesh; the port runs one process per rank of a ``torch.distributed`` group.
A ``Mesh`` here is the one data axis the ring runs over: the process group,
its size (JAX's ``mesh.shape[axis]``), this process's rank in it, and the
device this rank computes on.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from tpuflow_torch import resolve_device
from tpuflow_torch.parallel.placement import device_count

DATA_AXIS = "data"


@dataclass(frozen=True, eq=False)
class Mesh:
    """One ring: ``size`` ranks of ``group``, this process at ``rank``,
    computing on ``device``. ``backend`` is the group's (``"nccl"`` or
    ``"gloo"``); on gloo, tensors on the card travel through host copies."""

    group: Any
    size: int
    rank: int
    device: torch.device
    backend: str

    def global_rank(self, group_rank: int) -> int:
        """The default group's rank of this group's ``group_rank``."""
        return dist.get_global_rank(self.group, group_rank)


def make_mesh(group=None, device=None) -> Mesh:
    """The ring over ``group`` (None: the default group), computing on
    ``device`` (None: this rank's card, ``LOCAL_RANK`` or the global rank
    modulo the cards present, raising when there is none; ``"cpu"`` runs
    the kernels' plain versions). ``torch.distributed`` must be initialised
    (``init_distributed``)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs torch.distributed initialised: call "
            "tpuflow_torch.parallel.init_distributed() on every rank first"
        )
    group = dist.group.WORLD if group is None else group
    if device is None:
        resolve_device(None)  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % device_count())
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    backend = str(dist.get_backend(group))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group computes on a card, not on {dev}")
    return Mesh(group=group, size=dist.get_world_size(group),
                rank=dist.get_rank(group), device=dev, backend=backend)
