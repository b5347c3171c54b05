"""Best-checkpoint reads and writes in the JAX package's store layout.

Counterpart of ``tpuflow/storage/checkpoint.py::StoreCheckpointer`` over a
local directory, with the checksummed-npz leaf codec of
``tpuflow/elastic/exchange.py`` (``_savez`` / ``_loadz`` /
``leaves_crc32``). The JAX package writes this format itself through
``StoreCheckpointer(local_dir, name)``, so one artifact is readable by both
packages. Layout under ``{root}/models/{name}/``::

    steps/{step:08d}.npz    checksummed leaves (flax tree-leaves order)
    steps/{step:08d}.json   sidecar: val_loss + per-leaf shapes/dtypes
    BEST                    pointer doc -> the winning .npz

Orbax checkpoint trees (the JAX package's default for local roots) need
orbax and stay JAX-only.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
import zlib

import numpy as np

POINTER_SCHEMA = "tpuflow.storage.pointer/v1"


def leaves_crc32(leaves: list[np.ndarray]) -> int:
    """CRC32 over every leaf's shape, dtype and raw bytes."""
    crc = 0
    for leaf in leaves:
        a = np.ascontiguousarray(leaf)
        crc = zlib.crc32(repr((a.shape, a.dtype.str)).encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFFFFFF


def encode_leaves(leaves: list[np.ndarray]) -> bytes:
    """Leaves -> checksummed npz bytes."""
    buf = io.BytesIO()
    np.savez(buf, n_leaves=np.int64(len(leaves)),
             crc32=np.uint64(leaves_crc32(leaves)),
             **{f"arr_{i}": leaf for i, leaf in enumerate(leaves)})
    return buf.getvalue()


def decode_leaves(data: bytes) -> list[np.ndarray]:
    """Checksummed npz bytes -> leaves; raises ``ValueError`` on a corrupt
    or truncated payload."""
    with np.load(io.BytesIO(data)) as z:
        n = int(z["n_leaves"])
        leaves = [z[f"arr_{i}"] for i in range(n)]
        if "crc32" in z.files:  # pre-checksum files stay readable
            want = int(z["crc32"])
            got = leaves_crc32(leaves)
            if got != want:
                raise ValueError(
                    f"param payload checksum mismatch (crc32 {got:#010x}"
                    f" != recorded {want:#010x}) — torn file or truncated read"
                )
    return leaves


def _write_atomic(path: str, data: bytes) -> None:
    # tmp + fsync + rename, as the JAX package's LocalStore puts.
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class StoreCheckpointer:
    """Best-by-val-loss checkpoints under ``{root}/models/{name}``."""

    def __init__(self, root: str, name: str = "model"):
        self.root = os.path.abspath(root)
        self.prefix = f"models/{name}"

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/"))

    def _step_key(self, step: int, ext: str) -> str:
        return f"{self.prefix}/steps/{step:08d}.{ext}"

    def _pointer(self) -> dict | None:
        try:
            with open(self._path(f"{self.prefix}/BEST"), "rb") as f:
                doc = json.loads(f.read())
        except (FileNotFoundError, ValueError):
            return None
        if not isinstance(doc, dict) or "target" not in doc:
            return None
        return doc

    def maybe_save(self, step: int, leaves: list[np.ndarray], val_loss: float) -> bool:
        """Keep ``leaves`` as step ``step`` when ``val_loss`` beats the
        current best. Payload, sidecar, then the pointer; the superseded
        step is deleted after the pointer moved."""
        doc = self._pointer()
        if doc is not None and float(val_loss) >= float(
            doc.get("meta", {}).get("val_loss", float("inf"))
        ):
            return False
        leaves = [np.asarray(leaf) for leaf in leaves]
        target = self._step_key(step, "npz")
        _write_atomic(self._path(target), encode_leaves(leaves))
        _write_atomic(
            self._path(self._step_key(step, "json")),
            json.dumps({
                "step": int(step),
                "val_loss": float(val_loss),
                "leaves": [
                    {"shape": list(leaf.shape), "dtype": str(leaf.dtype)}
                    for leaf in leaves
                ],
            }).encode("utf-8"),
        )
        pointer = {
            "schema": POINTER_SCHEMA,
            "target": target,
            "generation": (doc.get("generation", 1) + 1) if doc else 1,
            "previous": doc["target"] if doc else None,
            "time": time.time(),
            "meta": {"step": int(step), "val_loss": float(val_loss)},
        }
        _write_atomic(
            self._path(f"{self.prefix}/BEST"),
            json.dumps(pointer, sort_keys=True).encode("utf-8"),
        )
        if doc is not None:
            old = int(doc.get("meta", {}).get("step", -1))
            if old >= 0 and old != int(step):
                for ext in ("npz", "json"):
                    try:
                        os.remove(self._path(self._step_key(old, ext)))
                    except FileNotFoundError:
                        pass
        return True

    def restore_best(self) -> list[np.ndarray]:
        """The best checkpoint's leaves, in flax tree-leaves order."""
        doc = self._pointer()
        if doc is None:
            directory = self._path(self.prefix)
            if os.path.isdir(directory) and any(
                e.isdigit() for e in os.listdir(directory)
            ):
                raise ValueError(
                    f"{directory} holds an Orbax checkpoint tree, which only "
                    "the JAX package reads; re-save the params with "
                    "tpuflow.storage.checkpoint.StoreCheckpointer (checksummed "
                    "npz) to serve them from tpuflow_torch"
                )
            raise FileNotFoundError(f"no checkpoint under {directory}")
        with open(self._path(doc["target"]), "rb") as f:
            return decode_leaves(f.read())
