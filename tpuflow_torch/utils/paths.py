"""Artifact-layout paths under a local storage root.

Counterpart of ``tpuflow/utils/paths.py``, cut to what the serving slice
needs: ``join_path`` and ``open_file`` for local paths. Remote URIs (gs://,
fsspec) are not ported yet and raise.
"""

from __future__ import annotations

import os
import re
from typing import IO

_URI_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def _local(path: str) -> str:
    if _URI_RE.match(path):
        raise ValueError(
            f"{path!r}: remote storage URIs are not ported to tpuflow_torch "
            "yet (ROADMAP.md); use a local directory"
        )
    return path


def join_path(base: str, *parts: str) -> str:
    """Join artifact-layout components under a local root, absolute."""
    return os.path.abspath(os.path.join(_local(base), *parts))


def open_file(path: str, mode: str = "r", **kwargs) -> IO:
    """Open a local path; parent directories are created on write."""
    _local(path)
    if "w" in mode or "a" in mode or "x" in mode:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    return open(path, mode, **kwargs)
