"""Headerless-CSV ingest against a dynamic schema.

The numpy parser of ``tpuflow/data/csv_io.py``: same field validation, same
dtypes (int32 / float32 / unicode). The native ``csv.cc`` binding and the
resilience retries of the JAX package are not ported yet.
"""

from __future__ import annotations

import numpy as np

from tpuflow_torch.data.schema import Schema


def read_csv(path: str, schema: Schema) -> dict[str, np.ndarray]:
    """Read a headerless CSV into per-column arrays, typed by the schema."""
    return parse_rows(iter_csv_lines(path), schema, source=path)


def iter_csv_lines(path: str):
    """Yield ``(lineno, text)`` for every non-blank line."""
    with open(path, "r", encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.rstrip("\n").rstrip("\r")
            if line:
                yield lineno, line


def parse_rows(
    rows, schema: Schema, source: str = "<csv>"
) -> dict[str, np.ndarray]:
    """Parse ``(lineno, text)`` rows into typed per-column arrays."""
    ncols = len(schema.columns)
    cells: list[list[str]] = [[] for _ in range(ncols)]
    for lineno, line in rows:
        parts = line.split(",")
        if len(parts) != ncols:
            raise ValueError(
                f"{source}:{lineno}: expected {ncols} fields, got {len(parts)}"
            )
        for i, p in enumerate(parts):
            cells[i].append(p)
    out: dict[str, np.ndarray] = {}
    for spec, col in zip(schema.columns, cells):
        if spec.kind == "int":
            out[spec.name] = np.asarray(col, dtype=np.int32)
        elif spec.kind == "float":
            out[spec.name] = np.asarray(col, dtype=np.float32)
        else:
            out[spec.name] = np.asarray(col, dtype=np.str_)
    return out
