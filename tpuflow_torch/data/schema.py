"""Dynamic schema: per-submission column names/types as runtime config.

A copy of ``tpuflow/data/schema.py`` (the port imports nothing of the JAX
package). The schema is a runtime input, not code: comma-separated names and
types plus a target column, with int/float columns continuous and every other
kind categorical. ``target=None`` is the serving variant for unlabeled data.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Reference type-string mapping (cnn.py:53-58): int | float | <anything else>.
_NUMPY_DTYPES = {"int": np.int32, "float": np.float32}
CONTINUOUS_KINDS = ("int", "float")


@dataclass(frozen=True)
class ColumnSpec:
    """One column: its name and reference-style type string."""

    name: str
    kind: str  # "int" | "float" | anything-else == categorical string

    @property
    def is_continuous(self) -> bool:
        return self.kind in CONTINUOUS_KINDS

    @property
    def numpy_dtype(self) -> np.dtype:
        return np.dtype(_NUMPY_DTYPES.get(self.kind, np.str_))


@dataclass(frozen=True)
class Schema:
    """A full per-submission schema: ordered columns plus the target.

    ``target=None`` denotes a features-only schema — unlabeled data at
    serving time (tpuflow.api.predict), where the target column the model
    was trained on does not exist yet.
    """

    columns: tuple[ColumnSpec, ...]
    target: str | None
    _by_name: dict = field(init=False, repr=False, compare=False, hash=False)

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate column names: {dupes}")
        if self.target is not None and self.target not in names:
            raise ValueError(
                f"target column {self.target!r} not in schema columns {names}"
            )
        object.__setattr__(self, "_by_name", {c.name: c for c in self.columns})

    @classmethod
    def from_cli(cls, names_csv: str, types_csv: str, target: str) -> "Schema":
        """Parse the reference's positional CLI contract.

        ``names_csv`` and ``types_csv`` are comma-separated (reference
        cnn.py:59-60); ``target`` is the target column name (cnn.py:43).
        """
        names = [n.strip() for n in names_csv.split(",") if n.strip()]
        kinds = [t.strip() for t in types_csv.split(",") if t.strip()]
        if len(names) != len(kinds):
            raise ValueError(
                f"{len(names)} column names but {len(kinds)} types"
            )
        return cls(
            columns=tuple(ColumnSpec(n, k) for n, k in zip(names, kinds)),
            target=target,
        )

    def __getitem__(self, name: str) -> ColumnSpec:
        return self._by_name[name]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    @property
    def feature_columns(self) -> tuple[ColumnSpec, ...]:
        """All non-target columns, in schema order."""
        return tuple(c for c in self.columns if c.name != self.target)

    @property
    def continuous_features(self) -> tuple[ColumnSpec, ...]:
        """int/float feature columns (reference cnn.py:93 selection)."""
        return tuple(c for c in self.feature_columns if c.is_continuous)

    @property
    def categorical_features(self) -> tuple[ColumnSpec, ...]:
        """Non-numeric feature columns (reference cnn.py:72 selection)."""
        return tuple(c for c in self.feature_columns if not c.is_continuous)

    @property
    def target_spec(self) -> ColumnSpec:
        return self._by_name[self.target]
