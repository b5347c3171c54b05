"""Seeded train/val/test splitting.

Counterpart of ``tpuflow/data/splits.py``: the reference's 64% / 16% / 20%
split (reference cnn.py:68), deterministic given a seed, with the same draws
from ``np.random.default_rng(seed)``, so both packages split alike.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

DEFAULT_FRACTIONS = (0.64, 0.16, 0.20)


def random_split(
    n: int,
    fractions: Sequence[float] = DEFAULT_FRACTIONS,
    seed: int = 0,
) -> tuple[np.ndarray, ...]:
    """Partition ``range(n)`` into len(fractions) disjoint sorted index
    arrays. Fractions must sum to 1; the last part takes the rounding
    remainder."""
    total = float(sum(fractions))
    if abs(total - 1.0) > 1e-6:
        raise ValueError(f"fractions must sum to 1, got {total}")
    perm = np.random.default_rng(seed).permutation(n)
    out = []
    start = 0
    for frac in fractions[:-1]:
        size = int(round(n * frac))
        out.append(np.sort(perm[start : start + size]))
        start += size
    out.append(np.sort(perm[start:]))
    return tuple(out)
