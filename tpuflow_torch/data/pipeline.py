"""Host pipeline for the sequence models: wells -> windows -> splits -> batches.

Counterpart of the windowed half of ``tpuflow/data/pipeline.py``: window each
well's log, split 64/16/20 at the window level (reference cnn.py:68),
normalise features and target with train-split statistics, and serve
minibatches. Everything is numpy with seeded ``default_rng``, so a seed
gives byte-identical arrays in both packages. The tabular pipeline
(``FeaturePipeline``) is not ported yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple, Sequence

import numpy as np

from tpuflow_torch.data.schema import Schema
from tpuflow_torch.data.splits import DEFAULT_FRACTIONS, random_split
from tpuflow_torch.data.synthetic import WellLog
from tpuflow_torch.data.windows import sliding_windows, teacher_forcing_pairs


class ArrayDataset(NamedTuple):
    """Host arrays: x [N, ...] float32, y [N] or [N, T] float32."""

    x: np.ndarray
    y: np.ndarray

    @property
    def n(self) -> int:
        return len(self.x)


@dataclass
class WindowedSplits:
    train: ArrayDataset
    val: ArrayDataset
    test: ArrayDataset
    feature_names: tuple[str, ...]
    norm_mean: np.ndarray
    norm_std: np.ndarray
    # Target standardization (train stats): training runs in scaled units so
    # the clip=6 loss is meaningful; invert with y*target_std + target_mean.
    target_mean: float = 0.0
    target_std: float = 1.0

    def inverse_target(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y) * self.target_std + self.target_mean


_SEQ_CHANNELS = ("pressure", "choke", "glr", "temperature", "water_cut")


def sequence_feature_names(schema: Schema, well_column: str | None) -> tuple[str, ...]:
    """The sequence-model feature channels: the schema's continuous feature
    columns minus the well-grouping column, in schema order."""
    names = tuple(
        c.name for c in schema.continuous_features if c.name != well_column
    )
    if not names:
        raise ValueError("no continuous feature columns for sequence model")
    return names


def prepare_windowed(
    wells: Sequence[WellLog],
    window: int = 24,
    stride: int = 1,
    seed: int = 0,
    fractions: Sequence[float] = DEFAULT_FRACTIONS,
    teacher_forcing: bool = False,
    append_gilbert: bool = False,
) -> WindowedSplits:
    """Window each well's log, then split by window across all wells, with
    normalisation stats from the training windows only. ``append_gilbert``
    adds the RAW per-timestep Gilbert prediction as the last channel."""
    pairs = [
        (
            np.stack([getattr(w, ch) for ch in _SEQ_CHANNELS], axis=1).astype(
                np.float32
            ),
            w.flow,
        )
        for w in wells
    ]
    return _windowed_from_pairs(
        pairs, _SEQ_CHANNELS, window, stride, seed, fractions, teacher_forcing,
        append_gilbert,
    )


def prepare_windowed_table(
    schema: Schema,
    columns: dict[str, np.ndarray],
    well_column: str | None = None,
    window: int = 24,
    stride: int = 1,
    seed: int = 0,
    fractions: Sequence[float] = DEFAULT_FRACTIONS,
    teacher_forcing: bool = False,
    append_gilbert: bool = False,
) -> WindowedSplits:
    """The sequence path from a dynamic-schema table (CSV ingest). Rows are
    time-ordered within each well; ``well_column`` groups rows into per-well
    logs, ``None`` treats the table as one well's log."""
    feature_names = sequence_feature_names(schema, well_column)
    target = columns[schema.target].astype(np.float32)
    series_all = np.stack(
        [columns[n].astype(np.float32) for n in feature_names], axis=1
    )
    if well_column is None:
        pairs = [(series_all, target)]
    else:
        # Stable argsort of the inverse codes clusters each well's rows
        # while keeping their original (time) order.
        ids = np.asarray(columns[well_column])
        _, inverse, counts = np.unique(ids, return_inverse=True, return_counts=True)
        grouped = np.argsort(inverse, kind="stable")
        pairs = [
            (series_all[rows], target[rows])
            for rows in np.split(grouped, np.cumsum(counts)[:-1])
        ]
    return _windowed_from_pairs(
        pairs, feature_names, window, stride, seed, fractions, teacher_forcing,
        append_gilbert,
    )


def _windowed_from_pairs(
    pairs: Sequence[tuple[np.ndarray, np.ndarray]],
    feature_names: tuple[str, ...],
    window: int,
    stride: int,
    seed: int,
    fractions: Sequence[float],
    teacher_forcing: bool,
    append_gilbert: bool = False,
) -> WindowedSplits:
    if append_gilbert:
        # The RAW Gilbert channel goes last and stays out of normalisation
        # (mean 0 / std 1 below), as the serving path appends it.
        from tpuflow_torch.core.gilbert import append_gilbert_channel

        pairs = [
            (append_gilbert_channel(series, feature_names), target)
            for series, target in pairs
        ]
    xs, ys = [], []
    for series, target in pairs:
        fn = teacher_forcing_pairs if teacher_forcing else sliding_windows
        x, y = fn(series, target, length=window, stride=stride)
        if len(x):
            xs.append(x)
            ys.append(y)
    if not xs:
        raise ValueError(f"no windows: every series is shorter than window={window}")
    x = np.concatenate(xs, axis=0)
    y = np.concatenate(ys, axis=0)
    tr_i, va_i, te_i = random_split(len(x), fractions, seed)

    mean = x[tr_i].reshape(-1, x.shape[-1]).mean(axis=0)
    std = x[tr_i].reshape(-1, x.shape[-1]).std(axis=0)
    std = np.where(std < 1e-8, 1.0, std).astype(np.float32)
    if append_gilbert:
        mean = mean.copy()
        mean[-1] = 0.0
        std[-1] = 1.0

    def norm(a):
        return ((a - mean) / std).astype(np.float32)

    t_mean = float(y[tr_i].mean())
    t_std = float(y[tr_i].std())
    t_std = t_std if t_std > 1e-8 else 1.0

    def mk(idx):
        return ArrayDataset(norm(x[idx]), ((y[idx] - t_mean) / t_std).astype(np.float32))

    return WindowedSplits(
        mk(tr_i), mk(va_i), mk(te_i), tuple(feature_names), mean, std, t_mean, t_std
    )


def epoch_order(
    n: int, batch_size: int, seed: int | None = None, drop_remainder: bool = True
) -> np.ndarray:
    """The row order one pass of ``batches`` visits: a seeded permutation
    (``np.random.default_rng(seed)``) or ``arange`` for ``seed=None``, cut to
    whole batches when ``drop_remainder``."""
    order = np.random.default_rng(seed).permutation(n) if seed is not None else np.arange(n)
    return order[: n - (n % batch_size)] if drop_remainder else order


def batches(
    dataset: ArrayDataset,
    batch_size: int,
    seed: int | None = None,
    drop_remainder: bool = True,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Minibatch iterator with optional shuffling; ``drop_remainder=True``
    keeps every batch the same shape."""
    order = epoch_order(dataset.n, batch_size, seed, drop_remainder)
    for s in range(0, len(order), batch_size):
        idx = order[s : s + batch_size]
        yield dataset.x[idx], dataset.y[idx]
