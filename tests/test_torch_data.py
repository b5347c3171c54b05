"""The port's windowed data pipeline against the JAX package's: windows,
split indices, normalisation statistics and epoch batch order must be
byte-identical (both are numpy with seeded ``default_rng``)."""

import numpy as np
import pytest

from tpuflow.data.pipeline import batches as jax_batches
from tpuflow.data.pipeline import prepare_windowed as jax_prepare_windowed
from tpuflow.data.pipeline import prepare_windowed_table as jax_prepare_table
from tpuflow.data.schema import Schema as JaxSchema
from tpuflow.data.splits import random_split as jax_random_split
from tpuflow.data.synthetic import generate_wells as jax_generate_wells
from tpuflow.data.synthetic import wells_to_table
from tpuflow.data.windows import sliding_windows as jax_sliding_windows
from tpuflow.data.windows import teacher_forcing_pairs as jax_teacher_forcing
from tpuflow_torch.data.pipeline import (
    batches,
    epoch_order,
    prepare_windowed,
    prepare_windowed_table,
    sequence_feature_names,
)
from tpuflow_torch.data.schema import Schema
from tpuflow_torch.data.splits import DEFAULT_FRACTIONS, random_split
from tpuflow_torch.data.synthetic import generate_wells
from tpuflow_torch.data.windows import sliding_windows, teacher_forcing_pairs

NAMES = "pressure,choke,glr,temperature,water_cut,completion,well,flow"
TYPES = "float,float,float,float,float,string,string,float"


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_splits(got, want):
    for split in ("train", "val", "test"):
        _same(getattr(got, split).x, getattr(want, split).x)
        _same(getattr(got, split).y, getattr(want, split).y)
    assert tuple(got.feature_names) == tuple(want.feature_names)
    _same(got.norm_mean, want.norm_mean)
    _same(got.norm_std, want.norm_std)
    assert (got.target_mean, got.target_std) == (want.target_mean, want.target_std)


@pytest.mark.parametrize("length,stride", [(8, 1), (5, 3), (64, 1)])
def test_windows_match_jax(length, stride):
    rng = np.random.default_rng(length + stride)
    series = rng.standard_normal((40, 5)).astype(np.float32)
    targets = rng.standard_normal(40).astype(np.float32)
    for port, jax_fn in ((sliding_windows, jax_sliding_windows),
                         (teacher_forcing_pairs, jax_teacher_forcing)):
        got = port(series, targets, length, stride)
        want = jax_fn(series, targets, length, stride)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("n,seed", [(3912, 0), (114, 1), (7, 2)])
def test_split_indices_match_jax(n, seed):
    got = random_split(n, seed=seed)
    want = jax_random_split(n, seed=seed)
    assert len(got) == len(want) == len(DEFAULT_FRACTIONS)
    for g, w in zip(got, want):
        _same(g, w)
    with pytest.raises(ValueError, match="sum to 1"):
        random_split(10, (0.5, 0.2))


@pytest.mark.parametrize("teacher_forcing", [True, False])
def test_prepare_windowed_matches_jax(teacher_forcing):
    kw = dict(window=8, stride=1, seed=3, teacher_forcing=teacher_forcing)
    got = prepare_windowed(generate_wells(n_wells=2, steps=64, seed=5), **kw)
    want = jax_prepare_windowed(jax_generate_wells(n_wells=2, steps=64, seed=5), **kw)
    _same_splits(got, want)
    assert got.train.n == 73  # 2 wells x 57 windows, split 64/16/20


@pytest.mark.parametrize("well_column", ["well", None])
def test_prepare_windowed_table_matches_jax(well_column):
    cols = wells_to_table(jax_generate_wells(n_wells=2, steps=64, seed=6))
    cols["well"] = np.repeat(["w1", "w0"], 64)
    kw = dict(well_column=well_column, window=8, seed=1, teacher_forcing=True)
    got = prepare_windowed_table(Schema.from_cli(NAMES, TYPES, "flow"), cols, **kw)
    want = jax_prepare_table(JaxSchema.from_cli(NAMES, TYPES, "flow"), cols, **kw)
    _same_splits(got, want)
    assert sequence_feature_names(Schema.from_cli(NAMES, TYPES, "flow"), "well") == (
        "pressure", "choke", "glr", "temperature", "water_cut")


def test_append_gilbert_channel_matches_jax():
    kw = dict(window=8, seed=0, teacher_forcing=True, append_gilbert=True)
    got = prepare_windowed(generate_wells(n_wells=2, steps=64, seed=2), **kw)
    want = jax_prepare_windowed(jax_generate_wells(n_wells=2, steps=64, seed=2), **kw)
    np.testing.assert_allclose(got.train.x, want.train.x, rtol=1e-6)
    assert (got.norm_mean[-1], got.norm_std[-1]) == (0.0, 1.0)


@pytest.mark.parametrize("seed,drop", [(4, True), (None, False), (7, False)])
def test_epoch_batch_order_matches_jax(seed, drop):
    splits = prepare_windowed(generate_wells(n_wells=2, steps=64, seed=0),
                              window=8, seed=0, teacher_forcing=True)
    got = list(batches(splits.train, 5, seed=seed, drop_remainder=drop))
    want = list(jax_batches(splits.train, 5, seed=seed, drop_remainder=drop))
    assert len(got) == len(want) == (14 if drop else 15)
    for (gx, gy), (wx, wy) in zip(got, want):
        _same(gx, wx)
        _same(gy, wy)
    order = epoch_order(splits.train.n, 5, seed, drop)
    _same(np.concatenate([b[1] for b in got]), splits.train.y[order])
