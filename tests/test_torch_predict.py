"""One artifact, two packages: the port's Predictor against the JAX one.

The artifact is written by the JAX package itself (``StoreCheckpointer`` over
a local directory, ``save_artifact_meta``) and loaded by the port on the CPU.
The JAX ``Predictor`` reads the same params from a ``fake://`` root (its
loader takes local roots as Orbax trees). Both answer the same columns and
CSV; predictions agree within 1e-5 in normalised target units (f32) and the
window index is identical.
"""

import json

import jax
import numpy as np
import pytest
import torch

from tpuflow.api.predict_api import Predictor as JaxPredictor
from tpuflow.api.predict_api import save_artifact_meta as jax_save_meta
from tpuflow.core.gilbert import append_gilbert_channel as jax_channel
from tpuflow.core.gilbert import gilbert_flow as jax_gilbert
from tpuflow.data.csv_io import read_csv as jax_read_csv
from tpuflow.data.schema import Schema as JaxSchema
from tpuflow.data.synthetic import generate_wells, wells_to_table, write_csv
from tpuflow.models import build_model as jax_build_model
from tpuflow.storage import write_json
from tpuflow.storage.checkpoint import StoreCheckpointer as JaxStoreCheckpointer
from tpuflow_torch.api.predict_api import Predictor
from tpuflow_torch.convert import model_leaves
from tpuflow_torch.core.gilbert import append_gilbert_channel, gilbert_flow
from tpuflow_torch.data import synthetic
from tpuflow_torch.data.csv_io import read_csv
from tpuflow_torch.data.schema import Schema
from tpuflow_torch.models import build_model
from tpuflow_torch.storage.checkpoint import StoreCheckpointer

FEATURES = ["pressure", "choke", "glr", "temperature", "water_cut"]
SCHEMA = [("pressure", "float"), ("choke", "float"), ("glr", "float"),
          ("temperature", "float"), ("water_cut", "float"),
          ("completion", "string"), ("well", "string"), ("flow", "float")]
KWARGS = {"hidden": 16, "backend": "xla"}
NORM_ATOL = 1e-5


def _preprocessor():
    table = wells_to_table(generate_wells(n_wells=3, steps=64, seed=0))
    series = np.stack([table[n] for n in FEATURES], axis=1)
    return {
        "feature_names": FEATURES, "window": 24, "stride": 1,
        "well_column": "well", "append_gilbert": False,
        "mean": series.mean(0).tolist(), "std": series.std(0).tolist(),
        "target_mean": float(table["flow"].mean()),
        "target_std": float(table["flow"].std()),
        "schema_columns": [{"name": n, "kind": k} for n, k in SCHEMA],
        "target": "flow",
    }


def _meta(model="lstm", kwargs=KWARGS):
    return {"model": model, "model_kwargs": kwargs, "kind": "windowed",
            "preprocessor": _preprocessor(), "sample_shape": [100, 24, 5]}


def _params(model="lstm", kwargs=KWARGS, seed=0):
    x = np.zeros((2, 24, 5), np.float32)
    return jax_build_model(model, **kwargs).init(jax.random.PRNGKey(seed), x)["params"]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The artifact under a local root, written by the JAX package."""
    root = str(tmp_path_factory.mktemp("artifact"))
    meta = _meta()
    params = _params()
    JaxStoreCheckpointer(root, "well_lstm").maybe_save(3, params, val_loss=0.5)
    jax_save_meta(root, "well_lstm", meta["model"], meta["model_kwargs"],
                  meta["kind"], meta["preprocessor"], meta["sample_shape"])
    return root, params, meta


def _jax_predictor(params, meta):
    """The JAX Predictor over the same params, from a fake:// root written
    here (fake buckets are process-global and other tests reset them)."""
    fake = "fake://torchparity/artifacts"
    JaxStoreCheckpointer(fake, "well_lstm").maybe_save(3, params, val_loss=0.5)
    write_json(f"{fake}/meta/well_lstm.json", meta)
    return JaxPredictor.load(fake, "well_lstm")


def _two_wells():
    cols = wells_to_table(generate_wells(n_wells=2, steps=40, seed=3))
    cols["well"] = np.repeat(["b", "a"], 40)  # first-appearance order, not sorted
    return cols


def _assert_same(port_out, jax_out, meta):
    (y, idx), (y_j, idx_j) = port_out, jax_out
    atol = NORM_ATOL * meta["preprocessor"]["target_std"]
    np.testing.assert_allclose(y, np.asarray(y_j), atol=atol, rtol=0)
    assert list(idx.wells) == list(idx_j.wells)
    np.testing.assert_array_equal(idx.starts, idx_j.starts)


def test_columns_match_jax_predictor(artifact):
    root, params, meta = artifact
    port = Predictor.load(root, "well_lstm", device="cpu")
    ref = _jax_predictor(params, meta)
    cols = _two_wells()
    out = port.predict_columns(cols, return_index=True)
    assert out[0].shape == (2 * 17, 24)
    assert out[1].wells[0] == "b"
    _assert_same(out, ref.predict_columns(cols, return_index=True), meta)
    # A ragged tail across two chunks: pow-2 padding by repeating the last row.
    x, _ = port.prepare_columns(cols)
    np.testing.assert_allclose(
        port.forward_prepared(x, batch_size=16),
        np.asarray(ref.forward_prepared(x, batch_size=16)),
        atol=NORM_ATOL * meta["preprocessor"]["target_std"], rtol=0,
    )


def test_csv_matches_jax_predictor(artifact, tmp_path):
    root, params, meta = artifact
    path = str(tmp_path / "wells.csv")
    write_csv(path, _two_wells(), [n for n, _ in SCHEMA if n != "flow"])
    port = Predictor.load(root, "well_lstm", device="cpu")
    ref = _jax_predictor(params, meta)
    _assert_same(port.predict_csv(path, return_index=True),
                 ref.predict_csv(path, return_index=True), meta)


def test_port_writer_is_read_by_the_jax_store_checkpointer(tmp_path):
    model = build_model("lstm", 5, hidden=16)
    leaves = model_leaves(model)
    assert StoreCheckpointer(str(tmp_path), "m").maybe_save(1, leaves, val_loss=0.4)
    assert not StoreCheckpointer(str(tmp_path), "m").maybe_save(2, leaves, val_loss=0.9)
    restored = JaxStoreCheckpointer(str(tmp_path), "m").restore_best(_params())
    for got, want in zip(jax.tree_util.tree_leaves(restored), leaves):
        np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize(
    "sidecar_model,sidecar_kwargs,match",
    [("stacked_lstm", KWARGS, "carries 5 leaves; this model has 8"),
     ("lstm", {"hidden": 32}, r"leaf 1 \(head.kernel\) has shape \(16, 1\)")],
)
def test_mismatched_checkpoint_raises(tmp_path, sidecar_model, sidecar_kwargs, match):
    root = str(tmp_path)
    JaxStoreCheckpointer(root, "m").maybe_save(1, _params(), val_loss=0.5)
    meta = _meta(sidecar_model, sidecar_kwargs)
    (tmp_path / "meta").mkdir()
    (tmp_path / "meta" / "m.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=match):
        Predictor.load(root, "m", device="cpu")


def test_bad_sidecars_and_missing_artifacts_raise(tmp_path):
    root = str(tmp_path)
    (tmp_path / "meta").mkdir()
    bad = {**_meta(), "kind": "tabular"}
    (tmp_path / "meta" / "tab.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="tabular artifacts are not ported yet"):
        Predictor.load(root, "tab", device="cpu")
    (tmp_path / "meta" / "nockpt.json").write_text(json.dumps(_meta()))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Predictor.load(root, "nockpt", device="cpu")
    (tmp_path / "models" / "orbax" / "3").mkdir(parents=True)
    (tmp_path / "meta" / "orbax.json").write_text(json.dumps(_meta()))
    with pytest.raises(ValueError, match="Orbax checkpoint tree"):
        Predictor.load(root, "orbax", device="cpu")


def test_data_plane_copies_match_jax(tmp_path):
    """Synthetic wells are byte-identical; Gilbert (numpy and torch) and the
    CSV reader agree with the JAX package's."""
    want = wells_to_table(generate_wells(n_wells=3, steps=50, seed=7))
    got = synthetic.wells_to_table(synthetic.generate_wells(n_wells=3, steps=50, seed=7))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])

    p, s, g = want["pressure"], want["choke"], want["glr"]
    ref = np.asarray(jax_gilbert(p, s, g))
    np.testing.assert_allclose(gilbert_flow(p, s, g), ref, rtol=1e-5)
    as_t = torch.from_numpy
    np.testing.assert_allclose(gilbert_flow(as_t(p), as_t(s), as_t(g)).numpy(), ref, rtol=1e-5)
    series = np.stack([want[n] for n in FEATURES], axis=1)
    np.testing.assert_allclose(
        append_gilbert_channel(series, FEATURES), jax_channel(series, FEATURES), rtol=1e-5
    )

    names, types = synthetic.SYNTHETIC_COLUMN_NAMES, synthetic.SYNTHETIC_COLUMN_TYPES
    path = str(tmp_path / "wells.csv")
    synthetic.write_csv(path, got, names.split(","))
    a = read_csv(path, Schema.from_cli(names, types, "flow"))
    b = jax_read_csv(path, JaxSchema.from_cli(names, types, "flow"))
    assert list(a) == list(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
