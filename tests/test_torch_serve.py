"""The port's HTTP server on the CPU: /predict, its errors, health, metrics."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpuflow_torch.api.predict_api import Predictor, save_artifact_meta
from tpuflow_torch.convert import model_leaves
from tpuflow_torch.data.synthetic import generate_wells, wells_to_table
from tpuflow_torch.models import build_model
from tpuflow_torch.serve import make_server
from tpuflow_torch.storage.checkpoint import StoreCheckpointer

FEATURES = ["pressure", "choke", "glr", "temperature", "water_cut"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    import torch

    root = str(tmp_path_factory.mktemp("serve"))
    model = build_model("stacked_lstm", 5, hidden=16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    StoreCheckpointer(root, "stack").maybe_save(1, model_leaves(model), val_loss=0.1)
    cols = wells_to_table(generate_wells(n_wells=2, steps=30, seed=1))
    series = np.stack([cols[n] for n in FEATURES], axis=1)
    pre = {
        "feature_names": FEATURES, "window": 24, "stride": 1,
        "well_column": "well", "mean": series.mean(0).tolist(),
        "std": series.std(0).tolist(), "target_mean": 100.0,
        "target_std": 50.0, "target": "flow",
        "schema_columns": [{"name": n, "kind": "float"} for n in FEATURES]
        + [{"name": "flow", "kind": "float"}],
    }
    save_artifact_meta(root, "stack", "stacked_lstm", {"hidden": 16},
                       "windowed", pre, (10, 24, 5))
    cols["well"] = np.repeat(["x", "y"], 30)
    server = make_server("127.0.0.1", 0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, root, cols
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _call(server, path, spec=None):
    url = f"http://127.0.0.1:{server.server_address[1]}{path}"
    data = None if spec is None else json.dumps(spec).encode()
    try:
        with urllib.request.urlopen(url, data=data, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_predict_matches_predictor(served):
    server, root, cols = served
    spec = {"storagePath": root, "model": "stack",
            "columns": {k: v.tolist() for k, v in cols.items()}}
    status, body = _call(server, "/predict", spec)
    assert status == 200, body
    want = Predictor.load(root, "stack", device="cpu").predict_columns(cols)
    assert body["count"] == len(want) == 2 * 7
    assert "degraded" not in body
    np.testing.assert_allclose(np.asarray(body["predictions"]), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "spec,code,match",
    [({"model": "stack", "columns": {}}, 400, "storagePath and model"),
     ({"storagePath": "ROOT", "model": "stack"}, 400, "data .csv path. or columns"),
     ({"storagePath": "ROOT", "model": "absent", "columns": {"a": [1]}},
      500, "FileNotFoundError")],
)
def test_predict_errors(served, spec, code, match):
    import re

    server, root, _ = served
    spec = {k: (root if v == "ROOT" else v) for k, v in spec.items()}
    status, body = _call(server, "/predict", spec)
    assert status == code
    assert re.search(match, body["error"])


def test_health_and_metrics(served):
    server, _, _ = served
    assert _call(server, "/healthz") == (200, {"status": "ok", "device": "cpu"})
    status, body = _call(server, "/metrics")
    assert status == 200
    m = body["predict"]
    assert {"requests", "errors", "cache_hits", "loads", "latency_ms",
            "batching"} <= set(m)
    assert m["requests"] >= m["errors"]
    assert m["latency_ms"]["count"] == m["requests"]
