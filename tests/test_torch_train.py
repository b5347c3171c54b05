"""The port's training path against the JAX package's, on the CPU.

``fit`` starts both packages from the same flax-initialised params (copied
with ``params_from_flax``) on byte-identical data and batch order, and
compares per-epoch losses and the final params. ``train()`` runs end to end
on the CPU: report, save-best artifact served by the port's ``Predictor``,
and the same params read by the JAX package's ``StoreCheckpointer`` giving
the JAX model the same predictions. Small sizes: hidden 8, window 8, batch
5, 2 wells x 64 rows.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from tpuflow.api.config import TrainJobConfig as JaxTrainJobConfig
from tpuflow.api.train_api import _prepare_data as jax_prepare_data
from tpuflow.data.pipeline import prepare_windowed as jax_prepare_windowed
from tpuflow.data.schema import Schema as JaxSchema
from tpuflow.data.synthetic import generate_wells as jax_generate_wells
from tpuflow.data.synthetic import wells_to_table, write_csv
from tpuflow.models import build_model as jax_build_model
from tpuflow.storage.checkpoint import StoreCheckpointer as JaxStoreCheckpointer
from tpuflow.train import FitConfig as JaxFitConfig
from tpuflow.train import create_state
from tpuflow.train import fit as jax_fit
from tpuflow.train.optim import build_optimizer as jax_build_optimizer
from tpuflow.train.optim import wrap_optimizer as jax_wrap_optimizer
from tpuflow_torch.api.config import TrainJobConfig
from tpuflow_torch.api.predict_api import Predictor
from tpuflow_torch.api.train_api import train
from tpuflow_torch.cli import main as cli_main
from tpuflow_torch.convert import params_from_flax
from tpuflow_torch.models import build_model
from tpuflow_torch.train import FitConfig, fit
from tpuflow_torch.train.optim import build_optimizer, wrap_optimizer

SMALL = dict(model_kwargs={"hidden": 8}, window=8, synthetic_wells=2,
             synthetic_steps=64, batch_size=5, verbose=False)
# fit parity: f32 on both sides, the same math in other summation orders;
# after 3 epochs of 14 Nesterov steps the losses agree to 1e-5 relative
# and the params to 1e-5 absolute (values of order 1).
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


@pytest.mark.parametrize("model_name", ["lstm", "stacked_lstm"])
def test_fit_matches_jax_fit_from_copied_params(model_name):
    splits = jax_prepare_windowed(
        jax_generate_wells(n_wells=2, steps=64, seed=0), window=8, seed=0,
        teacher_forcing=True,
    )
    kw = {"learning_rate": 0.01}
    jax_model = jax_build_model(model_name, hidden=8)
    state = create_state(
        jax_model, jax.random.PRNGKey(1), splits.train.x[:2],
        jax_wrap_optimizer(jax_build_optimizer("keras_sgd", **kw)),
    )
    params0 = jax.device_get(state.params)
    want = jax_fit(state, splits.train, splits.val, JaxFitConfig(
        max_epochs=3, batch_size=5, seed=0, verbose=False, jit_epoch=False,
    ))

    port = build_model(model_name, 5, hidden=8)
    port.load_state_dict(params_from_flax(params0))
    got = fit(port, splits.train, splits.val,
              FitConfig(max_epochs=3, batch_size=5, seed=0, verbose=False),
              optimizer=wrap_optimizer(build_optimizer("keras_sgd", **kw)))

    assert got.epochs_ran == want.epochs_ran == 3
    for g, w in zip(got.history, want.history):
        for key in ("loss", "val_loss", "val_mae"):
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL)
    final = params_from_flax(jax.device_get(want.state.params))
    moved = 0.0
    for name, p in port.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), atol=PARAM_ATOL)
        moved = max(moved, float((final[name] - params_from_flax(params0)[name]).abs().max()))
    assert moved > 100 * PARAM_ATOL  # the comparison is not of params that stood still


def _jax_apply(root, name, x):
    template = jax_build_model("lstm", hidden=8).init(
        jax.random.PRNGKey(0), np.zeros((2, 8, 5), np.float32))["params"]
    params = JaxStoreCheckpointer(root, name).restore_best(template)
    return np.asarray(jax_build_model("lstm", hidden=8).apply({"params": params}, x))


def test_train_end_to_end_on_cpu(tmp_path):
    root = str(tmp_path)
    report = train(TrainJobConfig(model="lstm", max_epochs=2, storage_path=root, **SMALL),
                   device="cpu")
    hist = report.result.history
    assert [h["epoch"] for h in hist] == [1, 2] and report.result.epochs_ran == 2
    assert all(np.isfinite([h["loss"], h["val_loss"]]).all() for h in hist)
    assert np.isfinite(report.test_loss) and report.test_mae > 0
    assert report.epoch_program == "per_batch" and report.device == "cpu"
    assert "Gilbert-baseline MAE" in report.summary()

    # The physical baseline is computed on the JAX package's test rows.
    jax_cfg = JaxTrainJobConfig(model="lstm", n_devices=1, **SMALL)
    names = "pressure,choke,glr,temperature,water_cut,completion,flow"
    types = "float,float,float,float,float,string,float"
    prep = jax_prepare_data(jax_cfg, JaxSchema.from_cli(names, types, "flow"), "flow")
    np.testing.assert_allclose(report.gilbert_mae, prep.gilbert_test, rtol=1e-5)

    # Save-best artifact: sidecar plus the store layout.
    with open(os.path.join(root, "meta", "lstm.json")) as f:
        meta = json.load(f)
    assert meta["kind"] == "windowed" and meta["model_kwargs"] == {"hidden": 8}
    assert meta["sample_shape"] == list(prep.train_ds.x.shape)
    pre = meta["preprocessor"]
    np.testing.assert_array_equal(pre["mean"], prep.splits.norm_mean.tolist())
    assert pre["target_std"] == prep.splits.target_std and pre["well_column"] is None

    # Served by the port, and the same params through the JAX model.
    pred = Predictor.load(root, "lstm", device="cpu")
    cols = wells_to_table(jax_generate_wells(n_wells=1, steps=30, seed=9))
    x, _ = pred.prepare_columns(cols)
    served = pred.predict_columns(cols)
    assert served.shape == (23, 8) and np.isfinite(served).all()
    want = _jax_apply(root, "lstm", x) * pre["target_std"] + pre["target_mean"]
    np.testing.assert_allclose(served, want, atol=1e-5 * pre["target_std"], rtol=0)


def test_train_from_csv_with_a_well_column(tmp_path):
    cols = wells_to_table(jax_generate_wells(n_wells=2, steps=64, seed=3))
    cols["well"] = np.repeat(["b", "a"], 64)
    names = ["pressure", "choke", "glr", "temperature", "water_cut", "completion",
             "well", "flow"]
    path = str(tmp_path / "wells.csv")
    write_csv(path, cols, names)
    report = train(TrainJobConfig(
        column_names=",".join(names),
        column_types="float,float,float,float,float,string,string,float",
        data_path=path, well_column="well", model="stacked_lstm", max_epochs=1,
        storage_path=str(tmp_path / "art"), **SMALL,
    ), device="cpu")
    assert np.isfinite(report.test_loss)
    pred = Predictor.load(str(tmp_path / "art"), "stacked_lstm", device="cpu")
    assert pred.predict_csv(path).shape == (2 * 57, 8)


def test_cli_train_verb(tmp_path, capsys):
    root = str(tmp_path)
    rc = cli_main(["", "", "flow", root, "--device", "cpu", "--epochs", "1",
                   "--synthetic-wells", "2", "--synthetic-steps", "64",
                   "--window", "8", "--batch-size", "5",
                   "--model-kwargs", '{"hidden": 8}', "--clip-norm", "1.0"])
    assert rc == 0
    assert "Gilbert-baseline MAE" in capsys.readouterr().out
    assert os.path.isfile(os.path.join(root, "models", "lstm", "BEST"))
    assert cli_main(["--tp", "2", "--device", "cpu"]) == 2
    assert "not ported yet" in capsys.readouterr().err
    assert cli_main(["--model", "cnn1d", "--device", "cpu"]) == 2
    assert cli_main(["--model-kwargs", "[1]", "--device", "cpu"]) == 2


def test_config_fields_and_defaults_match_jax():
    got = {f.name: f for f in dataclasses.fields(TrainJobConfig)}
    want = {f.name: f for f in dataclasses.fields(JaxTrainJobConfig)}
    assert list(got) == list(want)
    assert dataclasses.asdict(TrainJobConfig()) == dataclasses.asdict(JaxTrainJobConfig())


@pytest.mark.parametrize(
    "field,value",
    [("stream", True), ("tp", 2), ("pp", 2), ("ep", 2), ("n_devices", 2),
     ("elastic", {}), ("online", {}), ("autotune", {}), ("warm_start", "x"),
     ("resume", True), ("save_every", 1), ("faults", ["train.epoch_end,at=1"]),
     ("fault_epoch", 1), ("progress_path", "p.json"), ("trace_dir", "t"),
     ("metrics_path", "m.jsonl"), ("precision", "bf16"), ("health", "abort"),
     ("accumulate_steps", 2), ("model", "cnn1d")],
)
def test_fields_not_ported_yet_raise(field, value):
    config = dataclasses.replace(TrainJobConfig(), **{field: value})
    with pytest.raises(NotImplementedError, match=r"not ported yet.*ROADMAP\.md Queue 1"):
        train(config, device="cpu")


def test_n_devices_none_refuses_several_cards(monkeypatch):
    """JAX reads ``n_devices=None`` as every visible device (data parallel
    when there are several); the port raises on a host with more than one
    card rather than train on one of them, and the CPU path is unchanged."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    config = TrainJobConfig(model="lstm", max_epochs=1, **SMALL)
    assert config.n_devices is None
    with pytest.raises(NotImplementedError, match=r"n_devices=None.*Queue 1 item 8"):
        train(config)
    report = train(config, device="cpu")
    assert np.isfinite(report.test_loss)


def test_health_off_and_jit_epoch_are_accepted(tmp_path):
    report = train(TrainJobConfig(model="lstm", max_epochs=1, health="off",
                                  jit_epoch=True, **SMALL), device="cpu")
    assert report.epoch_program == "per_batch"
    assert "item 12" in report.epoch_program_reason
    assert torch.is_tensor(next(report.result.model.parameters()))
