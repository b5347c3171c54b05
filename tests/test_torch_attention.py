"""The port's attention regressor against the JAX package's, on copied params.

The JAX model is initialised by flax and its params are carried across with
``params_from_flax``; both see the same seeded numpy batches, in f32. The
JAX side runs ``backend="flash"`` (its Pallas kernels in interpret mode)
where the point is the kernels, and ``backend="full"`` in the fit and
serving comparisons, where tests/test_kernels.py already holds the two
backends equal. Small sizes: dim 16, 2 heads, windows of 8 to 24 steps.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tpuflow.api.predict_api import Predictor as JaxPredictor
from tpuflow.api.predict_api import save_artifact_meta as jax_save_meta
from tpuflow.data.pipeline import prepare_windowed as jax_prepare_windowed
from tpuflow.data.synthetic import generate_wells, wells_to_table
from tpuflow.models import AttentionRegressor as JaxAttentionRegressor
from tpuflow.models import build_model as jax_build_model
from tpuflow.storage import write_json
from tpuflow.storage.checkpoint import StoreCheckpointer as JaxStoreCheckpointer
from tpuflow.train import FitConfig as JaxFitConfig
from tpuflow.train import create_state
from tpuflow.train import fit as jax_fit
from tpuflow.train.optim import build_optimizer as jax_build_optimizer
from tpuflow.train.optim import wrap_optimizer as jax_wrap_optimizer
from tpuflow_torch.api.config import TrainJobConfig
from tpuflow_torch.api.predict_api import Predictor
from tpuflow_torch.api.train_api import train
from tpuflow_torch.convert import flax_leaf_order, model_leaves, params_from_flax, params_to_flax
from tpuflow_torch.kernels import KERNELS
from tpuflow_torch.models import AttentionRegressor, build_model
from tpuflow_torch.models.attention import LayerNorm, _merge_heads, _split_heads
from tpuflow_torch.train import FitConfig, fit
from tpuflow_torch.train.optim import build_optimizer, wrap_optimizer

ATOL = 1e-5  # outputs, f32
GRAD_ATOL = 1e-4  # parameter gradients through two attention layers
SMALL = {"dim": 16, "heads": 2}


@pytest.fixture(scope="module")
def jax_small():
    """flax params of the small model (2 layers) and a batch of 16 steps."""
    x = np.random.default_rng(1).standard_normal((3, 16, 5)).astype(np.float32)
    model = JaxAttentionRegressor(**SMALL)
    return model.init(jax.random.PRNGKey(0), x)["params"], x


def _port(params, T, **kw):
    port = build_model("attention", 5, window=T, **{**SMALL, **kw})
    port.load_state_dict(params_from_flax(jax.device_get(params)))
    return port


def test_leaf_order_names_and_round_trip_match_flax(jax_small):
    params, _ = jax_small
    port = _port(params, 16)
    want = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(params)]
    got = model_leaves(port)
    assert len(got) == len(want) == 31
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert flax_leaf_order(port)[:8] == [
        "LayerNorm_0.bias", "LayerNorm_0.scale", "block_0.Dense_0.bias",
        "block_0.Dense_0.kernel", "block_0.Dense_1.bias", "block_0.Dense_1.kernel",
        "block_0.LayerNorm_0.bias", "block_0.LayerNorm_0.scale",
    ]
    back = params_to_flax(port.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jax.device_get(params))


@pytest.mark.parametrize("readout,backend", [("sequence", "flash"), ("last", "full")])
def test_forward_matches_jax(monkeypatch, jax_small, readout, backend):
    monkeypatch.setenv("TPUFLOW_FLASH_BLOCK", "8")  # the JAX kernel crosses tiles
    params, x = jax_small
    model = JaxAttentionRegressor(**SMALL, readout=readout, backend=backend)
    want = np.asarray(model.apply({"params": params}, x))
    port = _port(params, 16, readout=readout, backend=backend)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        plain = port(torch.from_numpy(x), plain=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL)


def test_loss_gradients_match_jax_flash_backend(jax_small):
    """Gradients of the clipped-MAE loss reach every parameter and equal
    ``jax.grad`` through the JAX model's flash custom VJP."""
    from tpuflow.core.losses import mae_clip as jax_mae_clip
    from tpuflow_torch.core.losses import mae_clip

    params, x = jax_small
    model = JaxAttentionRegressor(**SMALL, backend="flash")
    y = (np.random.default_rng(5).standard_normal((3, 16)) + 1).astype(np.float32)
    want = jax.grad(lambda p: jax_mae_clip(y, model.apply({"params": p}, x)))(params)
    port = _port(params, 16, backend="flash")
    mae_clip(torch.from_numpy(y), port(torch.from_numpy(x))).backward()
    got = params_to_flax({n: p.grad for n, p in port.named_parameters()})
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL), got, want
    )
    assert all(p.grad.abs().sum() > 0 for p in port.parameters())


def test_layer_norm_and_heads_follow_flax():
    """flax's LayerNorm (epsilon 1e-6, the variance as E[x^2] - E[x]^2);
    heads split batch-major, and merge undoes split."""
    import flax.linen as nn

    # A spread of 0.01 makes the epsilon show (1e-5 would move the output by
    # 5%); a mean of 0.05 keeps E[x^2] - E[x]^2 clear of cancellation.
    x = (np.random.default_rng(3).standard_normal((4, 16)) * 0.01 + 0.05).astype(np.float32)
    want = nn.LayerNorm().apply({"params": {"scale": np.full(16, 1.5, np.float32),
                                            "bias": np.full(16, 0.25, np.float32)}}, x)
    ln = LayerNorm(16)
    with torch.no_grad():
        ln.scale.fill_(1.5)
        ln.bias.fill_(0.25)
        got = ln(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    t = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    split = _split_heads(t, 2)
    assert split.shape == (4, 3, 4)
    torch.testing.assert_close(split[1], t[0, :, 4:])  # batch 0, head 1
    torch.testing.assert_close(_merge_heads(split, 2), t)


def test_init_follows_flax_layout():
    port = build_model("attention", 5, window=24)
    port.reset_parameters(torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert shapes["embed.kernel"] == (5, 64) and shapes["pos_embed"] == (24, 64)
    assert shapes["block_1.qkv.kernel"] == (64, 192)
    assert shapes["block_0.Dense_0.kernel"] == (64, 256)
    assert shapes["head.kernel"] == (64, 1) and len(shapes) == 31
    assert torch.equal(port.LayerNorm_0.scale, torch.ones(64))
    assert torch.count_nonzero(port.block_0.qkv.bias) == 0
    assert 0.015 < port.pos_embed.std().item() < 0.025


def test_fit_matches_jax_fit_from_copied_params():
    """Three epochs of keras_sgd from the same params and batch order: the
    per-epoch losses agree to 1e-5 relative and the final params to 1e-5."""
    splits = jax_prepare_windowed(
        generate_wells(n_wells=2, steps=40, seed=0), window=8, seed=0,
        teacher_forcing=True,
    )
    kw = {"learning_rate": 0.01}
    jax_model = jax_build_model("attention", **SMALL)
    state = create_state(
        jax_model, jax.random.PRNGKey(1), splits.train.x[:2],
        jax_wrap_optimizer(jax_build_optimizer("keras_sgd", **kw)),
    )
    params0 = jax.device_get(state.params)
    want = jax_fit(state, splits.train, splits.val, JaxFitConfig(
        max_epochs=3, batch_size=5, seed=0, verbose=False, jit_epoch=False,
    ))
    port = build_model("attention", 5, window=8, **SMALL)
    port.load_state_dict(params_from_flax(params0))
    got = fit(port, splits.train, splits.val,
              FitConfig(max_epochs=3, batch_size=5, seed=0, verbose=False),
              optimizer=wrap_optimizer(build_optimizer("keras_sgd", **kw)))
    assert got.epochs_ran == want.epochs_ran == 3
    for g, w in zip(got.history, want.history):
        for key in ("loss", "val_loss", "val_mae"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5)
    final = params_from_flax(jax.device_get(want.state.params))
    moved = 0.0
    for name, p in port.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), atol=1e-5)
        moved = max(moved, float((final[name] - params_from_flax(params0)[name]).abs().max()))
    assert moved > 1e-3  # the comparison is not of params that stood still


def _preprocessor():
    table = wells_to_table(generate_wells(n_wells=3, steps=64, seed=0))
    names = ["pressure", "choke", "glr", "temperature", "water_cut"]
    series = np.stack([table[n] for n in names], axis=1)
    schema = names + ["completion", "well", "flow"]
    kinds = ["float"] * 5 + ["string", "string", "float"]
    return {
        "feature_names": names, "window": 24, "stride": 1, "well_column": "well",
        "append_gilbert": False, "mean": series.mean(0).tolist(),
        "std": series.std(0).tolist(), "target_mean": float(table["flow"].mean()),
        "target_std": float(table["flow"].std()),
        "schema_columns": [{"name": n, "kind": k} for n, k in zip(schema, kinds)],
        "target": "flow",
    }


def test_predictor_on_a_jax_written_artifact_matches_jax(tmp_path):
    kwargs = {**SMALL, "backend": "full"}
    model = jax_build_model("attention", **kwargs)
    params = model.init(jax.random.PRNGKey(4), np.zeros((2, 24, 5), np.float32))["params"]
    meta = {"model": "attention", "model_kwargs": kwargs, "kind": "windowed",
            "preprocessor": _preprocessor(), "sample_shape": [100, 24, 5]}
    root = str(tmp_path)
    JaxStoreCheckpointer(root, "att").maybe_save(2, params, val_loss=0.5)
    jax_save_meta(root, "att", "attention", kwargs, "windowed", meta["preprocessor"],
                  meta["sample_shape"])
    fake = "fake://torchparity/attention"
    JaxStoreCheckpointer(fake, "att").maybe_save(2, params, val_loss=0.5)
    write_json(f"{fake}/meta/att.json", meta)

    cols = wells_to_table(generate_wells(n_wells=2, steps=40, seed=3))
    cols["well"] = np.repeat(["b", "a"], 40)
    port = Predictor.load(root, "att", device="cpu")
    y, idx = port.predict_columns(cols, return_index=True)
    y_j, idx_j = JaxPredictor.load(fake, "att").predict_columns(cols, return_index=True)
    assert y.shape == (2 * 17, 24)
    atol = ATOL * meta["preprocessor"]["target_std"]
    np.testing.assert_allclose(y, np.asarray(y_j), atol=atol, rtol=0)
    assert list(idx.wells) == list(idx_j.wells)
    x, _ = port.prepare_columns(cols)  # ragged chunks, pow-2 padded
    np.testing.assert_allclose(port.forward_prepared(x, batch_size=16), np.asarray(y_j),
                               atol=atol, rtol=0)


def test_train_end_to_end_on_cpu_writes_a_servable_sidecar(tmp_path):
    root = str(tmp_path)
    counts = {k: w.launches for k, w in KERNELS.items()}
    report = train(TrainJobConfig(
        model="attention", model_kwargs={**SMALL, "backend": "flash"}, window=8,
        synthetic_wells=2, synthetic_steps=40, batch_size=5, max_epochs=2,
        storage_path=root, verbose=False,
    ), device="cpu")
    assert report.result.epochs_ran == 2 and np.isfinite(report.test_loss)
    assert {k: w.launches for k, w in KERNELS.items()} == counts  # plain versions
    with open(os.path.join(root, "meta", "attention.json")) as f:
        meta = json.load(f)
    assert meta["model_kwargs"] == {**SMALL, "backend": "flash"}
    assert meta["sample_shape"][1:] == [8, 5]
    pred = Predictor.load(root, "attention", device="cpu")
    assert isinstance(pred.model, AttentionRegressor)
    out = pred.predict_columns(wells_to_table(generate_wells(n_wells=1, steps=30, seed=9)))
    assert out.shape == (23, 8) and np.isfinite(out).all()


def test_sidecar_kwargs_serve_a_ring_run_as_full():
    from tpuflow.api.train_api import _sidecar_kwargs as jax_sidecar_kwargs
    from tpuflow_torch.api.train_api import _sidecar_kwargs

    for kw in ({"backend": "ring", "mesh": None, "dtype": "bfloat16", "dim": 32},
               {"backend": "flash", "heads": 2}, {}):
        assert _sidecar_kwargs(kw) == jax_sidecar_kwargs(kw)


@pytest.mark.parametrize(
    "kwargs,error,match",
    [({"backend": "ring"}, ValueError, 'backend="ring" needs a mesh'),
     ({"dropout_rate": 1.5}, ValueError, "dropout_rate must be in"),
     ({"ring_impl": "pallas"}, ValueError, "unknown ring_impl"),
     ({"backend": "cuda"}, ValueError, "unknown attention backend"),
     ({"readout": "mean"}, ValueError, "readout"),
     ({"dim": 30, "heads": 4}, ValueError, "multiple of heads"),
     ({"window": None}, ValueError, "needs the window")],
)
def test_unported_and_bad_options_raise(kwargs, error, match):
    kwargs = {"window": 24, **kwargs}
    with pytest.raises(error, match=match):
        build_model("attention", 5, **kwargs)


def test_window_mismatch_raises_and_lstm_ignores_the_window():
    port = build_model("attention", 5, window=8, **SMALL)
    with pytest.raises(ValueError, match="windows of 8 steps, got 12"):
        port(torch.zeros(2, 12, 5))
    assert build_model("lstm", 5, window=None).lstm_0.hidden == 64
    assert build_model("stacked_lstm", 5, window=24).num_layers == 2


def test_predictor_serves_a_jax_artifact_trained_with_dropout(tmp_path):
    """Two epochs of the JAX fit with dropout_rate=0.2 give the params of an
    artifact; its sidecar keeps the rate. The port's Predictor serves it in
    eval mode, deterministic, equal to the JAX Predictor within 1e-5 in
    normalised units."""
    splits = jax_prepare_windowed(
        generate_wells(n_wells=2, steps=40, seed=0), window=24, seed=0,
        teacher_forcing=True,
    )
    kwargs = {**SMALL, "backend": "full", "dropout_rate": 0.2}
    jax_model = jax_build_model("attention", **kwargs)
    state = create_state(jax_model, jax.random.PRNGKey(3), splits.train.x[:2],
                         jax_wrap_optimizer(jax_build_optimizer("keras_sgd")))
    params = jax.device_get(jax_fit(state, splits.train, splits.val, JaxFitConfig(
        max_epochs=2, batch_size=5, seed=0, verbose=False, jit_epoch=False,
    )).state.params)
    meta = {"model": "attention", "model_kwargs": kwargs, "kind": "windowed",
            "preprocessor": _preprocessor(), "sample_shape": [100, 24, 5]}
    root, fake = str(tmp_path), "fake://torchparity/attention_dropout"
    JaxStoreCheckpointer(root, "att").maybe_save(2, params, val_loss=0.5)
    jax_save_meta(root, "att", "attention", kwargs, "windowed", meta["preprocessor"],
                  meta["sample_shape"])
    JaxStoreCheckpointer(fake, "att").maybe_save(2, params, val_loss=0.5)
    write_json(f"{fake}/meta/att.json", meta)

    cols = wells_to_table(generate_wells(n_wells=2, steps=40, seed=3))
    cols["well"] = np.repeat(["b", "a"], 40)
    port = Predictor.load(root, "att", device="cpu")
    assert port.model.block_0.dropout_rate == 0.2 and not port.model.training
    y = port.predict_columns(cols)
    y_j = np.asarray(JaxPredictor.load(fake, "att").predict_columns(cols))
    np.testing.assert_allclose(y, y_j, atol=ATOL * meta["preprocessor"]["target_std"], rtol=0)
    np.testing.assert_array_equal(port.predict_columns(cols), y)  # deterministic


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_in_training_mode_drops_and_rescales(rate):
    """Training-mode dropout drops a share of units within 5 standard
    deviations of ``rate`` and scales the kept ones by 1 / (1 - rate); the
    masks come from the given generator, so a seed repeats them."""
    from tpuflow_torch.models.attention import dropout

    x = torch.rand((64, 24, 64)) + 0.5  # no unit is zero before dropout
    n = x.numel()
    y = dropout(x, rate, torch.Generator().manual_seed(0))
    dropped = (y == 0).float().mean().item()
    assert abs(dropped - rate) <= 5 * (rate * (1 - rate) / n) ** 0.5
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate), rtol=1e-6, atol=0)
    torch.testing.assert_close(dropout(x, rate, torch.Generator().manual_seed(0)), y,
                               rtol=0, atol=0)


def test_dropout_runs_in_training_and_not_in_eval():
    """The regressor with dropout: two training-mode forwards differ, with
    ``dropout_generator`` seeded they repeat, and eval mode is
    deterministic and equal to the model without dropout on the same
    params."""
    model = build_model("attention", 5, window=8, dropout_rate=0.3, **SMALL)
    same = build_model("attention", 5, window=8, **SMALL)
    same.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 8, 5)).astype(np.float32))
    model.dropout_generator = torch.Generator().manual_seed(1)
    a, b = model(x), model(x)
    assert not torch.equal(a, b)
    model.dropout_generator = torch.Generator().manual_seed(1)
    torch.testing.assert_close(model(x), a, rtol=0, atol=0)
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(model(x), same.eval()(x), rtol=0, atol=0)
