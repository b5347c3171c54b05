"""The port's LSTM regressors against the JAX package's, on copied params.

The JAX model is initialised by flax, its params are carried across with
``tpuflow_torch.convert.params_from_flax``, and both forwards see the same
seeded numpy batch, in f32.
"""

import jax
import numpy as np
import pytest
import torch

from tpuflow.models import LSTMRegressor as JaxLSTMRegressor
from tpuflow_torch.convert import (
    flax_leaf_order,
    model_leaves,
    params_from_flax,
    params_to_flax,
)
from tpuflow_torch.models import LSTMRegressor, build_model

ATOL = 1e-5


def _jax_model_and_params(layers, backend, readout, hidden=16, F=5, seed=0):
    model = JaxLSTMRegressor(
        hidden=hidden, num_layers=layers, readout=readout, backend=backend
    )
    x = np.random.default_rng(seed).standard_normal((3, 6, F)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(seed), x)["params"]
    return model, params, x


@pytest.mark.parametrize(
    "layers,backend,readout",
    [(1, "pallas", "sequence"), (2, "pallas", "last"),
     (1, "xla", "last"), (2, "xla", "sequence")],
)
def test_forward_matches_jax(layers, backend, readout):
    model, params, x = _jax_model_and_params(layers, backend, readout)
    want = np.asarray(model.apply({"params": params}, x))
    port = LSTMRegressor(5, hidden=16, num_layers=layers, readout=readout,
                         backend=backend)
    port.load_state_dict(params_from_flax(jax.device_get(params)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("layers,backend", [(1, "pallas"), (2, "xla")])
def test_loss_gradients_match_jax(layers, backend):
    """Gradients of the clipped-MAE loss reach every parameter (``w_x``
    through the projection matmul, ``w_h`` and ``b`` through ``lstm_scan``'s
    backward, and the head) and equal ``jax.grad`` on copied params."""
    from tpuflow.core.losses import mae_clip as jax_mae_clip
    from tpuflow_torch.core.losses import mae_clip
    from tpuflow_torch.convert import params_to_flax

    model, params, x = _jax_model_and_params(layers, backend, "sequence")
    # Offset, so that the signs of the errors do not balance to a zero
    # head-bias gradient.
    y = (np.random.default_rng(5).standard_normal((3, 6)) + 1).astype(np.float32)
    want = jax.grad(lambda p: jax_mae_clip(y, model.apply({"params": p}, x)))(params)
    port = LSTMRegressor(5, hidden=16, num_layers=layers, backend=backend)
    port.load_state_dict(params_from_flax(jax.device_get(params)))
    mae_clip(torch.from_numpy(y), port(torch.from_numpy(x))).backward()
    got = params_to_flax({n: p.grad for n, p in port.named_parameters()})
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), atol=ATOL), got, want
    )
    assert all(p.grad.abs().sum() > 0 for p in port.parameters())


def test_leaf_order_and_round_trip_match_flax():
    _, params, _ = _jax_model_and_params(2, "xla", "sequence")
    port = build_model("stacked_lstm", 5, hidden=16)
    port.load_state_dict(params_from_flax(jax.device_get(params)))
    assert flax_leaf_order(port) == [
        "head.bias", "head.kernel", "lstm_0.b", "lstm_0.w_h", "lstm_0.w_x",
        "lstm_1.b", "lstm_1.w_h", "lstm_1.w_x",
    ]
    want = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(params)]
    got = model_leaves(port)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    back = params_to_flax(port.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jax.device_get(params))


def test_init_follows_flax_layout_and_forget_bias():
    port = build_model("lstm", 5)
    port.reset_parameters(torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert shapes == {
        "lstm_0.w_x": (5, 256), "lstm_0.w_h": (64, 256), "lstm_0.b": (256,),
        "head.kernel": (64, 1), "head.bias": (1,),
    }
    b = port.lstm_0.b.detach()
    assert torch.equal(b[64:128], torch.ones(64))
    assert torch.count_nonzero(b[:64]) == 0
    wh = port.lstm_0.w_h.detach()  # orthonormal rows, as flax's orthogonal
    torch.testing.assert_close(wh @ wh.T, torch.eye(64), atol=1e-5, rtol=0)


def test_unknown_backend_readout_and_family_raise():
    with pytest.raises(ValueError, match="backend"):
        build_model("lstm", 5, backend="cuda")
    with pytest.raises(ValueError, match="readout"):
        build_model("lstm", 5, readout="mean")
    with pytest.raises(ValueError, match="not ported yet.*ROADMAP.md"):
        build_model("cnn1d", 5)
