"""The port's sequence-parallel LSTM ring, over four gloo ranks, against JAX.

One group of four ranks (``tpuflow_torch.parallel.spawn``, CPU, gloo) runs
``ring_lstm_scan`` (forward, and the gradients of sum(tanh(hs)) with respect
to ``xw``, ``wh`` and ``b``) and ``make_sp_forward`` on an ``LSTMLayer``'s
params copied from flax (forward and the parameter gradients), in a
module-scoped fixture. The JAX side runs in this process: its
``ring_lstm_scan`` and ``make_sp_forward`` on the four-device test ring, and
for gradients the oracles of ``tests/test_sp.py`` (the single-device chunk
scan, the ``LSTMLayer``). A missing sum of the replicated ``wh`` and ``b``
gradients over the ranks shows as gradients a quarter of the oracle's.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_ring import RANKS, _run_once
from tpuflow_torch.parallel import make_sp_forward, ring_lstm_scan
from tpuflow_torch.parallel.sp import _lstm_chunk_scan

ATOL = 1e-5  # tests/test_sp.py
T, B, H, F = 16, 4, 8, 5


def _case(seed=5):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    return xw, wh, b


def _x():
    return np.random.default_rng(2).standard_normal((2, 32, F)).astype(np.float32)


def _ranks(mesh, layer_params):
    args = [torch.from_numpy(a).requires_grad_() for a in _case()]
    hs = ring_lstm_scan(mesh, *args)
    torch.tanh(hs).sum().backward()
    out = {"scan": (hs.detach().numpy(), [a.grad.numpy() for a in args])}
    params = [torch.from_numpy(layer_params[n]).requires_grad_() for n in ("w_x", "w_h", "b")]
    y = make_sp_forward(mesh, hidden=H)(*params, torch.from_numpy(_x()))
    torch.tanh(y).sum().backward()
    out["forward"] = (y.detach().numpy(), [p.grad.numpy() for p in params])
    return out


@pytest.fixture(scope="module")
def flax_layer():
    import jax

    from tpuflow.models.lstm import LSTMLayer

    params = LSTMLayer(hidden=H).init(jax.random.PRNGKey(0), _x())["params"]
    return {n: np.asarray(p) for n, p in params.items()}


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory, flax_layer):
    from tpuflow_torch.parallel import spawn

    return _run_once(tmp_path_factory, "torch_sp",
                     lambda: spawn(_ranks, RANKS, flax_layer, device="cpu", timeout_s=240))


def test_ring_scan_matches_jax(sp_run):
    import jax.numpy as jnp

    from tests.conftest import ring_mesh
    from tpuflow.parallel import ring_lstm_scan as jax_ring_lstm_scan

    want = np.asarray(jax_ring_lstm_scan(ring_mesh(), *(jnp.asarray(a) for a in _case())))
    for rank in sp_run:
        np.testing.assert_allclose(rank["scan"][0], want, atol=ATOL)


def test_ring_scan_gradients_match_the_single_device_scan(sp_run):
    """dxw, dwh and db of sum(tanh(hs)) against ``jax.grad`` through the
    single-device chunk scan (tests/test_sp.py:60-85)."""
    import jax
    import jax.numpy as jnp

    from tpuflow.parallel.sp import _lstm_chunk_scan as jax_chunk_scan

    zero = (jnp.zeros((B, H)), jnp.zeros((B, H)))
    want = jax.grad(lambda *a: jnp.sum(jnp.tanh(jax_chunk_scan(zero, *a)[1])),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in _case()))
    for rank in sp_run:
        for g, w, name in zip(rank["scan"][1], want, ("dxw", "dwh", "db")):
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, err_msg=name)


def test_sp_forward_matches_jax_and_the_lstm_layer(sp_run, flax_layer):
    """``make_sp_forward`` against JAX's on the test ring, and its parameter
    gradients against ``jax.grad`` through the ``LSTMLayer``
    (tests/test_sp.py:88-110)."""
    import jax
    import jax.numpy as jnp

    from tests.conftest import ring_mesh
    from tpuflow.models.lstm import LSTMLayer
    from tpuflow.parallel import make_sp_forward as jax_make_sp_forward

    p = {n: jnp.asarray(a) for n, a in flax_layer.items()}
    x = _x()
    want = np.asarray(jax_make_sp_forward(ring_mesh(), hidden=H)(p["w_x"], p["w_h"], p["b"], x))
    layer = LSTMLayer(hidden=H)
    grads = jax.grad(lambda q: jnp.sum(jnp.tanh(layer.apply({"params": q}, x))))(p)
    for rank in sp_run:
        y, got = rank["forward"]
        np.testing.assert_allclose(y, want, atol=ATOL)
        for g, name in zip(got, ("w_x", "w_h", "b")):
            np.testing.assert_allclose(g, np.asarray(grads[name]), atol=ATOL, err_msg=name)


def test_chunk_scan_and_ring_of_one_match_the_step_loop():
    """With one rank the ring is the plain chunk scan (no communication)."""
    from tpuflow_torch.parallel import Mesh

    xw, wh, b = (torch.from_numpy(a) for a in _case(seed=8))
    zero = torch.zeros((B, H))
    (_, _), want = _lstm_chunk_scan((zero, zero), xw, wh, b)
    mesh = Mesh(group=None, size=1, rank=0, device=torch.device("cpu"), backend="gloo")
    torch.testing.assert_close(ring_lstm_scan(mesh, xw, wh, b), want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="not divisible"):
        ring_lstm_scan(Mesh(None, 3, 0, torch.device("cpu"), "gloo"), xw, wh, b)
