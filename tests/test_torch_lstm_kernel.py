"""The port's LSTM recurrence against the JAX package's Pallas kernel.

The JAX side runs ``tpuflow.kernels.lstm_scan`` in Pallas interpret mode on
the CPU (tests/conftest.py), as the JAX package's own tests run it; the port
runs on CPU tensors, where its wrapper takes the plain PyTorch version. The
CUDA kernel itself runs only on a GPU: the ``cuda``-marked test holds it to
its plain version there and skips elsewhere. JAX is imported inside the
parity tests, so that on a GPU machine without JAX this module still
collects: ``python -m pytest --noconftest -m cuda tests/test_torch_lstm_kernel.py``.
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.kernels import KERNELS
from tpuflow_torch.kernels.lstm import lstm_scan, lstm_scan_reference
from tpuflow_torch.models.lstm import lstm_step

ATOL = 1e-5  # f32, as tests/test_kernels.py holds the Pallas kernel


def _case(T, B, H, seed=0):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    return xw, wh, b


@pytest.mark.parametrize("B,H", [(5, 16), (5, 64), (1, 16), (1, 64)])
def test_lstm_scan_matches_jax_pallas(B, H):
    import jax.numpy as jnp

    from tpuflow.kernels import lstm_scan as jax_lstm_scan

    xw, wh, b = _case(7, B, H, seed=B + H)
    want = np.asarray(jax_lstm_scan(jnp.asarray(xw), jnp.asarray(wh), jnp.asarray(b)))
    launches = lstm_scan.launches
    got = lstm_scan(torch.from_numpy(xw), torch.from_numpy(wh), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert lstm_scan.launches == launches  # the CPU path launches nothing


def test_cell_states_match_jax_pallas():
    import jax.numpy as jnp

    from tpuflow.kernels.lstm import _fwd as jax_fwd

    xw, wh, b = _case(7, 5, 16, seed=3)
    _, want_cs = jax_fwd(jnp.asarray(xw), jnp.asarray(wh), jnp.asarray(b))
    cs = torch.empty((7, 5, 16))
    lstm_scan(torch.from_numpy(xw), torch.from_numpy(wh), torch.from_numpy(b), cs_out=cs)
    np.testing.assert_allclose(cs.numpy(), np.asarray(want_cs), atol=ATOL)


def test_reference_matches_a_loop_over_lstm_step():
    xw, wh, b = (torch.from_numpy(a) for a in _case(7, 5, 16, seed=4))
    hs, cs = lstm_scan_reference(xw, wh, b)
    h = c = torch.zeros(5, 16)
    for t in range(7):
        (h, c), out = lstm_step((h, c), xw[t], wh, b)
        torch.testing.assert_close(hs[t], out, atol=ATOL, rtol=0)
        torch.testing.assert_close(cs[t], c, atol=ATOL, rtol=0)


def test_shape_mismatch_raises():
    xw, wh, b = (torch.from_numpy(a) for a in _case(3, 2, 8))
    with pytest.raises(ValueError, match="wh"):
        lstm_scan(xw, wh[:, :16], b)
    with pytest.raises(ValueError, match="cs_out"):
        lstm_scan(xw, wh, b, cs_out=torch.empty(3, 2, 4))
    assert KERNELS["lstm_fwd"] is lstm_scan


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 300])
def test_cuda_kernel_matches_plain_version(cuda_device, B):
    xw, wh, b = (torch.from_numpy(a).to(cuda_device) for a in _case(24, B, 64, seed=B))
    cs = torch.empty((24, B, 64), device=cuda_device)
    launches = lstm_scan.launches
    hs = lstm_scan(xw, wh, b, cs_out=cs)
    torch.cuda.synchronize()
    assert lstm_scan.launches == launches + 1
    ref_hs, ref_cs = lstm_scan_reference(xw, wh, b)
    torch.testing.assert_close(hs, ref_hs, atol=ATOL, rtol=ATOL)
    torch.testing.assert_close(cs, ref_cs, atol=ATOL, rtol=ATOL)
    with pytest.raises(TypeError, match="float32"):
        lstm_scan(xw.double(), wh.double(), b.double())
