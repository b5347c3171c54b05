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
from tpuflow_torch.kernels.lstm import (
    lstm_scan,
    lstm_scan_backward,
    lstm_scan_backward_reference,
    lstm_scan_reference,
)
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


@pytest.mark.parametrize("B,H", [(5, 16), (1, 8), (3, 4)])
def test_autograd_matches_jax_grad(B, H):
    """Port autograd through ``lstm_scan`` (CPU: the plain backward) against
    ``jax.grad`` through the Pallas custom VJP (interpret mode)."""
    import jax
    import jax.numpy as jnp

    from tpuflow.kernels import lstm_scan as jax_lstm_scan

    xw, wh, b = _case(8, B, H, seed=20 + B + H)
    w = np.random.default_rng(B * H).standard_normal((8, B, H)).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(jax_lstm_scan(*a) * w), argnums=(0, 1, 2)
    )(jnp.asarray(xw), jnp.asarray(wh), jnp.asarray(b))
    args = [torch.from_numpy(a).requires_grad_() for a in (xw, wh, b)]
    hs = lstm_scan(*args)
    assert hs.grad_fn is not None
    (hs * torch.from_numpy(w)).sum().backward()
    for got, ref in zip(args, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=ATOL)


def test_backward_reference_matches_autograd_through_the_reference():
    xw, wh, b = (torch.from_numpy(a).requires_grad_() for a in _case(7, 4, 12, seed=5))
    dhs = torch.from_numpy(
        np.random.default_rng(6).standard_normal((7, 4, 12)).astype(np.float32)
    )
    hs, cs = lstm_scan_reference(xw, wh, b)
    want = torch.autograd.grad(hs, (xw, wh, b), dhs)
    with torch.no_grad():
        got = lstm_scan_backward_reference(xw, wh, b, hs, cs, dhs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


def test_card_path_output_carries_a_grad_fn(monkeypatch):
    """The CUDA branch of ``lstm_scan`` returns a differentiable ``hs``: the
    forward launcher gets a cell-state buffer, and ``backward()`` reaches
    ``W_h`` and ``b`` through the backward launcher, whose S
    weight-gradient partials are summed. The launchers are replaced by
    fakes (and the library's hidden-size limit skipped) that fill
    their outputs with the plain versions' results, so this runs without a
    card; the kernels themselves are held to those versions by the
    ``cuda`` tests below."""
    from tpuflow_torch.kernels import lstm as lstm_mod

    def fake_fwd(xw, wh, b, hs, cs):
        assert cs is not None, "training needs the cell states"
        ref_hs, ref_cs = lstm_scan_reference(xw, wh, b)
        hs.copy_(ref_hs)
        cs.copy_(ref_cs)

    def fake_bwd(xw, wh, b, hs, cs, dhs, dxw, dwh_parts, db_parts):
        dxw_r, dwh_r, db_r = lstm_scan_backward_reference(xw, wh, b, hs, cs, dhs)
        dxw.copy_(dxw_r)
        dwh_parts.zero_()
        db_parts.zero_()
        dwh_parts[0] = dwh_r / 2  # the wrapper must sum the partials
        dwh_parts[-1] += dwh_r / 2
        db_parts[0] = db_r

    monkeypatch.setattr(lstm_mod, "_runs_plain", lambda t: False)
    monkeypatch.setattr(lstm_mod, "_fwd_kernel", fake_fwd)
    monkeypatch.setattr(lstm_mod, "_bwd_kernel", fake_bwd)
    monkeypatch.setattr(lstm_mod, "_refuse_hidden", lambda stem, H: None)
    monkeypatch.setattr(lstm_mod, "_wgrad_splits", lambda T, B, H: 3)
    xw, wh, b = (torch.from_numpy(a).requires_grad_() for a in _case(5, 3, 8, seed=7))
    fwd0, bwd0 = lstm_scan.launches, lstm_scan_backward.launches
    hs = lstm_scan(xw, wh, b)
    assert hs.grad_fn is not None
    hs.sum().backward()
    assert (lstm_scan.launches, lstm_scan_backward.launches) == (fwd0 + 1, bwd0 + 1)
    ref = [t.detach().clone().requires_grad_() for t in (xw, wh, b)]
    lstm_scan_reference(*ref)[0].sum().backward()
    for got, want in zip((xw, wh, b), ref):
        torch.testing.assert_close(got.grad, want.grad, atol=ATOL, rtol=0)
    with torch.no_grad():  # serving: no grad, no cell-state buffer
        monkeypatch.setattr(lstm_mod, "_fwd_kernel", lambda xw, wh, b, hs, cs: hs.zero_())
        assert lstm_scan(xw, wh, b).grad_fn is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _normwise_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(1, 64), (20, 64), (37, 64), (300, 64), (37, 16), (5, 76)])
def test_cuda_backward_matches_plain_version(cuda_device, B, H):
    """``lstm_bwd`` against ``lstm_scan_backward_reference``. Tolerances,
    normwise (max abs error over max abs value): dxw 1e-5 (24 dependent
    steps, each summing 4H products in another order), dW_h and db 1e-4
    (sums over B*T products, in per-block then block-axis order)."""
    xw, wh, b = (torch.from_numpy(a).to(cuda_device) for a in _case(24, B, H, seed=B))
    dhs = torch.randn((24, B, H), device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(B))
    hs, cs = lstm_scan_reference(xw, wh, b)
    launches = lstm_scan_backward.launches
    got = lstm_scan_backward(xw, wh, b, hs, cs, dhs)
    torch.cuda.synchronize()
    assert lstm_scan_backward.launches == launches + 1
    want = lstm_scan_backward_reference(xw, wh, b, hs, cs, dhs)
    for g, w, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        assert g.shape == w.shape
        assert _normwise_err(g, w) <= tol


@pytest.mark.cuda
def test_cuda_autograd_runs_both_kernels(cuda_device):
    xw, wh, b = (torch.from_numpy(a).to(cuda_device).requires_grad_()
                 for a in _case(24, 20, 64, seed=11))
    fwd0, bwd0 = lstm_scan.launches, lstm_scan_backward.launches
    hs = lstm_scan(xw, wh, b)
    assert hs.grad_fn is not None
    (hs * hs).sum().backward()
    torch.cuda.synchronize()
    assert (lstm_scan.launches, lstm_scan_backward.launches) == (fwd0 + 1, bwd0 + 1)
    ref = [t.detach().clone().requires_grad_() for t in (xw, wh, b)]
    ref_hs = lstm_scan_reference(*ref)[0]
    (ref_hs * ref_hs).sum().backward()
    for got, want in zip((xw, wh, b), ref):
        assert _normwise_err(got.grad, want.grad) <= 1e-4
    from tpuflow_torch.kernels import lstm as lstm_mod

    # The forward's limit now passes the backward's, so the forward is fed
    # at limit + 1 without gradients: its own refusal is the one tested.
    limit = lstm_mod._library("lstm_fwd").tpuflow_lstm_fwd_max_hidden()
    assert limit >= 4096
    H = limit + 1
    with pytest.raises(ValueError, match=f"from 1 to {limit} "):
        lstm_scan(torch.zeros((2, 3, 4 * H), device=cuda_device),
                  torch.empty((H, 4 * H), device=cuda_device),
                  torch.zeros(4 * H, device=cuda_device))


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


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(20, 128), (37, 256), (5, 100), (20, 50), (4096, 50),
                                 (20, 300), (4096, 300), (20, 512), (4096, 512)])
def test_cuda_kernels_take_hidden_sizes_beyond_shared_memory(cuda_device, B, H):
    """Hidden sizes past what one block's shared memory holds of W_h: the
    forward's h rows read 16 bytes at a time (H a multiple of 4) or one
    float at a time (50), several tiles a block and step at B = 4096; the
    backward's chain reads W_h through L2. Tolerances as in the tests
    above (forward 1e-5, backward normwise dxw 1e-5, dW_h and db 1e-4)."""
    xw, wh, b = (torch.from_numpy(a).to(cuda_device) for a in _case(24, B, H, seed=H))
    wh = wh / H ** 0.5
    cs = torch.empty((24, B, H), device=cuda_device)
    hs = lstm_scan(xw, wh, b, cs_out=cs)
    dhs = torch.randn((24, B, H), device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(H))
    got = lstm_scan_backward(xw, wh, b, hs, cs, dhs)
    torch.cuda.synchronize()
    ref_hs, ref_cs = lstm_scan_reference(xw, wh, b)
    torch.testing.assert_close(hs, ref_hs, atol=ATOL, rtol=ATOL)
    torch.testing.assert_close(cs, ref_cs, atol=ATOL, rtol=ATOL)
    want = lstm_scan_backward_reference(xw, wh, b, ref_hs, ref_cs, dhs)
    for g, w, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        assert _normwise_err(g, w) <= tol
