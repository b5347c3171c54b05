"""The port's losses against the JAX package's, and the clipped-MAE kernel.

The JAX side runs ``tpuflow.kernels.mae_clip_pallas`` in Pallas interpret
mode on the CPU (tests/conftest.py) and ``tpuflow.core.losses``; the port
runs on CPU tensors, where the kernel wrapper takes its plain version. The
CUDA kernel runs only on a GPU: the ``cuda``-marked tests hold it to its
plain version there and skip elsewhere. JAX is imported inside the parity
tests, so on a GPU machine without JAX this module still collects:
``python -m pytest --noconftest -m cuda tests/test_torch_losses.py``.
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.core.losses import CLIP_VALUE, LOSSES, mae_clip, per_example
from tpuflow_torch.kernels import KERNELS
from tpuflow_torch.kernels.losses import mae_clip_reference, mae_clip_rows

RTOL = 1e-6  # f32 sums in another order, as tests/test_kernels.py holds the kernel


def _pair(shape, seed, scale=5.0):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal(shape) * scale).astype(np.float32),
        (rng.standard_normal(shape) * scale).astype(np.float32),
    )


@pytest.mark.parametrize("shape", [(16,), (33, 7), (4, 24)])
def test_value_and_gradient_match_jax(shape):
    import jax
    import jax.numpy as jnp

    from tpuflow.core.losses import mae_clip as jax_mae_clip
    from tpuflow.kernels import mae_clip_pallas

    yt, yp = _pair(shape, seed=len(shape))
    pred = torch.from_numpy(yp).requires_grad_()
    loss = mae_clip(torch.from_numpy(yt), pred)
    loss.backward()
    for fn in (mae_clip_pallas, jax_mae_clip):
        np.testing.assert_allclose(loss.item(), float(fn(yt, yp)), rtol=RTOL)
        want = jax.grad(lambda p: fn(jnp.asarray(yt), p))(jnp.asarray(yp))
        np.testing.assert_allclose(pred.grad.numpy(), np.asarray(want), atol=1e-7)
    assert LOSSES["mae_clip"] is LOSSES["mae_clip_pallas"] is mae_clip


def test_clip_saturates_with_zero_gradient():
    pred = torch.full((8,), 100.0, requires_grad=True)
    loss = mae_clip(torch.zeros(8), pred)
    loss.backward()
    assert loss.item() == CLIP_VALUE
    assert torch.count_nonzero(pred.grad) == 0


def test_custom_clip_value_and_zero_gradient_at_zero_error():
    from tpuflow.core.losses import mae_clip as jax_mae_clip
    from tpuflow.kernels import mae_clip_pallas

    yt = np.zeros(5, np.float32)
    yp = np.asarray([0.5, 1.5, 2.5, 10.0, 0.0], np.float32)
    pred = torch.from_numpy(yp).requires_grad_()
    loss = mae_clip(torch.from_numpy(yt), pred, clip_value=2.0)
    loss.backward()
    for fn in (mae_clip_pallas, jax_mae_clip):
        np.testing.assert_allclose(loss.item(), float(fn(yt, yp, clip_value=2.0)), rtol=RTOL)
    # sign(d) * (|d| < clip) / n for y_pred: saturated and zero errors give 0.
    np.testing.assert_array_equal(
        pred.grad.numpy(), np.asarray([1, 1, 0, 0, 0], np.float32) / np.float32(5)
    )


@pytest.mark.parametrize("name", ["mae_clip", "mae_clip_pallas", "mae", "mse", "huber"])
def test_per_example_rows_match_jax_vmap(name):
    """The eval step's per-example loss, ``jax.vmap(loss_fn)(y, pred)``: one
    row per example, R > 1."""
    import jax

    from tpuflow.core.losses import LOSSES as JAX_LOSSES

    yt, yp = _pair((6, 24), seed=9)
    want = np.asarray(jax.vmap(JAX_LOSSES[name])(yt, yp))
    got = per_example(LOSSES[name], torch.from_numpy(yt), torch.from_numpy(yp))
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    full = LOSSES[name](torch.from_numpy(yt), torch.from_numpy(yp)).item()
    np.testing.assert_allclose(full, float(JAX_LOSSES[name](yt, yp)), rtol=RTOL)


def test_per_example_of_a_loss_without_rows_calls_it_per_example():
    yt, yp = _pair((4, 6), seed=2)
    got = per_example(lambda t, p: torch.max(torch.abs(t - p)),
                      torch.from_numpy(yt), torch.from_numpy(yp))
    np.testing.assert_array_equal(got.numpy(), np.abs(yt - yp).max(axis=1))


def test_registry_names_match_jax():
    from tpuflow.core.losses import CLIP_VALUE as JAX_CLIP
    from tpuflow.core.losses import LOSSES as JAX_LOSSES

    assert sorted(LOSSES) == sorted(JAX_LOSSES)
    assert CLIP_VALUE == JAX_CLIP


def test_rows_shape_checks_and_counter():
    assert KERNELS["mae_clip"] is mae_clip_rows
    with pytest.raises(ValueError, match=r"\[R, N\]"):
        mae_clip_rows(torch.zeros(4), torch.zeros(4), 6.0)
    with pytest.raises(ValueError, match="shapes differ"):
        mae_clip(torch.zeros(4), torch.zeros(5))
    launches = mae_clip_rows.launches
    mae_clip_rows(torch.zeros(2, 3), torch.ones(2, 3), 6.0)
    assert mae_clip_rows.launches == launches  # the CPU path launches nothing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 480), (20, 24), (1, 4096 * 24), (3, 37), (256, 24)])
def test_cuda_kernel_matches_plain_version(cuda_device, shape):
    """Per-row sums in f32 in another order: rtol 1e-5 covers rows of up to
    98,304 elements."""
    yt, yp = (torch.from_numpy(a).to(cuda_device) for a in _pair(shape, seed=shape[1]))
    launches = mae_clip_rows.launches
    got = mae_clip_rows(yt, yp, CLIP_VALUE)
    torch.cuda.synchronize()
    assert mae_clip_rows.launches == launches + 1
    torch.testing.assert_close(got, mae_clip_reference(yt, yp, CLIP_VALUE), atol=0, rtol=1e-5)
    with pytest.raises(TypeError, match="float32"):
        mae_clip_rows(yt.double(), yp.double(), CLIP_VALUE)


@pytest.mark.cuda
def test_cuda_loss_and_gradient_match_the_cpu(cuda_device):
    yt, yp = _pair((20, 24), seed=4)
    cpu = torch.from_numpy(yp).requires_grad_()
    card = torch.from_numpy(yp).to(cuda_device).requires_grad_()
    want = mae_clip(torch.from_numpy(yt), cpu)
    got = mae_clip(torch.from_numpy(yt).to(cuda_device), card)
    want.backward()
    got.backward()
    torch.testing.assert_close(got.cpu(), want, atol=0, rtol=1e-5)
    torch.testing.assert_close(card.grad.cpu(), cpu.grad, atol=0, rtol=0)
    nan = torch.tensor([[float("nan"), 1.0]], device=cuda_device)
    assert torch.isnan(mae_clip_rows(nan, torch.zeros_like(nan), CLIP_VALUE)).all()
