"""The port's losses against the JAX package's, and the clipped-MAE kernel.

The JAX side runs ``tpuflow.kernels.mae_clip_pallas`` in Pallas interpret
mode on the CPU (tests/conftest.py) and ``tpuflow.core.losses``; the port
runs on CPU tensors, where the kernel wrapper takes its plain version. The
CUDA kernel runs only on a GPU: the ``cuda``-marked tests hold it to its
plain version there and skip elsewhere. JAX is imported inside the parity
tests, so on a GPU machine without JAX this module still collects:
``python -m pytest --noconftest -m cuda tests/test_torch_losses.py``.
"""

import types

import numpy as np
import pytest
import torch

from tpuflow_torch.core.losses import CLIP_VALUE, LOSSES, mae_clip, per_example
from tpuflow_torch.kernels import KERNELS
from tpuflow_torch.kernels import losses as losses_mod
from tpuflow_torch.kernels.losses import (
    mae_clip_grad,
    mae_clip_grad_reference,
    mae_clip_reference,
    mae_clip_rows,
)

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


def test_grad_reference_matches_jax_grad_with_nan_and_zero_error():
    """The plain backward against ``jax.grad`` of the Pallas loss: saturated
    and zero errors give 0, and so does a NaN error (``|NaN| < clip`` is
    false), on both sides."""
    import jax
    import jax.numpy as jnp

    from tpuflow.kernels import mae_clip_pallas

    yt, yp = _pair((7, 24), seed=11)
    yp[0, :4] = yt[0, :4]  # d = 0
    yt[1, 3] = np.nan
    yp[2, 5] = np.nan
    g = np.float32(0.75)
    want_t, want_p = jax.grad(
        lambda t, p: g * mae_clip_pallas(t, p, CLIP_VALUE), argnums=(0, 1)
    )(jnp.asarray(yt), jnp.asarray(yp))
    got_t, got_p = mae_clip_grad_reference(
        torch.from_numpy(yt), torch.from_numpy(yp), torch.tensor(g), CLIP_VALUE)
    for got, want in ((got_t, want_t), (got_p, want_p)):
        assert got.dtype == torch.float32 and got.shape == (7, 24)
        assert not np.isnan(np.asarray(want)).any()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, rtol=0)
    for got in (got_t, got_p):
        assert not got[0, :4].any() and got[1, 3] == 0 and got[2, 5] == 0


def test_card_path_launches_one_kernel_each_way(monkeypatch):
    """``mae_clip`` on the card: one ``mae_clip`` launch forward and one
    ``mae_clip_grad`` launch backward, nothing else launched, on
    contiguous f32 tensors. The library and the launcher are replaced by
    fakes (the launcher fills the outputs from the plain versions), so this
    runs without a card; the kernels are held to those versions by the
    ``cuda`` tests below."""
    calls = []

    def fake_launch(entry, what, *args):
        tensors = [a for a in args if torch.is_tensor(a)]
        assert all(t.dtype == torch.float32 and t.is_contiguous() for t in tensors)
        calls.append(entry)
        if entry == "tpuflow_mae_clip_means_f32":
            yt, yp, _, means = tensors
            means.copy_(mae_clip_reference(yt, yp, args[-1]))
        else:
            yt, yp, g, dyt, dyp = tensors
            for out, ref in zip((dyt, dyp), mae_clip_grad_reference(yt, yp, g, args[-1])):
                out.copy_(ref)

    monkeypatch.setattr(losses_mod, "_runs_plain", lambda t: False)
    monkeypatch.setattr(losses_mod, "_launch", fake_launch)
    monkeypatch.setattr(losses_mod, "_library", lambda: types.SimpleNamespace(
        tpuflow_mae_clip_chunks=lambda N: 1))
    yt, yp = _pair((20, 24), seed=12)
    pred = torch.from_numpy(yp).requires_grad_()
    counts = (mae_clip_rows.launches, mae_clip_grad.launches)
    loss = mae_clip(torch.from_numpy(yt), pred)
    loss.backward()
    assert calls == ["tpuflow_mae_clip_means_f32", "tpuflow_mae_clip_grad_f32"]
    assert (mae_clip_rows.launches, mae_clip_grad.launches) == (counts[0] + 1, counts[1] + 1)
    monkeypatch.undo()
    ref = torch.from_numpy(yp).requires_grad_()
    want = mae_clip(torch.from_numpy(yt), ref)
    want.backward()
    assert loss.item() == want.item()
    torch.testing.assert_close(pred.grad, ref.grad, atol=0, rtol=0)
    assert KERNELS["mae_clip_grad"] is mae_clip_grad


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


def _bitwise_equal(got, want) -> bool:
    """Equal bit for bit where not NaN, and NaN at the same places."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                                want.masked_fill(nan, 0).view(torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 480), (20, 24), (1, 4096 * 24), (3, 37)])
def test_cuda_grad_kernel_is_bitwise_the_plain_version(cuda_device, shape):
    """``mae_clip_grad`` does the plain backward's arithmetic in its order
    (a true division for g / n, then two products), so it equals it bit
    for bit, signed zeros included, with a NaN input and zero errors."""
    yt, yp = (torch.from_numpy(a).to(cuda_device) for a in _pair(shape, seed=shape[1] + 1))
    yp[0, :3] = yt[0, :3]
    yt[-1, -1] = float("nan")
    g = torch.tensor(0.37, device=cuda_device)
    launches = mae_clip_grad.launches
    got = mae_clip_grad(yt, yp, g, CLIP_VALUE)
    torch.cuda.synchronize()
    assert mae_clip_grad.launches == launches + 1
    for got_t, want_t in zip(got, mae_clip_grad_reference(yt, yp, g, CLIP_VALUE)):
        assert _bitwise_equal(got_t, want_t)
    with pytest.raises(TypeError, match="float32"):
        mae_clip_grad(yt.double(), yp.double(), g, CLIP_VALUE)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 24), (1, 10 ** 6)])
def test_cuda_means_repeat_bitwise_and_match(cuda_device, shape):
    """Many eval rows of one warp each, and a row of 245 blocks whose last
    block (by ticket) sums the partials: within rtol 1e-5 of the plain
    version, and 200 launches bitwise equal to the first."""
    yt, yp = (torch.from_numpy(a).to(cuda_device) for a in _pair(shape, seed=5))
    first = mae_clip_rows(yt, yp, CLIP_VALUE)
    runs = [mae_clip_rows(yt, yp, CLIP_VALUE) for _ in range(200)]
    torch.cuda.synchronize()
    torch.testing.assert_close(first, mae_clip_reference(yt, yp, CLIP_VALUE), atol=0, rtol=1e-5)
    assert all(torch.equal(r, first) for r in runs)
