"""The LSTM forward's tile schedule, and the persistent kernel on the card.

``csrc/lstm_fwd.cu`` spreads each step's ``h_{t-1} @ W_h`` over the card in
tiles of batch rows by hidden units, sums each tile over ``k`` slice by
slice, and separates the steps by a barrier across the grid.
``lstm_fwd_tiled_reference`` states that schedule in torch. On the CPU it
is held against ``lstm_scan_reference`` and against the JAX package's
Pallas ``lstm_scan`` (interpret mode, tests/conftest.py), at ragged shapes
and small tiles so that several tiles, and a ragged last one, occur. The
``cuda``-marked tests hold the kernel against the plain version on the
card and skip elsewhere:
``python -m pytest --noconftest -m cuda tests/test_torch_lstm_fwd.py``.
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.kernels import lstm as lstm_mod
from tpuflow_torch.kernels.lstm import (
    lstm_fwd_tiled_reference,
    lstm_scan,
    lstm_scan_reference,
)

TOL = 1e-5  # f32, abs and rel, as the other LSTM parity tests hold it
# Small tiles: rows 16, units 4, slices of 8, so that B = 20 .. 70 and
# H = 16 .. 64 give several tiles and slices, the last of each ragged.
SMALL_TILES = {"rows": 16, "units": 4, "slice": 8}


def _case(T, B, H, seed=0):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) / max(H, 1) ** 0.5).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    return xw, wh, b


@pytest.mark.parametrize("H", [1, 3, 16, 17, 50, 64])
@pytest.mark.parametrize("B", [1, 20, 37, 70])
def test_tiled_schedule_matches_reference_and_jax(B, H):
    import jax.numpy as jnp

    from tpuflow.kernels.lstm import _fwd as jax_fwd

    xw, wh, b = _case(6, B, H, seed=10 * B + H)
    args = [torch.from_numpy(a) for a in (xw, wh, b)]
    hs, cs = lstm_fwd_tiled_reference(*args, **SMALL_TILES)
    ref_hs, ref_cs = lstm_scan_reference(*args)
    torch.testing.assert_close(hs, ref_hs, atol=TOL, rtol=TOL)
    torch.testing.assert_close(cs, ref_cs, atol=TOL, rtol=TOL)
    want_hs, want_cs = jax_fwd(jnp.asarray(xw), jnp.asarray(wh), jnp.asarray(b))
    np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(cs.numpy(), np.asarray(want_cs), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("T,B,H", [(24, 20, 64), (5, 70, 17), (3, 128, 128), (1, 3, 5)])
def test_kernel_tiles_match_reference(T, B, H):
    """The kernel's own tiles (64 rows, 16 units, slices of 16): one tile
    at LSTM-64's training shape, ragged ones elsewhere, and T = 1, where no
    product runs."""
    args = [torch.from_numpy(a) for a in _case(T, B, H, seed=T + B + H)]
    hs, cs = lstm_fwd_tiled_reference(*args)
    ref_hs, ref_cs = lstm_scan_reference(*args)
    torch.testing.assert_close(hs, ref_hs, atol=TOL, rtol=TOL)
    torch.testing.assert_close(cs, ref_cs, atol=TOL, rtol=TOL)


class _AskedNothing:
    def __getattr__(self, name):
        raise AssertionError(f"the card path asked the library for {name} before the launch")


@pytest.mark.parametrize("grad", [False, True])
def test_card_path_asks_the_library_only_through_the_launcher(monkeypatch, grad):
    """On a CUDA tensor the forward reaches the library only inside
    ``_fwd_kernel(xw, wh, b, hs, cs)`` (and, with gradients, the
    backward's refusal before it): no plan, grid or workspace question is
    asked in ``_forward``, ``_LSTMScan.forward`` or ``lstm_scan``. Serving
    passes no ``cs``; training passes the buffer it keeps."""
    calls = []

    def fake_fwd(xw, wh, b, hs, cs):
        calls.append(cs)
        ref_hs, ref_cs = lstm_scan_reference(xw, wh, b)
        hs.copy_(ref_hs)
        if cs is not None:
            cs.copy_(ref_cs)

    monkeypatch.setattr(lstm_mod, "_runs_plain", lambda t: False)
    monkeypatch.setattr(lstm_mod, "_library", lambda stem: _AskedNothing())
    monkeypatch.setattr(lstm_mod, "_refuse_hidden", lambda stem, H: None)
    monkeypatch.setattr(lstm_mod, "_fwd_kernel", fake_fwd)
    xw, wh, b = (torch.from_numpy(a).requires_grad_(grad) for a in _case(4, 3, 8, seed=2))
    launches = lstm_scan.launches
    hs = lstm_scan(xw, wh, b)
    assert lstm_scan.launches == launches + 1
    assert (calls[0] is not None) == grad
    torch.testing.assert_close(hs, lstm_scan_reference(xw, wh, b)[0], atol=TOL, rtol=TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _card_case(device, T, B, H, seed):
    return [torch.from_numpy(a).to(device) for a in _case(T, B, H, seed=seed)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(24, 1, 64), (24, 20, 64), (24, 37, 300), (24, 20, 2048),
                                   (24, 4096, 512), (3, 2, 9685)])
def test_cuda_kernel_matches_plain_version(cuda_device, T, B, H):
    """hs and cs against ``lstm_scan_reference``, with and without a cs
    buffer (serving keeps c in the kernel's scratch); B = 4096, H = 512
    has more tiles a step than blocks resident at once."""
    xw, wh, b = _card_case(cuda_device, T, B, H, seed=B + H)
    cs = torch.empty((T, B, H), device=cuda_device)
    launches = lstm_scan.launches
    hs = lstm_scan(xw, wh, b, cs_out=cs)
    served = lstm_scan(xw, wh, b)
    torch.cuda.synchronize()
    assert lstm_scan.launches == launches + 2
    ref_hs, ref_cs = lstm_scan_reference(xw, wh, b)
    torch.testing.assert_close(hs, ref_hs, atol=TOL, rtol=TOL)
    torch.testing.assert_close(cs, ref_cs, atol=TOL, rtol=TOL)
    assert torch.equal(served, hs)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(20, 64), (37, 300)])
def test_cuda_repeats_bitwise_over_200_launches(cuda_device, B, H):
    """200 launches back to back on one stream equal the first bitwise: a
    race at the barrier, or h of the step before read stale from another
    SM, would show as a launch that differs."""
    xw, wh, b = _card_case(cuda_device, 24, B, H, seed=3)
    first = lstm_scan(xw, wh, b)
    runs = [lstm_scan(xw, wh, b) for _ in range(200)]
    torch.cuda.synchronize()
    bad = [i for i, hs in enumerate(runs) if not torch.equal(hs, first)]
    assert not bad, f"launches {bad[:10]} differ from the first"


@pytest.mark.cuda
def test_cuda_refuses_past_the_limit_naming_it(cuda_device):
    """The forward states its limit (at least the backward's 9685) and
    refuses the next hidden size before launching, naming the limit. No
    gradients, so that the forward's own refusal is the one raised."""
    limit = lstm_mod._library("lstm_fwd").tpuflow_lstm_fwd_max_hidden()
    assert limit >= lstm_mod._library("lstm_bwd").tpuflow_lstm_bwd_max_hidden()
    H = limit + 1
    xw = torch.zeros((2, 3, 4 * H), device=cuda_device)
    wh = torch.empty((H, 4 * H), device=cuda_device)
    b = torch.zeros(4 * H, device=cuda_device)
    with pytest.raises(ValueError, match=f"lstm_fwd takes hidden sizes from 1 to {limit} "):
        lstm_scan(xw, wh, b)
