"""The LSTM backward as three pieces: gates, chain, weight gradients.

``csrc/lstm_bwd.cu`` computes the backward of ``lstm_scan`` as three
kernels (``lstm_bwd_gates``, ``lstm_bwd_chain``, ``lstm_bwd_wgrad``), each
with a plain PyTorch version. On the CPU the pieces are held, composed,
against ``lstm_scan_backward_reference`` and against ``jax.vjp`` through
the JAX package's Pallas ``lstm_scan`` (interpret mode, tests/conftest.py);
the Python glue that launches the kernels is held with the launchers
replaced by their plain versions. The ``cuda``-marked tests hold each
kernel against its plain piece on the card and skip elsewhere:
``python -m pytest --noconftest -m cuda tests/test_torch_lstm_bwd.py``.
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.kernels import lstm as lstm_mod
from tpuflow_torch.kernels.lstm import (
    lstm_bwd_chain,
    lstm_bwd_chain_reference,
    lstm_bwd_gates,
    lstm_bwd_gates_reference,
    lstm_bwd_wgrad,
    lstm_bwd_wgrad_reference,
    lstm_scan,
    lstm_scan_backward,
    lstm_scan_backward_reference,
    lstm_scan_reference,
)

ATOL = 1e-5  # f32, as tests/test_kernels.py holds the Pallas kernel
# Kernel vs plain piece on the card, normwise (max abs error over max abs
# value): gates and dz 1e-5 (sums of H and 4H products in another order,
# dz over T dependent steps); dW_h and db 1e-4 (sums over T*B products, by
# chunks and then over the chunks).
CARD_TOL = {"gates": 1e-5, "dz": 1e-5, "dwh": 1e-4, "db": 1e-4}


def _case(T, B, H, seed=0):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) / max(H, 1) ** 0.5).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    dhs = rng.standard_normal((T, B, H)).astype(np.float32)
    return xw, wh, b, dhs


def _pieces(xw, wh, b, hs, cs, dhs):
    gates = lstm_bwd_gates(xw, wh, b, hs)
    dz = lstm_bwd_chain(wh, cs, dhs, gates)
    return (dz, *lstm_bwd_wgrad(hs, dz))


@pytest.mark.parametrize("T", [1, 2, 8])
@pytest.mark.parametrize("B,H", [(1, 1), (5, 3), (3, 16), (7, 50)])
def test_pieces_compose_to_the_backward_and_match_jax(T, B, H):
    import jax
    import jax.numpy as jnp

    from tpuflow.kernels import lstm_scan as jax_lstm_scan

    xw, wh, b, dhs = _case(T, B, H, seed=T * 100 + B * 10 + H)
    _, vjp = jax.vjp(jax_lstm_scan, jnp.asarray(xw), jnp.asarray(wh), jnp.asarray(b))
    want_jax = vjp(jnp.asarray(dhs))
    xw_t, wh_t, b_t, dhs_t = (torch.from_numpy(a) for a in (xw, wh, b, dhs))
    hs, cs = lstm_scan_reference(xw_t, wh_t, b_t)
    got = _pieces(xw_t, wh_t, b_t, hs, cs, dhs_t)
    want = lstm_scan_backward_reference(xw_t, wh_t, b_t, hs, cs, dhs_t)
    for g, w, j in zip(got, want, want_jax):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=ATOL)
    if T == 1:
        assert not got[1].any()  # no h_{t-1} but zeros: dW_h is zero


def test_gates_piece_is_the_recomputed_forward():
    """The gate activations at step t are what the forward computed from
    h_{t-1}: their cell update gives cs[t]."""
    xw, wh, b, _ = (torch.from_numpy(a) for a in _case(6, 4, 12, seed=1))
    hs, cs = lstm_scan_reference(xw, wh, b)
    i, f, g, o = lstm_bwd_gates_reference(xw, wh, b, hs).split(12, dim=-1)
    c_prev = torch.cat([torch.zeros(1, 4, 12), cs[:-1]])
    torch.testing.assert_close(f * c_prev + i * g, cs, atol=ATOL, rtol=0)
    torch.testing.assert_close(o * torch.tanh(cs), hs, atol=ATOL, rtol=0)


def test_chain_piece_overwrites_the_gates_in_place():
    xw, wh, b, dhs = (torch.from_numpy(a) for a in _case(5, 3, 8, seed=2))
    hs, cs = lstm_scan_reference(xw, wh, b)
    gates = lstm_bwd_gates(xw, wh, b, hs)
    want = lstm_bwd_chain_reference(wh, cs, dhs, gates.clone())
    dz = lstm_bwd_chain(wh, cs, dhs, gates)
    assert dz.data_ptr() == gates.data_ptr()
    torch.testing.assert_close(dz, want, atol=0, rtol=0)
    dwh, db = lstm_bwd_wgrad_reference(hs, dz)
    torch.testing.assert_close(db, dz.sum(dim=(0, 1)), atol=ATOL, rtol=0)
    torch.testing.assert_close(dwh, hs[:-1].reshape(-1, 8).T @ dz[1:].reshape(-1, 32),
                               atol=ATOL, rtol=0)


def test_card_path_launches_the_three_kernels_in_order(monkeypatch):
    """``lstm_scan_backward``'s CUDA branch, with the three launchers
    replaced by their plain versions writing into the wrapper's buffers:
    the gates go into ``dxw``, the chain turns them into ``dz`` in place,
    the weight gradients come as S partials that the wrapper sums."""
    calls = []

    def fake_gates(xw, wh, b, hs, gates):
        calls.append("gates")
        gates.copy_(lstm_bwd_gates_reference(xw, wh, b, hs))

    def fake_chain(wh, cs, dhs, dxw):
        calls.append("chain")
        dxw.copy_(lstm_bwd_chain_reference(wh, cs, dhs, dxw))

    def fake_wgrad(hs, dz, dwh_parts, db_parts):
        calls.append("wgrad")
        dwh, db = lstm_bwd_wgrad_reference(hs, dz)
        dwh_parts.zero_()
        db_parts.zero_()
        dwh_parts[0] = dwh / 2
        dwh_parts[-1] += dwh / 2
        db_parts[1] = db

    monkeypatch.setattr(lstm_mod, "_runs_plain", lambda t: False)
    monkeypatch.setattr(lstm_mod, "_wgrad_splits", lambda T, B, H: 3)
    monkeypatch.setattr(lstm_mod, "_gates_kernel", fake_gates)
    monkeypatch.setattr(lstm_mod, "_chain_kernel", fake_chain)
    monkeypatch.setattr(lstm_mod, "_wgrad_kernel", fake_wgrad)
    xw, wh, b, dhs = (torch.from_numpy(a) for a in _case(6, 4, 10, seed=3))
    hs, cs = lstm_scan_reference(xw, wh, b)
    launches = lstm_scan_backward.launches
    got = lstm_scan_backward(xw, wh, b, hs, cs, dhs)
    assert calls == ["gates", "chain", "wgrad"]
    assert lstm_scan_backward.launches == launches + 1
    want = lstm_scan_backward_reference(xw, wh, b, hs, cs, dhs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


class _FakeLimits:
    def __init__(self, fwd, bwd):
        self.tpuflow_lstm_fwd_max_hidden = lambda: fwd
        self.tpuflow_lstm_bwd_max_hidden = lambda: bwd


def test_hidden_beyond_the_limit_names_the_limit(monkeypatch):
    """The wrappers ask each kernel for the largest H its shared-memory
    tiles take and raise beyond it, naming that limit; training refuses
    before the forward runs."""
    limits = _FakeLimits(fwd=6, bwd=5)
    monkeypatch.setattr(lstm_mod, "_library", lambda stem: limits)
    lstm_mod._refuse_hidden("lstm_bwd", 5)
    with pytest.raises(ValueError, match="lstm_bwd takes hidden sizes from 1 to 5 .*H=6"):
        lstm_mod._refuse_hidden("lstm_bwd", 6)
    with pytest.raises(ValueError, match="lstm_fwd takes hidden sizes from 1 to 6 .*H=7"):
        lstm_mod._refuse_hidden("lstm_fwd", 7)

    monkeypatch.setattr(lstm_mod, "_runs_plain", lambda t: False)

    def no_forward(*args):
        raise AssertionError("the forward ran before the refusal")

    monkeypatch.setattr(lstm_mod, "_fwd_kernel", no_forward)
    xw, wh, b, _ = (torch.from_numpy(a).requires_grad_() for a in _case(2, 3, 6))
    with pytest.raises(ValueError, match="from 1 to 5 .*H=6"):
        lstm_scan(xw, wh, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _normwise_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _card_case(device, B, H, T=24, seed=0):
    xw, wh, b, dhs = (torch.from_numpy(a).to(device) for a in _case(T, B, H, seed=seed))
    hs, cs = lstm_scan_reference(xw, wh, b)
    return xw, wh, b, hs, cs, dhs


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(1, 64), (20, 64), (37, 64), (5, 76), (20, 50), (4096, 512),
                                 (3, 1), (7, 3)])
def test_cuda_each_kernel_matches_its_plain_piece(cuda_device, B, H):
    """Each kernel on the same inputs as its plain piece (the chain and the
    weight gradients take the plain piece's gates and dz), then the whole
    backward against ``lstm_scan_backward_reference``."""
    xw, wh, b, hs, cs, dhs = _card_case(cuda_device, B, H, seed=B + H)
    gates = lstm_bwd_gates(xw, wh, b, hs)
    want_gates = lstm_bwd_gates_reference(xw, wh, b, hs)
    dz = lstm_bwd_chain(wh, cs, dhs, want_gates.clone())
    want_dz = lstm_bwd_chain_reference(wh, cs, dhs, want_gates)
    dwh, db = lstm_bwd_wgrad(hs, want_dz)
    want_dwh, want_db = lstm_bwd_wgrad_reference(hs, want_dz)
    torch.cuda.synchronize()
    for name, g, w in (("gates", gates, want_gates), ("dz", dz, want_dz),
                       ("dwh", dwh, want_dwh), ("db", db, want_db)):
        assert _normwise_err(g, w) <= CARD_TOL[name], name
    got = lstm_scan_backward(xw, wh, b, hs, cs, dhs)
    want = lstm_scan_backward_reference(xw, wh, b, hs, cs, dhs)
    for name, g, w in zip(("dz", "dwh", "db"), got, want):
        assert _normwise_err(g, w) <= CARD_TOL[name], name


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(20, 64), (4096, 64), (33, 300)])
def test_cuda_backward_repeats_bitwise(cuda_device, B, H):
    """No float atomics: two calls give bitwise-equal gradients."""
    xw, wh, b, hs, cs, dhs = _card_case(cuda_device, B, H, seed=7)
    first = lstm_scan_backward(xw, wh, b, hs, cs, dhs)
    second = lstm_scan_backward(xw, wh, b, hs, cs, dhs)
    for g1, g2 in zip(first, second):
        assert torch.equal(g1, g2)


@pytest.mark.cuda
def test_cuda_lstm_scan_at_hidden_2048(cuda_device):
    """H = 2048 (beyond the old 1024 cap): the forward over 128 unit tiles
    a step, the chain with W_h read through L2, against the plain versions."""
    xw, wh, b, hs_ref, cs_ref, dhs = _card_case(cuda_device, 4, 2048, seed=5)
    cs = torch.empty_like(cs_ref)
    hs = lstm_scan(xw, wh, b, cs_out=cs)
    got = lstm_scan_backward(xw, wh, b, hs, cs, dhs)
    torch.cuda.synchronize()
    torch.testing.assert_close(hs, hs_ref, atol=ATOL, rtol=ATOL)
    torch.testing.assert_close(cs, cs_ref, atol=ATOL, rtol=ATOL)
    want = lstm_scan_backward_reference(xw, wh, b, hs_ref, cs_ref, dhs)
    for name, g, w in zip(("dz", "dwh", "db"), got, want):
        assert _normwise_err(g, w) <= CARD_TOL[name], name


@pytest.mark.cuda
def test_cuda_kernels_take_hidden_4096(cuda_device):
    """Both kernels state a limit of at least 4096, and run there."""
    fwd = lstm_mod._library("lstm_fwd").tpuflow_lstm_fwd_max_hidden()
    bwd = lstm_mod._library("lstm_bwd").tpuflow_lstm_bwd_max_hidden()
    assert fwd >= 4096 and bwd >= 4096
    xw, wh, b, hs_ref, cs_ref, dhs = _card_case(cuda_device, 2, 4096, T=3, seed=6)
    cs = torch.empty_like(cs_ref)
    hs = lstm_scan(xw, wh, b, cs_out=cs)
    got = lstm_scan_backward(xw, wh, b, hs, cs, dhs)
    torch.cuda.synchronize()
    torch.testing.assert_close(hs, hs_ref, atol=ATOL, rtol=ATOL)
    want = lstm_scan_backward_reference(xw, wh, b, hs_ref, cs_ref, dhs)
    for name, g, w in zip(("dz", "dwh", "db"), got, want):
        assert _normwise_err(g, w) <= CARD_TOL[name], name


@pytest.mark.cuda
@pytest.mark.parametrize("H", [9686, 23170])
def test_cuda_backward_past_the_shared_memory_tiles(cuda_device, H):
    """Past H = 9685 the chain's tiles no longer fit in shared memory and
    live in a scratch in device memory; the backward takes every H up to
    the forward's 32-bit limit on W_h, 23170 (W_h then holds 8.6 GB), and
    matches its plain version at the tolerances above."""
    assert lstm_mod._library("lstm_bwd").tpuflow_lstm_bwd_max_hidden() == 23170
    gen = torch.Generator(cuda_device).manual_seed(H)
    xw = torch.randn((2, 2, 4 * H), generator=gen, device=cuda_device)
    wh = torch.randn((H, 4 * H), generator=gen, device=cuda_device) / H ** 0.5
    b = torch.randn(4 * H, generator=gen, device=cuda_device) * 0.1
    dhs = torch.randn((2, 2, H), generator=gen, device=cuda_device)
    hs, cs = lstm_scan_reference(xw, wh, b)
    got = lstm_scan_backward(xw, wh, b, hs, cs, dhs)
    torch.cuda.synchronize()
    want = lstm_scan_backward_reference(xw, wh, b, hs, cs, dhs)
    for name, g, w in zip(("dz", "dwh", "db"), got, want):
        assert _normwise_err(g, w) <= CARD_TOL[name], name
