"""The port's flash attention against the JAX package's Pallas kernels.

The JAX side runs ``tpuflow.kernels.flash_attention`` in Pallas interpret
mode on the CPU (tests/conftest.py), as the JAX package's own tests run it,
with ``TPUFLOW_FLASH_BLOCK=8`` so that its grid crosses tiles and pads a
ragged edge; the port runs on CPU tensors, where each wrapper takes its
plain version, tiled by ``block=8`` here. The CUDA kernels run only on a
GPU: the ``cuda``-marked tests hold them to their plain versions there and
skip elsewhere. JAX is imported inside the parity tests, so that on a GPU
machine without JAX this module still collects:
``python -m pytest --noconftest -m cuda tests/test_torch_attention_kernel.py``.
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.kernels import KERNELS
from tpuflow_torch.kernels import attention as att
from tpuflow_torch.kernels.attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_forward,
    flash_attention_reference,
    flash_dkv_reference,
    flash_dq_reference,
)
from tpuflow_torch.parallel.ring_attention import full_attention

ATOL = 1e-5  # forward, f32, as tests/test_kernels.py holds the Pallas kernel
GRAD_ATOL = 1e-4  # gradients: sums over T products in other orders


def _qkv(BH, T, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((BH, T, D)).astype(np.float32) for _ in range(3))


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("T", [16, 24, 40])
def test_forward_matches_jax_flash_attention(monkeypatch, T):
    import jax.numpy as jnp

    from tpuflow.kernels import flash_attention as jax_flash_attention

    monkeypatch.setenv("TPUFLOW_FLASH_BLOCK", "8")
    q, k, v = _qkv(4, T, 8, seed=T)
    want = np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v))))
    launches = flash_attention_forward.launches
    got = flash_attention(*_torch(q, k, v))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    tiled, lse = flash_attention_reference(*_torch(q, k, v), block=8)
    np.testing.assert_allclose(tiled.numpy(), want, atol=ATOL)
    assert lse.shape == (4, T) and lse.dtype == torch.float32
    assert flash_attention_forward.launches == launches  # the CPU path launches nothing


@pytest.mark.parametrize("T", [16, 40])
def test_gradients_match_jax_grad(monkeypatch, T):
    """Port autograd through ``flash_attention`` (CPU: the plain backward)
    against ``jax.grad`` through the Pallas custom VJP (interpret mode)."""
    import jax
    import jax.numpy as jnp

    from tpuflow.kernels import flash_attention as jax_flash_attention

    monkeypatch.setenv("TPUFLOW_FLASH_BLOCK", "8")
    q, k, v = _qkv(3, T, 8, seed=50 + T)
    w = np.random.default_rng(T).standard_normal((3, T, 8)).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(jax_flash_attention(*a) * w), argnums=(0, 1, 2)
    )(*(jnp.asarray(a) for a in (q, k, v)))
    args = _torch(q, k, v, grad=True)
    out = flash_attention(*args)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref, name in zip(args, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("T,block", [(24, 8), (40, 8), (37, 16), (20, 64), (1, 8)])
def test_tiled_plain_versions_match_full_attention(T, block):
    """The tiled plain versions (causal skip, ragged last tile) against the
    materialised softmax with torch autograd, forward and all three
    gradients, with a non-default scale."""
    q, k, v = _torch(*_qkv(2, T, 8, seed=T + block), grad=True)
    do = torch.from_numpy(np.random.default_rng(block).standard_normal((2, T, 8)).astype(np.float32))
    want = full_attention(q, k, v, causal=True, scale=0.3)
    dq, dk, dv = torch.autograd.grad(want, (q, k, v), do)
    with torch.no_grad():
        o, lse = flash_attention_reference(q, k, v, 0.3, block)
        s = torch.einsum("bqd,bkd->bqk", q, k) * 0.3
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), float("-inf"))
        torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=ATOL, rtol=0)
        torch.testing.assert_close(o, want, atol=ATOL, rtol=0)
        got = flash_attention_backward_reference(q, k, v, o, lse, do, 0.3, block)
    for g, w in zip(got, (dq, dk, dv)):
        torch.testing.assert_close(g, w, atol=GRAD_ATOL, rtol=0)
    # The dQ and dK/dV plain versions, called on their own with delta.
    delta = (do * o).sum(-1)
    torch.testing.assert_close(flash_dq_reference(q, k, v, do, lse, delta, 0.3, block),
                               got[0], atol=0, rtol=0)
    dk2, dv2 = flash_dkv_reference(q, k, v, do, lse, delta, 0.3, block)
    torch.testing.assert_close(dk2, got[1], atol=0, rtol=0)
    torch.testing.assert_close(dv2, got[2], atol=0, rtol=0)


@pytest.mark.parametrize("factor,block", [(100.0, 8), (50.0, 64)])
def test_extreme_scores_stay_finite(factor, block):
    """The running max keeps exp() in range, and masked pairs (-1e30, then
    multiplied by 0) inject no NaN into the output or the gradients."""
    q, k, v = _torch(*_qkv(2, 37, 8, seed=7))
    q, k = (q * factor).requires_grad_(), (k * factor).requires_grad_()
    v.requires_grad_()
    o, lse = flash_attention_reference(q, k, v, block=block)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    grads = flash_attention_backward(q.detach(), k.detach(), v.detach(), o.detach(),
                                     lse, torch.ones_like(o))
    for g in grads:
        assert torch.isfinite(g).all()
    out = flash_attention(q, k, v)
    out.square().sum().backward()
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()


def test_shape_device_and_head_dim_checks(monkeypatch):
    q, k, v = _torch(*_qkv(2, 8, 8, seed=1))
    with pytest.raises(ValueError, match="k must be"):
        flash_attention(q, k[:, :4], v)
    with pytest.raises(ValueError, match=r"\[BH, T, D\]"):
        flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_dq(q, k, v, q, torch.zeros(2, 7), torch.zeros(2, 8))
    assert KERNELS["flash_fwd"] is flash_attention_forward
    assert KERNELS["flash_dq"] is flash_attention_dq
    assert KERNELS["flash_dkv"] is flash_attention_dkv
    # On the card path the wrappers refuse a head dim the kernels are not
    # built for, and float64, before any library is built or loaded.
    monkeypatch.setattr(att, "_runs_plain", lambda t: False)
    monkeypatch.setattr(att, "_launch", lambda *a: pytest.fail("no launch expected"))
    with pytest.raises(ValueError, match=r"head dims \(16, 32, 64, 128\), got D=8"):
        flash_attention_forward(q, k, v)
    lse, delta = torch.zeros(2, 8), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="got D=8"):
        flash_attention_dq(q, k, v, q, lse, delta)
    with pytest.raises(ValueError, match="got D=8"):
        flash_attention_dkv(q, k, v, q, lse, delta)
    q16, k16, v16 = _torch(*_qkv(2, 8, 16, seed=2))
    with pytest.raises(TypeError, match="float32"):
        flash_attention_forward(q16.double(), k16.double(), v16.double())


def test_card_path_routes_through_the_three_launchers(monkeypatch):
    """The CUDA branch of ``flash_attention``: the forward launch, then in
    ``backward()`` the dQ and the dK/dV launches with ``delta`` from the
    wrapper, each counted once, on contiguous f32 tensors of the right
    shapes. The launcher is replaced by a fake that fills the outputs from
    the plain versions, so this runs without a card; the kernels themselves
    are held to those versions by the ``cuda`` tests below."""
    calls = []

    def fake_launch(stem, entry, what, *args):
        tensors = [a for a in args if torch.is_tensor(a)]
        assert all(t.dtype == torch.float32 and t.is_contiguous() for t in tensors)
        BH, T, D, scale = args[len(tensors):]
        calls.append((stem, entry, (BH, T, D)))
        if entry == "tpuflow_flash_fwd_f32":
            q, k, v, o, lse = tensors
            for t, ref in zip((o, lse), flash_attention_reference(q, k, v, scale)):
                t.copy_(ref)
        elif entry == "tpuflow_flash_dq_f32":
            *inputs, dq = tensors
            dq.copy_(flash_dq_reference(*inputs, scale))
        else:
            *inputs, dk, dv = tensors
            for t, ref in zip((dk, dv), flash_dkv_reference(*inputs, scale)):
                t.copy_(ref)

    monkeypatch.setattr(att, "_runs_plain", lambda t: False)
    monkeypatch.setattr(att, "_launch", fake_launch)
    q, k, v = _torch(*_qkv(3, 20, 16, seed=3), grad=True)
    wrappers = (flash_attention_forward, flash_attention_dq, flash_attention_dkv)
    counts = [w.launches for w in wrappers]
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None
    (out * out).sum().backward()
    assert [w.launches for w in wrappers] == [c + 1 for c in counts]
    assert calls == [("flash_fwd", "tpuflow_flash_fwd_f32", (3, 20, 16)),
                     ("flash_bwd", "tpuflow_flash_dq_f32", (3, 20, 16)),
                     ("flash_bwd", "tpuflow_flash_dkv_f32", (3, 20, 16))]
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = full_attention(*ref)
    torch.testing.assert_close(out.detach(), want.detach(), atol=ATOL, rtol=0)
    (want * want).sum().backward()
    for got, w in zip((q, k, v), ref):
        torch.testing.assert_close(got.grad, w.grad, atol=GRAD_ATOL, rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _normwise_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("BH,T,D", [(80, 24, 16), (6, 200, 32), (4, 130, 64),
                                    (3, 70, 128), (5, 3, 16)])
def test_cuda_kernels_match_plain_versions(cuda_device, BH, T, D):
    """``flash_fwd`` within 1e-5 abs of its plain version (f32 sums of up to
    T products in another order); ``flash_dq`` and ``flash_dkv`` normwise
    within 1e-4 (sums over T pairs, each of two D-term products)."""
    q, k, v, do = (torch.randn((BH, T, D), device=cuda_device,
                               generator=torch.Generator(cuda_device).manual_seed(i))
                   for i in range(4))
    counts = [w.launches for w in KERNELS.values()]
    o, lse = flash_attention_forward(q, k, v)
    delta = (o * do).sum(-1)
    dq = flash_attention_dq(q, k, v, do, lse, delta)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    ref_o, ref_lse = flash_attention_reference(q, k, v)
    torch.testing.assert_close(o, ref_o, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    want = flash_attention_backward_reference(q, k, v, o, lse, do)
    for g, w in zip((dq, dk, dv), want):
        assert _normwise_err(g, w) <= 1e-4
    got_counts = dict(zip(KERNELS, (w.launches - c for w, c in zip(KERNELS.values(), counts))))
    assert got_counts == {"lstm_fwd": 0, "lstm_bwd": 0, "mae_clip": 0, "mae_clip_grad": 0,
                          "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1,
                          "ring_round_fwd": 0, "ring_round_bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 128])
@pytest.mark.parametrize("T", [1, 24, 63, 64, 65])
def test_cuda_forward_on_both_sides_of_the_window_switch(cuda_device, T, D):
    """``flash_fwd`` takes windows of up to 64 as whole slices, 256 / (T
    D/16) of them a block, and longer ones as 64-row tiles on the tensor
    cores (3xTF32). BH = 257 is a multiple of no slice count a block takes
    here, so the last block is partial. o and lse within 1e-5 abs of the
    plain version; a second launch equals the first bitwise."""
    BH = 257
    q, k, v = (torch.randn((BH, T, D), device=cuda_device,
                           generator=torch.Generator(cuda_device).manual_seed(T + i))
               for i in range(3))
    o, lse = flash_attention_forward(q, k, v)
    o2, lse2 = flash_attention_forward(q, k, v)
    torch.cuda.synchronize()
    ref_o, ref_lse = flash_attention_reference(q, k, v)
    torch.testing.assert_close(o, ref_o, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_cuda_autograd_matches_full_attention(cuda_device):
    q, k, v = (torch.randn((8, 100, 16), device=cuda_device,
                           generator=torch.Generator(cuda_device).manual_seed(i)).requires_grad_()
               for i in range(3))
    out = flash_attention(q, k, v)
    (out * out).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = full_attention(*ref)
    (want * want).sum().backward()
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    for got, w in zip((q, k, v), ref):
        assert _normwise_err(got.grad, w.grad) <= 1e-4
    with pytest.raises(ValueError, match="got D=24"):
        flash_attention(*(torch.zeros((2, 8, 24), device=cuda_device) for _ in range(3)))
