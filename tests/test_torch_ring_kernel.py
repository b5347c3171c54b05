"""The port's ring-round kernels against the JAX package's Pallas kernels.

``tpuflow.kernels.attention.ring_round_fwd`` and ``ring_round_bwd`` run in
Pallas interpret mode on the CPU, as the JAX package's own tests run them;
at chunk lengths 12 and 20 JAX pads the chunk to its tile, so its
``real_len`` masking runs. The port's wrappers take their plain versions on
CPU tensors (tiled by ``block=8`` here as well, to cross tiles and a ragged
edge). Three offset patterns: the diagonal round, a block from the past and
one from the future. The CUDA kernels run only on a GPU: the ``cuda``-marked
tests hold them to their plain versions there and skip elsewhere
(``python -m pytest --noconftest -m cuda tests/test_torch_ring_kernel.py``).
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.kernels import KERNELS
from tpuflow_torch.kernels.attention import (
    ring_round_bwd,
    ring_round_bwd_reference,
    ring_round_fwd,
    ring_round_fwd_reference,
)

ATOL = 1e-5  # forward, f32
GRAD_ATOL = 1e-4  # backward: sums over Tl pairs of products in other orders
# (q_off, k_off) in units of the chunk length: the diagonal round, a block
# from the past (one rank back) and one from the future.
OFFSETS = {"diagonal": (1, 1), "past": (2, 1), "future": (0, 1)}


def _round_inputs(B, Tl, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do, acc = (rng.standard_normal((B, Tl, D)).astype(np.float32) for _ in range(5))
    m = rng.standard_normal((B, Tl)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (B, Tl)).astype(np.float32)
    # lse above every score keeps exp(s - lse) of order 1, as a real one does.
    lse = (3.0 + rng.uniform(0.0, 1.0, (B, Tl))).astype(np.float32)
    delta = rng.standard_normal((B, Tl)).astype(np.float32)
    return {"q": q, "k": k, "v": v, "do": do, "acc": acc, "m": m, "l": l,
            "lse": lse, "delta": delta}


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("pattern", sorted(OFFSETS))
@pytest.mark.parametrize("Tl", [12, 20])
def test_round_forward_matches_jax(monkeypatch, Tl, pattern):
    import jax.numpy as jnp

    from tpuflow.kernels.attention import ring_round_fwd as jax_ring_round_fwd

    monkeypatch.setenv("TPUFLOW_FLASH_BLOCK", "8")
    a = _round_inputs(3, Tl, 8, seed=Tl)
    q_off, k_off = (o * Tl for o in OFFSETS[pattern])
    scale = 8 ** -0.5
    want = jax_ring_round_fwd(
        *(jnp.asarray(a[n]) for n in ("q", "k", "v", "m", "l", "acc")),
        jnp.int32(q_off), jnp.int32(k_off), scale)
    launches = ring_round_fwd.launches
    for got in (ring_round_fwd(*(_t(a[n]) for n in ("q", "k", "v", "m", "l", "acc")),
                               q_off, k_off, scale),
                ring_round_fwd_reference(*(_t(a[n]) for n in ("q", "k", "v", "m", "l", "acc")),
                                         q_off, k_off, scale, block=8)):
        for g, w, name in zip(got, want, ("m", "l", "acc")):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)
    assert ring_round_fwd.launches == launches  # the CPU path launches nothing
    if pattern == "future":  # a wholly future block leaves the stats as they were
        for g, n in zip(got, ("m", "l", "acc")):
            np.testing.assert_array_equal(g.numpy(), a[n])


@pytest.mark.parametrize("pattern", sorted(OFFSETS))
@pytest.mark.parametrize("Tl", [12, 20])
def test_round_backward_matches_jax(monkeypatch, Tl, pattern):
    import jax.numpy as jnp

    from tpuflow.kernels.attention import ring_round_bwd as jax_ring_round_bwd

    monkeypatch.setenv("TPUFLOW_FLASH_BLOCK", "8")
    a = _round_inputs(2, Tl, 16, seed=100 + Tl)
    q_off, k_off = (o * Tl for o in OFFSETS[pattern])
    scale = 0.3
    names = ("q", "k", "v", "do", "lse", "delta")
    want = jax_ring_round_bwd(*(jnp.asarray(a[n]) for n in names),
                              jnp.int32(q_off), jnp.int32(k_off), scale)
    for got in (ring_round_bwd(*(_t(a[n]) for n in names), q_off, k_off, scale),
                ring_round_bwd_reference(*(_t(a[n]) for n in names), q_off, k_off, scale,
                                         block=8)):
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            assert g.shape == (2, Tl, 16)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, err_msg=name)
    if pattern == "future":
        assert all(not g.any() for g in got)


# q_off - k_off of rounds whose causal edge lies inside a tile or across
# tiles (of 8 rows here): the ring never gives them, the kernels' interface
# allows them.
UNALIGNED = [-5, 3, 13, 29]


@pytest.mark.parametrize("ahead", UNALIGNED)
@pytest.mark.parametrize("Tl", [12, 20])
def test_round_kernels_match_jax_at_unaligned_offsets(monkeypatch, Tl, ahead):
    import jax.numpy as jnp

    from tpuflow.kernels.attention import ring_round_bwd as jax_ring_round_bwd
    from tpuflow.kernels.attention import ring_round_fwd as jax_ring_round_fwd

    monkeypatch.setenv("TPUFLOW_FLASH_BLOCK", "8")
    a = _round_inputs(2, Tl, 8, seed=200 + Tl + ahead)
    k_off = 37
    q_off = k_off + ahead
    scale = 8 ** -0.5
    names = ("q", "k", "v", "m", "l", "acc")
    want = jax_ring_round_fwd(*(jnp.asarray(a[n]) for n in names),
                              jnp.int32(q_off), jnp.int32(k_off), scale)
    for got in (ring_round_fwd(*(_t(a[n]) for n in names), q_off, k_off, scale),
                ring_round_fwd_reference(*(_t(a[n]) for n in names), q_off, k_off, scale,
                                         block=8)):
        for g, w, name in zip(got, want, ("m", "l", "acc")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)
    if ahead < 0:  # rows that no key reaches keep their stats
        for g, n in zip(got, ("m", "l", "acc")):
            np.testing.assert_array_equal(g.numpy()[:, :-ahead], a[n][:, :-ahead])
    names = ("q", "k", "v", "do", "lse", "delta")
    want = jax_ring_round_bwd(*(jnp.asarray(a[n]) for n in names),
                              jnp.int32(q_off), jnp.int32(k_off), scale)
    for got in (ring_round_bwd(*(_t(a[n]) for n in names), q_off, k_off, scale),
                ring_round_bwd_reference(*(_t(a[n]) for n in names), q_off, k_off, scale,
                                         block=8)):
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, err_msg=name)


def test_rounds_compose_to_causal_attention():
    """Four rounds of the plain versions over the chunks of one sequence, in
    the ring's order for each chunk, give causal attention and its
    gradients (the backward from the forward's own lse and delta)."""
    from tpuflow_torch.parallel.ring_attention import full_attention

    n, Tl, D = 4, 5, 8
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, n * Tl, D)).astype(np.float32))
                   for _ in range(4))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    want = full_attention(qg, kg, vg)
    want_grads = torch.autograd.grad(want, (qg, kg, vg), do)
    scale = D ** -0.5

    def chunk(t, i):
        return t[:, i * Tl : (i + 1) * Tl].contiguous()

    outs, lses = [], []
    for i in range(n):
        m = torch.full((2, Tl), -1e30)
        l, acc = torch.zeros((2, Tl)), torch.zeros((2, Tl, D))
        for r in range(n):
            j = (i - r) % n
            m, l, acc = ring_round_fwd(chunk(q, i), chunk(k, j), chunk(v, j), m, l, acc,
                                       i * Tl, j * Tl, scale)
        outs.append(acc / l[..., None])
        lses.append(m + torch.log(l))
    out = torch.cat(outs, dim=1)
    torch.testing.assert_close(out, want.detach(), atol=ATOL, rtol=0)
    delta = (do * out).sum(-1)
    lse = torch.cat(lses, dim=1)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for i in range(n):
        for j in range(n):
            g = ring_round_bwd(chunk(q, i), chunk(k, j), chunk(v, j), chunk(do, i),
                               lse[:, i * Tl : (i + 1) * Tl], delta[:, i * Tl : (i + 1) * Tl],
                               i * Tl, j * Tl, scale)
            dq[:, i * Tl : (i + 1) * Tl] += g[0]
            dk[:, j * Tl : (j + 1) * Tl] += g[1]
            dv[:, j * Tl : (j + 1) * Tl] += g[2]
    for got, w in zip((dq, dk, dv), want_grads):
        torch.testing.assert_close(got, w, atol=GRAD_ATOL, rtol=0)


def test_shapes_are_checked_and_the_wrappers_are_registered():
    a = _round_inputs(2, 8, 16, seed=0)
    with pytest.raises(ValueError, match="m must be"):
        ring_round_fwd(_t(a["q"]), _t(a["k"]), _t(a["v"]), _t(a["m"][:, :4]), _t(a["l"]),
                       _t(a["acc"]), 0, 0, 0.25)
    with pytest.raises(ValueError, match="do must be"):
        ring_round_bwd(_t(a["q"]), _t(a["k"]), _t(a["v"]), _t(a["do"][:1]), _t(a["lse"]),
                       _t(a["delta"]), 0, 0, 0.25)
    assert KERNELS["ring_round_fwd"] is ring_round_fwd
    assert KERNELS["ring_round_bwd"] is ring_round_bwd


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _normwise_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", sorted(OFFSETS))
@pytest.mark.parametrize("B,Tl,D", [(80, 64, 16), (6, 100, 16), (4, 250, 64), (3, 70, 128),
                                    (5, 3, 32)])
def test_cuda_round_kernels_match_plain_versions(cuda_device, B, Tl, D, pattern):
    """Forward: m, the log-sum-exp m + log(l) and the normalised output
    acc / l within 1e-5 abs of the plain version (the same online softmax
    over the same 64-row tiles, dot products summed in another order; the
    raw l and acc are running sums of exponentials, in the hundreds here,
    and acc's cancel); backward normwise within 1e-4. One launch each."""
    a = {n: _t(x).to(cuda_device) for n, x in _round_inputs(B, Tl, D, seed=Tl).items()}
    q_off, k_off = (o * Tl for o in OFFSETS[pattern])
    scale = D ** -0.5
    counts = {n: w.launches for n, w in KERNELS.items()}
    fwd = ring_round_fwd(*(a[n] for n in ("q", "k", "v", "m", "l", "acc")), q_off, k_off, scale)
    bwd = ring_round_bwd(*(a[n] for n in ("q", "k", "v", "do", "lse", "delta")),
                         q_off, k_off, scale)
    torch.cuda.synchronize()
    got_counts = {n: w.launches - counts[n] for n, w in KERNELS.items()}
    assert got_counts == {**dict.fromkeys(KERNELS, 0), "ring_round_fwd": 1, "ring_round_bwd": 1}
    want = ring_round_fwd_reference(*(a[n] for n in ("q", "k", "v", "m", "l", "acc")),
                                    q_off, k_off, scale)
    (gm, gl, ga), (wm, wl, wa) = fwd, want
    for g, w in ((gm, wm), (gm + torch.log(gl), wm + torch.log(wl)),
                 (ga / gl[..., None], wa / wl[..., None])):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    want = ring_round_bwd_reference(*(a[n] for n in ("q", "k", "v", "do", "lse", "delta")),
                                    q_off, k_off, scale)
    for g, w in zip(bwd, want):
        if pattern == "future":
            assert not g.any()
        else:
            assert _normwise_err(g, w) <= GRAD_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", sorted(OFFSETS) + ["unaligned"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("Tl", [1, 63, 64, 65, 128, 250])
def test_cuda_round_kernels_on_both_sides_of_the_design_switch(cuda_device, Tl, D, pattern):
    """The short-chunk kernels (Tl <= 64; at 531 heads, so that blocks take
    several slices and the last one fewer) and the tensor-core ones (Tl > 64)
    at every head dim, the three patterns and q_off - k_off = 30 - Tl // 2,
    which puts the causal edge inside a tile (and leaves the first rows
    without a key where it is negative): the forward within 1e-5 of the
    plain version on m, m + log(l) and acc / l, the backward normwise within
    1e-4; a future block copies the stats through bit for bit and gives zero
    gradients. One launch each."""
    B = 531 if Tl <= 64 else 3
    a = {n: _t(x).to(cuda_device) for n, x in _round_inputs(B, Tl, D, seed=Tl + D).items()}
    if pattern == "unaligned":
        q_off, k_off = 4 * Tl + 30, 4 * Tl + Tl // 2
    else:
        q_off, k_off = (o * Tl for o in OFFSETS[pattern])
    scale = D ** -0.5
    fwd_in = tuple(a[n] for n in ("q", "k", "v", "m", "l", "acc"))
    bwd_in = tuple(a[n] for n in ("q", "k", "v", "do", "lse", "delta"))
    counts = {n: w.launches for n, w in KERNELS.items()}
    fwd = ring_round_fwd(*fwd_in, q_off, k_off, scale)
    bwd = ring_round_bwd(*bwd_in, q_off, k_off, scale)
    torch.cuda.synchronize()
    got_counts = {n: w.launches - counts[n] for n, w in KERNELS.items()}
    assert got_counts == {**dict.fromkeys(KERNELS, 0), "ring_round_fwd": 1, "ring_round_bwd": 1}
    if pattern == "future":
        for g, n in zip(fwd, ("m", "l", "acc")):
            assert torch.equal(g, a[n]), n
        assert not any(g.any() for g in bwd)
        return
    (gm, gl, ga), (wm, wl, wa) = fwd, ring_round_fwd_reference(*fwd_in, q_off, k_off, scale)
    for g, w in ((gm, wm), (gm + torch.log(gl), wm + torch.log(wl)),
                 (ga / gl[..., None], wa / wl[..., None])):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    for g, w in zip(bwd, ring_round_bwd_reference(*bwd_in, q_off, k_off, scale)):
        assert _normwise_err(g, w) <= GRAD_ATOL
