"""Causal flash attention: the hand-written Hopper kernels and their plain versions.

Counterpart of ``tpuflow/kernels/attention.py::flash_attention``, forward
and custom VJP, for ``q, k, v [BH, T, D]`` with the heads folded into the
batch axis (the ``models.attention`` convention).

Kernels, each bound by bytes at the model's windows (T = 24, D = 16) and
by operations from T of about 150:
- ``csrc/flash_fwd.cu`` (``flash_fwd``) replaces the Pallas TPU kernel
  ``_fwd_kernel`` (launched by ``_fwd``), writing ``o`` and ``lse [BH, T]``
  f32: windows of up to 64 as whole (bh) slices, several a block, each
  row's scores in registers; longer ones as the online softmax over 64-row
  K/V tiles up to the diagonal, one block per (bh, 64-row q tile), with
  Q K^T and P V on the tensor cores in 3xTF32 (about f32 accuracy);
- ``csrc/flash_bwd.cu`` holds ``flash_dq``, which replaces ``_dq_kernel``,
  and ``flash_dkv``, which replaces ``_dkv_kernel``, in the forward's two
  designs: windows of up to 64 as whole (bh) slices, a thread group a q
  row (dq) or key row (dkv) walking only the pairs it sees; longer ones as
  64-row tiles, the heaviest first, with S, dP and the gradient products
  on the tensor cores in 3xTF32 (dq over K/V tiles up to the diagonal,
  dk and dv over Q/dO tiles from the diagonal to the end); probabilities
  recomputed from ``lse``, the scale applied once at the end;
- ``csrc/ring_round.cu`` holds ``ring_round_fwd``, which replaces
  ``_round_fwd_kernel`` (launched by ``ring_round_fwd``): one causal ring
  round, the running (m, l, acc) of the local q chunk updated against one
  visiting K/V block at global offsets; and ``ring_round_bwd``, which
  replaces ``_round_bwd_kernel``: that round's dq partial and the visiting
  block's dk, dv, from the final ``lse`` and ``delta``. The context-parallel
  ring (``tpuflow_torch.parallel.ring_attention``) drives them round by round.

``delta = rowsum(dO * O)`` in f32 stays a torch op here, as the JAX package
computes it outside its kernels. Each kernel masks the ragged last tile by T
(by the chunk length ``Tl`` for the ring rounds), so nothing is padded.

On a CUDA tensor each wrapper launches its kernel (f32, contiguous, head dim
16, 32, 64 or 128) or raises; on a CPU tensor it runs the plain version,
which states the tile loop of the JAX kernels line for line over tiles of
``block`` rows. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpuflow_torch.kernels import _build

NEG = -1e30  # finite mask value: keeps exp() NaN-free on masked rows
BLOCK = 64  # rows of the CUDA kernels' q and k/v tiles
HEAD_DIMS = (16, 32, 64, 128)  # the head dims the CUDA kernels are built for

_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _library(stem: str) -> ctypes.CDLL:
    lib = _libs.get(stem)
    if lib is None:
        lib = _build.load(stem)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32, i32, i32, ctypes.c_float, ptr]  # BH, T, D, scale, stream
        if stem == "flash_fwd":
            lib.tpuflow_flash_fwd_f32.argtypes = [ptr] * 5 + tail
            lib.tpuflow_flash_fwd_f32.restype = i32
        elif stem == "ring_round":
            # BH, Tl, D, q_off, k_off, scale, stream
            ring_tail = [i32] * 5 + [ctypes.c_float, ptr]
            for fn in (lib.tpuflow_ring_round_fwd_f32, lib.tpuflow_ring_round_bwd_f32):
                fn.argtypes = [ptr] * 9 + ring_tail
                fn.restype = i32
        else:
            lib.tpuflow_flash_dq_f32.argtypes = [ptr] * 7 + tail
            lib.tpuflow_flash_dq_f32.restype = i32
            lib.tpuflow_flash_dkv_f32.argtypes = [ptr] * 8 + tail
            lib.tpuflow_flash_dkv_f32.restype = i32
        _libs[stem] = lib
    return lib


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def _check_qkv(what: str, q, k, v, rows=None, **more) -> tuple[int, int, int]:
    """``(BH, T, D)``; raises unless q, k, v and the other ``[BH, T, D]``
    tensors share one shape and each of ``rows`` (name: tensor) is
    ``[BH, T]``."""
    if q.dim() != 3:
        raise ValueError(f"{what}: q must be [BH, T, D], got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v), *more.items()):
        if t.shape != q.shape:
            raise ValueError(
                f"{what}: {name} must be {tuple(q.shape)} like q, got {tuple(t.shape)}"
            )
    for name, t in (rows or {}).items():
        if t.shape != q.shape[:2]:
            raise ValueError(
                f"{what}: {name} must be {tuple(q.shape[:2])}, got {tuple(t.shape)}"
            )
    return tuple(q.shape)


def _runs_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA tensor
    (the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"flash attention runs on cuda or cpu, got {t.device}")


def _check_card(what: str, ref: torch.Tensor, **tensors) -> None:
    """What the CUDA kernels take: f32, contiguous, one device, a head dim
    they are built for."""
    D = ref.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(
            f"{what}: the CUDA kernels are built for head dims {HEAD_DIMS}, "
            f"got D={D} (model dim / heads)"
        )
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the CUDA kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


def _launch(stem: str, entry: str, what: str, *args) -> None:
    """Call C entry point ``entry`` of ``csrc/<stem>.cu`` on the current
    stream of the first tensor's device (tensors pass as pointers) and raise
    if it returns a CUDA error."""
    lib = _library(stem)
    device = next(a for a in args if torch.is_tensor(a)).device
    with torch.cuda.device(device):
        code = getattr(lib, entry)(
            *(a.data_ptr() if torch.is_tensor(a) else a for a in args),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, what)


# --- the plain versions: the JAX kernels' tile loop, line for line ----------


def _online_block_update(q, k_blk, v_blk, scale, m, l, acc, allowed):
    """The flash forward recurrence for one (q tile, k/v tile) pair
    (``attention.py::_online_block_update``); m, l, acc in f32."""
    s = scale * (q @ k_blk.transpose(-1, -2))
    s = torch.where(allowed, s, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None]) * allowed
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + p @ v_blk
    return m_new, l, acc


def _p_block(q, k_blk, scale, lse, allowed):
    """Backward probabilities ``exp(s - lse)`` for one tile pair, already
    final softmax values."""
    s = scale * (q @ k_blk.transpose(-1, -2))
    p = torch.exp(torch.where(allowed, s, NEG) - lse[..., None])
    return p * allowed


def _dq_block(q, k_blk, v_blk, do, scale, lse, delta, allowed):
    """One tile pair's contribution to dQ (the caller scales once)."""
    p = _p_block(q, k_blk, scale, lse, allowed)
    dp = do @ v_blk.transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    return ds @ k_blk


def _dkv_block(q, k_blk, v_blk, do, scale, lse, delta, allowed):
    """One tile pair's contribution to (dK, dV); dK carries the scale."""
    p = _p_block(q, k_blk, scale, lse, allowed)
    dv = p.transpose(-1, -2) @ do
    dp = do @ v_blk.transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    dk = scale * (ds.transpose(-1, -2) @ q)
    return dk, dv


def _allowed(q0: int, nq: int, k0: int, nk: int, device) -> torch.Tensor:
    """Causal mask of a tile pair, ``[nq, nk]``: key position <= query
    position."""
    q_pos = q0 + torch.arange(nq, device=device)[:, None]
    k_pos = k0 + torch.arange(nk, device=device)[None, :]
    return k_pos <= q_pos


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    block: int = BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward: ``(o [BH, T, D], lse [BH, T] f32)``
    over q and k/v tiles of ``block`` rows, k/v tiles wholly above the
    diagonal skipped, the last tile ragged. Differentiable by autograd."""
    BH, T, D = _check_qkv("flash_attention_reference", q, k, v)
    scale = _scale(q, scale)
    outs, lses = [], []
    for q0 in range(0, T, block):
        qi = q[:, q0 : q0 + block]
        nq = qi.shape[1]
        m = torch.full((BH, nq), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((BH, nq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((BH, nq, D), dtype=torch.float32, device=q.device)
        for k0 in range(0, q0 + nq, block):  # causal: up to the diagonal
            kj, vj = k[:, k0 : k0 + block], v[:, k0 : k0 + block]
            allowed = _allowed(q0, nq, k0, kj.shape[1], q.device)
            m, l, acc = _online_block_update(qi, kj, vj, scale, m, l, acc, allowed)
        l_safe = torch.where(l == 0, 1.0, l)
        outs.append((acc / l_safe[..., None]).to(q.dtype))
        lses.append(m + torch.log(l_safe))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def flash_dq_reference(q, k, v, do, lse, delta, scale=None, block: int = BLOCK):
    """The plain version of ``flash_dq``: ``dq [BH, T, D]`` from the
    residuals, over q tiles and the k/v tiles up to the diagonal."""
    _, T, _ = _check_qkv("flash_dq_reference", q, k, v, {"lse": lse, "delta": delta}, do=do)
    scale = _scale(q, scale)
    dqs = []
    for q0 in range(0, T, block):
        qi, doi = q[:, q0 : q0 + block], do[:, q0 : q0 + block]
        nq = qi.shape[1]
        lse_i, delta_i = lse[:, q0 : q0 + block], delta[:, q0 : q0 + block]
        acc = torch.zeros(qi.shape, dtype=torch.float32, device=q.device)
        for k0 in range(0, q0 + nq, block):
            kj, vj = k[:, k0 : k0 + block], v[:, k0 : k0 + block]
            allowed = _allowed(q0, nq, k0, kj.shape[1], q.device)
            acc = acc + _dq_block(qi, kj, vj, doi, scale, lse_i, delta_i, allowed)
        dqs.append((acc * scale).to(q.dtype))
    return torch.cat(dqs, dim=1)


def flash_dkv_reference(q, k, v, do, lse, delta, scale=None, block: int = BLOCK):
    """The plain version of ``flash_dkv``: ``(dk, dv)``, each ``[BH, T, D]``,
    over k tiles and the q tiles from the diagonal to the end."""
    _, T, _ = _check_qkv("flash_dkv_reference", q, k, v, {"lse": lse, "delta": delta}, do=do)
    scale = _scale(q, scale)
    dks, dvs = [], []
    for k0 in range(0, T, block):
        kj, vj = k[:, k0 : k0 + block], v[:, k0 : k0 + block]
        nk = kj.shape[1]
        dk = torch.zeros(kj.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(kj.shape, dtype=torch.float32, device=q.device)
        # Causal: q tiles wholly before this k tile contribute nothing.
        for q0 in range(k0, T, block):
            qi, doi = q[:, q0 : q0 + block], do[:, q0 : q0 + block]
            lse_i, delta_i = lse[:, q0 : q0 + block], delta[:, q0 : q0 + block]
            allowed = _allowed(q0, qi.shape[1], k0, nk, q.device)
            dk_p, dv_p = _dkv_block(qi, kj, vj, doi, scale, lse_i, delta_i, allowed)
            dk, dv = dk + dk_p, dv + dv_p
        dks.append(dk.to(k.dtype))
        dvs.append(dv.to(v.dtype))
    return torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta_t = sum_d do_t * o_t`` in f32: a small elementwise pass that
    stays outside the kernels, as in the JAX package."""
    return torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)


def flash_attention_backward_reference(
    q, k, v, o, lse, do, scale=None, block: int = BLOCK
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward: ``(dq, dk, dv)``."""
    delta = _delta(o, do)
    dq = flash_dq_reference(q, k, v, do, lse, delta, scale, block)
    dk, dv = flash_dkv_reference(q, k, v, do, lse, delta, scale, block)
    return dq, dk, dv


def _reaches(q0: int, nq: int, k0: int) -> bool:
    """Whether a k tile starting at global position ``k0`` reaches any of
    the ``nq`` queries from global position ``q0`` (the causal edge)."""
    return k0 <= q0 + nq - 1


def ring_round_fwd_reference(
    q, k_blk, v_blk, m, l, acc, q_off: int, k_off: int, scale: float,
    block: int = BLOCK,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of one forward ring round: the new ``(m, l, acc)``
    (f32) of the local chunk ``q [B, Tl, D]`` at global offset ``q_off``
    after the visiting ``k_blk, v_blk`` at ``k_off``, over tiles of
    ``block`` rows; k tiles past each q tile's causal edge are skipped."""
    B, Tl, D = _check_qkv("ring_round_fwd_reference", q, k_blk, v_blk,
                          {"m": m, "l": l}, acc=acc)
    ms, ls, accs = [], [], []
    for q0 in range(0, Tl, block):
        qi = q[:, q0 : q0 + block]
        nq = qi.shape[1]
        mi, li, ai = m[:, q0 : q0 + nq], l[:, q0 : q0 + nq], acc[:, q0 : q0 + nq]
        for k0 in range(0, Tl, block):
            if not _reaches(q_off + q0, nq, k_off + k0):
                break
            kj, vj = k_blk[:, k0 : k0 + block], v_blk[:, k0 : k0 + block]
            allowed = _allowed(q_off + q0, nq, k_off + k0, kj.shape[1], q.device)
            mi, li, ai = _online_block_update(qi, kj, vj, scale, mi, li, ai, allowed)
        ms.append(mi)
        ls.append(li)
        accs.append(ai)
    return torch.cat(ms, dim=1), torch.cat(ls, dim=1), torch.cat(accs, dim=1)


def ring_round_bwd_reference(
    q, k_blk, v_blk, do, lse, delta, q_off: int, k_off: int, scale: float,
    block: int = BLOCK,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of one backward ring round: this round's dq
    partial for the local chunk and dk, dv of the visiting block, each
    ``[B, Tl, D]`` in q's dtype, from the final ``lse`` and ``delta``."""
    B, Tl, D = _check_qkv("ring_round_bwd_reference", q, k_blk, v_blk,
                          {"lse": lse, "delta": delta}, do=do)
    dqs = []
    for q0 in range(0, Tl, block):
        qi, doi = q[:, q0 : q0 + block], do[:, q0 : q0 + block]
        nq = qi.shape[1]
        lse_i, delta_i = lse[:, q0 : q0 + nq], delta[:, q0 : q0 + nq]
        acc = torch.zeros(qi.shape, dtype=torch.float32, device=q.device)
        for k0 in range(0, Tl, block):
            if not _reaches(q_off + q0, nq, k_off + k0):
                break
            kj, vj = k_blk[:, k0 : k0 + block], v_blk[:, k0 : k0 + block]
            allowed = _allowed(q_off + q0, nq, k_off + k0, kj.shape[1], q.device)
            acc = acc + _dq_block(qi, kj, vj, doi, scale, lse_i, delta_i, allowed)
        dqs.append((acc * scale).to(q.dtype))
    dks, dvs = [], []
    for k0 in range(0, Tl, block):
        kj, vj = k_blk[:, k0 : k0 + block], v_blk[:, k0 : k0 + block]
        nk = kj.shape[1]
        dk = torch.zeros(kj.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(kj.shape, dtype=torch.float32, device=q.device)
        for q0 in range(0, Tl, block):
            qi, doi = q[:, q0 : q0 + block], do[:, q0 : q0 + block]
            nq = qi.shape[1]
            if not _reaches(q_off + q0, nq, k_off + k0):
                continue  # q tiles wholly before this k tile
            lse_i, delta_i = lse[:, q0 : q0 + nq], delta[:, q0 : q0 + nq]
            allowed = _allowed(q_off + q0, nq, k_off + k0, nk, q.device)
            dk_p, dv_p = _dkv_block(qi, kj, vj, doi, scale, lse_i, delta_i, allowed)
            dk, dv = dk + dk_p, dv + dv_p
        dks.append(dk.to(q.dtype))
        dvs.append(dv.to(q.dtype))
    return torch.cat(dqs, dim=1), torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


# --- the wrappers: the kernel on a CUDA tensor, the plain version on a CPU one


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o [BH, T, D], lse [BH, T] f32)`` of causal attention.

    CUDA tensors go through ``csrc/flash_fwd.cu`` and count one launch in
    ``flash_attention_forward.launches``; CPU tensors go through
    ``flash_attention_reference``."""
    BH, T, D = _check_qkv("flash_attention_forward", q, k, v)
    scale = _scale(q, scale)
    if _runs_plain(q):
        return flash_attention_reference(q, k, v, scale)
    _check_card("flash_fwd", q, q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    if BH and T:
        _launch("flash_fwd", "tpuflow_flash_fwd_f32",
                f"flash_fwd launch (BH={BH}, T={T}, D={D})",
                q, k, v, o, lse, BH, T, D, scale)
        _count(flash_attention_forward)
    return o, lse


def flash_attention_dq(q, k, v, do, lse, delta, scale=None) -> torch.Tensor:
    """``dq [BH, T, D]`` from the residuals and ``delta [BH, T]`` f32.

    CUDA tensors go through ``flash_dq`` in ``csrc/flash_bwd.cu`` and count
    one launch in ``flash_attention_dq.launches``; CPU tensors go through
    ``flash_dq_reference``."""
    BH, T, D = _check_qkv("flash_attention_dq", q, k, v, {"lse": lse, "delta": delta}, do=do)
    scale = _scale(q, scale)
    if _runs_plain(q):
        return flash_dq_reference(q, k, v, do, lse, delta, scale)
    _check_card("flash_dq", q, q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    if BH and T:
        _launch("flash_bwd", "tpuflow_flash_dq_f32",
                f"flash_dq launch (BH={BH}, T={T}, D={D})",
                q, k, v, do, lse, delta, dq, BH, T, D, scale)
        _count(flash_attention_dq)
    return dq


def flash_attention_dkv(
    q, k, v, do, lse, delta, scale=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)``, each ``[BH, T, D]``, from the same inputs as
    ``flash_attention_dq``.

    CUDA tensors go through ``flash_dkv`` in ``csrc/flash_bwd.cu`` and count
    one launch in ``flash_attention_dkv.launches``; CPU tensors go through
    ``flash_dkv_reference``."""
    BH, T, D = _check_qkv("flash_attention_dkv", q, k, v, {"lse": lse, "delta": delta}, do=do)
    scale = _scale(q, scale)
    if _runs_plain(q):
        return flash_dkv_reference(q, k, v, do, lse, delta, scale)
    _check_card("flash_dkv", q, q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if BH and T:
        _launch("flash_bwd", "tpuflow_flash_dkv_f32",
                f"flash_dkv launch (BH={BH}, T={T}, D={D})",
                q, k, v, do, lse, delta, dk, dv, BH, T, D, scale)
        _count(flash_attention_dkv)
    return dk, dv


def flash_attention_backward(
    q, k, v, o, lse, do, scale=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of causal attention for the upstream ``do``, from the
    forward's residuals ``o`` and ``lse``: ``delta`` here, then
    ``flash_attention_dq`` and ``flash_attention_dkv``."""
    _check_qkv("flash_attention_backward", q, k, v, {"lse": lse}, o=o, do=do)
    delta = _delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


def ring_round_fwd(q, k_blk, v_blk, m, l, acc, q_off: int, k_off: int, scale: float):
    """One causal ring round (``tpuflow/kernels/attention.py::ring_round_fwd``):
    the running ``m, l [B, Tl]`` and ``acc [B, Tl, D]`` (f32) of the local
    queries ``q [B, Tl, D]`` at global offset ``q_off``, updated with the
    visiting ``k_blk, v_blk [B, Tl, D]`` at ``k_off``. Returns new tensors,
    as the JAX kernel does.

    CUDA tensors go through ``ring_round_fwd`` in ``csrc/ring_round.cu`` and
    count one launch in ``ring_round_fwd.launches``, every round, a wholly
    future block too; CPU tensors go through ``ring_round_fwd_reference``."""
    B, Tl, D = _check_qkv("ring_round_fwd", q, k_blk, v_blk, {"m": m, "l": l}, acc=acc)
    if _runs_plain(q):
        return ring_round_fwd_reference(q, k_blk, v_blk, m, l, acc, q_off, k_off, scale)
    _check_card("ring_round_fwd", q, q=q, k=k_blk, v=v_blk, m=m, l=l, acc=acc)
    m2, l2, acc2 = torch.empty_like(m), torch.empty_like(l), torch.empty_like(acc)
    if B and Tl:
        _launch("ring_round", "tpuflow_ring_round_fwd_f32",
                f"ring_round_fwd launch (B={B}, Tl={Tl}, D={D}, q_off={q_off}, k_off={k_off})",
                q, k_blk, v_blk, m, l, acc, m2, l2, acc2, B, Tl, D, int(q_off),
                int(k_off), float(scale))
        _count(ring_round_fwd)
    return m2, l2, acc2


def ring_round_bwd(q, k_blk, v_blk, do, lse, delta, q_off: int, k_off: int, scale: float):
    """One backward ring round (``tpuflow/kernels/attention.py::ring_round_bwd``):
    ``(dq, dk, dv)``, each ``[B, Tl, D]`` in q's dtype, the local chunk's dq
    partial and the visiting block's dk, dv, from the final ``lse`` and
    ``delta [B, Tl]`` (f32).

    CUDA tensors go through ``ring_round_bwd`` in ``csrc/ring_round.cu`` and
    count one launch in ``ring_round_bwd.launches``; CPU tensors go through
    ``ring_round_bwd_reference``."""
    B, Tl, D = _check_qkv("ring_round_bwd", q, k_blk, v_blk,
                          {"lse": lse, "delta": delta}, do=do)
    if _runs_plain(q):
        return ring_round_bwd_reference(q, k_blk, v_blk, do, lse, delta, q_off, k_off, scale)
    _check_card("ring_round_bwd", q, q=q, k=k_blk, v=v_blk, do=do, lse=lse, delta=delta)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    if B and Tl:
        _launch("ring_round", "tpuflow_ring_round_bwd_f32",
                f"ring_round_bwd launch (B={B}, Tl={Tl}, D={D}, q_off={q_off}, k_off={k_off})",
                q, k_blk, v_blk, do, lse, delta, dq, dk, dv, B, Tl, D, int(q_off),
                int(k_off), float(scale))
        _count(ring_round_bwd)
    return dq, dk, dv


flash_attention_forward.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
ring_round_fwd.launches = 0
ring_round_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with gradients: the forward saves ``(q, k, v, o,
    lse)``, the backward is ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, do.contiguous(), ctx.scale
        )
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Fused causal attention: ``q, k, v [BH, T, D] -> [BH, T, D]``,
    ``scale = D ** -0.5`` by default, differentiable through
    ``flash_attention_backward``. The kernels on CUDA tensors, the plain
    versions on CPU tensors."""
    _check_qkv("flash_attention", q, k, v)
    return _FlashAttention.apply(q, k, v, _scale(q, scale))
