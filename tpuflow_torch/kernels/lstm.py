"""Fused LSTM recurrence: the hand-written Hopper kernels and their plain versions.

Counterpart of ``tpuflow/kernels/lstm.py::lstm_scan``, forward and backward.
The surrounding layer (``tpuflow_torch.models.lstm``) hoists the input
projection ``x @ W_x`` out of the recurrence as one matmul; what remains,
``h @ W_h`` plus the gate math for every step, runs here.

Kernels:
- ``csrc/lstm_fwd.cu`` replaces the Pallas TPU kernel
  ``tpuflow/kernels/lstm.py::_fwd_kernel`` (launched by ``_fwd``). On an H100
  it is bound by operations: at the serving shape (T=24, B=4096, H=64) the
  recurrent product is 3.2 GFLOP on the f32 CUDA cores against 125 MB of
  ``xw`` read and ``hs`` written. It keeps ``W_h`` in shared memory for all
  steps (read through L2 instead where it does not fit, H > 116), ``h`` in
  shared memory, ``c`` in registers, and gives each thread the four gate
  columns of one hidden unit so the gate math needs no exchange between
  threads. A multiple of 4 up to 256 runs one thread per hidden unit with
  ``h`` read as float4; every other size runs a layout with several units a
  thread and ``h`` read one float at a time.
- ``csrc/lstm_bwd.cu`` replaces ``_bwd_kernel`` (launched by ``_bwd``) with
  three kernels, launched one after the other by ``_bwd_kernel`` here:
  ``lstm_bwd_gates`` recomputes the gates of all ``T*B`` rows at once (a
  tiled GEMM ``[T*B, H] x [H, 4H]`` with the activations in its epilogue)
  into the ``dxw`` buffer; ``lstm_bwd_chain`` walks the steps backwards
  with ``dz @ W_h^T`` as the only product on its serial chain and
  overwrites the gates with ``dz``; ``lstm_bwd_wgrad`` forms ``dW_h =
  Hprev^T dz`` and ``db`` after the loop, as ``S`` partials over chunks of
  the rows that ``lstm_scan_backward`` sums in a fixed order. Each has its
  plain version (``lstm_bwd_gates_reference``, ``lstm_bwd_chain_reference``,
  ``lstm_bwd_wgrad_reference``); composed they are
  ``lstm_scan_backward_reference``.

The kernels compute the largest hidden size their shared-memory tiles take
(``tpuflow_lstm_{fwd,bwd}_max_hidden``: 4842 forward, 9685 backward); the
wrappers raise beyond it, naming the limit.

``lstm_scan`` is differentiable: when gradients are needed it runs as a
``torch.autograd.Function`` whose forward keeps the cell states and whose
backward is ``lstm_scan_backward``. On a CUDA tensor each wrapper launches
its kernel or raises; on a CPU tensor it runs the plain PyTorch version
(``lstm_scan_reference``, ``lstm_scan_backward_reference``). There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpuflow_torch.kernels import _build

_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _check_shapes(xw, wh, b, cs_out) -> tuple[int, int, int]:
    if xw.dim() != 3 or xw.shape[2] % 4:
        raise ValueError(f"lstm_scan: xw must be [T, B, 4H], got {tuple(xw.shape)}")
    T, B, H4 = xw.shape
    H = H4 // 4
    if tuple(wh.shape) != (H, H4) or tuple(b.shape) != (H4,):
        raise ValueError(
            f"lstm_scan: xw {tuple(xw.shape)} needs wh [{H}, {H4}] and "
            f"b [{H4}], got {tuple(wh.shape)} and {tuple(b.shape)}"
        )
    if cs_out is not None and tuple(cs_out.shape) != (T, B, H):
        raise ValueError(
            f"lstm_scan: cs_out must be [{T}, {B}, {H}], got "
            f"{tuple(cs_out.shape)}"
        )
    return T, B, H


def _runs_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA tensor
    (the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"lstm_scan runs on cuda or cpu, got {t.device}")


def _check_card(what: str, ref: torch.Tensor, **tensors) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the CUDA kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


def _library(stem: str) -> ctypes.CDLL:
    lib = _libs.get(stem)
    if lib is None:
        lib = _build.load(stem)
        if stem == "lstm_fwd":
            fn = lib.tpuflow_lstm_fwd_f32
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        else:
            for name, n_ptrs, n_ints in (("gates", 5, 3), ("chain", 4, 3), ("wgrad", 4, 4)):
                fn = getattr(lib, f"tpuflow_lstm_bwd_{name}")
                fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.tpuflow_lstm_bwd_splits.argtypes = [ctypes.c_int] * 3
            lib.tpuflow_lstm_bwd_splits.restype = ctypes.c_int
        max_hidden = getattr(lib, f"tpuflow_{stem}_max_hidden")
        max_hidden.argtypes = []
        max_hidden.restype = ctypes.c_int
        _libs[stem] = lib
    return lib


def _refuse_hidden(stem: str, H: int) -> None:
    """Raise, naming the limit, when kernel ``stem`` does not take hidden
    size H (1 up to the most its shared-memory tiles hold)."""
    limit = getattr(_library(stem), f"tpuflow_{stem}_max_hidden")()
    if H <= 0 or H > limit:
        raise ValueError(
            f"{stem} takes hidden sizes from 1 to {limit} (the most its "
            f"per-block tiles fit in shared memory); got H={H}"
        )


def _wgrad_splits(T: int, B: int, H: int) -> int:
    """S, the partials of ``lstm_bwd_wgrad`` (chunks of its ``T*B`` rows);
    raises when the backward does not take hidden size H."""
    _refuse_hidden("lstm_bwd", H)
    return _library("lstm_bwd").tpuflow_lstm_bwd_splits(T, B, H)


def _fwd_kernel(xw, wh, b, hs, cs) -> None:
    """Launch ``csrc/lstm_fwd.cu`` on the current stream into ``hs`` (and
    ``cs`` when it is not None)."""
    T, B, H = hs.shape
    _refuse_hidden("lstm_fwd", H)
    lib = _library("lstm_fwd")
    with torch.cuda.device(xw.device):
        code = lib.tpuflow_lstm_fwd_f32(
            xw.data_ptr(), wh.data_ptr(), b.data_ptr(), hs.data_ptr(),
            None if cs is None else cs.data_ptr(),
            T, B, H, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, code, f"lstm_fwd launch (T={T}, B={B}, H={H})")


def _launch_bwd(name: str, ref: torch.Tensor, *args) -> None:
    """Call ``tpuflow_lstm_bwd_<name>`` with ``args`` (tensors as pointers,
    then ints) and the current stream; raise on its CUDA error code."""
    lib = _library("lstm_bwd")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(ref.device):
        code = getattr(lib, f"tpuflow_lstm_bwd_{name}")(
            *ptrs, torch.cuda.current_stream().cuda_stream)
    shape = ", ".join(f"{k}={v}" for k, v in zip("TBH", args[-3:]))
    _build.check(lib, code, f"lstm_bwd_{name} launch ({shape})")


def _gates_kernel(xw, wh, b, hs, gates) -> None:
    _launch_bwd("gates", xw, xw, wh, b, hs, gates, *hs.shape)


def _chain_kernel(wh, cs, dhs, dxw) -> None:
    if wh.data_ptr() % 16:
        raise ValueError("lstm_bwd_chain reads W_h as float4: it must be 16-byte aligned")
    _launch_bwd("chain", cs, wh, cs, dhs, dxw, *cs.shape)


def _wgrad_kernel(hs, dz, dwh_parts, db_parts) -> None:
    _launch_bwd("wgrad", hs, hs, dz, dwh_parts, db_parts, dwh_parts.shape[0], *hs.shape)


def _bwd_kernel(xw, wh, b, hs, cs, dhs, dxw, dwh_parts, db_parts) -> None:
    """Launch the three kernels of ``csrc/lstm_bwd.cu`` on the current
    stream: the gates into ``dxw``, the chain over them (``dxw`` then holds
    ``dz``), and the ``S = len(dwh_parts)`` weight-gradient partials."""
    _gates_kernel(xw, wh, b, hs, dxw)
    _chain_kernel(wh, cs, dhs, dxw)
    _wgrad_kernel(hs, dxw, dwh_parts, db_parts)


def lstm_scan_reference(
    xw: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``(hs, cs)``, both ``[T, B, H]`` in
    ``xw``'s dtype. The cell state is carried in f32 and ``h`` in ``xw``'s
    dtype, as in the TPU kernel."""
    T, B, H = _check_shapes(xw, wh, b, None)
    f32 = torch.float32
    wh32, b32 = wh.to(f32), b.to(f32)
    h = torch.zeros((B, H), dtype=xw.dtype, device=xw.device)
    c = torch.zeros((B, H), dtype=f32, device=xw.device)
    hs = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    cs = torch.empty_like(hs)
    for t in range(T):
        z = xw[t].to(f32) + h.to(f32) @ wh32 + b32
        i, f, g, o = z.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(xw.dtype)
        hs[t] = h
        cs[t] = c.to(xw.dtype)
    return hs, cs


def lstm_scan_backward_reference(
    xw: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    hs: torch.Tensor,
    cs: torch.Tensor,
    dhs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward: ``(dxw, dwh, db)`` for the
    upstream gradient ``dhs [T, B, H]``, by an explicit reverse-time loop
    that states ``_bwd_kernel``'s math line for line (gates recomputed from
    ``(xw_t, h_{t-1})``, ``dh`` and ``dc`` carried in f32, zero ``h_{t-1}``
    and ``c_{t-1}`` at t = 0)."""
    T, B, H = _check_shapes(xw, wh, b, cs)
    f32 = torch.float32
    wh32, b32 = wh.to(f32), b.to(f32)
    dh_carry = torch.zeros((B, H), dtype=f32, device=xw.device)
    dc_carry = torch.zeros((B, H), dtype=f32, device=xw.device)
    zeros = torch.zeros((B, H), dtype=f32, device=xw.device)
    dxw = torch.empty_like(xw)
    dwh = torch.zeros((H, 4 * H), dtype=f32, device=xw.device)
    db = torch.zeros(4 * H, dtype=f32, device=xw.device)
    for t in reversed(range(T)):
        h_prev = hs[t - 1].to(f32) if t > 0 else zeros
        c_prev = cs[t - 1].to(f32) if t > 0 else zeros

        # Recompute this step's pre-activations and gates.
        z = xw[t].to(f32) + h_prev @ wh32 + b32
        zi, zf, zg, zo = z.split(H, dim=-1)
        i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
        g = torch.tanh(zg)
        c = cs[t].to(f32)
        tanh_c = torch.tanh(c)

        dh = dhs[t].to(f32) + dh_carry
        do = dh * tanh_c
        dc = dc_carry + dh * o * (1.0 - tanh_c * tanh_c)
        di, df, dg = dc * g, dc * c_prev, dc * i
        dz = torch.cat(
            [di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g),
             do * o * (1.0 - o)],
            dim=-1,
        )  # [B, 4H]

        dxw[t] = dz.to(xw.dtype)
        dwh += h_prev.T @ dz
        db += dz.sum(dim=0)
        dh_carry = dz @ wh32.T
        dc_carry = dc * f
    return dxw, dwh.to(wh.dtype), db.to(b.dtype)


def _hprev(hs: torch.Tensor) -> torch.Tensor:
    """``hs`` shifted one step later in f32: row t is ``hs[t-1]``, zero at t = 0."""
    hprev = torch.zeros(hs.shape, dtype=torch.float32, device=hs.device)
    hprev[1:] = hs[:-1]
    return hprev


def lstm_bwd_gates_reference(xw, wh, b, hs) -> torch.Tensor:
    """Plain version of ``lstm_bwd_gates``: the activations ``[sigmoid(z_i),
    sigmoid(z_f), tanh(z_g), sigmoid(z_o)]`` of ``z = xw + Hprev @ W_h + b``
    for every step at once, ``[T, B, 4H]`` in ``xw``'s dtype."""
    H = _check_shapes(xw, wh, b, None)[2]
    f32 = torch.float32
    z = xw.to(f32) + _hprev(hs) @ wh.to(f32) + b.to(f32)
    zi, zf, zg, zo = z.split(H, dim=-1)
    return torch.cat(
        [torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg), torch.sigmoid(zo)], dim=-1
    ).to(xw.dtype)


def lstm_bwd_chain_reference(wh, cs, dhs, gates) -> torch.Tensor:
    """Plain version of ``lstm_bwd_chain``: ``dz [T, B, 4H]`` from the
    recomputed ``gates``, by the reverse-time loop of
    ``lstm_scan_backward_reference`` with the gates taken as given."""
    T, B, H = cs.shape
    f32 = torch.float32
    wh32 = wh.to(f32)
    zeros = torch.zeros((B, H), dtype=f32, device=cs.device)
    dh_carry, dc_carry = zeros, zeros
    dz_all = torch.empty_like(gates)
    for t in reversed(range(T)):
        c_prev = cs[t - 1].to(f32) if t > 0 else zeros
        i, f, g, o = gates[t].to(f32).split(H, dim=-1)
        tanh_c = torch.tanh(cs[t].to(f32))
        dh = dhs[t].to(f32) + dh_carry
        do = dh * tanh_c
        dc = dc_carry + dh * o * (1.0 - tanh_c * tanh_c)
        di, df, dg = dc * g, dc * c_prev, dc * i
        dz = torch.cat(
            [di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g),
             do * o * (1.0 - o)],
            dim=-1,
        )
        dz_all[t] = dz.to(gates.dtype)
        dh_carry = dz @ wh32.T
        dc_carry = dc * f
    return dz_all


def lstm_bwd_wgrad_reference(hs, dz) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``lstm_bwd_wgrad``: ``dW_h = Hprev^T dz`` over all
    ``T*B`` rows and ``db``, the column sums of ``dz``; both f32."""
    H = hs.shape[-1]
    dz32 = dz.to(torch.float32).reshape(-1, 4 * H)
    return _hprev(hs).reshape(-1, H).T @ dz32, dz32.sum(dim=0)


def _on_card(what: str, **tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA tensors
    that pass the kernel's checks."""
    ref = next(iter(tensors.values()))
    if _runs_plain(ref):
        return False
    _check_card(what, ref, **tensors)
    return True


def lstm_bwd_gates(xw, wh, b, hs) -> torch.Tensor:
    """``lstm_bwd_gates`` (CUDA) or its plain version (CPU): the recomputed
    gate activations ``[T, B, 4H]``. Not counted: ``lstm_scan_backward``
    counts the backward as a whole."""
    T, B, H = _check_shapes(xw, wh, b, hs)
    if not _on_card("lstm_bwd_gates", xw=xw, wh=wh, b=b, hs=hs):
        return lstm_bwd_gates_reference(xw, wh, b, hs)
    _refuse_hidden("lstm_bwd", H)
    gates = torch.empty_like(xw)
    if T and B:
        _gates_kernel(xw, wh, b, hs, gates)
    return gates


def lstm_bwd_chain(wh, cs, dhs, gates) -> torch.Tensor:
    """``lstm_bwd_chain`` (CUDA) or its plain version (CPU): overwrites
    ``gates`` with ``dz`` and returns it."""
    T, B, H = cs.shape
    if not _on_card("lstm_bwd_chain", gates=gates, wh=wh, cs=cs, dhs=dhs):
        return gates.copy_(lstm_bwd_chain_reference(wh, cs, dhs, gates))
    _refuse_hidden("lstm_bwd", H)
    if T and B:
        _chain_kernel(wh, cs, dhs, gates)
    return gates


def lstm_bwd_wgrad(hs, dz) -> tuple[torch.Tensor, torch.Tensor]:
    """``lstm_bwd_wgrad`` (CUDA, its ``S`` partials summed in order) or its
    plain version (CPU): ``(dW_h [H, 4H], db [4H])``."""
    T, B, H = hs.shape
    if not _on_card("lstm_bwd_wgrad", dz=dz, hs=hs):
        return lstm_bwd_wgrad_reference(hs, dz)
    if not (T and B):
        return (torch.zeros((H, 4 * H), device=dz.device),
                torch.zeros(4 * H, device=dz.device))
    S = _wgrad_splits(T, B, H)
    dwh_parts = torch.empty((S, H, 4 * H), dtype=torch.float32, device=dz.device)
    db_parts = torch.empty((S, 4 * H), dtype=torch.float32, device=dz.device)
    _wgrad_kernel(hs, dz, dwh_parts, db_parts)
    return dwh_parts.sum(dim=0), db_parts.sum(dim=0)


def _forward(xw, wh, b, cs_out):
    """``(hs, cs)``: the kernel on a CUDA tensor (``cs`` is ``cs_out``, which
    it fills when given), the plain version on a CPU tensor."""
    T, B, H = xw.shape[0], xw.shape[1], wh.shape[0]
    if _runs_plain(xw):
        hs, cs = lstm_scan_reference(xw, wh, b)
        if cs_out is not None:
            cs_out.copy_(cs)
        return hs, cs
    _check_card("lstm_scan", xw, xw=xw, wh=wh, b=b, cs_out=cs_out)
    hs = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    if T and B:
        _fwd_kernel(xw, wh, b, hs, cs_out)
        _count(lstm_scan)
    return hs, cs_out


class _LSTMScan(torch.autograd.Function):
    """``lstm_scan`` with gradients: the forward keeps the cell states and
    saves ``(xw, wh, b, hs, cs)`` as ``_lstm_scan_fwd`` does; the backward is
    ``lstm_scan_backward``."""

    @staticmethod
    def forward(ctx, xw, wh, b, cs_out):
        T, B, H = xw.shape[0], xw.shape[1], wh.shape[0]
        if not _runs_plain(xw):
            _refuse_hidden("lstm_bwd", H)  # refuse before the forward runs
            if cs_out is None:
                cs_out = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
        hs, cs = _forward(xw, wh, b, cs_out)
        ctx.save_for_backward(xw, wh, b, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xw, wh, b, hs, cs = ctx.saved_tensors
        dxw, dwh, db = lstm_scan_backward(xw, wh, b, hs, cs, dhs.contiguous())
        return dxw, dwh, db, None


def lstm_scan(
    xw: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    cs_out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused LSTM recurrence: ``xw [T, B, 4H] -> hs [T, B, H]`` (time-major,
    gate order i, f, g, o, zero initial state). ``wh [H, 4H]`` is the
    recurrent weight, ``b [4H]`` the bias. When ``cs_out`` is given, the
    cell states are written into it too.

    CUDA tensors go through ``csrc/lstm_fwd.cu`` (f32, contiguous, one
    device) and count one launch in ``lstm_scan.launches``; CPU tensors go
    through ``lstm_scan_reference``. With gradients enabled and an input
    that requires them, the result is differentiable through
    ``lstm_scan_backward``.
    """
    _check_shapes(xw, wh, b, cs_out)
    if torch.is_grad_enabled() and (
        xw.requires_grad or wh.requires_grad or b.requires_grad
    ):
        return _LSTMScan.apply(xw, wh, b, cs_out)
    return _forward(xw, wh, b, cs_out)[0]


def lstm_scan_backward(
    xw: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    hs: torch.Tensor,
    cs: torch.Tensor,
    dhs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``lstm_scan``: ``(dxw [T, B, 4H], dwh [H, 4H], db [4H])``
    from the forward's residuals ``hs``, ``cs`` and the upstream ``dhs``.

    CUDA tensors go through the three kernels of ``csrc/lstm_bwd.cu`` (f32,
    contiguous, one device) and count one launch in
    ``lstm_scan_backward.launches``; the ``S`` partials of ``dW_h``/``db``
    are summed here in a fixed order. CPU tensors go through
    ``lstm_scan_backward_reference``.
    """
    T, B, H = _check_shapes(xw, wh, b, cs)
    for name, t in (("hs", hs), ("dhs", dhs)):
        if tuple(t.shape) != (T, B, H):
            raise ValueError(
                f"lstm_scan_backward: {name} must be [{T}, {B}, {H}], got "
                f"{tuple(t.shape)}"
            )
    if _runs_plain(xw):
        return lstm_scan_backward_reference(xw, wh, b, hs, cs, dhs)
    _check_card("lstm_scan_backward", xw, xw=xw, wh=wh, b=b, hs=hs, cs=cs, dhs=dhs)
    dxw = torch.empty_like(xw)
    if not (T and B):
        return dxw.zero_(), torch.zeros_like(wh), torch.zeros_like(b)
    S = _wgrad_splits(T, B, H)
    dwh_parts = torch.empty((S, H, 4 * H), dtype=torch.float32, device=xw.device)
    db_parts = torch.empty((S, 4 * H), dtype=torch.float32, device=xw.device)
    _bwd_kernel(xw, wh, b, hs, cs, dhs, dxw, dwh_parts, db_parts)
    _count(lstm_scan_backward)
    return dxw, dwh_parts.sum(dim=0), db_parts.sum(dim=0)


lstm_scan.launches = 0
lstm_scan_backward.launches = 0
