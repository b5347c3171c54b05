#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpuflow_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a GPU, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device  — ``nvidia-smi``'s name and power limit, torch's device name.
2. build   — every kernel source under ``tpuflow_torch/kernels/csrc`` is
   compiled by ``nvcc`` (one process per source, started together).
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes the training and serving paths give it (``lstm_fwd``,
   ``lstm_bwd``, ``mae_clip``, ``mae_clip_grad``, ``flash_fwd``,
   ``flash_dq``, ``flash_dkv``, ``ring_round_fwd``, ``ring_round_bwd``; the
   LSTM kernels also at hidden sizes 128, 256, 50, 300, 512 and 2048, and
   the backward at 12000, past the hidden size whose chain tiles fit in
   shared memory; the ring rounds at five shapes, each with a diagonal, a
   past and a future block, and two rounds whose causal edge crosses
   tiles), with CUDA-event timings of the kernel, the
   plain version and, where one exists, a library call as a yardstick.
   ``lstm_bwd`` is three kernels (gates, chain, weight gradients): each is
   held against its own plain piece, and timed by CUDA events and by
   profiled device time. ``mae_clip_grad`` must equal its plain version bit
   for bit. ``lstm_fwd`` (one persistent kernel with a barrier across the
   grid between steps), ``mae_clip`` (whose wide rows are summed by the
   block that draws the last ticket), ``mae_clip_grad``, ``flash_fwd``,
   ``flash_dq``, ``flash_dkv``, ``ring_round_fwd`` and ``ring_round_bwd``
   must also give bitwise the same result in 200 launches back to back,
   and wide-row ``mae_clip`` calls on two streams at once must each match
   their plain version. A future ring round must copy the forward's state
   through bit for bit and give zero gradients.
4. train   — ``train(TrainJobConfig(...))`` at its defaults on the default
   device: LSTM-64 for 3 epochs, the stacked LSTM for 2, the attention
   regressor for 3, then the attention regressor at a 256-step window for
   1. Each run's kernel launches must equal what the dataset sizes give;
   losses must be finite and LSTM-64 and the 3-epoch attention run must
   beat the Gilbert baseline. Then, after the counted runs: one batch's
   gradients through the kernels against the plain path, steady train
   samples/s, and a ``torch.profiler`` window of steady steps.
5. ring    — four ranks (``spawn``; NCCL with a card each, else gloo on
   ``cuda:0`` with the ring's tensors staged through host memory): one
   batch at window 1024 through ``backend="ring"`` against ``backend=
   "flash"`` in this process (loss and gradients, ranks bitwise equal,
   launches of the round kernels); ``train(config)`` of the attention
   regressor at a 256-step window with the ring on every rank (launches,
   test MAE within 2% of the single-card run, final parameters bitwise
   equal, only rank 0 writes the artifact, whose sidecar says ``full``); the
   SP LSTM ring (``make_sp_forward``) against ``lstm_scan``; and where a
   ring train step's time goes.
6. serve   — the trained artifacts (LSTM-64, stacked LSTM, attention, the
   ring-trained attention at 256 steps) and
   an LSTM-64, a stacked-LSTM and an attention artifact with random weights
   from a seed (written by the port's checkpoint writer) served over
   ``POST /predict`` by the port's HTTP server on the default device; each
   answer is checked for status, count, finite values, agreement with the
   same predictor's plain path, and the kernel launches it caused.
7. breakdown — after the counted run, where one warm 3912-window request's
   time goes: host-clock stages and one ``torch.profiler`` window.

The line before last is ``nvidia-smi``'s name and power limit, the one
before it the kernels' JSON record (launches from the counted train runs;
for the ring-round kernels, rank 0's in the ring training),
and the last line ``{"ok": true, "device": {...}}``. Imports nothing of JAX or
``tpuflow``.

``python3 chip_smoke.py --lstm-steps ROOT`` runs only a profiled window of
20 LSTM-64 train steps of the port in the tree at ROOT, then times that
tree's ``lstm_fwd`` and ``lstm_bwd`` alone at H = 64 and at
``kernel_lstm_wide``'s shapes, for comparing two trees on one card (run it
once per tree, in turns, on the same card).

``python3 chip_smoke.py --flash-loss-steps ROOT`` runs, in the tree at
ROOT, profiled windows of 20 LSTM-64 and 20 attention train steps (device
kernels launched a step, device ms by kernel), the loss's forward and
backward alone (host microseconds a call, kernels a call), then that
tree's ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` at ``FLASH_SHAPES``
and ``mae_clip`` (and ``mae_clip_grad`` where the tree has it) at their
shapes alone, by CUDA events and profiled device time; for comparing two
trees in turns.

``python3 chip_smoke.py --ring-steps ROOT`` builds only ROOT's
``ring_round.cu`` and times that tree's ``ring_round_fwd`` and
``ring_round_bwd`` alone at each of ``RING_SHAPES`` and ``RING_PATTERNS``
(CUDA events, and the median of three 20-call profiler windows of device
time), beside their f32 and 3xTF32 bounds; for comparing two trees in
turns.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

T, H = 24, 64  # window (api/config.py) and hidden width of LSTM-64
FEATURES = ["pressure", "choke", "glr", "temperature", "water_cut"]
SCHEMA = [("pressure", "float"), ("choke", "float"), ("glr", "float"),
          ("temperature", "float"), ("water_cut", "float"),
          ("completion", "string"), ("well", "string"), ("flow", "float")]
BATCH = 4096  # Predictor's forward chunk
TRAIN_BATCH = 20  # TrainJobConfig.batch_size
# H100 SXM data sheet: HBM rate and the f32 rate
# of the CUDA cores, which the f32 kernels use.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Kernel vs plain on the card, f32: the two sum h @ W_h in other orders and
# use other exp/tanh code; over 24 dependent steps that stays within a few
# ulp of values of order 1, far inside 1e-5.
KERNEL_ATOL = KERNEL_RTOL = 1e-5
# lstm_bwd vs plain, normwise (max abs error over max abs value): dxw 1e-5
# (24 dependent steps, each summing 4H products in another order); dW_h and
# db 1e-4 (sums over B*T products, per block and then over the blocks).
BWD_TOL = {"dxw": 1e-5, "dwh": 1e-4, "db": 1e-4}
# Each of lstm_bwd's kernels vs its plain piece on the same inputs,
# normwise: the gates 1e-5 (H-term sums in another order), dz 1e-5 (as
# dxw), dW_h and db 1e-4 (sums over B*T products by chunks, then over them).
BWD_PIECE_TOL = {"gates": 1e-5, "dz": 1e-5, "dwh": 1e-4, "db": 1e-4}
# mae_clip vs plain: per-row f32 sums in another order, up to 98,304
# elements a row; relative 1e-5.
MAE_RTOL = 1e-5
# lstm_fwd's hidden sizes past LSTM-64, each at B = 20 and 4096.
WIDE_HIDDEN = (128, 256, 50, 300, 512, 2048)
# A hidden size past 9685, where lstm_bwd's chain keeps its tiles in device
# memory; run at B = 20 only (W_h alone is 2.3 GB).
BEYOND_SHARED_HIDDEN = 12000
# mae_clip's shapes: the train loss at batch 20, the eval (one row an
# example), and a row of the serving chunk's size (several blocks a row).
MAE_SHAPES = ((1, TRAIN_BATCH * T), (TRAIN_BATCH, T), (1, 4096 * T))
# Wide-row mae_clip calls on two streams at once, (shape, calls a stream):
# rows of 24 and of 1024 blocks.
MAE_STREAM_SHAPES = (((3, 4096 * T), 40), ((3, 4096 * 1024), 8))
# lstm_fwd launches back to back that must equal the first bitwise, and the
# (B, H) it runs them at: LSTM-64's training shape, and a ragged batch at
# a width whose h rows are read 16 bytes at a time over several tiles.
REPEAT_LAUNCHES = 200
REPEAT_SHAPES = ((TRAIN_BATCH, 64), (37, 300))
# Parameter gradients of one training batch, kernels vs plain path,
# normwise 1e-4: they sum B*T products through both recurrences.
GRAD_TOL = 1e-4
# flash_fwd vs plain: the same online softmax over the same 64-row tiles,
# with each row's dot products summed in another order; o and lse are of
# order 1, so 1e-5 absolute.
FLASH_ATOL = 1e-5
# flash_dq and flash_dkv vs plain, normwise: sums over up to T pairs of
# products of two D-term dot products, in another order.
FLASH_GRAD_TOL = 1e-4
# (BH, T, D): the train step (batch 20 x 4 heads), a long window, a serving
# chunk (4096 windows x 4 heads), benchmarks/bench_attention.py's long T,
# and a ragged last tile at another head dim.
FLASH_SHAPES = ((80, 24, 16), (80, 256, 16), (16384, 24, 16), (256, 1024, 16),
                (64, 1000, 64))
# Ring rounds vs plain, on the card: the forward's m, log-sum-exp m + log(l)
# and normalised output acc / l within FLASH_ATOL, the quantities flash_fwd
# is held on (of order 1; the raw l and acc are running sums of up to 2 Tl
# exponentials, and acc's cancel). The backward normwise within
# FLASH_GRAD_TOL. (BH, Tl, D): the ring train step (window 256 over 4 ranks),
# window 1024, a 4096-step log, a ragged chunk, another head dim.
RING_SHAPES = ((80, 64, 16), (80, 256, 16), (256, 1024, 16), (80, 100, 16), (64, 250, 64))
# (q_off, k_off) in chunk lengths: the diagonal round, a past and a future block.
RING_PATTERNS = {"diagonal": (1, 1), "past": (2, 1), "future": (0, 1)}
# Rounds whose causal edge crosses tiles of the local chunk (q_off - k_off =
# 30, offsets not multiples of Tl or of 64), at a ragged chunk of each
# design: (BH, Tl, D) and (q_off, k_off).
RING_UNALIGNED = (((80, 100, 16), (107, 77)), ((64, 250, 64), (107, 77)))
RING_RANKS = 4  # the JAX tests' ring (tests/conftest.py RING_DEVICES)
RING_WINDOW = 1024  # the gradient and SP phases' sequence length
RING_TRAIN_WINDOW = 256
RING_TIMEOUT_S = 480.0
# Ring vs single-card loss and gradients, normwise: the same sums grouped
# by chunks and rounds.
RING_GRAD_TOL = 1e-4
RING_MAE_REL = 0.02  # ring-trained test MAE vs the single-card run
# SP ring (a loop of lstm_step, cuBLAS products) vs lstm_scan's kernel over
# 1024 steps, f32: the recurrence contracts, so errors stay at a few ulp.
SP_ATOL = 1e-5
LAYERS = {"lstm": 1, "stacked_lstm": 2, "attention": 2}
# The kernel each family's forward runs (what serving launches).
FORWARD_KERNEL = {"lstm": "lstm_fwd", "stacked_lstm": "lstm_fwd",
                  "attention": "flash_fwd"}
# Served predictions vs the plain path, in normalised target units (they are
# compared after denormalisation, so scaled by target_std).
PRED_ATOL_NORM = 1e-5
# The tensor cores' TF32 rate and the exponentials an SM issues a clock
# (compute capability 9.0) at the H100 SXM's 1.98 GHz boost clock: the
# bound of flash_fwd's long-window kernel, which runs its products in
# 3xTF32 (three TF32 products for each f32 one).
TF32_FLOP_PER_S = 495e12
SFU_EXP_PER_S = 132 * 16 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(torch, fn, runs: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current stream, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def lstm_bound(Tn: int, B: int, Hn: int) -> tuple[float, str]:
    """Least time for lstm_fwd on the card: the larger of bytes over the HBM
    rate (xw, W_h, b read once; hs written once — the serving path passes no
    cs buffer) and operations over the f32 rate (h @ W_h: 2*H*4H per row and
    step; adding xw and b: 2*4H; gate math: 9*H — 3 sigmoid, 2 tanh, 3
    products, 1 sum)."""
    nbytes = 4 * (Tn * B * 4 * Hn + Hn * 4 * Hn + 4 * Hn + Tn * B * Hn)
    ops = Tn * B * (2 * Hn * 4 * Hn + 2 * 4 * Hn + 9 * Hn)
    return _bound(nbytes, ops)


def lstm_bwd_bound(Tn: int, B: int, Hn: int) -> tuple[float, str]:
    """Least time for lstm_bwd: bytes of xw, W_h, b, hs, cs and dhs read once
    and dxw, dW_h and db written once; operations per row and step of the
    three H x 4H products (2*H*4H each: the recomputed h @ W_h, dz @ W_h^T
    and h^T dz), adding xw and b (2*4H), and 32*H of gate math (5
    activations, 23 elementwise for dz, dh and dc, 4 db sums)."""
    nbytes = 4 * (2 * Tn * B * 4 * Hn + 2 * (Hn * 4 * Hn + 4 * Hn) + 3 * Tn * B * Hn)
    ops = Tn * B * (3 * 2 * Hn * 4 * Hn + 2 * 4 * Hn + 32 * Hn)
    return _bound(nbytes, ops)


def causal_pairs(Tn: int) -> int:
    return Tn * (Tn + 1) // 2


def flash_fwd_bound(BH: int, Tn: int, D: int) -> tuple[float, str]:
    """Least time for flash_fwd: q, k, v read once, o and lse written once;
    4*D operations (the q.k and p*v products) per causal pair."""
    nbytes = 4 * (4 * BH * Tn * D + BH * Tn)
    return _bound(nbytes, 4 * BH * D * causal_pairs(Tn))


def flash_dq_bound(BH: int, Tn: int, D: int) -> tuple[float, str]:
    """Least time for flash_dq: q, k, v, do, lse and delta read once, dq
    written once; 6*D operations (q.k, do.v, ds*k) per causal pair."""
    nbytes = 4 * (5 * BH * Tn * D + 2 * BH * Tn)
    return _bound(nbytes, 6 * BH * D * causal_pairs(Tn))


def flash_dkv_bound(BH: int, Tn: int, D: int) -> tuple[float, str]:
    """Least time for flash_dkv: the same inputs read once, dk and dv
    written once; 8*D operations (q.k, do.v, p*do, ds*q) per causal pair."""
    nbytes = 4 * (6 * BH * Tn * D + 2 * BH * Tn)
    return _bound(nbytes, 8 * BH * D * causal_pairs(Tn))


def ring_pairs(Tl: int, q_off: int, k_off: int) -> int:
    """Allowed (q, k) pairs of one ring round: k_off + j <= q_off + i.
    Tl(Tl+1)/2 on the diagonal, Tl^2 for a past block, 0 for a future one."""
    return sum(max(0, min(Tl, q_off + i - k_off + 1)) for i in range(Tl))


def ring_fwd_bound(BH: int, Tl: int, D: int, pairs: int) -> tuple[float, str]:
    """Least time for ring_round_fwd: q, k, v, acc, m and l read once, m,
    l and acc written once; 4*D operations (q.k and p*v) per allowed pair."""
    nbytes = 4 * (4 * BH * Tl * D + 2 * BH * Tl + BH * Tl * D + 2 * BH * Tl)
    return _bound(nbytes, 4 * D * BH * pairs)


def ring_bwd_bound(BH: int, Tl: int, D: int, pairs: int) -> tuple[float, str]:
    """Least time for ring_round_bwd: q, k, v, do, lse and delta read once,
    dq, dk and dv written once; 10*D operations per allowed pair (q.k and
    do.v for each of the two halves, ds*k, ds*q, p*do)."""
    nbytes = 4 * (4 * BH * Tl * D + 2 * BH * Tl + 3 * BH * Tl * D)
    return _bound(nbytes, 10 * D * BH * pairs)


def _tc_bound(nbytes: float, ops_per_pair: float, pairs: int) -> tuple[float, str]:
    """The larger of bytes over the HBM rate, three TF32 products for each
    f32 operation (3xTF32) over the TF32 rate, and one exponential a pair
    over the SFUs' rate: (ms, what sets it)."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "tensor cores": 3 * ops_per_pair * pairs / TF32_FLOP_PER_S,
             "exponentials": pairs / SFU_EXP_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def flash_fwd_tc_bound(BH: int, Tn: int, D: int) -> tuple[float, str]:
    """Least time for flash_fwd on the tensor cores in 3xTF32: the larger of
    its bytes over the HBM rate, three times its 4*D operations a causal
    pair over the TF32 rate, and one exponential a causal pair over the
    SFUs' rate."""
    return _tc_bound(4 * (4 * BH * Tn * D + BH * Tn), 4 * D, BH * causal_pairs(Tn))


def flash_dq_tc_bound(BH: int, Tn: int, D: int) -> tuple[float, str]:
    """Least time for flash_dq on the tensor cores in 3xTF32: flash_dq_bound's
    bytes, three times its 6*D operations a causal pair, one exponential a
    causal pair."""
    return _tc_bound(4 * (5 * BH * Tn * D + 2 * BH * Tn), 6 * D, BH * causal_pairs(Tn))


def flash_dkv_tc_bound(BH: int, Tn: int, D: int) -> tuple[float, str]:
    """Least time for flash_dkv on the tensor cores in 3xTF32: flash_dkv_bound's
    bytes, three times its 8*D operations a causal pair, one exponential a
    causal pair."""
    return _tc_bound(4 * (6 * BH * Tn * D + 2 * BH * Tn), 8 * D, BH * causal_pairs(Tn))


def ring_fwd_tc_bound(BH: int, Tl: int, D: int, pairs: int) -> tuple[float, str]:
    """Least time for ring_round_fwd on the tensor cores in 3xTF32:
    ring_fwd_bound's bytes, three times its 4*D operations an allowed pair,
    one exponential an allowed pair."""
    nbytes = 4 * (4 * BH * Tl * D + 2 * BH * Tl + BH * Tl * D + 2 * BH * Tl)
    return _tc_bound(nbytes, 4 * D, BH * pairs)


def ring_bwd_tc_bound(BH: int, Tl: int, D: int, pairs: int) -> tuple[float, str]:
    """Least time for ring_round_bwd on the tensor cores in 3xTF32:
    ring_bwd_bound's bytes, three times its 10*D operations an allowed
    pair, one exponential an allowed pair."""
    nbytes = 4 * (4 * BH * Tl * D + 2 * BH * Tl + 3 * BH * Tl * D)
    return _tc_bound(nbytes, 10 * D, BH * pairs)


def mae_clip_bound(R: int, N: int) -> tuple[float, str]:
    """Least time for mae_clip: both operands read once, R means written;
    4 operations per element (subtract, abs, clip, add)."""
    return _bound(4 * (2 * R * N + R), 4 * R * N)


def mae_clip_grad_bound(n: int) -> tuple[float, str]:
    """Least time for mae_clip_grad: both operands and g read once, both
    gradients written once; 5 operations per element (subtract, |d| <
    clip, sign times the mask, times g / n, negate)."""
    return _bound(4 * (4 * n + 1), 5 * n)


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def normwise_err(got, want) -> float:
    """Max abs error over max abs value of the reference."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def device_ms_by_kernel(prof) -> dict:
    """Device milliseconds by kernel in a ``torch.profiler`` window: device
    events only (a CPU op also reports its kernels' time), without the
    ranges of user annotations such as ``Optimizer.step``, which span
    kernels counted on their own."""
    from torch.autograd import DeviceType

    by_kernel = {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if (evt.device_type == DeviceType.CUDA and us > 0
                and not getattr(evt, "is_user_annotation", False)):
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e3
    return by_kernel


def phase_build() -> None:
    from tpuflow_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {len(libs)} kernel source(s) in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for stem, path in libs.items():
        info = _build.build_log.get(stem)
        if info is None:
            log(f"[build]   {stem}: already built at {path}")
            continue
        log(f"[build]   {stem}: {info['seconds']:.1f} s -> {path}")
        for line in info["ptxas"]:
            log(f"[build]     {line.strip()}")


def phase_kernels(torch) -> dict:
    """Every kernel against its plain version; {name: record}."""
    records = {
        "lstm_fwd": kernel_lstm_fwd(torch),
        "lstm_bwd": kernel_lstm_bwd(torch),
    }
    records.update(kernel_mae_clip(torch))
    kernel_lstm_repeat(torch)
    kernel_lstm_wide(torch)
    records.update(kernel_flash(torch))
    kernel_repeat(torch)
    kernel_mae_clip_streams(torch)
    records.update(kernel_ring(torch))
    return records


def kernel_lstm_fwd(torch) -> dict:
    """lstm_fwd against lstm_scan_reference at T=24, H=64, B in {1, 20, 37,
    4096}; returns the record of the serving shape, B=4096."""
    from tpuflow_torch.kernels.lstm import lstm_scan, lstm_scan_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    log(f"[kernel] lstm_fwd vs lstm_scan_reference: f32, T={T}, H={H}; "
        f"tolerance atol={KERNEL_ATOL} rtol={KERNEL_RTOL} (other summation "
        "order and exp/tanh code over 24 dependent steps)")
    worst, record = 0.0, None
    for B in (1, TRAIN_BATCH, 37, 4096):
        xw = torch.randn((T, B, 4 * H), generator=gen, device=dev)
        wh = torch.randn((H, 4 * H), generator=gen, device=dev) / H ** 0.5
        b = torch.randn(4 * H, generator=gen, device=dev) * 0.1
        cs = torch.empty((T, B, H), device=dev)
        hs = lstm_scan(xw, wh, b, cs_out=cs)
        torch.cuda.synchronize()
        ref_hs, ref_cs = lstm_scan_reference(xw, wh, b)
        err = max((hs - ref_hs).abs().max().item(), (cs - ref_cs).abs().max().item())
        worst = max(worst, err)
        for got, want, what in ((hs, ref_hs, "hs"), (cs, ref_cs, "cs")):
            if not torch.allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
                raise AssertionError(
                    f"lstm_fwd disagrees with its plain version at B={B} on "
                    f"{what}: max abs err {err:.3e}"
                )
        kernel_ms = cuda_ms(torch, lambda: lstm_scan(xw, wh, b))
        plain_ms = cuda_ms(torch, lambda: lstm_scan_reference(xw, wh, b), runs=20)
        lib = cudnn_lstm(torch, wh, b)
        with torch.no_grad():
            lib_err = (lib(xw)[0] - ref_hs).abs().max().item()
            library_ms = cuda_ms(torch, lambda: lib(xw))
        bound_ms, bound_by = lstm_bound(T, B, H)
        log(f"[kernel] B={B:5d}: max_abs_err={err:.3e} kernel_ms={kernel_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (cuDNN "
            f"nn.LSTM, projection plus recurrence; max abs err vs plain "
            f"{lib_err:.3e}) bound_ms={bound_ms:.4f} ({bound_by})")
        record = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": library_ms}
    record["max_abs_err"] = worst
    return record


def kernel_lstm_repeat(torch) -> None:
    """REPEAT_LAUNCHES launches of lstm_fwd back to back on one stream at
    each of REPEAT_SHAPES (T=24) must equal the first bitwise: a race at the
    barrier between steps, or h of the step before read stale from another
    SM, shows as a launch that differs. Raises on a mismatch."""
    from tpuflow_torch.kernels.lstm import lstm_scan

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for B, Hn in REPEAT_SHAPES:
        xw = torch.randn((T, B, 4 * Hn), generator=gen, device=dev)
        wh = torch.randn((Hn, 4 * Hn), generator=gen, device=dev) / Hn ** 0.5
        b = torch.randn(4 * Hn, generator=gen, device=dev) * 0.1
        first = lstm_scan(xw, wh, b)
        runs = [lstm_scan(xw, wh, b) for _ in range(REPEAT_LAUNCHES)]
        torch.cuda.synchronize()
        bad = [i for i, hs in enumerate(runs) if not torch.equal(hs, first)]
        if bad:
            raise AssertionError(
                f"lstm_fwd at B={B}, H={Hn}: launches {bad[:10]} of {REPEAT_LAUNCHES} "
                "differ from the first")
        log(f"[kernel] lstm_fwd B={B} H={Hn}: {REPEAT_LAUNCHES} launches back to back "
            "equal the first bitwise")


def profiled_ms(torch, fn, runs: int = 10) -> dict:
    """Device milliseconds a call by kernel: ``fn`` run ``runs`` times
    (after one warm call) inside one ``torch.profiler`` window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {k: v / runs for k, v in device_ms_by_kernel(prof).items()}


def cudnn_lstm(torch, wh, b):
    """Yardstick only, never called by the port: cuDNN's ``nn.LSTM`` with
    an identity input projection, W_hh = W_h^T and the bias computes
    lstm_scan's function on the same xw (projection plus recurrence)."""
    Hn = wh.shape[0]
    lib = torch.nn.LSTM(4 * Hn, Hn).to(wh.device)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(torch.eye(4 * Hn, device=wh.device))
        lib.weight_hh_l0.copy_(wh.t())
        lib.bias_ih_l0.copy_(b)
        lib.bias_hh_l0.zero_()
    return lib


def cudnn_backward_ms(torch, xw, wh, b, dhs, want) -> tuple[float, float]:
    """Milliseconds of cuDNN's LSTM backward (dxw, dW_h, db on a saved
    forward; it also forms the input-weight gradient) and its normwise error
    against the plain backward ``want``."""
    lib = cudnn_lstm(torch, wh, b)
    inp = xw.clone().requires_grad_()
    out = lib(inp)[0]
    wrt = [inp, lib.weight_hh_l0, lib.bias_ih_l0]
    grads = torch.autograd.grad(out, wrt, dhs, retain_graph=True)
    err = max(normwise_err(grads[0], want[0]), normwise_err(grads[1].t(), want[1]),
              normwise_err(grads[2], want[2]))
    ms = cuda_ms(torch, lambda: torch.autograd.grad(out, wrt, dhs, retain_graph=True),
                 runs=10)
    return ms, err


def check_lstm_bwd(torch, xw, wh, b, hs, cs, dhs, where: str, runs: int = 25) -> dict:
    """lstm_bwd at one shape: each of its three kernels against its plain
    piece on the same inputs (the chain on the plain gates, the weight
    gradients on the plain dz), the whole backward against
    lstm_scan_backward_reference; then its time by CUDA events and by
    profiled device time (split by kernel), the plain version's and
    cuDNN's. Raises on a disagreement."""
    from tpuflow_torch.kernels.lstm import (
        lstm_bwd_chain,
        lstm_bwd_chain_reference,
        lstm_bwd_gates,
        lstm_bwd_gates_reference,
        lstm_bwd_wgrad,
        lstm_bwd_wgrad_reference,
        lstm_scan_backward,
        lstm_scan_backward_reference,
    )

    gates = lstm_bwd_gates(xw, wh, b, hs)
    want_gates = lstm_bwd_gates_reference(xw, wh, b, hs)
    dz = lstm_bwd_chain(wh, cs, dhs, want_gates.clone())
    want_dz = lstm_bwd_chain_reference(wh, cs, dhs, want_gates)
    wgrad = lstm_bwd_wgrad(hs, want_dz)
    want_wgrad = lstm_bwd_wgrad_reference(hs, want_dz)
    got = lstm_scan_backward(xw, wh, b, hs, cs, dhs)
    torch.cuda.synchronize()
    want = lstm_scan_backward_reference(xw, wh, b, hs, cs, dhs)
    pieces = {"gates": normwise_err(gates, want_gates), "dz": normwise_err(dz, want_dz),
              "dwh": normwise_err(wgrad[0], want_wgrad[0]),
              "db": normwise_err(wgrad[1], want_wgrad[1])}
    errs = {k: normwise_err(g, w) for k, g, w in zip(BWD_TOL, got, want)}
    bad = {k: e for k, e in pieces.items() if not e <= BWD_PIECE_TOL[k]}
    bad.update({k: e for k, e in errs.items() if not e <= BWD_TOL[k]})
    if bad:
        raise AssertionError(f"lstm_bwd disagrees with its plain version at {where}: {bad}")
    max_abs = max((g - w).abs().max().item() for g, w in zip(got, want))
    few = max(3, runs // 5)
    scratch = want_gates.clone()
    ms = cuda_ms(torch, lambda: lstm_scan_backward(xw, wh, b, hs, cs, dhs), runs=runs)
    piece_ms = {
        "gates": cuda_ms(torch, lambda: lstm_bwd_gates(xw, wh, b, hs), runs=runs),
        "chain": cuda_ms(torch, lambda: lstm_bwd_chain(wh, cs, dhs, scratch), runs=runs),
        "wgrad": cuda_ms(torch, lambda: lstm_bwd_wgrad(hs, want_dz), runs=runs),
    }
    by_kernel = profiled_ms(torch, lambda: lstm_scan_backward(xw, wh, b, hs, cs, dhs),
                            runs=few)
    device = {name: sum(v for k, v in by_kernel.items() if f"lstm_bwd_{name}" in k)
              for name in ("gates", "chain", "wgrad")}
    device_total = sum(by_kernel.values())  # the three kernels and the partials' sums
    plain_ms = cuda_ms(
        torch, lambda: lstm_scan_backward_reference(xw, wh, b, hs, cs, dhs), runs=few)
    library_ms, lib_err = cudnn_backward_ms(torch, xw, wh, b, dhs, want)
    Tn, B, Hn = hs.shape
    bound_ms, bound_by = lstm_bwd_bound(Tn, B, Hn)
    log(f"[kernel] lstm_bwd {where}: pieces normwise_err="
        + ",".join(f"{k}:{v:.3e}" for k, v in pieces.items())
        + "; whole normwise_err=" + ",".join(f"{k}:{v:.3e}" for k, v in errs.items())
        + f" max_abs_err={max_abs:.3e}; kernel_ms={ms:.4f} (CUDA events; pieces "
        + ", ".join(f"{k}={v:.4f}" for k, v in piece_ms.items())
        + f") device_ms={device_total:.4f} (profiled; "
        + ", ".join(f"{k}={v:.4f}" for k, v in device.items())
        + f") plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (cuDNN nn.LSTM "
        f"backward; normwise err vs plain {lib_err:.3e}) plain/kernel="
        f"{plain_ms / ms:.2f} library/kernel={library_ms / ms:.2f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "max_abs_err": max_abs}


def kernel_lstm_bwd(torch) -> dict:
    """lstm_bwd's three kernels against their plain pieces, and the whole
    against lstm_scan_backward_reference, at T=24, H=64, B in {20 (the
    training batch), 37 (ragged), 4096}; returns the record of the training
    shape, B=20."""
    from tpuflow_torch.kernels.lstm import lstm_scan_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    log(f"[kernel] lstm_bwd vs lstm_scan_backward_reference: f32, T={T}, "
        f"H={H}; normwise tolerance {BWD_TOL} (dxw: 24 dependent steps of "
        "4H-term sums in another order; dW_h, db: sums over B*T products); its "
        f"kernels vs their plain pieces {BWD_PIECE_TOL}")
    record, worst = None, 0.0
    for B in (TRAIN_BATCH, 37, 4096):
        xw = torch.randn((T, B, 4 * H), generator=gen, device=dev)
        wh = torch.randn((H, 4 * H), generator=gen, device=dev) / H ** 0.5
        b = torch.randn(4 * H, generator=gen, device=dev) * 0.1
        dhs = torch.randn((T, B, H), generator=gen, device=dev)
        hs, cs = lstm_scan_reference(xw, wh, b)
        got = check_lstm_bwd(torch, xw, wh, b, hs, cs, dhs, f"H={H} B={B:5d}")
        worst = max(worst, got["max_abs_err"])
        if B == TRAIN_BATCH:
            record = got
    record["max_abs_err"] = worst
    return record


def kernel_lstm_wide(torch) -> None:
    """lstm_fwd and lstm_bwd at hidden sizes past LSTM-64 (B = 20 and 4096):
    H = 128, 256, 300 and 512 (past what a block's shared memory holds of
    W_h), 50 (h read one float at a time) and 2048 (W_h past the L2); then
    BEYOND_SHARED_HIDDEN at B = 20. Same tolerances as at H = 64, each
    backward kernel against its plain piece; times are logged, with cuDNN's
    LSTM as the yardstick, and the JSON records stay those of H = 64."""
    from tpuflow_torch.kernels.lstm import lstm_scan, lstm_scan_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    for Hn in WIDE_HIDDEN:
        for B in (TRAIN_BATCH, 4096):
            xw = torch.randn((T, B, 4 * Hn), generator=gen, device=dev)
            wh = torch.randn((Hn, 4 * Hn), generator=gen, device=dev) / Hn ** 0.5
            b = torch.randn(4 * Hn, generator=gen, device=dev) * 0.1
            dhs = torch.randn((T, B, Hn), generator=gen, device=dev)
            cs = torch.empty((T, B, Hn), device=dev)
            hs = lstm_scan(xw, wh, b, cs_out=cs)
            torch.cuda.synchronize()
            ref_hs, ref_cs = lstm_scan_reference(xw, wh, b)
            fwd_err = max((hs - ref_hs).abs().max().item(), (cs - ref_cs).abs().max().item())
            if not (torch.allclose(hs, ref_hs, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
                    and torch.allclose(cs, ref_cs, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)):
                raise AssertionError(
                    f"lstm_fwd disagrees with its plain version at H={Hn}, B={B}: "
                    f"max abs err {fwd_err:.3e}")
            big = Hn * B >= 512 * 4096
            fwd_ms = cuda_ms(torch, lambda: lstm_scan(xw, wh, b), runs=10)
            fwd_plain = cuda_ms(torch, lambda: lstm_scan_reference(xw, wh, b), runs=5)
            fb, fby = lstm_bound(T, B, Hn)
            lib = cudnn_lstm(torch, wh, b)
            with torch.no_grad():
                lib_fwd = cuda_ms(torch, lambda: lib(xw), runs=10)
            log(f"[kernel] lstm wide H={Hn} B={B:5d}: lstm_fwd max_abs_err={fwd_err:.3e} "
                f"kernel_ms={fwd_ms:.4f} plain_ms={fwd_plain:.4f} library_ms={lib_fwd:.4f} "
                f"(cuDNN nn.LSTM forward) bound_ms={fb:.4f} ({fby})")
            check_lstm_bwd(torch, xw, wh, b, ref_hs, ref_cs, dhs, f"H={Hn} B={B:5d}",
                           runs=5 if big else 10)
    kernel_lstm_beyond_shared(torch)


def kernel_lstm_beyond_shared(torch) -> None:
    """lstm_fwd and lstm_bwd at H = BEYOND_SHARED_HIDDEN, B = 20, T = 24:
    past H = 9685 the backward's chain keeps its tiles in a scratch in
    device memory. Both against their plain versions at the tolerances of
    H = 64, each backward kernel against its plain piece; timed by CUDA
    events, without the cuDNN yardstick (its identity input projection
    alone would be 9.2 GB)."""
    from tpuflow_torch.kernels.lstm import (
        lstm_bwd_chain,
        lstm_bwd_chain_reference,
        lstm_bwd_gates_reference,
        lstm_scan,
        lstm_scan_backward,
        lstm_scan_backward_reference,
        lstm_scan_reference,
    )

    Hn, B = BEYOND_SHARED_HIDDEN, TRAIN_BATCH
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    xw = torch.randn((T, B, 4 * Hn), generator=gen, device=dev)
    wh = torch.randn((Hn, 4 * Hn), generator=gen, device=dev) / Hn ** 0.5
    b = torch.randn(4 * Hn, generator=gen, device=dev) * 0.1
    dhs = torch.randn((T, B, Hn), generator=gen, device=dev)
    cs = torch.empty((T, B, Hn), device=dev)
    hs = lstm_scan(xw, wh, b, cs_out=cs)
    got = lstm_scan_backward(xw, wh, b, hs, cs, dhs)
    gates = lstm_bwd_gates_reference(xw, wh, b, hs)
    dz = lstm_bwd_chain(wh, cs, dhs, gates.clone())
    torch.cuda.synchronize()
    ref_hs, ref_cs = lstm_scan_reference(xw, wh, b)
    fwd_err = max((hs - ref_hs).abs().max().item(), (cs - ref_cs).abs().max().item())
    want = lstm_scan_backward_reference(xw, wh, b, hs, cs, dhs)
    errs = {k: normwise_err(g, w) for k, g, w in zip(BWD_TOL, got, want)}
    dz_err = normwise_err(dz, lstm_bwd_chain_reference(wh, cs, dhs, gates))
    del want
    bad = {k: e for k, e in errs.items() if not e <= BWD_TOL[k]}
    if dz_err > BWD_PIECE_TOL["dz"]:
        bad["chain dz"] = dz_err
    if bad or not (torch.allclose(hs, ref_hs, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
                   and torch.allclose(cs, ref_cs, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)):
        raise AssertionError(f"lstm at H={Hn}, B={B} disagrees with its plain version: "
                             f"forward max abs err {fwd_err:.3e}, backward {bad}")
    fwd_ms = cuda_ms(torch, lambda: lstm_scan(xw, wh, b), runs=3, warmup=1)
    bwd_ms = cuda_ms(torch, lambda: lstm_scan_backward(xw, wh, b, hs, cs, dhs),
                     runs=3, warmup=1)
    log(f"[kernel] lstm H={Hn} B={B} (chain tiles in device memory): lstm_fwd max_abs_err="
        f"{fwd_err:.3e} kernel_ms={fwd_ms:.4f}; lstm_bwd normwise_err="
        + ",".join(f"{k}:{v:.3e}" for k, v in errs.items())
        + f", chain dz {dz_err:.3e}; kernel_ms={bwd_ms:.4f} (CUDA events)")


def kernel_flash(torch) -> dict:
    """flash_fwd, flash_dq and flash_dkv against their plain versions at
    FLASH_SHAPES (the backward pair on the kernel's own lse and delta, so
    that each is held alone), with SDPA (is_causal, f32) timed as the
    yardstick; returns the records of the serving chunk for flash_fwd and
    of the train step for flash_dq and flash_dkv."""
    from tpuflow_torch.kernels.attention import (
        flash_attention_dkv,
        flash_attention_dq,
        flash_attention_forward,
        flash_attention_reference,
        flash_dkv_reference,
        flash_dq_reference,
    )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    log(f"[kernel] flash_fwd/flash_dq/flash_dkv vs their plain versions: f32; "
        f"flash_fwd within atol={FLASH_ATOL} on o and lse (same tiles, dot "
        f"products summed in another order), flash_dq and flash_dkv normwise "
        f"within {FLASH_GRAD_TOL} (sums over up to T pairs in another order); "
        "library: scaled_dot_product_attention(is_causal=True), a yardstick "
        "the port never calls")
    records, worst = {}, dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"), 0.0)
    for BH, Tn, D in FLASH_SHAPES:
        q, k, v, do = (torch.randn((BH, Tn, D), generator=gen, device=dev) for _ in range(4))
        o, lse = flash_attention_forward(q, k, v)
        delta = (do * o).sum(-1)
        dq = flash_attention_dq(q, k, v, do, lse, delta)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        ref_o, ref_lse = flash_attention_reference(q, k, v)
        ref_dq = flash_dq_reference(q, k, v, do, lse, delta)
        ref_dk, ref_dv = flash_dkv_reference(q, k, v, do, lse, delta)
        errs = {
            "flash_fwd": max((o - ref_o).abs().max().item(), (lse - ref_lse).abs().max().item()),
            "flash_dq": (dq - ref_dq).abs().max().item(),
            "flash_dkv": max((dk - ref_dk).abs().max().item(), (dv - ref_dv).abs().max().item()),
        }
        norm = {"dq": normwise_err(dq, ref_dq), "dk": normwise_err(dk, ref_dk),
                "dv": normwise_err(dv, ref_dv)}
        for name, err in errs.items():
            worst[name] = max(worst[name], err)
        if errs["flash_fwd"] > FLASH_ATOL:
            raise AssertionError(f"flash_fwd disagrees with its plain version at "
                                 f"{(BH, Tn, D)}: max abs err {errs['flash_fwd']:.3e}")
        bad = {n: e for n, e in norm.items() if not e <= FLASH_GRAD_TOL}
        if bad:
            raise AssertionError(f"flash backward disagrees with its plain version at "
                                 f"{(BH, Tn, D)}: normwise {bad}")
        ms = {
            "flash_fwd": cuda_ms(torch, lambda: flash_attention_forward(q, k, v)),
            "flash_dq": cuda_ms(torch, lambda: flash_attention_dq(q, k, v, do, lse, delta)),
            "flash_dkv": cuda_ms(torch, lambda: flash_attention_dkv(q, k, v, do, lse, delta)),
        }
        plain_ms = {
            "flash_fwd": cuda_ms(torch, lambda: flash_attention_reference(q, k, v), runs=10),
            "flash_dq": cuda_ms(
                torch, lambda: flash_dq_reference(q, k, v, do, lse, delta), runs=10),
            "flash_dkv": cuda_ms(
                torch, lambda: flash_dkv_reference(q, k, v, do, lse, delta), runs=10),
        }
        lib_err = (sdpa(q, k, v, is_causal=True) - ref_o).abs().max().item()
        sdpa_fwd = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True))
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        out = sdpa(qg, kg, vg, is_causal=True)
        sdpa_bwd = cuda_ms(
            torch, lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))
        sdpa_both = cuda_ms(torch, lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), do))
        library_ms = {"flash_fwd": sdpa_fwd, "flash_dq": sdpa_bwd, "flash_dkv": sdpa_bwd}
        bounds = {"flash_fwd": flash_fwd_bound(BH, Tn, D),
                  "flash_dq": flash_dq_bound(BH, Tn, D),
                  "flash_dkv": flash_dkv_bound(BH, Tn, D)}
        log(f"[kernel] flash (BH, T, D)=({BH}, {Tn}, {D}): normwise_err="
            + ",".join(f"{n}:{e:.3e}" for n, e in norm.items())
            + f"; SDPA fwd max abs err vs plain {lib_err:.3e}, sdpa_fwd_ms={sdpa_fwd:.4f} "
            f"sdpa_bwd_ms={sdpa_bwd:.4f} (dq, dk, dv together, on a saved forward) "
            f"sdpa_fwd_bwd_ms={sdpa_both:.4f}")
        tc_bounds = {"flash_fwd": flash_fwd_tc_bound(BH, Tn, D),
                     "flash_dq": flash_dq_tc_bound(BH, Tn, D),
                     "flash_dkv": flash_dkv_tc_bound(BH, Tn, D)}
        for name in ms:
            bound_ms, bound_by = bounds[name]
            tc_ms, tc_by = tc_bounds[name]
            extra = f"; tensor-core/SFU bound_ms={tc_ms:.6f} ({tc_by})"
            log(f"[kernel]   {name:9s} max_abs_err={errs[name]:.3e} kernel_ms={ms[name]:.4f} "
                f"plain_ms={plain_ms[name]:.4f} library_ms={library_ms[name]:.4f} "
                f"bound_ms={bound_ms:.6f} ({bound_by}){extra}")
        keep = ("flash_fwd",) if (BH, Tn, D) == (16384, T, 16) else (
            ("flash_dq", "flash_dkv") if (BH, Tn, D) == (TRAIN_BATCH * 4, T, 16) else ())
        for name in keep:
            records[name] = {"ms": ms[name], "plain_ms": plain_ms[name],
                             "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                             "library_ms": library_ms[name]}
    for name, record in records.items():
        record["max_abs_err"] = worst[name]
    return records


def kernel_ring(torch) -> dict:
    """ring_round_fwd and ring_round_bwd against their plain versions at
    RING_SHAPES, each at the three RING_PATTERNS, and at RING_UNALIGNED's
    offsets. The forward starts from a genuine running state (the plain
    round of a diagonal block), and the backward takes the log-sum-exp and
    delta of the forward's result; a future block must copy the forward's
    state through bit for bit and give zero gradients. Logs each kernel's
    f32 and 3xTF32 bounds. Returns the records of the ring train step's
    diagonal round."""
    from tpuflow_torch.kernels.attention import (
        ring_round_bwd,
        ring_round_bwd_reference,
        ring_round_fwd,
        ring_round_fwd_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    log(f"[kernel] ring_round_fwd/ring_round_bwd vs their plain versions: f32; the "
        f"forward's m, lse = m + log(l) and o = acc / l within atol={FLASH_ATOL}; the "
        f"backward normwise within {FLASH_GRAD_TOL}; library: none (no single PyTorch "
        "call returns a round's state or its partial gradients)")
    records, worst = {}, {"ring_round_fwd": 0.0, "ring_round_bwd": 0.0}
    unaligned = dict(RING_UNALIGNED)
    for BH, Tl, D in RING_SHAPES:
        q, k, v, do, k0, v0 = (torch.randn((BH, Tl, D), generator=gen, device=dev)
                               for _ in range(6))
        scale = D ** -0.5
        big = Tl >= 1024
        offsets = {pattern: (qo * Tl, ko * Tl) for pattern, (qo, ko) in RING_PATTERNS.items()}
        if (BH, Tl, D) in unaligned:
            offsets["unaligned"] = unaligned[BH, Tl, D]
        for pattern, (q_off, k_off) in offsets.items():
            start = (torch.full((BH, Tl), -1e30, device=dev), torch.zeros((BH, Tl), device=dev),
                     torch.zeros((BH, Tl, D), device=dev))
            m, l, acc = ring_round_fwd_reference(q, k0, v0, *start, q_off, q_off, scale)
            got = ring_round_fwd(q, k, v, m, l, acc, q_off, k_off, scale)
            torch.cuda.synchronize()
            want = ring_round_fwd_reference(q, k, v, m, l, acc, q_off, k_off, scale)
            (gm, gl, ga), (wm, wl, wa) = got, want
            if pattern == "future" and not all(map(torch.equal, got, (m, l, acc))):
                raise AssertionError(f"ring_round_fwd: a future block at {(BH, Tl, D)} "
                                     "changed the running state")
            fwd_err = max((gm - wm).abs().max().item(),
                          ((gm + torch.log(gl)) - (wm + torch.log(wl))).abs().max().item(),
                          ((ga / gl[..., None]) - (wa / wl[..., None])).abs().max().item())
            if not fwd_err <= FLASH_ATOL:
                raise AssertionError(
                    f"ring_round_fwd disagrees with its plain version at {(BH, Tl, D)}, "
                    f"{pattern}: max abs err {fwd_err:.3e} on m, lse or acc / l")
            lse = wm + torch.log(wl)
            delta = (do * (wa / wl[..., None])).sum(-1)
            dgot = ring_round_bwd(q, k, v, do, lse, delta, q_off, k_off, scale)
            torch.cuda.synchronize()
            dwant = ring_round_bwd_reference(q, k, v, do, lse, delta, q_off, k_off, scale)
            norm = {n: normwise_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), dgot, dwant)}
            bwd_err = max((g - w).abs().max().item() for g, w in zip(dgot, dwant))
            if pattern == "future" and any(g.any().item() for g in dgot):
                raise AssertionError(f"ring_round_bwd: a future block at {(BH, Tl, D)} "
                                     "gave non-zero gradients")
            bad = {n: e for n, e in norm.items() if not e <= FLASH_GRAD_TOL}
            if bad:
                raise AssertionError(f"ring_round_bwd disagrees with its plain version at "
                                     f"{(BH, Tl, D)}, {pattern}: normwise {bad}")
            worst["ring_round_fwd"] = max(worst["ring_round_fwd"], fwd_err)
            worst["ring_round_bwd"] = max(worst["ring_round_bwd"], bwd_err)
            ms = {
                "ring_round_fwd": cuda_ms(
                    torch, lambda: ring_round_fwd(q, k, v, m, l, acc, q_off, k_off, scale)),
                "ring_round_bwd": cuda_ms(
                    torch, lambda: ring_round_bwd(q, k, v, do, lse, delta, q_off, k_off, scale)),
            }
            plain_ms = {
                "ring_round_fwd": cuda_ms(torch, lambda: ring_round_fwd_reference(
                    q, k, v, m, l, acc, q_off, k_off, scale), runs=5 if big else 10),
                "ring_round_bwd": cuda_ms(torch, lambda: ring_round_bwd_reference(
                    q, k, v, do, lse, delta, q_off, k_off, scale), runs=5 if big else 10),
            }
            pairs = ring_pairs(Tl, q_off, k_off)
            bounds = {"ring_round_fwd": ring_fwd_bound(BH, Tl, D, pairs),
                      "ring_round_bwd": ring_bwd_bound(BH, Tl, D, pairs)}
            tc = {"ring_round_fwd": ring_fwd_tc_bound(BH, Tl, D, pairs),
                  "ring_round_bwd": ring_bwd_tc_bound(BH, Tl, D, pairs)}
            log(f"[kernel] ring (BH, Tl, D)=({BH}, {Tl}, {D}) {pattern:9s} "
                f"q_off={q_off} k_off={k_off} pairs/head={pairs}: "
                f"fwd max_abs_err={fwd_err:.3e} kernel_ms={ms['ring_round_fwd']:.4f} "
                f"plain_ms={plain_ms['ring_round_fwd']:.4f} "
                f"bound_ms={bounds['ring_round_fwd'][0]:.6f} ({bounds['ring_round_fwd'][1]}) "
                f"3xTF32 bound_ms={tc['ring_round_fwd'][0]:.6f} ({tc['ring_round_fwd'][1]}); "
                "bwd normwise_err=" + ",".join(f"{n}:{e:.3e}" for n, e in norm.items())
                + f" kernel_ms={ms['ring_round_bwd']:.4f} plain_ms={plain_ms['ring_round_bwd']:.4f} "
                f"bound_ms={bounds['ring_round_bwd'][0]:.6f} ({bounds['ring_round_bwd'][1]}) "
                f"3xTF32 bound_ms={tc['ring_round_bwd'][0]:.6f} ({tc['ring_round_bwd'][1]}) "
                "library_ms=null")
            if (BH, Tl, D) == RING_SHAPES[0] and pattern == "diagonal":
                for name in ms:
                    records[name] = {"ms": ms[name], "plain_ms": plain_ms[name],
                                     "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                                     "library_ms": None}
    for name, record in records.items():
        record["max_abs_err"] = worst[name]
    return records


def ring_round_inputs(torch, gen, BH: int, Tl: int, D: int) -> tuple[tuple, tuple]:
    """Seeded inputs of one ring round on the card: ``(q, k, v, m, l, acc)``
    for the forward and ``(q, k, v, do, lse, delta)`` for the backward, with
    l in [0.5, 1.5) and lse in [3, 4), above every score as a real one is."""
    dev = torch.device("cuda")
    q, k, v, do, acc = (torch.randn((BH, Tl, D), generator=gen, device=dev)
                        for _ in range(5))
    m, delta = (torch.randn((BH, Tl), generator=gen, device=dev) for _ in range(2))
    l = 0.5 + torch.rand((BH, Tl), generator=gen, device=dev)
    lse = 3.0 + torch.rand((BH, Tl), generator=gen, device=dev)
    return (q, k, v, m, l, acc), (q, k, v, do, lse, delta)


def kernel_mae_clip(torch) -> dict:
    """mae_clip against mae_clip_reference at MAE_SHAPES, and mae_clip_grad
    against mae_clip_grad_reference bit for bit at the same shapes (with
    zero errors and a NaN input among them); returns the records of the
    train-loss shape, [1, 480]."""
    from tpuflow_torch.core.losses import CLIP_VALUE
    from tpuflow_torch.kernels.losses import (
        mae_clip_grad,
        mae_clip_grad_reference,
        mae_clip_reference,
        mae_clip_rows,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    log(f"[kernel] mae_clip vs mae_clip_reference: f32, clip {CLIP_VALUE}; "
        f"tolerance rtol={MAE_RTOL} (per-row f32 sums in another order); "
        "mae_clip_grad vs mae_clip_grad_reference: bitwise (the same arithmetic "
        "in the same order)")
    records, worst, grad_worst = {}, 0.0, 0.0
    for R, N in MAE_SHAPES:
        yt = torch.randn((R, N), generator=gen, device=dev) * 5
        yp = torch.randn((R, N), generator=gen, device=dev) * 5
        yp[0, :3] = yt[0, :3]
        g = torch.rand((), generator=gen, device=dev)
        got = mae_clip_rows(yt, yp, CLIP_VALUE)
        grads = mae_clip_grad(yt, yp, g, CLIP_VALUE)
        torch.cuda.synchronize()
        want = mae_clip_reference(yt, yp, CLIP_VALUE)
        want_grads = mae_clip_grad_reference(yt, yp, g, CLIP_VALUE)
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(got, want, atol=0, rtol=MAE_RTOL):
            raise AssertionError(
                f"mae_clip disagrees with its plain version at [{R}, {N}]: "
                f"max abs err {err:.3e}")
        for name, a, b in zip(("dyt", "dyp"), grads, want_grads):
            grad_worst = max(grad_worst, (a - b).abs().max().item())
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"mae_clip_grad's {name} differs from its plain "
                                     f"version at [{R}, {N}]")
        yt_nan = yt.clone()
        yt_nan[-1, -1] = float("nan")
        nan_got = mae_clip_grad(yt_nan, yp, g, CLIP_VALUE)
        nan_want = mae_clip_grad_reference(yt_nan, yp, g, CLIP_VALUE)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(nan_got, nan_want)):
            raise AssertionError(f"mae_clip_grad differs from its plain version at "
                                 f"[{R}, {N}] with a NaN input")
        kernel_ms = cuda_ms(torch, lambda: mae_clip_rows(yt, yp, CLIP_VALUE))
        plain_ms = cuda_ms(torch, lambda: mae_clip_reference(yt, yp, CLIP_VALUE))
        device_ms = sum(profiled_ms(torch, lambda: mae_clip_rows(yt, yp, CLIP_VALUE)).values())
        grad_ms = cuda_ms(torch, lambda: mae_clip_grad(yt, yp, g, CLIP_VALUE))
        grad_plain_ms = cuda_ms(torch, lambda: mae_clip_grad_reference(yt, yp, g, CLIP_VALUE))
        grad_device_ms = sum(profiled_ms(
            torch, lambda: mae_clip_grad(yt, yp, g, CLIP_VALUE)).values())
        bound_ms, bound_by = mae_clip_bound(R, N)
        grad_bound_ms, grad_bound_by = mae_clip_grad_bound(R * N)
        log(f"[kernel] mae_clip [{R}, {N}]: max_abs_err={err:.3e} "
            f"kernel_ms={kernel_ms:.4f} device_ms={device_ms:.4f} (profiled) "
            f"plain_ms={plain_ms:.4f} library_ms=null "
            f"(no single PyTorch call computes it) bound_ms={bound_ms:.6f} ({bound_by}); "
            f"mae_clip_grad bitwise kernel_ms={grad_ms:.4f} device_ms={grad_device_ms:.4f} "
            f"plain_ms={grad_plain_ms:.4f} library_ms=null bound_ms={grad_bound_ms:.6f} "
            f"({grad_bound_by})")
        if not records:
            records = {
                "mae_clip": {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": None},
                "mae_clip_grad": {"ms": grad_ms, "plain_ms": grad_plain_ms,
                                  "bound_ms": grad_bound_ms, "bound_by": grad_bound_by,
                                  "library_ms": None},
            }
    records["mae_clip"]["max_abs_err"] = worst
    records["mae_clip_grad"]["max_abs_err"] = grad_worst
    return records


def kernel_repeat(torch) -> None:
    """REPEAT_LAUNCHES launches back to back of mae_clip and mae_clip_grad
    (at each of MAE_SHAPES: the wide row's last block sums by ticket), of
    flash_fwd, and of flash_dq and flash_dkv (at each of FLASH_SHAPES, on
    the forward's lse and delta), and of ring_round_fwd and ring_round_bwd
    (at each of RING_SHAPES, a diagonal and a past round) must equal the
    first bitwise. Each launch is compared with the first on the card as it
    goes (no synchronise in between). Raises on a mismatch."""
    from tpuflow_torch.core.losses import CLIP_VALUE
    from tpuflow_torch.kernels.attention import (
        flash_attention_dkv,
        flash_attention_dq,
        flash_attention_forward,
        ring_round_bwd,
        ring_round_fwd,
    )
    from tpuflow_torch.kernels.losses import mae_clip_grad, mae_clip_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = [(f"mae_clip and mae_clip_grad [{R}, {N}]",
              lambda a=torch.randn((R, N), generator=gen, device=dev) * 5,
              b=torch.randn((R, N), generator=gen, device=dev) * 5,
              g=torch.rand((), generator=gen, device=dev):
              (mae_clip_rows(a, b, CLIP_VALUE), *mae_clip_grad(a, b, g, CLIP_VALUE)))
             for R, N in MAE_SHAPES]
    cases += [(f"flash_fwd {(BH, Tn, D)}",
               lambda qkv=[torch.randn((BH, Tn, D), generator=gen, device=dev)
                           for _ in range(3)]: flash_attention_forward(*qkv))
              for BH, Tn, D in FLASH_SHAPES]
    for BH, Tn, D in FLASH_SHAPES:
        q, k, v, do = (torch.randn((BH, Tn, D), generator=gen, device=dev) for _ in range(4))
        o, lse = flash_attention_forward(q, k, v)
        args = (q, k, v, do, lse, (do * o).sum(-1))
        cases += [(f"flash_dq {(BH, Tn, D)}", lambda a=args: (flash_attention_dq(*a),)),
                  (f"flash_dkv {(BH, Tn, D)}", lambda a=args: flash_attention_dkv(*a))]
    for BH, Tl, D in RING_SHAPES:
        fwd_in, bwd_in = ring_round_inputs(torch, gen, BH, Tl, D)
        for pattern in ("diagonal", "past"):
            qo, ko = RING_PATTERNS[pattern]
            offs = (qo * Tl, ko * Tl, D ** -0.5)
            cases += [(f"ring_round_fwd {(BH, Tl, D)} {pattern}",
                       lambda a=fwd_in + offs: ring_round_fwd(*a)),
                      (f"ring_round_bwd {(BH, Tl, D)} {pattern}",
                       lambda a=bwd_in + offs: ring_round_bwd(*a))]
    for what, fn in cases:
        first = fn()
        differs = []
        for _ in range(REPEAT_LAUNCHES):
            out = fn()
            differs.append(torch.stack([torch.ne(a, b).any() for a, b in zip(out, first)]).any())
        torch.cuda.synchronize()
        bad = [i for i, d in enumerate(differs) if d.item()]
        if bad:
            raise AssertionError(f"{what}: launches {bad[:10]} of {REPEAT_LAUNCHES} differ "
                                 "from the first")
        log(f"[kernel] {what}: {REPEAT_LAUNCHES} launches back to back equal the first "
            "bitwise")


def kernel_mae_clip_streams(torch) -> None:
    """Wide-row mae_clip calls (MAE_STREAM_SHAPES, each call on other inputs)
    launched alternately on two streams with no synchronise in between,
    both streams first held behind a sleep kernel so that their calls run
    at once: each call's means must match its plain version (MAE_RTOL) and
    equal bitwise the same call made alone. A call's ticket counters live
    in its own partials. Raises on a mismatch."""
    from tpuflow_torch.core.losses import CLIP_VALUE
    from tpuflow_torch.kernels.losses import mae_clip_reference, mae_clip_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for shape, rounds in MAE_STREAM_SHAPES:
        calls = [tuple(torch.randn(shape, generator=gen, device=dev) * 5 for _ in range(2))
                 for _ in range(2 * rounds)]
        torch.cuda.synchronize()
        got = [None] * len(calls)
        for s in streams:
            with torch.cuda.stream(s):
                torch.cuda._sleep(20_000_000)
        for i, (yt, yp) in enumerate(calls):
            with torch.cuda.stream(streams[i % 2]):
                got[i] = mae_clip_rows(yt, yp, CLIP_VALUE)
        torch.cuda.synchronize()
        for i, (yt, yp) in enumerate(calls):
            want = mae_clip_reference(yt, yp, CLIP_VALUE)
            if not (torch.allclose(got[i], want, atol=0, rtol=MAE_RTOL)
                    and torch.equal(got[i], mae_clip_rows(yt, yp, CLIP_VALUE))):
                raise AssertionError(
                    f"mae_clip on two streams at {list(shape)}: call {i} of {len(calls)} "
                    f"gave {got[i].tolist()}, its plain version {want.tolist()}")
        log(f"[kernel] mae_clip {list(shape)}: {rounds} calls on each of two streams at "
            "once match their plain versions and equal each call made alone")


def expected_train_launches(config) -> tuple[dict, dict]:
    """Each kernel's launches in one ``train(config)`` on synthetic wells,
    from the data sizes: windows per well, the 64/16/20 split, whole train
    batches, padded val batches each epoch, then the test split once at
    the final eval's batch (256 when it is over 4 train batches). Each of
    the model's layers runs its family's forward kernel once per batch and
    its backward kernels once per train batch; the loss's kernel runs once
    per batch and its gradient once per train batch; the family's other
    kernels and the other family's run no time."""
    n = config.synthetic_wells * (config.synthetic_steps - config.window + 1)
    n_train, n_val = int(round(n * 0.64)), int(round(n * 0.16))
    n_test = n - n_train - n_val
    bs = config.batch_size
    eval_bs = max(bs, 256) if n_test > 4 * bs else bs
    train_b, val_b, test_b = n_train // bs, -(-n_val // bs), -(-n_test // eval_bs)
    epochs, layers = config.max_epochs, LAYERS[config.model]
    backward = ("flash_dq", "flash_dkv") if config.model == "attention" else ("lstm_bwd",)
    want = {
        "lstm_fwd": 0, "lstm_bwd": 0, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
        "ring_round_fwd": 0, "ring_round_bwd": 0,
        FORWARD_KERNEL[config.model]: layers * (train_b + val_b) * epochs + layers * test_b,
        "mae_clip": (train_b + val_b) * epochs + test_b,
        "mae_clip_grad": train_b * epochs,
    }
    for name in backward:
        want[name] = layers * train_b * epochs
    sizes = {"windows": n, "train": n_train, "val": n_val, "test": n_test,
             "train_batches": train_b, "val_batches": val_b,
             "test_batches": test_b, "test_batch": eval_bs}
    return want, sizes


def phase_train(torch, root: str, smi: str) -> tuple[dict, float]:
    """Train LSTM-64 (3 epochs), the stacked LSTM (2 epochs) and the
    attention regressor (3 epochs) through ``train(TrainJobConfig(...))`` at
    its defaults into ``root``, then the attention regressor at a 256-step
    window (1 epoch, into a directory of its own); returns the kernels'
    launches summed over the counted runs, and the 256-step run's test MAE."""
    from tpuflow_torch.api.config import TrainJobConfig
    from tpuflow_torch.api.train_api import train
    from tpuflow_torch.data.pipeline import prepare_windowed
    from tpuflow_torch.data.synthetic import generate_wells
    from tpuflow_torch.kernels import KERNELS

    totals = dict.fromkeys(KERNELS, 0)
    models = []
    runs = (("lstm", 3, T), ("stacked_lstm", 2, T), ("attention", 3, T), ("attention", 1, 256))
    for model_name, epochs, window in runs:
        label = model_name if window == T else f"{model_name}@{window}"
        config = TrainJobConfig(
            model=model_name, max_epochs=epochs, window=window, verbose=False,
            storage_path=root if window == T else os.path.join(root, f"window{window}"),
        )
        want, sizes = expected_train_launches(config)
        for k in KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        report = train(config)  # device left at its default: cuda
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {name: k.launches for name, k in KERNELS.items()}
        history = report.result.history
        log(f"[train] {label:14s} {epochs} epochs in {seconds:.2f} s on "
            f"{report.device}; data {sizes}")
        for h in history:
            log(f"[train] {label:14s} epoch {h['epoch']}: loss={h['loss']:.6f} "
                f"val_loss={h['val_loss']:.6f} time_s={h['time']:.3f}")
        log(f"[train] {label:14s} test_loss={report.test_loss:.6f} "
            f"test_mae={report.test_mae:.2f} gilbert_mae={report.gilbert_mae:.2f} "
            f"stb/day; fit samples/s={report.samples_per_sec:.1f} (host clock over "
            f"the fit, eval included; card: {smi}); program {report.epoch_program}")
        log(f"[train] {label:14s} launches {got}, expected {want}")
        if got != want:
            raise AssertionError(f"{label}: kernel launches {got} != {want}")
        if len(history) != epochs or not all(
            np.isfinite([h["loss"], h["val_loss"]]).all() for h in history
        ) or not np.isfinite(report.test_loss):
            raise AssertionError(f"{label}: non-finite or missing losses {history}")
        if label in ("lstm", "attention") and not report.test_mae < report.gilbert_mae:
            raise AssertionError(
                f"{label} test MAE {report.test_mae:.2f} does not beat the Gilbert "
                f"baseline {report.gilbert_mae:.2f}")
        for k in totals:
            totals[k] += got[k]
        if window == T:
            models.append((model_name, report.result.model))
        else:
            mae_256 = report.test_mae

    # After the counted runs: gradients, steady steps, profile.
    splits = prepare_windowed(generate_wells(n_wells=8, steps=512, seed=0),
                              window=T, seed=0, teacher_forcing=True)
    x = torch.from_numpy(splits.train.x).cuda()
    y = torch.from_numpy(splits.train.y).cuda()
    for model_name, model in models:
        check_gradients(torch, model_name, model, x[:TRAIN_BATCH], y[:TRAIN_BATCH])
        steady_steps(torch, model_name, model, x, y, smi)
    return totals, mae_256


def check_gradients(torch, model_name, model, x, y) -> None:
    """One batch's parameter gradients through the kernels against the plain
    path (``model(x, plain=True)`` and the loss's plain version)."""
    from tpuflow_torch.core.losses import CLIP_VALUE, mae_clip
    from tpuflow_torch.kernels.losses import mae_clip_reference

    grads = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        pred = model(x, plain=plain)
        if plain:
            loss = mae_clip_reference(y.reshape(1, -1), pred.reshape(1, -1), CLIP_VALUE)[0]
        else:
            loss = mae_clip(y, pred)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    errs = {n: normwise_err(grads[0][n], grads[1][n]) for n in grads[1]}
    log(f"[train] {model_name:12s} one batch, gradients kernels vs plain path: "
        f"normwise err " + ", ".join(f"{n}={e:.2e}" for n, e in errs.items())
        + f" (tolerance {GRAD_TOL})")
    bad = {n: e for n, e in errs.items() if not e <= GRAD_TOL}
    if bad:
        raise AssertionError(f"{model_name}: kernel gradients disagree with the plain path: {bad}")
    model.zero_grad(set_to_none=True)


def steady_steps(torch, model_name, model, x, y, smi) -> None:
    """Steady train steps at batch 20 (keras_sgd, mae_clip): samples/s on the
    host clock ending in a synchronise, then one profiled window for device
    time by kernel and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from tpuflow_torch.core.losses import mae_clip
    from tpuflow_torch.train.optim import keras_sgd
    from tpuflow_torch.train.steps import make_train_step

    step = make_train_step(model, keras_sgd().bind(model.parameters()), mae_clip)
    n_batches = len(x) // TRAIN_BATCH

    def run(k):
        for i in range(k):
            s = (i % n_batches) * TRAIN_BATCH
            step(x[s : s + TRAIN_BATCH], y[s : s + TRAIN_BATCH])

    run(10)
    torch.cuda.synchronize()
    steps = 200
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"[train] {model_name:12s} steady steps at batch {TRAIN_BATCH}: "
        f"{steps * TRAIN_BATCH / dt:.1f} samples/s, {dt / steps * 1e3:.3f} ms/step "
        f"(host clock over {steps} steps ending in a synchronise; card: {smi})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(20)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log_profiled_steps(model_name, device_ms_by_kernel(prof), wall_ms)


# The port's kernels as the profiler names them; the backward of the LSTM
# is its three kernels.
OUR_KERNELS = ("lstm_fwd_f32", "lstm_bwd_gates", "lstm_bwd_chain", "lstm_bwd_wgrad",
               "flash_", "mae_clip_", "clipped_abs_partial", "row_sum_kernel")
LSTM_BWD_KERNELS = ("lstm_bwd_gates", "lstm_bwd_chain", "lstm_bwd_wgrad")


def log_profiled_steps(model_name, by_kernel: dict, wall_ms: float) -> None:
    """One profiled window of 20 train steps: device busy and idle share,
    the eight largest kernels and the port's own wherever they rank, and
    the LSTM backward's device time (its three kernels summed)."""
    busy_ms = sum(by_kernel.values())
    idle = f"{1 - busy_ms / wall_ms:.3f}" if busy_ms else "not measured"
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    top = ranked[:8] + [kv for kv in ranked[8:] if any(m in kv[0] for m in OUR_KERNELS)]
    bwd = {m: sum(v for k, v in by_kernel.items() if m in k) for m in LSTM_BWD_KERNELS}
    # Every kernel named lstm_bwd: also the single kernel of earlier trees.
    bwd_ms = sum(v for k, v in by_kernel.items() if "lstm_bwd" in k)
    log(f"[train] {model_name:12s} profiled 20 steps: wall_ms={wall_ms:.3f} "
        f"device_busy_ms={busy_ms:.3f} idle_share={idle} kernels={len(by_kernel)}; "
        f"lstm_bwd device_ms={bwd_ms:.4f} ("
        + ", ".join(f"{k}={v:.4f}" for k, v in bwd.items())
        + "); by kernel (ms over 20 steps): "
        + "; ".join(f"{k[:60]}={v:.4f}" for k, v in top))


def _tree(root: str, stems=None):
    """Import the port from the tree at ROOT (this checkout, or another tree
    unpacked beside it) and build its kernels (``stems``, or all); returns
    ``torch``, or None when there is no card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return None
    sys.path.insert(0, os.path.abspath(root))
    import tpuflow_torch
    from tpuflow_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(stems)
    log(f"[steps] tree {os.path.dirname(os.path.abspath(tpuflow_torch.__file__))}; "
        f"card: {nvidia_smi()}")
    return torch


def _train_steps(torch, model_name: str):
    """A train step of ``model_name`` (seeded weights, keras_sgd, mae_clip)
    and ``run(k)``, k steps at batch 20 over the seeded wells' windows."""
    from tpuflow_torch.core.losses import mae_clip
    from tpuflow_torch.data.pipeline import prepare_windowed
    from tpuflow_torch.data.synthetic import generate_wells
    from tpuflow_torch.models import build_model
    from tpuflow_torch.train.optim import keras_sgd
    from tpuflow_torch.train.steps import make_train_step

    splits = prepare_windowed(generate_wells(n_wells=8, steps=512, seed=0),
                              window=T, seed=0, teacher_forcing=True)
    x = torch.from_numpy(splits.train.x).cuda()
    y = torch.from_numpy(splits.train.y).cuda()
    model = build_model(model_name, len(FEATURES), window=T)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.cuda()
    step = make_train_step(model, keras_sgd().bind(model.parameters()), mae_clip)
    n_batches = len(x) // TRAIN_BATCH

    def run(k):
        for i in range(k):
            s = (i % n_batches) * TRAIN_BATCH
            step(x[s : s + TRAIN_BATCH], y[s : s + TRAIN_BATCH])

    return run


def _profiled_steps(torch, run, steps: int = 20):
    """10 warm steps, then ``steps`` in one profiler window: (profile, wall
    ms of the window)."""
    from torch.profiler import ProfilerActivity, profile

    run(10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def device_launches(prof) -> dict:
    """Device activities by name in a profiler window, as counts: kernels,
    and the memory copies and sets, each launched on the device."""
    from torch.autograd import DeviceType

    return {evt.key: evt.count for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0
            and not getattr(evt, "is_user_annotation", False)}


def lstm_steps(root: str) -> int:
    """``--lstm-steps ROOT``: profiled LSTM-64 train steps of the port in the
    tree at ROOT, so that two trees can be compared in one run on one card:
    build ROOT's kernels, then 10 warm steps and one profiled window of 20
    steps at batch 20 (keras_sgd, mae_clip) on seeded wells and weights;
    then ROOT's LSTM kernels alone."""
    torch = _tree(root)
    if torch is None:
        return 1
    prof, wall_ms = _profiled_steps(torch, _train_steps(torch, "lstm"))
    log_profiled_steps("lstm", device_ms_by_kernel(prof), wall_ms)
    lstm_alone(torch)
    return 0


def lstm_alone(torch) -> None:
    """The imported tree's lstm_fwd alone (no gradients, no cs buffer, as
    serving calls it) and lstm_bwd alone at H = 64 and WIDE_HIDDEN, B = 20
    and 4096, T=24: the forward's max abs error against that tree's plain
    version, milliseconds a call by CUDA events (median of 10 after 3 warm
    calls; the backward at B = 4096 and H >= 512 median of 3) and each
    one's kernels' profiled device milliseconds a call."""
    from tpuflow_torch.kernels.lstm import lstm_scan, lstm_scan_backward, lstm_scan_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    for Hn in (H, *WIDE_HIDDEN):
        for B in (TRAIN_BATCH, 4096):
            xw = torch.randn((T, B, 4 * Hn), generator=gen, device=dev)
            wh = torch.randn((Hn, 4 * Hn), generator=gen, device=dev) / Hn ** 0.5
            b = torch.randn(4 * Hn, generator=gen, device=dev) * 0.1
            err = (lstm_scan(xw, wh, b) - lstm_scan_reference(xw, wh, b)[0]).abs().max().item()
            ms = cuda_ms(torch, lambda: lstm_scan(xw, wh, b), runs=10)
            by_kernel = profiled_ms(torch, lambda: lstm_scan(xw, wh, b))
            device_ms = sum(v for k, v in by_kernel.items() if "lstm_fwd" in k)
            log(f"[steps] lstm_fwd alone H={Hn} B={B:5d}: kernel_ms={ms:.4f} "
                f"device_ms={device_ms:.4f} max_abs_err={err:.3e}")
            cs = torch.empty((T, B, Hn), device=dev)
            hs = lstm_scan(xw, wh, b, cs_out=cs)
            dhs = torch.randn((T, B, Hn), generator=gen, device=dev)
            big = Hn * B >= 512 * 4096
            ms = cuda_ms(torch, lambda: lstm_scan_backward(xw, wh, b, hs, cs, dhs),
                         runs=3 if big else 10)
            by_kernel = profiled_ms(torch, lambda: lstm_scan_backward(xw, wh, b, hs, cs, dhs),
                                    runs=3 if big else 10)
            device_ms = sum(v for k, v in by_kernel.items() if "lstm_bwd" in k)
            log(f"[steps] lstm_bwd alone H={Hn} B={B:5d}: kernel_ms={ms:.4f} "
                f"device_ms={device_ms:.4f}")


def flash_loss_steps(root: str) -> int:
    """``--flash-loss-steps ROOT``: in the tree at ROOT, profiled windows of
    20 LSTM-64 and 20 attention train steps (device launches a step and
    device ms by kernel), the loss's forward and backward alone at the
    train shape, then that tree's flash_fwd, flash_dq, flash_dkv and
    mae_clip kernels alone; for comparing two trees in turns on one card."""
    torch = _tree(root)
    if torch is None:
        return 1
    from tpuflow_torch.core.losses import CLIP_VALUE, mae_clip
    from tpuflow_torch.kernels import losses as loss_kernels
    from tpuflow_torch.kernels.attention import (
        flash_attention_dkv,
        flash_attention_dq,
        flash_attention_forward,
    )

    for model_name in ("lstm", "attention"):
        prof, wall_ms = _profiled_steps(torch, _train_steps(torch, model_name))
        by_kernel = device_ms_by_kernel(prof)
        launches = device_launches(prof)
        log_profiled_steps(model_name, by_kernel, wall_ms)
        log(f"[steps] {model_name:12s} device launches a step: "
            f"{sum(launches.values()) / 20:.2f} ("
            + "; ".join(f"{k[:50]}={n / 20:g}" for k, n in
                        sorted(launches.items(), key=lambda kv: -kv[1]))
            + ")")

    # The loss alone at the train shape: host time of forward and backward
    # (200 calls ending in a synchronise) and what they launch.
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    y = torch.randn((TRAIN_BATCH, T), generator=gen, device=dev)
    pred = torch.randn((TRAIN_BATCH, T), generator=gen, device=dev).requires_grad_()

    def loss_calls(k):
        for _ in range(k):
            torch.autograd.grad(mae_clip(y, pred), pred)

    per_call = []
    for _ in range(5):
        loss_calls(20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_calls(200)
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) / 200 * 1e6)
    prof, _ = _profiled_steps(torch, loss_calls)
    launches = device_launches(prof)
    log(f"[steps] loss forward+backward at [{TRAIN_BATCH}, {T}]: host_us_per_call median "
        f"{statistics.median(per_call):.1f} (runs {', '.join(f'{u:.1f}' for u in per_call)}; "
        f"200 calls ending in a synchronise); device launches a call "
        f"{sum(launches.values()) / 20:g} ("
        + "; ".join(f"{k[:50]}={n / 20:g}" for k, n in launches.items()) + ")")

    gen = torch.Generator(device=dev).manual_seed(3)
    for BH, Tn, D in FLASH_SHAPES:
        q, k, v, do = (torch.randn((BH, Tn, D), generator=gen, device=dev) for _ in range(4))
        ms = cuda_ms(torch, lambda: flash_attention_forward(q, k, v))
        device_ms = sum(profiled_ms(torch, lambda: flash_attention_forward(q, k, v)).values())
        log(f"[steps] flash_fwd alone {(BH, Tn, D)}: kernel_ms={ms:.4f} "
            f"device_ms={device_ms:.4f}")
        # The backward pair alone, on the forward's lse and delta: device
        # time as the median of three profiler windows of 20 calls (a window
        # can drop kernels, PERF.md section 7), with the kernels each saw.
        o, lse = flash_attention_forward(q, k, v)
        delta = (do * o).sum(-1)
        for name, fn in (
                ("flash_dq", lambda: flash_attention_dq(q, k, v, do, lse, delta)),
                ("flash_dkv", lambda: flash_attention_dkv(q, k, v, do, lse, delta))):
            ms = cuda_ms(torch, fn)
            windows = [profiled_ms(torch, fn, runs=20) for _ in range(3)]
            device = [sum(w.values()) for w in windows]
            log(f"[steps] {name} alone {(BH, Tn, D)}: kernel_ms={ms:.4f} "
                f"device_ms={statistics.median(device):.4f} (windows "
                + ", ".join(f"{d:.4f}" for d in device) + "; kernels "
                + ", ".join(str(len(w)) for w in windows) + ")")
    grad = getattr(loss_kernels, "mae_clip_grad", None)
    for R, N in MAE_SHAPES:
        yt, yp = (torch.randn((R, N), generator=gen, device=dev) * 5 for _ in range(2))
        ms = cuda_ms(torch, lambda: loss_kernels.mae_clip_rows(yt, yp, CLIP_VALUE))
        by_kernel = profiled_ms(torch, lambda: loss_kernels.mae_clip_rows(yt, yp, CLIP_VALUE))
        line = (f"[steps] mae_clip alone [{R}, {N}]: kernel_ms={ms:.4f} "
                f"device_ms={sum(by_kernel.values()):.4f} kernels={len(by_kernel)}")
        if grad is not None:
            g = torch.ones((), device=dev)
            line += (f"; mae_clip_grad kernel_ms="
                     f"{cuda_ms(torch, lambda: grad(yt, yp, g, CLIP_VALUE)):.4f} device_ms="
                     f"{sum(profiled_ms(torch, lambda: grad(yt, yp, g, CLIP_VALUE)).values()):.4f}")
        log(line)
    return 0


def ring_steps(root: str) -> int:
    """``--ring-steps ROOT``: that tree's ring_round_fwd and ring_round_bwd
    alone at each of RING_SHAPES and RING_PATTERNS, on seeded inputs, by
    CUDA events and profiled device time (the median of three profiler
    windows of 20 calls, with the kernels each window saw), beside the f32
    and 3xTF32 bounds; for comparing two trees in turns on one card."""
    torch = _tree(root, ["ring_round"])
    if torch is None:
        return 1
    from tpuflow_torch.kernels.attention import ring_round_bwd, ring_round_fwd

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(12)
    for BH, Tl, D in RING_SHAPES:
        fwd_in, bwd_in = ring_round_inputs(torch, gen, BH, Tl, D)
        for pattern, (qo, ko) in RING_PATTERNS.items():
            q_off, k_off = qo * Tl, ko * Tl
            pairs = ring_pairs(Tl, q_off, k_off)
            offs = (q_off, k_off, D ** -0.5)
            for name, fn, bound, tc_bound in (
                    ("ring_round_fwd", lambda: ring_round_fwd(*fwd_in, *offs),
                     ring_fwd_bound, ring_fwd_tc_bound),
                    ("ring_round_bwd", lambda: ring_round_bwd(*bwd_in, *offs),
                     ring_bwd_bound, ring_bwd_tc_bound)):
                ms = cuda_ms(torch, fn)
                windows = [profiled_ms(torch, fn, runs=20) for _ in range(3)]
                device = [sum(t for n, t in w.items() if "ring_round" in n) for w in windows]
                f32_ms, f32_by = bound(BH, Tl, D, pairs)
                tc_ms, tc_by = tc_bound(BH, Tl, D, pairs)
                log(f"[steps] {name} alone {(BH, Tl, D)} {pattern:8s}: kernel_ms={ms:.4f} "
                    f"device_ms={statistics.median(device):.4f} (windows "
                    + ", ".join(f"{d:.4f}" for d in device) + "; kernels "
                    + ", ".join(str(len(w)) for w in windows)
                    + f") bound_ms={f32_ms:.6f} ({f32_by}) "
                    f"3xTF32 bound_ms={tc_ms:.6f} ({tc_by})")
    return 0


def _ring_batch() -> tuple[np.ndarray, np.ndarray]:
    """The gradient phase's batch: 20 windows of RING_WINDOW steps, 5
    features, and their targets, from a seed."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((TRAIN_BATCH, RING_WINDOW, len(FEATURES))).astype(np.float32)
    return x, rng.standard_normal((TRAIN_BATCH, RING_WINDOW)).astype(np.float32)


def _loss_and_grads(torch, backend: str, device, mesh=None):
    """One batch through the attention regressor at flax's defaults and
    RING_WINDOW, params from a seed: ``(loss, predictions, {name: grad})``."""
    from tpuflow_torch.core.losses import mae_clip
    from tpuflow_torch.models import build_model

    model = build_model("attention", len(FEATURES), window=RING_WINDOW, backend=backend,
                        mesh=mesh)
    model.reset_parameters(torch.Generator().manual_seed(7))
    model.to(device)
    x, y = (torch.from_numpy(a).to(device) for a in _ring_batch())
    pred = model(x)
    loss = mae_clip(y, pred)
    loss.backward()
    grads = {n: p.grad.detach().cpu().numpy() for n, p in model.named_parameters()}
    return loss.item(), pred.detach().cpu().numpy(), grads


def _ring_train_config(root: str, mesh=None):
    from tpuflow_torch.api.config import TrainJobConfig

    kwargs = {} if mesh is None else {"backend": "ring", "mesh": mesh}
    return TrainJobConfig(model="attention", max_epochs=1, window=RING_TRAIN_WINDOW,
                          verbose=False, storage_path=os.path.join(root, "ring"),
                          model_kwargs=kwargs)


def ring_ranks(mesh, root: str) -> dict:
    """One rank's part of the ring phase, run by every rank together:
    gradients of one batch, ``train(config)`` with the ring, the split of a
    steady ring train step, and the SP ring's forward. Returns numpy
    results for the parent to hold against its single-card references."""
    import torch

    from tpuflow_torch.api import predict_api
    from tpuflow_torch.api.train_api import train
    from tpuflow_torch.kernels import KERNELS
    from tpuflow_torch.storage.checkpoint import StoreCheckpointer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device)}

    def counts():
        return {n: k.launches for n, k in KERNELS.items()}

    for k in KERNELS.values():
        k.launches = 0
    loss, pred, grads = _loss_and_grads(torch, "ring", mesh.device, mesh)
    torch.cuda.synchronize()
    out["grads"] = {"loss": loss, "pred": pred, "grads": grads, "launches": counts()}

    # Count each rank's artifact writes: only rank 0 may write.
    writes = {"checkpoints": 0, "sidecars": 0}
    save, meta = StoreCheckpointer.maybe_save, predict_api.save_artifact_meta

    def counted_save(self, *a, **kw):
        writes["checkpoints"] += 1
        return save(self, *a, **kw)

    def counted_meta(*a, **kw):
        writes["sidecars"] += 1
        return meta(*a, **kw)

    StoreCheckpointer.maybe_save, predict_api.save_artifact_meta = counted_save, counted_meta
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    report = train(_ring_train_config(root, mesh))
    torch.cuda.synchronize()
    out["train"] = {
        "seconds": time.perf_counter() - t0, "launches": counts(), "writes": writes,
        "history": report.result.history, "test_loss": report.test_loss,
        "test_mae": report.test_mae, "gilbert_mae": report.gilbert_mae,
        "params": {n: p.detach().cpu().numpy()
                   for n, p in report.result.model.named_parameters()},
    }
    out["split"] = _ring_step_split(torch, mesh, report.result.model)
    out["sp"] = _rank_sp(torch, mesh)
    return out


def _ring_step_split(torch, mesh, model) -> dict:
    """Where a steady ring train step goes (batch 20, window 256): host
    clock over 20 steps ending in a synchronise, one profiled window of 5
    steps for device time by kernel, and the ring's communication timed on
    its own at the step's shapes, 20 times each: a rotation of (k, v), one
    of (k, v, dk, dv), the output's all-gather and the input gradients'
    all-gather. Every rank runs it; rank 0's numbers are reported."""
    from torch.profiler import ProfilerActivity, profile

    from tpuflow_torch.core.losses import mae_clip
    from tpuflow_torch.parallel.collectives import _gather, rotate
    from tpuflow_torch.train.optim import keras_sgd
    from tpuflow_torch.train.steps import make_train_step

    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, RING_TRAIN_WINDOW, len(FEATURES))).astype(np.float32)).to(mesh.device)
    y = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, RING_TRAIN_WINDOW)).astype(np.float32)).to(mesh.device)
    step = make_train_step(model, keras_sgd().bind(model.parameters()), mae_clip)
    for _ in range(3):
        step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step(x, y)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 20 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = device_ms_by_kernel(prof)
    ring_ms = sum(v for k, v in by_kernel.items() if "ring_round" in k)

    heads, dim = 4, 64
    Tl = RING_TRAIN_WINDOW // mesh.size
    chunk = torch.randn((TRAIN_BATCH * heads, Tl, dim // heads), device=mesh.device)
    flat = torch.randn(3 * chunk.numel(), device=mesh.device)

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    comm = {
        "rotate_kv_ms": timed(lambda: rotate((chunk, chunk), mesh)),
        "rotate_kv_dkdv_ms": timed(lambda: rotate((chunk, chunk, chunk, chunk), mesh)),
        "gather_out_ms": timed(lambda: _gather(chunk, mesh, 1)),
        "gather_grads_ms": timed(lambda: _gather(flat, mesh, 0)),
    }
    n, layers = mesh.size, LAYERS["attention"]
    # Per train step: each layer's forward rotates (k, v) n - 1 times and
    # gathers its output once; its backward rotates (k, v, dk, dv) n - 1
    # times, (dk, dv) once more, and gathers the q, k, v gradients once.
    per_step = {"rotate_kv": layers * (n - 1 + 1), "rotate_kv_dkdv": layers * (n - 1),
                "gather_out": layers, "gather_grads": layers}
    comm_ms = (per_step["rotate_kv"] * comm["rotate_kv_ms"]
               + per_step["rotate_kv_dkdv"] * comm["rotate_kv_dkdv_ms"]
               + per_step["gather_out"] * comm["gather_out_ms"]
               + per_step["gather_grads"] * comm["gather_grads_ms"])
    return {"step_ms": step_ms, "profiled_wall_ms_5": wall_ms,
            "device_busy_ms_5": sum(by_kernel.values()), "ring_kernels_ms_5": ring_ms,
            "comm_each": comm, "comm_per_step": per_step, "comm_ms_per_step": comm_ms}


def _sp_case(torch, device):
    """The SP phase's LSTM-64 layer (params from a seed) and input
    ``[20, RING_WINDOW, 5]``."""
    from tpuflow_torch.models.lstm import LSTMLayer

    layer = LSTMLayer(len(FEATURES), H)
    layer.reset_parameters(torch.Generator().manual_seed(3))
    layer.to(device)
    x = np.random.default_rng(13).standard_normal(
        (TRAIN_BATCH, RING_WINDOW, len(FEATURES))).astype(np.float32)
    return layer, torch.from_numpy(x).to(device)


def _rank_sp(torch, mesh) -> np.ndarray:
    from tpuflow_torch.parallel import make_sp_forward

    layer, x = _sp_case(torch, mesh.device)
    with torch.no_grad():
        y = make_sp_forward(mesh, H)(layer.w_x, layer.w_h, layer.b, x)
    return y.cpu().numpy()


def phase_ring(torch, root: str, smi: str, single_mae: float) -> dict:
    """The ring on RING_RANKS ranks against single-card references in this
    process; returns rank 0's kernel launches in the ring training."""
    from tpuflow_torch.api.config import TrainJobConfig
    from tpuflow_torch.kernels import KERNELS
    from tpuflow_torch.parallel import spawn
    from tpuflow_torch.parallel.distributed import default_backend

    backend = default_backend(RING_RANKS)
    where = ("each rank on a card of its own" if backend == "nccl" else
             "all ranks on cuda:0, the ring's tensors staged through host memory")
    log(f"[ring] {RING_RANKS} ranks over {backend}: {where} "
        f"({torch.cuda.device_count()} card(s); card: {smi})")
    t0 = time.perf_counter()
    ranks = spawn(ring_ranks, RING_RANKS, root, timeout_s=RING_TIMEOUT_S)
    log(f"[ring] ranks done in {time.perf_counter() - t0:.1f} s (spawn included): "
        + ", ".join(f"rank {r['rank']} {r['backend']} {r['device']}" for r in ranks))

    # 1. One batch's loss and gradients against backend="flash" here.
    for k in KERNELS.values():
        k.launches = 0
    loss, pred, grads = _loss_and_grads(torch, "flash", torch.device("cuda"))
    for r in ranks[1:]:
        got = r["grads"]
        if not (np.array_equal(got["pred"], ranks[0]["grads"]["pred"]) and all(
                np.array_equal(got["grads"][n], ranks[0]["grads"]["grads"][n]) for n in grads)):
            raise AssertionError(f"ring rank {r['rank']}'s outputs or gradients differ "
                                 "from rank 0's")
    g0 = ranks[0]["grads"]
    errs = {n: float(np.abs(g0["grads"][n] - g).max() / max(np.abs(g).max(), 1e-30))
            for n, g in grads.items()}
    loss_err = abs(g0["loss"] - loss) / abs(loss)
    pred_err = float(np.abs(g0["pred"] - pred).max() / np.abs(pred).max())
    log(f"[ring] window {RING_WINDOW}, batch {TRAIN_BATCH}, backend ring vs flash: loss "
        f"{g0['loss']:.6f} vs {loss:.6f} (rel err {loss_err:.2e}), predictions normwise "
        f"{pred_err:.2e}, gradients normwise " + ", ".join(f"{n}={e:.2e}" for n, e in errs.items())
        + f" (tolerance {RING_GRAD_TOL}); all {RING_RANKS} ranks bitwise equal; rank 0 "
        f"launches {g0['launches']}")
    bad = {n: e for n, e in errs.items() if not e <= RING_GRAD_TOL}
    if bad or not loss_err <= RING_GRAD_TOL or not pred_err <= RING_GRAD_TOL:
        raise AssertionError(f"ring gradients disagree with the flash path: {bad}, "
                             f"loss {loss_err:.2e}, predictions {pred_err:.2e}")
    layers, n = LAYERS["attention"], RING_RANKS
    want = {**dict.fromkeys(KERNELS, 0), "mae_clip": 1, "mae_clip_grad": 1,
            "ring_round_fwd": layers * n, "ring_round_bwd": layers * n}
    for r in ranks:
        if r["grads"]["launches"] != want:
            raise AssertionError(f"ring rank {r['rank']} launches {r['grads']['launches']} "
                                 f"!= {want}")

    # 2. train(config) with the ring on every rank.
    plain_config = TrainJobConfig(model="attention", max_epochs=1, window=RING_TRAIN_WINDOW)
    want, sizes = expected_train_launches(plain_config)
    want["ring_round_fwd"], want["ring_round_bwd"] = want["flash_fwd"] * n, want["flash_dq"] * n
    want["flash_fwd"] = want["flash_dq"] = want["flash_dkv"] = 0
    t0 = ranks[0]["train"]
    for h in t0["history"]:
        log(f"[ring] train epoch {h['epoch']}: loss={h['loss']:.6f} "
            f"val_loss={h['val_loss']:.6f} time_s={h['time']:.3f}")
    log(f"[ring] train at window {RING_TRAIN_WINDOW}, 1 epoch, {t0['seconds']:.2f} s on rank 0; "
        f"data {sizes}; test_loss={t0['test_loss']:.6f} test_mae={t0['test_mae']:.2f} "
        f"gilbert_mae={t0['gilbert_mae']:.2f} stb/day; single-card run {single_mae:.2f} "
        f"(tolerance {RING_MAE_REL:.0%}); launches {t0['launches']}, expected {want}; "
        "writes " + ", ".join(f"rank {r['rank']} {r['train']['writes']}" for r in ranks))
    for r in ranks:
        tr = r["train"]
        if tr["launches"] != want:
            raise AssertionError(f"ring train rank {r['rank']}: launches {tr['launches']} != {want}")
        if not (np.isfinite([[h["loss"], h["val_loss"]] for h in tr["history"]]).all()
                and np.isfinite(tr["test_loss"])):
            raise AssertionError(f"ring train rank {r['rank']}: non-finite losses")
        if any(not np.array_equal(tr["params"][p], t0["params"][p]) for p in t0["params"]):
            raise AssertionError(f"ring train rank {r['rank']}: final parameters differ from "
                                 "rank 0's")
        wrote = tr["writes"]["checkpoints"] + tr["writes"]["sidecars"]
        if (r["rank"] == 0) != (wrote > 0):
            raise AssertionError(f"ring train rank {r['rank']} wrote {tr['writes']}: only "
                                 "rank 0 may write the artifact")
    if not abs(t0["test_mae"] - single_mae) <= RING_MAE_REL * single_mae:
        raise AssertionError(f"ring-trained test MAE {t0['test_mae']:.2f} is not within "
                             f"{RING_MAE_REL:.0%} of the single-card {single_mae:.2f}")
    if not t0["test_mae"] < t0["gilbert_mae"]:
        raise AssertionError("the ring-trained model does not beat the Gilbert baseline")
    with open(os.path.join(root, "ring", "meta", "attention.json")) as f:
        sidecar = json.load(f)["model_kwargs"]
    if sidecar.get("backend") != "full" or "mesh" in sidecar:
        raise AssertionError(f"ring artifact's sidecar kwargs {sidecar}")
    log(f"[ring] the artifact's sidecar model_kwargs: {sidecar}")

    # 3. Where a steady ring train step goes (rank 0).
    sp = ranks[0]["split"]
    log(f"[ring] steady ring train step, batch {TRAIN_BATCH}, window {RING_TRAIN_WINDOW}: "
        f"{sp['step_ms']:.3f} ms (host clock over 20 steps); profiled 5 steps: "
        f"wall_ms={sp['profiled_wall_ms_5']:.3f} device_busy_ms={sp['device_busy_ms_5']:.3f} "
        f"ring_kernels_ms={sp['ring_kernels_ms_5']:.3f}; communication alone, median of 20: "
        + ", ".join(f"{k}={v:.3f}" for k, v in sp["comm_each"].items())
        + f", per step {sp['comm_per_step']} = {sp['comm_ms_per_step']:.3f} ms "
        f"({ranks[0]['backend']}; card: {smi})")

    # 4. The SP ring against lstm_scan's kernel.
    layer, x = _sp_case(torch, torch.device("cuda"))
    with torch.no_grad():
        want_y = layer(x).cpu().numpy()
    errs = [float(np.abs(r["sp"] - want_y).max()) for r in ranks]
    log(f"[ring] SP LSTM ring (make_sp_forward, H={H}) at B={TRAIN_BATCH}, T={RING_WINDOW} "
        f"vs lstm_scan: max abs err by rank {[f'{e:.2e}' for e in errs]} (tolerance {SP_ATOL})")
    if max(errs) > SP_ATOL:
        raise AssertionError(f"the SP ring disagrees with lstm_scan: {errs}")
    return t0["launches"]


def _columns(n_wells: int, steps: int, seed: int, well_ids: bool) -> dict:
    from tpuflow_torch.data.synthetic import generate_wells, wells_to_table

    cols = wells_to_table(generate_wells(n_wells=n_wells, steps=steps, seed=seed))
    if well_ids:
        cols["well"] = np.repeat([f"s{seed}w{i}" for i in range(n_wells)], steps)
    return cols


def _post(url: str, spec: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        url, data=json.dumps(spec).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def phase_serve(torch, root: str, smi: str) -> dict:
    """Serve the trained artifacts in ``root`` and the ring-trained one in
    ``root/ring`` (no well column in their sidecars: each request is one
    series) and three with random weights (well column "well") over HTTP;
    returns each kernel's launches over the serving run."""
    from tpuflow_torch.api.predict_api import save_artifact_meta
    from tpuflow_torch.convert import model_leaves
    from tpuflow_torch.data.synthetic import write_csv
    from tpuflow_torch.kernels import KERNELS
    from tpuflow_torch.models import build_model
    from tpuflow_torch.serve import make_server
    from tpuflow_torch.storage.checkpoint import StoreCheckpointer

    ref = _columns(8, 512, 0, well_ids=False)
    series = np.stack([ref[n] for n in FEATURES], axis=1)
    pre = {
        "feature_names": FEATURES, "window": T, "stride": 1,
        "well_column": "well", "append_gilbert": False,
        "mean": series.mean(axis=0).tolist(), "std": series.std(axis=0).tolist(),
        "target_mean": float(ref["flow"].mean()),
        "target_std": float(ref["flow"].std()),
        "schema_columns": [{"name": n, "kind": k} for n, k in SCHEMA],
        "target": "flow",
    }
    # (name, family, grouped by well, storage root, window)
    random_artifacts = [("lstm64", "lstm", True, root, T),
                        ("stacked", "stacked_lstm", True, root, T),
                        ("attn", "attention", True, root, T)]
    for seed, (name, model_name, *_) in enumerate(random_artifacts):
        model = build_model(model_name, len(FEATURES), window=T)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        StoreCheckpointer(root, name).maybe_save(1, model_leaves(model), val_loss=0.0)
        save_artifact_meta(root, name, model_name, {}, "windowed", pre,
                           (8 * (512 - T + 1), T, len(FEATURES)))

    csv_cols = _columns(2, 300, 4, well_ids=True)
    csv_path = os.path.join(root, "two_wells.csv")
    write_csv(csv_path, csv_cols, [n for n, _ in SCHEMA if n != "flow"])
    requests = [  # (label, payload, columns, windows grouped by well)
        ("8 wells + well column", "columns", _columns(8, 512, 1, True), 8 * 489),
        ("one well", "columns", _columns(1, 512, 2, False), 489),
        ("ragged tail, 11 wells", "columns", _columns(11, 512, 3, True), 11 * 489),
        ("csv path, 2 wells", "data", csv_cols, 2 * 277),
    ]
    trained = [("lstm", "lstm", False, root, T),
               ("stacked_lstm", "stacked_lstm", False, root, T),
               ("attention", "attention", False, root, T),
               ("attention", "attention", False, os.path.join(root, "ring"), RING_TRAIN_WINDOW)]
    artifacts = trained + random_artifacts

    server = make_server("127.0.0.1", 0)  # device left at its default: cuda
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    answers = []
    try:
        log(f"[serve] port server on {url} ({server.predictor.device}); card: {smi}")
        for k in KERNELS.values():
            k.launches = 0
        for name, model_name, grouped, store, window in artifacts:
            forward_kernel = KERNELS[FORWARD_KERNEL[model_name]]
            layers = LAYERS[model_name]
            label_name = name if store == root else "ring-trained"
            for label, kind, cols, windows in requests:
                if not grouped:
                    if kind == "data":  # the CSV's well column is not in its schema
                        continue
                    windows = len(cols["pressure"]) - window + 1
                spec = {"storagePath": store, "model": name}
                if kind == "data":
                    spec["data"] = csv_path
                else:
                    spec["columns"] = {c: v.tolist() for c, v in cols.items()}
                before = forward_kernel.launches
                t0 = time.perf_counter()
                status, body = _post(url, spec)
                seconds = time.perf_counter() - t0
                launched = forward_kernel.launches - before
                chunks = -(-windows // BATCH)
                rows = len(cols["pressure"])
                log(f"[serve] {label_name:12s} {label:22s} status={status} "
                    f"windows={body.get('count')} latency_ms={seconds * 1e3:.1f} "
                    f"rows/s={rows / seconds:.0f} windows/s={windows / seconds:.0f} "
                    f"launches={launched} (card: {smi})")
                if status != 200:
                    raise AssertionError(f"{model_name} {label}: HTTP {status} {body}")
                if "degraded" in body:
                    raise AssertionError(f"{model_name} {label}: degraded answer")
                y = np.asarray(body["predictions"], np.float64)
                if body["count"] != windows or y.shape != (windows, window):
                    raise AssertionError(
                        f"{model_name} {label}: count {body['count']}, shape "
                        f"{y.shape}; expected {windows} windows of {window} steps")
                if not np.isfinite(y).all():
                    raise AssertionError(f"{model_name} {label}: non-finite predictions")
                if launched != layers * chunks:
                    raise AssertionError(
                        f"{model_name} {label}: {launched} {FORWARD_KERNEL[model_name]} "
                        f"launches, expected layers x chunks = {layers} x {chunks}")
                answers.append((name, label_name, store, label, kind, cols, y))
        launches = {name: k.launches for name, k in KERNELS.items()}
        metrics = server.predictor.metrics()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"[serve] kernel launches over the serving run: {launches}; "
        f"service metrics: requests={metrics['requests']} errors={metrics['errors']} "
        f"loads={metrics['loads']} latency_ms={metrics['latency_ms']}")
    if metrics["errors"] or metrics["requests"] != len(answers):
        raise AssertionError(f"service counted {metrics}")

    # The same Predictor's plain path on the card (after the counted run).
    for name, label_name, store, label, kind, cols, y in answers:
        pred = server.predictor.get_predictor(store, name)
        atol = PRED_ATOL_NORM * pred._meta["preprocessor"]["target_std"]
        if kind == "data":
            cols = pred.columns_from_csv(csv_path)
        x, _ = pred.prepare_columns(cols)
        plain = pred.forward_prepared(x, plain=True)
        err = float(np.abs(plain - y).max())
        log(f"[serve] {label_name:12s} {label:22s} served vs plain path: max abs "
            f"err {err:.3e} (tolerance {atol:.3e} = {PRED_ATOL_NORM} x target_std)")
        if err > atol:
            raise AssertionError(f"{label_name} {label}: served predictions "
                                 f"disagree with the plain path ({err:.3e})")
    phase_breakdown(torch, server.predictor, root, requests[0][2], random_artifacts, smi)
    return launches


def phase_breakdown(torch, service, root, cols, artifacts, smi) -> None:
    """Where a warm request's time goes, in process (after the counted run):
    host-clock medians of its three stages, then one profiled forward for
    device time by kernel and the device's idle share of that window."""
    from torch.profiler import ProfilerActivity, profile

    for name, model_name, *_ in artifacts:
        pred = service.get_predictor(root, name)
        stages = {"prepare_ms": [], "forward_ms": [], "encode_ms": []}
        for _ in range(5):
            t0 = time.perf_counter()
            x, _ = pred.prepare_columns(cols)
            t1 = time.perf_counter()
            y = pred.forward_prepared(x)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            json.dumps({"predictions": y.tolist(), "count": len(y)})
            t3 = time.perf_counter()
            for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
                stages[key].append(dt * 1e3)
        medians = {k: round(statistics.median(v), 3) for k, v in stages.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pred.forward_prepared(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = device_ms_by_kernel(prof)
        busy_ms = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        log(f"[breakdown] {model_name:12s} {len(x)} windows, warm, median of 5: "
            f"{medians} (card: {smi})")
        idle = f"{1 - busy_ms / wall_ms:.3f}" if busy_ms else "not measured"
        log(f"[breakdown] {model_name:12s} profiled forward: wall_ms={wall_ms:.3f} "
            f"device_busy_ms={busy_ms:.3f} idle_share={idle}; by kernel (ms): "
            + "; ".join(f"{k[:60]}={v:.4f}" for k, v in top))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1
    import tpuflow_torch  # noqa: F401 — fails here when run outside the repo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log(f"[device] nvidia-smi: {smi}; torch: {torch.cuda.get_device_name(0)}; "
        f"count {torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for matmul and cuDNN")
    phase_build()
    records = phase_kernels(torch)
    with tempfile.TemporaryDirectory(prefix="tpuflow_torch_smoke_") as root:
        launches, mae_256 = phase_train(torch, root, smi)
        ring_launches = phase_ring(torch, root, smi, mae_256)
        serve_launches = phase_serve(torch, root, smi)
    missed = [k for k in ("lstm_fwd", "flash_fwd") if serve_launches[k] == 0]
    if missed:
        raise AssertionError(f"not launched on the serving path: {missed}")
    for name in ("ring_round_fwd", "ring_round_bwd"):
        launches[name] = ring_launches[name]
    missed = [k for k, n in launches.items() if n == 0]
    if missed:
        raise AssertionError(f"not launched on the training paths: {missed}")
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"tpuflow_torch/kernels/csrc/{source}.cu", "replaces": replaces,
         "launches": launches[name], **records[name]}
        for name, source, replaces in (
            ("lstm_fwd", "lstm_fwd", "tpuflow/kernels/lstm.py:68"),
            ("lstm_bwd", "lstm_bwd", "tpuflow/kernels/lstm.py:97"),
            ("mae_clip", "mae_clip", "tpuflow/kernels/losses.py:33"),
            ("mae_clip_grad", "mae_clip", "tpuflow/kernels/losses.py:99"),
            ("flash_fwd", "flash_fwd", "tpuflow/kernels/attention.py:208"),
            ("flash_dq", "flash_bwd", "tpuflow/kernels/attention.py:255"),
            ("flash_dkv", "flash_bwd", "tpuflow/kernels/attention.py:284"),
            ("ring_round_fwd", "ring_round", "tpuflow/kernels/attention.py:483"),
            ("ring_round_bwd", "ring_round", "tpuflow/kernels/attention.py:562"),
        )
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lstm-steps"]:
        sys.exit(lstm_steps(sys.argv[2]))
    if sys.argv[1:2] == ["--flash-loss-steps"]:
        sys.exit(flash_loss_steps(sys.argv[2]))
    if sys.argv[1:2] == ["--ring-steps"]:
        sys.exit(ring_steps(sys.argv[2]))
    sys.exit(main())
