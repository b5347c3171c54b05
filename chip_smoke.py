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
   the shapes the serving path gives it, with CUDA-event timings of the
   kernel, the plain version and one library call as a yardstick.
4. serve   — an LSTM-64 and a stacked-LSTM artifact (random weights from a
   seed, written by the port's checkpoint writer) served over
   ``POST /predict`` by the port's HTTP server on the default device; each
   answer is checked for status, count, finite values, agreement with the
   same predictor's plain path, and the kernel launches it caused.
5. breakdown — after the counted run, where one warm 3912-window request's
   time goes: host-clock stages and one ``torch.profiler`` window.

The line before last is ``nvidia-smi``'s name and power limit, the one
before it the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``tpuflow``.
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
# H100 SXM data sheet: HBM rate and the f32 rate
# of the CUDA cores, which the f32 kernel uses.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Kernel vs plain on the card, f32: the two sum h @ W_h in other orders and
# use other exp/tanh code; over 24 dependent steps that stays within a few
# ulp of values of order 1, far inside 1e-5.
KERNEL_ATOL = KERNEL_RTOL = 1e-5
# Served predictions vs the plain path, in normalised target units (they are
# compared after denormalisation, so scaled by target_std).
PRED_ATOL_NORM = 1e-5


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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    """lstm_fwd against lstm_scan_reference at T=24, H=64, B in {1, 37, 4096};
    returns the record of the serving shape, B=4096."""
    from tpuflow_torch.kernels.lstm import lstm_scan, lstm_scan_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    log(f"[kernel] lstm_fwd vs lstm_scan_reference: f32, T={T}, H={H}; "
        f"tolerance atol={KERNEL_ATOL} rtol={KERNEL_RTOL} (other summation "
        "order and exp/tanh code over 24 dependent steps)")
    worst, record = 0.0, None
    for B in (1, 37, 4096):
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
        # Yardstick only, never called by the port: cuDNN's LSTM on the same
        # xw with an identity input projection and W_hh = W_h^T computes the
        # same function (projection plus recurrence).
        lib = torch.nn.LSTM(4 * H, H).to(dev)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(torch.eye(4 * H, device=dev))
            lib.weight_hh_l0.copy_(wh.t())
            lib.bias_ih_l0.copy_(b)
            lib.bias_hh_l0.zero_()
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


def phase_serve(torch, root: str, smi: str) -> int:
    """Serve both artifacts over HTTP; returns lstm_fwd's launches."""
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
    artifacts = [("lstm64", "lstm", 1), ("stacked", "stacked_lstm", 2)]
    for seed, (name, model_name, _) in enumerate(artifacts):
        model = build_model(model_name, len(FEATURES))
        model.reset_parameters(torch.Generator().manual_seed(seed))
        StoreCheckpointer(root, name).maybe_save(1, model_leaves(model), val_loss=0.0)
        save_artifact_meta(root, name, model_name, {}, "windowed", pre,
                           (8 * (512 - T + 1), T, len(FEATURES)))

    csv_cols = _columns(2, 300, 4, well_ids=True)
    csv_path = os.path.join(root, "two_wells.csv")
    write_csv(csv_path, csv_cols, [n for n, _ in SCHEMA if n != "flow"])
    requests = [  # (label, payload, columns, windows)
        ("8 wells + well column", "columns", _columns(8, 512, 1, True), 8 * 489),
        ("one well", "columns", _columns(1, 512, 2, False), 489),
        ("ragged tail, 11 wells", "columns", _columns(11, 512, 3, True), 11 * 489),
        ("csv path, 2 wells", "data", csv_cols, 2 * 277),
    ]

    server = make_server("127.0.0.1", 0)  # device left at its default: cuda
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    answers = []
    try:
        log(f"[serve] port server on {url} ({server.predictor.device}); card: {smi}")
        for k in KERNELS.values():
            k.launches = 0
        lstm_scan = KERNELS["lstm_fwd"]
        for name, model_name, layers in artifacts:
            for label, kind, cols, windows in requests:
                spec = {"storagePath": root, "model": name}
                if kind == "data":
                    spec["data"] = csv_path
                else:
                    spec["columns"] = {c: v.tolist() for c, v in cols.items()}
                before = lstm_scan.launches
                t0 = time.perf_counter()
                status, body = _post(url, spec)
                seconds = time.perf_counter() - t0
                launched = lstm_scan.launches - before
                chunks = -(-windows // BATCH)
                rows = len(cols["pressure"])
                log(f"[serve] {model_name:12s} {label:22s} status={status} "
                    f"windows={body.get('count')} latency_ms={seconds * 1e3:.1f} "
                    f"rows/s={rows / seconds:.0f} windows/s={windows / seconds:.0f} "
                    f"launches={launched} (card: {smi})")
                if status != 200:
                    raise AssertionError(f"{model_name} {label}: HTTP {status} {body}")
                if "degraded" in body:
                    raise AssertionError(f"{model_name} {label}: degraded answer")
                y = np.asarray(body["predictions"], np.float64)
                if body["count"] != windows or y.shape != (windows, T):
                    raise AssertionError(
                        f"{model_name} {label}: count {body['count']}, shape "
                        f"{y.shape}; expected {windows} windows of {T} steps")
                if not np.isfinite(y).all():
                    raise AssertionError(f"{model_name} {label}: non-finite predictions")
                if launched != layers * chunks:
                    raise AssertionError(
                        f"{model_name} {label}: {launched} kernel launches, "
                        f"expected layers x chunks = {layers} x {chunks}")
                answers.append((name, model_name, label, kind, cols, y))
        launches = lstm_scan.launches
        metrics = server.predictor.metrics()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"[serve] lstm_fwd launches over the serving run: {launches}; "
        f"service metrics: requests={metrics['requests']} errors={metrics['errors']} "
        f"loads={metrics['loads']} latency_ms={metrics['latency_ms']}")
    if metrics["errors"] or metrics["requests"] != len(answers):
        raise AssertionError(f"service counted {metrics}")

    # The same Predictor's plain path on the card (after the counted run).
    atol = PRED_ATOL_NORM * pre["target_std"]
    for name, model_name, label, kind, cols, y in answers:
        pred = server.predictor.get_predictor(root, name)
        if kind == "data":
            cols = pred.columns_from_csv(csv_path)
        x, _ = pred.prepare_columns(cols)
        plain = pred.forward_prepared(x, plain=True)
        err = float(np.abs(plain - y).max())
        log(f"[serve] {model_name:12s} {label:22s} served vs plain path: max abs "
            f"err {err:.3e} (tolerance {atol:.3e} = {PRED_ATOL_NORM} x target_std)")
        if err > atol:
            raise AssertionError(f"{model_name} {label}: served predictions "
                                 f"disagree with the plain path ({err:.3e})")
    phase_breakdown(torch, server.predictor, root, requests[0][2], artifacts, smi)
    return launches


def phase_breakdown(torch, service, root, cols, artifacts, smi) -> None:
    """Where a warm request's time goes, in process (after the counted run):
    host-clock medians of its three stages, then one profiled forward for
    device time by kernel and the device's idle share of that window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, model_name, _ in artifacts:
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
        by_kernel = {}
        for evt in prof.key_averages():  # device-side events only: a CPU op
            us = evt.self_device_time_total  # also reports its kernels' time
            if evt.device_type == DeviceType.CUDA and us > 0:
                by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e3
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
    record = phase_kernels(torch)
    with tempfile.TemporaryDirectory(prefix="tpuflow_torch_smoke_") as root:
        launches = phase_serve(torch, root, smi)
    if launches == 0:
        raise AssertionError("lstm_fwd was not launched on the serving path")
    kernels = [{
        "name": "lstm_fwd",
        "route": "cuda",
        "source": "tpuflow_torch/kernels/csrc/lstm_fwd.cu",
        "replaces": "tpuflow/kernels/lstm.py:68",
        "launches": launches,
        "max_abs_err": record["max_abs_err"],
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"],
        "bound_by": record["bound_by"],
        "library_ms": record["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
