"""Prediction server of the port: ``POST /predict`` over trained artifacts.

Counterpart of the serving half of ``tpuflow/serve.py``, cut to its default
path: a ``PredictService`` with a predictor cache that answers each request
unbatched (``begin_request`` -> ``answer_unbatched`` -> ``finish_response``)
and keeps the JAX service's JSON metric names, and a threaded HTTP server
with ``POST /predict`` (200, 400 for a malformed request, 500 for a failed
load or forward), ``GET /healthz`` and ``GET /metrics``.

The job runner, journal, micro-batching, replicas, autoscaling, Prometheus
exposition, trace IDs and the Gilbert degraded fallback are not ported yet
(ROADMAP.md): a failed artifact load is a 500, never a physics answer.

Run: ``python -m tpuflow_torch.serve --port 8700`` (``--device cpu`` for the
plain PyTorch path on the CPU).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tpuflow_torch import resolve_device


class LatencyStats:
    """Bounded reservoir of recent request latencies (seconds in,
    milliseconds out), with the JAX service's snapshot keys."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._samples: deque[float] = deque(maxlen=window)
        self._count = 0
        self._total = 0.0
        self._max = 0.0

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            self._count += 1
            self._total += seconds
            self._max = max(self._max, seconds)

    def snapshot(self) -> dict:
        with self._lock:
            samples = list(self._samples)
            count, total, worst = self._count, self._total, self._max
        arr = np.asarray(samples, np.float64) * 1000.0
        return {
            "count": count,
            "window": len(samples),
            "p50_ms": round(float(np.percentile(arr, 50)), 3) if samples else None,
            "p99_ms": round(float(np.percentile(arr, 99)), 3) if samples else None,
            "mean_ms": round(total / count * 1000.0, 3) if count else None,
            "max_ms": round(worst * 1000.0, 3) if count else None,
        }


class PredictService:
    """Synchronous serving over trained artifacts, with a ``Predictor``
    cache (a load reads the sidecar and restores params: once per artifact,
    not per request). ``device=None`` serves on the GPU and raises when
    there is none."""

    _COUNTERS = ("requests", "errors", "cache_hits", "loads")

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cache: dict[tuple[str, str], object] = {}
        self._lock = threading.Lock()  # guards the dicts, never held on load
        self._key_locks: dict[tuple[str, str], threading.Lock] = {}
        self._counts = dict.fromkeys(self._COUNTERS, 0)
        self._latency = LatencyStats()

    def _count(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def metrics(self) -> dict:
        with self._lock:
            out = dict(self._counts)
        out["latency_ms"] = self._latency.snapshot()
        out["batching"] = {"enabled": False}
        out["device"] = str(self.device)
        return out

    def get_predictor(self, storage_path: str, name: str):
        """The cached ``Predictor`` for an artifact, loaded on first use
        under a per-artifact lock (other artifacts stay servable)."""
        from tpuflow_torch.api.predict_api import Predictor

        key = (storage_path, name)
        with self._lock:
            cached = self._cache.get(key)
            if cached is not None:
                self._counts["cache_hits"] += 1
                return cached
            key_lock = self._key_locks.setdefault(key, threading.Lock())
        with key_lock:
            with self._lock:
                cached = self._cache.get(key)
                if cached is not None:
                    self._counts["cache_hits"] += 1
                    return cached
            loaded = Predictor.load(storage_path, name, device=self.device)
            with self._lock:
                self._counts["loads"] += 1
                self._cache[key] = loaded
            return loaded

    def predict(self, spec: dict) -> dict:
        """One request, end to end; its wall time is recorded whether it
        succeeds or raises."""
        t0 = time.perf_counter()
        try:
            pred, payload = self.begin_request(spec)
            return self.finish_response(self.answer_unbatched(pred, payload))
        except Exception:
            self._count("errors")
            raise
        finally:
            self._latency.record(time.perf_counter() - t0)

    def begin_request(self, spec: dict):
        """Count the request, validate the spec, resolve the predictor.
        Returns ``(pred, payload)`` with payload ``("data", path)`` or
        ``("columns", {name: array})``; a malformed spec raises ValueError."""
        self._count("requests")
        storage = spec.get("storagePath") or spec.get("storage_path")
        name = spec.get("model") or spec.get("name")
        if not storage or not name:
            raise ValueError("predict needs storagePath and model")
        if "data" in spec:
            payload = ("data", spec["data"])
        elif "columns" in spec:
            columns = spec["columns"]
            if not isinstance(columns, dict):
                raise ValueError("columns must be an object of name -> list")
            payload = ("columns", {k: np.asarray(v) for k, v in columns.items()})
        else:
            raise ValueError("predict needs data (csv path) or columns")
        return self.get_predictor(storage, name), payload

    @staticmethod
    def answer_unbatched(pred, payload):
        """Transform + forward in one blocking call."""
        kind, value = payload
        if kind == "data":
            return pred.predict_csv(value)
        return pred.predict_columns(value)

    @staticmethod
    def finish_response(y) -> dict:
        y = np.asarray(y)
        return {"predictions": y.tolist(), "count": int(len(y))}


def make_server(
    host: str = "127.0.0.1", port: int = 8700, device=None
) -> ThreadingHTTPServer:
    """Build the HTTP server (the caller drives ``serve_forever`` and
    ``shutdown``). ``server.predictor`` is its ``PredictService``."""
    started = time.monotonic()
    service = PredictService(device=device)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _route(self) -> str:
            from urllib.parse import urlsplit

            return urlsplit(self.path).path.rstrip("/")

        def do_GET(self):
            route = self._route()
            if route in ("", "/health", "/healthz"):
                self._send(200, {"status": "ok", "device": str(service.device)})
            elif route == "/metrics":
                self._send(200, {
                    "predict": service.metrics(),
                    "uptime_s": round(time.monotonic() - started, 1),
                })
            else:
                self._send(404, {"error": f"no route {self.path!r}"})

        def do_POST(self):
            if self._route() != "/predict":
                self._send(404, {"error": f"no route {self.path!r}"})
                return
            try:
                length = max(0, int(self.headers.get("Content-Length", 0)))
                spec = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(spec, dict):
                    raise ValueError("request body must be a JSON object")
            except (ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
                return
            try:
                self._send(200, service.predict(spec))
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # missing artifact, failed forward
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    class Server(ThreadingHTTPServer):
        request_queue_size = 128
        daemon_threads = True

    server = Server((host, port), Handler)
    server.predictor = service
    return server


def main(argv=None) -> int:
    import argparse
    import signal

    p = argparse.ArgumentParser(
        prog="tpuflow_torch.serve",
        description="tpuflow_torch prediction server (POST /predict)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8700)
    p.add_argument(
        "--device", default=None,
        help="cuda (default; fails without a GPU), cuda:N or cpu",
    )
    args = p.parse_args(argv)
    server = make_server(args.host, args.port, device=args.device)

    def _stop(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    host, port = server.server_address[:2]
    print(f"tpuflow_torch server on http://{host}:{port} "
          f"({server.predictor.device})", flush=True)
    server.serve_forever()
    server.server_close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
