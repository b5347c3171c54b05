"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<stem>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface, ``build/<stem>-<hash>.so`` beside this
file (git-ignored), the first time a wrapper needs it; the hash covers the
sources and the flags, so an edited source builds anew. The library is loaded
with ``ctypes``. Nothing is built or imported when this module is imported:
the CPU tests import every module on a machine without ``nvcc``.

``build()`` starts one ``nvcc`` for each source, all together, and waits for
them; a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# stem -> {"path", "seconds", "ptxas"} for the builds this process ran.
build_log: dict[str, dict] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels build only where the CUDA toolkit is installed"
    )


def stems() -> list[str]:
    """Every kernel source under ``csrc/``."""
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC, "*.cu"))
    )


def library_path(stem: str) -> str:
    """Where ``stem``'s library goes: named by a hash of its source, the
    shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, stem + ".cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    ):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` each, started together. Returns ``{stem: library path}``."""
    names = stems() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, running = {}, []
    for stem in names:
        path = library_path(stem)
        out[stem] = path
        if os.path.isfile(path):
            continue
        tmp = f"{path[:-3]}.{os.getpid()}.{threading.get_ident()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, stem + ".cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((stem, path, tmp, proc, time.perf_counter()))
    failures = []
    for stem, path, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        build_log[stem] = {
            "path": path,
            "seconds": seconds,
            "ptxas": [ln for ln in log.splitlines() if "ptxas" in ln or "spill" in ln],
        }
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(build([stem])[stem])
            lib.tpuflow_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tpuflow_cuda_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.tpuflow_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
