"""The port stands alone: it imports with JAX and ``tpuflow`` blocked, and
its entry points refuse to run on the CPU unless asked to."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "tpuflow"}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import tpuflow_torch
names = [m.name for m in pkgutil.walk_packages(tpuflow_torch.__path__, "tpuflow_torch.")]
ring = {f"tpuflow_torch.parallel.{m}"
        for m in ("mesh", "distributed", "collectives", "ring_attention", "sp")}
assert ring <= set(names), sorted(ring - set(names))
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names), "modules")
"""


def _run(args, cwd, **env):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, capture_output=True, text=True,
        timeout=240, env={**os.environ, **env},
    )


def test_port_and_chip_smoke_import_without_jax_or_tpuflow():
    r = _run(["-c", _BLOCKED_IMPORT], REPO)
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    from tpuflow_torch import resolve_device
    from tpuflow_torch.api.config import TrainJobConfig
    from tpuflow_torch.api.predict_api import Predictor
    from tpuflow_torch.api.train_api import train
    from tpuflow_torch.cli import main as cli_main
    from tpuflow_torch.serve import PredictService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.load(str(tmp_path), "any")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(TrainJobConfig(max_epochs=1, storage_path=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["", "", "flow", str(tmp_path), "--epochs", "1", "--quiet"])
    assert not os.path.exists(os.path.join(str(tmp_path), "models"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu_or_outside_the_repo(tmp_path, where):
    """Without a visible GPU (and, alone, without the package) the script
    exits non-zero and prints no result line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run(["chip_smoke.py"], cwd, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
