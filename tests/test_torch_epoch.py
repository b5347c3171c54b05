"""The epoch program: its choice, the scanned epoch, and its launch counts.

On the CPU: ``choose_epoch_program`` gives the JAX package's program,
source and reason at batch sizes around the crossover and for each
constraint (f32, on the port's card, ``"NVIDIA H100 80GB HBM3"``, and on
the CPU), when JAX reads the port's measured sweeps; with JAX's own
``benchmarks/program_sweep.json``, which holds no H100 record, the two
differ on the card at batch 256 and above and nowhere else; a ring is
per-batch under AUTO and refused under an explicit ``jit_epoch=True``; the
attention regressor's scanned epoch matches JAX's ``lax.scan`` epoch from
copied params; ``count_captured`` moves the launches a capture counted to
the replays; the CLI's flags parse as JAX's. The ``cuda``-marked test
holds a graphed epoch against the per-batch epoch on the card and skips
elsewhere: ``python -m pytest --noconftest -m cuda tests/test_torch_epoch.py``.
"""

import json

import numpy as np
import pytest
import torch

from tpuflow_torch.api.config import TrainJobConfig
from tpuflow_torch.api.train_api import _epoch_program, train
from tpuflow_torch.cli import build_parser
from tpuflow_torch.kernels import KERNELS, count_captured
from tpuflow_torch.parallel.mesh import Mesh
from tpuflow_torch.train import FitConfig, fit
from tpuflow_torch.train.autotune import (
    HEURISTIC_CROSSOVER_BATCH,
    MEASURED_SWEEPS,
    choose_epoch_program,
)
from tpuflow_torch.train.optim import build_optimizer, wrap_optimizer

BATCHES = [1, 20, 255, 256, 4096]
CARD = "NVIDIA H100 80GB HBM3"
CONSTRAINTS = {"none": {}, "stream": {"stream": True}, "tp": {"tp": 2}, "pp": {"pp": 2},
               "ep": {"ep": 4}}


@pytest.mark.parametrize("kind", [CARD, "cpu"])
@pytest.mark.parametrize("constraint", sorted(CONSTRAINTS))
@pytest.mark.parametrize("batch", BATCHES)
def test_choice_matches_jax(batch, constraint, kind, tmp_path, monkeypatch):
    """JAX given the port's sweeps as its sweep file: the card's record
    (measured), the CPU's none (heuristic)."""
    from tpuflow.train.autotune import HEURISTIC_CROSSOVER_BATCH as JAX_CROSSOVER
    from tpuflow.train.autotune import choose_epoch_program as jax_choose

    path = tmp_path / "program_sweep.json"
    path.write_text(json.dumps(MEASURED_SWEEPS))
    monkeypatch.setenv("TPUFLOW_PROGRAM_SWEEP", str(path))
    kwargs = CONSTRAINTS[constraint]
    got = choose_epoch_program(batch, device_kind=kind, compute_dtype="f32", **kwargs)
    want = jax_choose(batch, device_kind=kind, compute_dtype="f32", **kwargs)
    assert HEURISTIC_CROSSOVER_BATCH == JAX_CROSSOVER
    if not kwargs:
        assert got.source == ("measured" if kind == CARD else "heuristic")
    assert (got.jit_epoch, got.source, got.name) == (want.jit_epoch, want.source, want.name)
    if got.source == "heuristic":
        # The same words, up to JAX's pointer to its own sweep script.
        assert got.reason.rstrip(")") == want.reason[: len(got.reason) - 1]
    else:
        assert got.reason == want.reason


@pytest.mark.parametrize("batch", BATCHES)
def test_card_choice_departs_from_jax_only_by_the_measured_sweep(batch, monkeypatch):
    """JAX reading its own sweep file has no H100 record and takes its
    heuristic 256; the port's sweep measured the graph faster at every
    batch (``chip_smoke.py --program-sweep``), so at 256 and above the
    port scans where JAX steps per batch."""
    from tpuflow.train.autotune import choose_epoch_program as jax_choose

    monkeypatch.delenv("TPUFLOW_PROGRAM_SWEEP", raising=False)
    got = choose_epoch_program(batch, device_kind=CARD, compute_dtype="f32")
    want = jax_choose(batch, device_kind=CARD, compute_dtype="f32")
    assert (got.name, got.source) == ("jit_epoch", "measured")
    assert got.reason == f"scanned program measured faster at every swept batch on {CARD!r} [f32]"
    assert want.source == "heuristic"
    assert want.jit_epoch == (batch < HEURISTIC_CROSSOVER_BATCH)


SMALL = dict(model="lstm", model_kwargs={"hidden": 8}, window=8, synthetic_wells=2,
             synthetic_steps=64, batch_size=5, max_epochs=1, verbose=False)


def _ring(device="cpu"):
    """A ring's mesh as ``train()`` reads it before it trains (no group is
    needed to resolve the epoch program)."""
    return Mesh(group=None, size=4, rank=0, device=torch.device(device), backend="gloo")


def test_ring_is_per_batch_and_refuses_an_explicit_scan():
    choice = choose_epoch_program(20, ring=True)
    assert (choice.name, choice.source) == ("per_batch", "constraint")
    assert "cannot be captured" in choice.reason
    auto = _epoch_program(TrainJobConfig(), _ring(), torch.device("cpu"))
    assert auto == choice
    off = _epoch_program(TrainJobConfig(jit_epoch=False), _ring(), torch.device("cpu"))
    assert (off.name, off.source) == ("per_batch", "explicit")
    config = TrainJobConfig(**{**SMALL, "model": "attention", "model_kwargs": {
        "backend": "ring", "mesh": _ring()}}, jit_epoch=True)
    with pytest.raises(ValueError, match=r"jit_epoch=True cannot train a ring"):
        train(config, device="cpu")


def test_default_job_resolves_to_the_scanned_program():
    """``train(TrainJobConfig())``'s choice: batch 20 is below the crossover."""
    choice = _epoch_program(TrainJobConfig(), None, torch.device("cpu"))
    assert (choice.name, choice.source) == ("jit_epoch", "heuristic")
    assert choice.reason == ("batch_size 20 < heuristic crossover 256 (no sweep "
                             "recorded for 'cpu' [f32])")
    for flag, name in ((True, "jit_epoch"), (False, "per_batch")):
        explicit = _epoch_program(TrainJobConfig(jit_epoch=flag), None, torch.device("cpu"))
        assert (explicit.name, explicit.reason) == (name, "explicitly set in config")
    card = choose_epoch_program(20, device_kind=CARD, compute_dtype="f32")
    assert (card.name, card.source) == ("jit_epoch", "measured")


def test_attention_scanned_epoch_matches_jax():
    """Two scanned epochs of the attention regressor (flash backend, the
    kernels' plain versions here) from JAX's params, at a steep lr decay:
    losses to 1e-5 relative, params to 1e-5."""
    import jax

    from tpuflow.data.pipeline import prepare_windowed as jax_prepare_windowed
    from tpuflow.data.synthetic import generate_wells
    from tpuflow.models import build_model as jax_build_model
    from tpuflow.train import FitConfig as JaxFitConfig
    from tpuflow.train import create_state
    from tpuflow.train import fit as jax_fit
    from tpuflow.train.optim import build_optimizer as jax_build_optimizer
    from tpuflow.train.optim import wrap_optimizer as jax_wrap_optimizer
    from tpuflow_torch.convert import params_from_flax
    from tpuflow_torch.models import build_model

    small = {"dim": 16, "num_layers": 2, "heads": 2, "backend": "flash"}
    splits = jax_prepare_windowed(generate_wells(n_wells=2, steps=40, seed=0), window=8,
                                  seed=0, teacher_forcing=True)
    kw = {"learning_rate": 0.01, "decay": 0.1}
    state = create_state(
        jax_build_model("attention", **small), jax.random.PRNGKey(2), splits.train.x[:2],
        jax_wrap_optimizer(jax_build_optimizer("keras_sgd", **kw)),
    )
    params0 = jax.device_get(state.params)
    want = jax_fit(state, splits.train, splits.val, JaxFitConfig(
        max_epochs=2, batch_size=5, seed=0, verbose=False, jit_epoch=True))
    port = build_model("attention", 5, window=8, **small)
    port.load_state_dict(params_from_flax(params0))
    got = fit(port, splits.train, splits.val,
              FitConfig(max_epochs=2, batch_size=5, seed=0, verbose=False, jit_epoch=True),
              optimizer=wrap_optimizer(build_optimizer("keras_sgd", **kw)))
    for g, w in zip(got.history, want.history, strict=True):
        for key in ("loss", "val_loss", "val_mae"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5)
    final = params_from_flax(jax.device_get(want.state.params))
    for name, p in port.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), atol=1e-5)
    assert got.samples_per_sec > 0 and got.anomalies == []


def test_count_captured_moves_counts_to_replays():
    """A capture's counts are taken back out, also when it raises, and each
    replay adds them once."""
    before = {name: fn.launches for name, fn in KERNELS.items()}

    def capture():
        KERNELS["lstm_fwd"].launches += 2
        KERNELS["mae_clip"].launches += 1

    replayed = count_captured(capture)
    assert {name: fn.launches for name, fn in KERNELS.items()} == before
    replayed(3)
    assert KERNELS["lstm_fwd"].launches == before["lstm_fwd"] + 6
    assert KERNELS["mae_clip"].launches == before["mae_clip"] + 3
    assert KERNELS["flash_fwd"].launches == before["flash_fwd"]

    def fails():
        KERNELS["lstm_bwd"].launches += 1
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        count_captured(fails)
    assert KERNELS["lstm_bwd"].launches == before["lstm_bwd"]
    KERNELS["lstm_fwd"].launches = before["lstm_fwd"]
    KERNELS["mae_clip"].launches = before["mae_clip"]


@pytest.mark.parametrize("argv,want", [([], None), (["--jit-epoch"], True),
                                        (["--no-jit-epoch"], False)])
def test_cli_jit_epoch_flags_parse_as_jax(argv, want):
    from tpuflow.cli import build_parser as jax_build_parser

    base = ["", "", "flow", "/tmp/x"]
    assert build_parser().parse_args(base + argv).jit_epoch is want
    assert jax_build_parser().parse_known_args(base + argv)[0].jit_epoch is want


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA graph and the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model_name", ["lstm", "attention"])
def test_cuda_graphed_epoch_matches_per_batch(cuda_device, model_name):
    """One epoch per-batch and one graphed from the same weights: the same
    kernel launches, counted by replay, and final params within 1e-6 of
    each other relative to their largest value."""
    from tpuflow_torch.data.pipeline import prepare_windowed
    from tpuflow_torch.data.synthetic import generate_wells
    from tpuflow_torch.models import build_model

    splits = prepare_windowed(generate_wells(n_wells=2, steps=64, seed=0), window=8, seed=0,
                              teacher_forcing=True)
    finals, counts = [], []
    for jit_epoch in (False, True):
        model = build_model(model_name, 5, window=8)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(cuda_device)
        for fn in KERNELS.values():
            fn.launches = 0
        fit(model, splits.train, splits.val,
            FitConfig(max_epochs=1, batch_size=5, verbose=False, health=None,
                      jit_epoch=jit_epoch),
            optimizer=wrap_optimizer(build_optimizer("keras_sgd", decay=0.1)))
        torch.cuda.synchronize()
        counts.append({name: fn.launches for name, fn in KERNELS.items()})
        finals.append({n: p.detach().clone() for n, p in model.state_dict().items()})
    assert counts[0] == counts[1]
    for name, want in finals[0].items():
        err = float((finals[1][name] - want).abs().max() / want.abs().max().clamp_min(1e-30))
        assert err <= 1e-6, f"{name}: {err:.2e}"
