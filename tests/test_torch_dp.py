"""The port's data-parallel training, over two gloo ranks, against the JAX package.

One group of two ranks (``tpuflow_torch.parallel.spawn``, CPU, gloo) runs
every rank-side check of this file at once, in a module-scoped fixture:

- ``replicate`` from unequal starts; the DP eval step's sums; three
  ``make_dp_train_step`` steps of a small stacked LSTM (hidden 8, 2 layers,
  window 12, ``keras_sgd``) from params carried across from flax, fed the
  global batch through ``make_process_fed_steps``;
- the attention regressor with dropout 0.1, each rank's generator seeded by
  ``rank_seed``: different masks, equal parameters;
- ``train(TrainJobConfig(model="stacked_lstm", n_devices=2, ...))`` and its
  refusals inside the group.

The ranks import torch only. JAX runs in this process: its
``make_dp_train_step`` and ``make_dp_eval_step`` on a two-device CPU mesh,
the LSTM path (its MLP DP drill aborts on this host). The port's
one-process step on the concatenated batch and a one-process ``train`` at the
same global batch are the second oracle. Under pytest-xdist the workers share
one run of the group through a file lock (``_run_once``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_torch_ring import _run_once
from tpuflow_torch.api.config import TrainJobConfig
from tpuflow_torch.parallel import (
    Mesh,
    device_kind,
    place,
    process_batch_bounds,
    replica_devices,
)

RANKS = 2
STEPS, BATCH, WINDOW, F, HIDDEN = 3, 8, 12, 5, 8
KW = {"learning_rate": 0.01, "decay": 0.1}  # keras_sgd, a rate that moves
RTOL = 1e-5  # DP step vs JAX's and vs one process: f32, summation order
TRAIN_RTOL = 1e-4  # two epochs of train() vs one process
ATTN = {"dim": 16, "num_layers": 1, "heads": 2, "dropout_rate": 0.1}
TRAIN = TrainJobConfig(model="stacked_lstm", n_devices=RANKS, max_epochs=2,
                       model_kwargs={"hidden": 8}, window=8, synthetic_wells=2,
                       synthetic_steps=64, batch_size=10, verbose=False)


def _batches():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((STEPS + 1, BATCH, WINDOW, F)).astype(np.float32)
    y = rng.standard_normal((STEPS + 1, BATCH, WINDOW)).astype(np.float32)
    mask = np.array([1] * 6 + [0] * (BATCH - 6), np.float32)
    return x, y, mask  # batches 0..2 train, batch 3 evaluates


def _params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _rel(got, want) -> float:
    """Normwise relative error."""
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ranks(mesh, state, root):
    """Every rank's part (see the module docstring); numpy results."""
    from tpuflow_torch.api.train_api import train
    from tpuflow_torch.core.losses import mae_clip
    from tpuflow_torch.models import build_model
    from tpuflow_torch.parallel import (
        make_dp_eval_step,
        make_dp_train_step,
        make_process_fed_steps,
        rank_seed,
        replicate,
    )
    from tpuflow_torch.storage.checkpoint import StoreCheckpointer
    from tpuflow_torch.train.optim import build_optimizer, wrap_optimizer

    out = {"rank": mesh.rank}
    x, y, mask = (torch.from_numpy(a) for a in _batches())

    # The stacked LSTM: rank 0 from the flax params, the others from their
    # own init, until replicate.
    model = build_model("stacked_lstm", F, hidden=HIDDEN)
    if mesh.rank == 0:
        model.load_state_dict({n: torch.from_numpy(a) for n, a in state.items()})
    else:
        model.reset_parameters(torch.Generator().manual_seed(100 + mesh.rank))
    replicate(mesh, model)
    out["replicated"] = _params(model)
    opt = wrap_optimizer(build_optimizer("keras_sgd", **KW)).bind(model.parameters())
    train_step, eval_step = make_process_fed_steps(
        mesh, make_dp_train_step(model, opt, mae_clip, mesh),
        make_dp_eval_step(model, mae_clip, mesh))
    out["eval"] = {k: float(v) for k, v in eval_step(x[STEPS], y[STEPS], mask).items()}
    out["steps"] = []
    for k in range(STEPS):
        m = train_step(x[k], y[k])
        out["steps"].append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                             "params": _params(model)})

    # Dropout: each rank its own masks, the same parameters.
    attn = build_model("attention", F, window=WINDOW, **ATTN)
    attn.reset_parameters(torch.Generator().manual_seed(3))
    attn.dropout_generator = torch.Generator().manual_seed(rank_seed(0, mesh.rank))
    attn.train()
    with torch.no_grad():
        out["dropout_out"] = attn(x[0]).numpy()
    attn_opt = wrap_optimizer(build_optimizer("keras_sgd", **KW)).bind(attn.parameters())
    attn_step, _ = make_process_fed_steps(
        mesh, make_dp_train_step(attn, attn_opt, mae_clip, mesh), None)
    before = _params(attn)
    for k in range(2):
        attn_step(x[k], y[k])
    out["dropout"] = {"before": before, "after": _params(attn)}

    # train(): only rank 0 may write the artifact.
    writes = []
    save = StoreCheckpointer.maybe_save
    StoreCheckpointer.maybe_save = lambda self, *a, **kw: writes.append(1) or save(self, *a, **kw)
    try:
        report = train(dataclasses.replace(TRAIN, storage_path=root), device="cpu")
    finally:
        StoreCheckpointer.maybe_save = save
    out["train"] = {
        "epochs_ran": report.result.epochs_ran,
        "history": [{k: h[k] for k in ("loss", "val_loss", "val_mae")}
                    for h in report.result.history],
        "params": _params(report.result.model),
        "test_loss": report.test_loss, "test_mae": report.test_mae,
        "program": (report.epoch_program, report.epoch_program_reason),
        "samples_per_sec": report.samples_per_sec,
        "fit_samples_per_sec": report.result.samples_per_sec,
        "writes": len(writes),
    }
    out["refusals"] = {}
    for name, change in (("indivisible", {"batch_size": 9}), ("jit_epoch", {"jit_epoch": True}),
                         ("n_devices", {"n_devices": 3}), ("one_device", {"n_devices": 1})):
        try:
            train(dataclasses.replace(TRAIN, **change), device="cpu")
            out["refusals"][name] = None
        except ValueError as e:
            out["refusals"][name] = str(e)
    return out


@pytest.fixture(scope="module")
def flax_start():
    """A flax stacked LSTM's params (as made by ``create_state``) and the
    port's state dict of them."""
    import jax

    from tpuflow.models import build_model as jax_build_model
    from tpuflow.train import create_state
    from tpuflow.train.optim import build_optimizer as jax_build_optimizer
    from tpuflow.train.optim import wrap_optimizer as jax_wrap_optimizer
    from tpuflow_torch.convert import params_from_flax

    x = _batches()[0]
    state = create_state(jax_build_model("stacked_lstm", hidden=HIDDEN), jax.random.PRNGKey(1),
                         x[0][:2], jax_wrap_optimizer(jax_build_optimizer("keras_sgd", **KW)))
    params = jax.device_get(state.params)
    return state, {n: t.numpy() for n, t in params_from_flax(params).items()}


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory, flax_start):
    from tpuflow_torch.parallel import spawn

    def compute():
        root = str(tmp_path_factory.mktemp("dp_train"))
        return root, spawn(_ranks, RANKS, flax_start[1], root, device="cpu", timeout_s=240)

    return _run_once(tmp_path_factory, "torch_dp", compute)


@pytest.fixture(scope="module")
def jax_dp(flax_start):
    """JAX's DP eval sums at the start and its three DP steps (loss, params
    as port state dicts) on a two-device mesh."""
    import jax

    from tpuflow.parallel import make_dp_eval_step, make_dp_train_step, make_mesh, shard_batch
    from tpuflow.parallel.dp import replicate
    from tpuflow_torch.convert import params_from_flax

    mesh = make_mesh(n_data=RANKS, devices=jax.devices()[:RANKS])
    state = replicate(mesh, flax_start[0])
    x, y, mask = _batches()
    sums = make_dp_eval_step(mesh)(state, *shard_batch(mesh, x[STEPS], y[STEPS], mask))
    step, steps = make_dp_train_step(mesh), []
    for k in range(STEPS):
        state, m = step(state, *shard_batch(mesh, x[k], y[k]), jax.random.PRNGKey(0))
        params = params_from_flax(jax.device_get(state.params))
        steps.append({"loss": float(m["loss"]),
                      "params": {n: t.numpy() for n, t in params.items()}})
    return {k: float(v) for k, v in sums.items()}, steps


def _one_process_steps(state):
    """The port's single-process train step on each whole global batch."""
    from tpuflow_torch.core.losses import mae_clip
    from tpuflow_torch.models import build_model
    from tpuflow_torch.train.optim import build_optimizer, wrap_optimizer
    from tpuflow_torch.train.steps import make_train_step

    model = build_model("stacked_lstm", F, hidden=HIDDEN)
    model.load_state_dict({n: torch.from_numpy(a) for n, a in state.items()})
    opt = wrap_optimizer(build_optimizer("keras_sgd", **KW)).bind(model.parameters())
    step = make_train_step(model, opt, mae_clip)
    x, y, _ = (torch.from_numpy(a) for a in _batches())
    out = []
    for k in range(STEPS):
        m = step(x[k], y[k])
        out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "params": _params(model)})
    return out


@pytest.mark.parametrize("global_batch", [1, 2, 6, 20, 21, 4096])
@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_process_batch_bounds_match_jax(global_batch, size):
    from tpuflow.parallel.dp import process_batch_bounds as jax_bounds

    for rank in range(size):
        if global_batch % size:
            with pytest.raises(ValueError, match="not divisible"):
                jax_bounds(global_batch, rank, size)
            with pytest.raises(ValueError, match=f"global batch {global_batch} not divisible"):
                process_batch_bounds(global_batch, rank, size)
        else:
            assert process_batch_bounds(global_batch, rank, size) == jax_bounds(
                global_batch, rank, size)
    assert process_batch_bounds(global_batch, 0, 1) == process_batch_bounds(global_batch)


def test_replicate_starts_every_rank_from_rank_0(dp_run, flax_start):
    for rank in dp_run[1]:
        for n, a in flax_start[1].items():
            np.testing.assert_array_equal(rank["replicated"][n], a)


def test_dp_steps_match_jax_dp_step(dp_run, jax_dp):
    """Three DP steps on two ranks against JAX's ``make_dp_train_step`` on
    a two-device mesh: the loss averaged over the ranks and the params."""
    for rank in dp_run[1]:
        for got, want in zip(rank["steps"], jax_dp[1]):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
            for n, w in want["params"].items():
                assert _rel(got["params"][n], w) <= RTOL, n


def test_dp_steps_match_one_process_on_the_whole_batch(dp_run, flax_start):
    """The same arithmetic as one process stepping the global batch; the
    params move, so the comparison is not of params that stood still."""
    want = _one_process_steps(flax_start[1])
    for rank in dp_run[1]:
        for got, w in zip(rank["steps"], want):
            np.testing.assert_allclose(got["loss"], w["loss"], rtol=RTOL)
            np.testing.assert_allclose(got["grad_norm"], w["grad_norm"], rtol=RTOL)
            for n, a in w["params"].items():
                assert _rel(got["params"][n], a) <= RTOL, n
    moved = max(_rel(want[-1]["params"][n], a) for n, a in flax_start[1].items())
    assert moved > 100 * RTOL


def test_ranks_bitwise_equal_after_each_step(dp_run):
    first, *others = dp_run[1]
    for rank in others:
        for got, want in zip(rank["steps"], first["steps"]):
            assert got["loss"] == want["loss"] and got["grad_norm"] == want["grad_norm"]
            for n, a in want["params"].items():
                np.testing.assert_array_equal(got["params"][n], a)


def test_dp_eval_sums_match_jax(dp_run, jax_dp):
    """Masked sums over both ranks' rows (the last two rows masked out)."""
    for rank in dp_run[1]:
        assert rank["eval"]["count"] == jax_dp[0]["count"] == 6
        for key in ("loss_sum", "mae_sum"):
            np.testing.assert_allclose(rank["eval"][key], jax_dp[0][key], rtol=RTOL)


def test_dropout_draws_other_masks_on_each_rank_yet_equal_params(dp_run):
    first, *others = dp_run[1]
    for rank in others:
        assert not np.array_equal(rank["dropout_out"], first["dropout_out"])
        for n, a in first["dropout"]["after"].items():
            np.testing.assert_array_equal(rank["dropout"]["after"][n], a)
    moved = [n for n, a in first["dropout"]["after"].items()
             if not np.array_equal(a, first["dropout"]["before"][n])]
    assert moved


def test_train_ranks_agree_and_rank_0_writes(dp_run):
    root, ranks = dp_run
    first = ranks[0]["train"]
    assert first["epochs_ran"] == 2 and len(first["history"]) == 2
    for rank in ranks:
        tr = rank["train"]
        assert tr["epochs_ran"] == first["epochs_ran"] and tr["history"] == first["history"]
        for n, a in first["params"].items():
            np.testing.assert_array_equal(tr["params"][n], a)
        assert np.isfinite([[h["loss"], h["val_loss"]] for h in tr["history"]]).all()
        assert (tr["writes"] > 0) == (rank["rank"] == 0)
        # Samples/s a chip: the fit's global rate over the ranks (JAX's :1184).
        assert tr["samples_per_sec"] == pytest.approx(tr["fit_samples_per_sec"] / RANKS)
    assert os.path.isfile(os.path.join(root, "meta", "stacked_lstm.json"))
    assert os.path.isfile(os.path.join(root, "models", "stacked_lstm", "BEST"))


def test_train_matches_one_process_at_the_same_global_batch(dp_run):
    from tpuflow_torch.api.train_api import train

    want = train(dataclasses.replace(TRAIN, n_devices=1), device="cpu")
    got = dp_run[1][0]["train"]
    assert got["epochs_ran"] == want.result.epochs_ran
    for g, w in zip(got["history"], want.result.history):
        for key in ("loss", "val_loss", "val_mae"):
            np.testing.assert_allclose(g[key], w[key], rtol=TRAIN_RTOL)
    for n, p in want.result.model.named_parameters():
        assert _rel(got["params"][n], p.detach().numpy()) <= TRAIN_RTOL, n
    np.testing.assert_allclose(got["test_mae"], want.test_mae, rtol=TRAIN_RTOL)


@pytest.mark.parametrize("case,match", [
    ("indivisible", "batch_size 9 not divisible by 2 devices"),
    ("jit_epoch", "jit_epoch=True cannot train data parallel over 2 ranks"),
    ("n_devices", "n_devices=3 differs from the process group's 2 ranks"),
    ("one_device", "n_devices=1 differs from the process group's 2 ranks"),
])
def test_train_refusals_inside_a_group(dp_run, case, match):
    import re

    for rank in dp_run[1]:
        assert rank["refusals"][case] is not None and re.search(match, rank["refusals"][case])


def test_auto_is_per_batch_and_names_data_parallelism(dp_run):
    """JAX's multi-process DP (``multi_host``) and the port's DP both train
    per-batch under AUTO; the port says why."""
    from tpuflow.train.autotune import choose_epoch_program as jax_choose
    from tpuflow_torch.train.autotune import choose_epoch_program

    for kind in ("NVIDIA H100 80GB HBM3", "cpu"):
        got = choose_epoch_program(20, data_parallel=True, device_kind=kind,
                                   compute_dtype="f32")
        want = jax_choose(20, multi_host=True, device_kind=kind, compute_dtype="f32")
        assert (got.jit_epoch, got.source) == (want.jit_epoch, want.source) == (
            False, "constraint")
        assert "data parallelism" in got.reason and "CUDA graph" in got.reason
    for rank in dp_run[1]:
        program, reason = rank["train"]["program"]
        assert program == "per_batch" and reason.startswith("data parallelism")


def test_fit_refuses_the_scanned_epoch_with_an_injected_step():
    from tpuflow_torch.data.pipeline import ArrayDataset
    from tpuflow_torch.models import build_model
    from tpuflow_torch.train import FitConfig, fit

    x, y, _ = _batches()
    ds = ArrayDataset(x[0], y[0])
    with pytest.raises(ValueError, match="injected train_step"):
        fit(build_model("lstm", F, hidden=4), ds, ds, FitConfig(jit_epoch=True, verbose=False),
            train_step=lambda x, y: None)


def test_placement_on_a_host_without_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert device_kind() == "cpu" and device_kind("unknown") == "unknown"
    with pytest.raises(ValueError, match="cannot place 2 replicas on 1 available card"):
        replica_devices(2, devices=[torch.device("cpu")])
    with pytest.raises(ValueError, match=">= 1"):
        replica_devices(0)
    tree = place({"a": np.ones(2, np.float32), "b": [torch.zeros(1)]}, "cpu")
    assert torch.is_tensor(tree["a"]) and isinstance(tree["b"], list)
    assert Mesh(group=None, size=2, rank=1, device=torch.device("cpu"), backend="gloo").size == 2


def test_cli_devices_flag_parses_as_jax():
    from tpuflow.cli import build_parser as jax_build_parser
    from tpuflow_torch.cli import build_parser

    base = ["", "", "flow", "/tmp/x"]
    for argv in ([], ["--devices", "4"]):
        assert (build_parser().parse_args(base + argv).devices
                == jax_build_parser().parse_known_args(base + argv)[0].devices)
