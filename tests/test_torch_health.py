"""The port's numerics watchdog against the JAX package's, on the CPU.

The same host float sequences, epoch by epoch, go through
``tpuflow.obs.health.NumericsWatchdog("warn", verbose=False)`` and the
port's ``tpuflow_torch.obs.health.NumericsWatchdog``, and the two anomaly
trails must be equal. The port's tuning is fixed at JAX's defaults; the
warm-up case sets JAX's ``warmup_epochs`` and the port's ``WARMUP_EPOCHS``
alike. Then ``train()`` on the CPU with a run whose loss
goes non-finite records it in the report, under per-batch steps (losses and
gradient norms) and under the scanned epoch (its mean loss alone, the same
trail as the JAX package's ``train()`` gives), and the off values train as
off.
"""

import math

import pytest

from tpuflow.api.config import TrainJobConfig as JaxTrainJobConfig
from tpuflow.api.train_api import train as jax_train
from tpuflow.obs.health import NumericsWatchdog as JaxWatchdog
from tpuflow_torch.api.config import TrainJobConfig
from tpuflow_torch.api.train_api import train
from tpuflow_torch.obs import health as health_mod
from tpuflow_torch.obs.health import NumericsWatchdog

NAN, INF = float("nan"), float("inf")

# name -> (JAX watchdog kwargs, [(epoch losses, epoch grad norms), ...]); a
# kwarg is set on the port as the module constant of its name in capitals.
CASES = {
    "nan_loss": ({}, [([1.0, 2.0], [0.5, 0.6]), ([NAN, 1.0], [0.5, 0.5])]),
    "inf_grad": ({}, [([1.0], [0.5]), ([1.0, 1.1], [INF, 0.4])]),
    "nan_outranks_inf": ({}, [([INF, NAN, 1.0], [NAN, -INF])]),
    "spike_after_warmup": ({}, [([1.0], [1.0]), ([20.0], [1.0]), ([1.0], [30.0])]),
    "no_spike_during_warmup": (
        {"warmup_epochs": 3}, [([1.0], [1.0]), ([20.0], [1.0]), ([300.0], [50.0])]),
    "ewma_untouched_by_anomalies": (
        {}, [([1.0], [1.0]), ([100.0], [1.0]), ([11.0], [1.0]), ([NAN], [1.0]),
             ([10.5], [1.0])]),
    "near_zero_ewma": (
        {}, [([0.0], [0.0]), ([1e-13], [1e-14]), ([1e-10], [1e-10]), ([0.0], [0.0])]),
    "no_grad_norms": ({}, [([1.0], None), ([50.0], None), ([INF], None)]),
}


def _trail(anomalies):
    """Anomalies with NaN values made comparable."""
    return [{k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
             for k, v in a.items()} for a in anomalies]


@pytest.mark.parametrize("name", sorted(CASES))
def test_anomaly_trail_matches_jax(name, monkeypatch):
    kwargs, epochs = CASES[name]
    for key, value in kwargs.items():
        monkeypatch.setattr(health_mod, key.upper(), value)
    jax_dog = JaxWatchdog("warn", verbose=False, **kwargs)
    dog = NumericsWatchdog(verbose=False)
    for epoch, (losses, grads) in enumerate(epochs, start=1):
        jax_dog.observe_epoch(epoch, losses, grads)
        dog.observe_epoch(epoch, losses, grads)
    assert _trail(dog.anomalies) == _trail(jax_dog.anomalies)
    if name != "no_spike_during_warmup":
        assert dog.anomalies  # each case but that one finds something


SMALL = dict(model="lstm", model_kwargs={"hidden": 8}, window=8, synthetic_wells=2,
             synthetic_steps=64, batch_size=5, max_epochs=2, verbose=False)


def test_only_warn_is_ported():
    """``train()`` refuses every policy but ``warn`` before it trains."""
    assert health_mod.HEALTH_POLICIES == ("warn",)
    for policy in ("abort", "halve_lr", "bogus"):
        with pytest.raises(NotImplementedError, match="not ported"):
            train(TrainJobConfig(**SMALL, health=policy), device="cpu")
# A NaN learning rate makes every parameter NaN after the first step.
DIVERGING = dict(SMALL, optimizer_kwargs={"learning_rate": NAN})


def test_non_finite_run_is_recorded_in_the_report():
    report = train(TrainJobConfig(**DIVERGING, jit_epoch=False), device="cpu")
    assert report.epoch_program == "per_batch"
    kinds = {a["kind"] for a in report.anomalies}
    assert kinds == {"nan_loss", "nan_grad"}
    assert {a["epoch"] for a in report.anomalies} == {1, 2}
    assert report.result.anomalies == report.anomalies
    assert report.recompiles is None and report.result.recompiles is None
    assert "Numerics anomalies: nan_grad=2, nan_loss=2" in report.summary()


@pytest.mark.parametrize("jit_epoch", [True, None])
def test_scanned_program_trail_matches_jax(jit_epoch):
    """The scanned epoch hands the watchdog its mean loss and no gradient
    norms, as JAX's does (``loop.py:489``): the trail of the diverging run
    equals the JAX package's under ``jit_epoch=True``, explicit or AUTO's
    choice at batch 5."""
    report = train(TrainJobConfig(**DIVERGING, jit_epoch=jit_epoch), device="cpu")
    assert report.epoch_program == "jit_epoch"
    want = jax_train(JaxTrainJobConfig(**DIVERGING, jit_epoch=True, n_devices=1))
    assert want.epoch_program == "jit_epoch"
    assert _trail(report.anomalies) == _trail(want.anomalies)
    assert {a["kind"] for a in report.anomalies} == {"nan_loss"}
    assert "Numerics anomalies: nan_loss=2" in report.summary()


@pytest.mark.parametrize("health", ["", "none", "off", None])
def test_off_values_train_without_the_watchdog(health):
    report = train(TrainJobConfig(**DIVERGING, health=health), device="cpu")
    assert report.anomalies == []
    assert "Numerics anomalies" not in report.summary()
