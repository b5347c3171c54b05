"""The numerics watchdog: NaN, Inf and spikes in a run's per-epoch losses
and gradient norms.

Counterpart of ``tpuflow/obs/health.py::NumericsWatchdog`` with the same
detection, copied rather than imported (the port imports nothing of
``tpuflow``). The fit loop hands it each epoch's batch losses and gradient
norms as host floats, read back with the epoch's losses in the one
read-back an epoch already does, so it adds no synchronisation of the card.

Detection:
- ``nan_loss`` / ``inf_loss`` / ``nan_grad`` / ``inf_grad``: a non-finite
  value among the epoch's values; NaN outranks inf in the report;
- ``spike_loss`` / ``spike_grad``: the epoch's mean of finite values
  exceeds ``SPIKE_FACTOR`` (10) times the EWMA (``EWMA_ALPHA`` 0.3) of
  earlier healthy epochs, once ``WARMUP_EPOCHS`` (1) healthy epochs have
  seeded it (the EWMA floored at 1e-12, so float noise around a converged
  zero is no spike). Anomalous epochs do not update the EWMA.

Only the ``warn`` policy is ported: an anomaly is recorded in
``anomalies`` and printed to stderr, and the run goes on. ``abort`` and
``halve_lr`` are refused by ``train()`` (ROADMAP.md Queue 1 item 12). The
JAX watchdog's metric counter and forensics dump belong to the
observability planes, which are not ported (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import math
import sys

# The policies this port implements, and the values that turn the watchdog
# off (the JAX package's HEALTH_OFF).
HEALTH_POLICIES = ("warn",)
HEALTH_OFF = (None, "", "off", "none")

# The JAX watchdog's defaults, the only values its callers use.
EWMA_ALPHA = 0.3
SPIKE_FACTOR = 10.0
WARMUP_EPOCHS = 1


class NumericsWatchdog:
    """Per-epoch checks over host floats under the ``warn`` policy;
    ``anomalies`` is the trail of ``{"kind", "value", "epoch"}`` dicts."""

    def __init__(self, *, model_name: str = "model", verbose: bool = True):
        self.model_name = model_name
        self.verbose = verbose
        self.anomalies: list[dict] = []
        self._ewma_loss: float | None = None
        self._ewma_grad: float | None = None
        self._healthy_epochs = 0

    @staticmethod
    def _classify(values, nan_kind: str, inf_kind: str):
        """(anomaly kind or None, representative value, mean of the finite
        values or None)."""
        finite, bad_kind, bad_value = [], None, None
        for v in values:
            v = float(v)
            if math.isnan(v):
                bad_kind, bad_value = nan_kind, v
            elif math.isinf(v):
                if bad_kind != nan_kind:  # NaN outranks inf in the report
                    bad_kind, bad_value = inf_kind, v
            else:
                finite.append(v)
        mean = sum(finite) / len(finite) if finite else None
        return bad_kind, bad_value, mean

    def _spike(self, mean: float | None, ewma: float | None) -> bool:
        if mean is None or ewma is None or self._healthy_epochs < WARMUP_EPOCHS:
            return False
        return mean > SPIKE_FACTOR * max(ewma, 1e-12)

    def observe_epoch(self, epoch: int, losses, grad_norms=None) -> list[dict]:
        """Check one epoch's host floats; returns the anomalies it found
        (also appended to ``anomalies``)."""
        found: list[dict] = []
        kind, value, loss_mean = self._classify(losses, "nan_loss", "inf_loss")
        if kind:
            found.append({"kind": kind, "value": value})
        grad_mean = None
        if grad_norms:
            gkind, gvalue, grad_mean = self._classify(grad_norms, "nan_grad", "inf_grad")
            if gkind:
                found.append({"kind": gkind, "value": gvalue})
        if not kind and self._spike(loss_mean, self._ewma_loss):
            found.append({"kind": "spike_loss", "value": loss_mean})
        if grad_norms and not any(
            a["kind"] in ("nan_grad", "inf_grad") for a in found
        ) and self._spike(grad_mean, self._ewma_grad):
            found.append({"kind": "spike_grad", "value": grad_mean})

        if not found:
            a = EWMA_ALPHA
            if loss_mean is not None:
                self._ewma_loss = (loss_mean if self._ewma_loss is None
                                   else a * loss_mean + (1 - a) * self._ewma_loss)
            if grad_mean is not None:
                self._ewma_grad = (grad_mean if self._ewma_grad is None
                                   else a * grad_mean + (1 - a) * self._ewma_grad)
            self._healthy_epochs += 1
            return found

        for a in found:
            a["epoch"] = epoch
            self.anomalies.append(a)
        if self.verbose:
            kinds = ", ".join(f"{a['kind']}={a['value']:g}" for a in found)
            print(f"tpuflow_torch.obs.health: epoch {epoch} of {self.model_name}: "
                  f"{kinds} (policy=warn; continuing)", file=sys.stderr)
        return found
