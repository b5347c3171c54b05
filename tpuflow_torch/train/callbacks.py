"""Training callbacks.

Counterpart of ``tpuflow/train/callbacks.py``: ``EarlyStopping`` matches the
reference's ``EarlyStopping(monitor='val_loss', patience=10)`` (reference
cnn.py:121), stopping after ``patience`` epochs without val-loss improvement.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class EarlyStopping:
    patience: int = 10
    min_delta: float = 0.0
    best: float = field(default=float("inf"), init=False)
    bad_epochs: int = field(default=0, init=False)

    def update(self, val_loss: float) -> bool:
        """Record an epoch's val loss; returns True if training should stop."""
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs >= self.patience

    @property
    def improved(self) -> bool:
        return self.bad_epochs == 0
