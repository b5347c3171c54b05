"""Training plane of the port: optimizers, steps and the per-batch fit loop."""

from tpuflow_torch.train.callbacks import EarlyStopping
from tpuflow_torch.train.loop import FitConfig, FitResult, evaluate, fit
from tpuflow_torch.train.optim import build_optimizer, keras_sgd, wrap_optimizer

__all__ = [
    "EarlyStopping", "FitConfig", "FitResult", "build_optimizer", "evaluate",
    "fit", "keras_sgd", "wrap_optimizer",
]
