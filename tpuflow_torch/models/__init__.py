"""Model families of the port."""

from tpuflow_torch.models.lstm import LSTMLayer, LSTMRegressor, lstm_step
from tpuflow_torch.models.registry import MODELS, NOT_PORTED, build_model

__all__ = [
    "LSTMLayer", "LSTMRegressor", "MODELS", "NOT_PORTED", "build_model",
    "lstm_step",
]
