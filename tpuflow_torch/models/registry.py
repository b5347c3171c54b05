"""Model registry: name -> constructor, for the families ported so far.

Counterpart of ``tpuflow/models/registry.py``. Unlike flax, a torch module
needs its input width when it is built, so ``build_model`` takes
``in_features`` (the sidecar's ``sample_shape[-1]``).
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from tpuflow_torch.models.lstm import LSTMRegressor

MODELS: dict[str, Callable[..., nn.Module]] = {
    # BASELINE config 4: "LSTM-64 single-well sequence model"
    "lstm": lambda in_features, **kw: LSTMRegressor(
        in_features, **{"hidden": 64, **kw}
    ),
    # BASELINE config 5: "Multi-well stacked-LSTM"
    "stacked_lstm": lambda in_features, **kw: LSTMRegressor(
        in_features, **{"hidden": 64, "num_layers": 2, **kw}
    ),
}

# The JAX package's other families; each comes in a later slice.
NOT_PORTED = (
    "static_mlp", "dynamic_mlp", "cnn1d", "gilbert_residual",
    "lstm_residual", "attention", "pipeline_mlp", "moe_mlp",
)


def build_model(name: str, in_features: int, **kwargs) -> nn.Module:
    if name in MODELS:
        return MODELS[name](in_features, **kwargs)
    if name in NOT_PORTED:
        raise ValueError(
            f"model {name!r} is not ported yet to tpuflow_torch (ported: "
            f"{sorted(MODELS)}); see ROADMAP.md, Queue 1"
        )
    raise ValueError(f"unknown model {name!r}; known: {sorted(MODELS)}")
