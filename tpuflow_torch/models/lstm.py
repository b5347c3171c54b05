"""LSTM sequence regressors: LSTM-64 and the stacked LSTM.

Counterpart of ``tpuflow/models/lstm.py``. Parameters keep flax's layout
and names (``w_x [F, 4H]``, ``w_h [H, 4H]``, ``b [4H]``; head ``kernel
[H, 1]``, ``bias [1]``) so that a checkpoint maps one to one between the two
packages. Each layer hoists the input projection ``x @ W_x`` for all steps
into one matmul and runs the recurrence through ``lstm_scan``, the kernel on
a GPU and its plain version on the CPU.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tpuflow_torch.kernels.lstm import lstm_scan, lstm_scan_reference

BACKENDS = ("xla", "pallas")
READOUTS = ("sequence", "last")


def lstm_step(carry, xw_t, w_h, b):
    """One LSTM step (gate order i, f, g, o); ``carry = (h, c)`` and
    ``xw_t`` the pre-projected input ``x_t @ W_x``."""
    h, c = carry
    z = xw_t + h @ w_h + b
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    # flax's lecun_normal: truncated normal at +-2 std, rescaled so that the
    # variance is 1 / fan_in.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class LSTMLayer(nn.Module):
    """One LSTM layer: ``[B, T, F] -> [B, T, H]``, batch-major in and out.

    The sidecar's ``backend`` of ``"xla"`` or ``"pallas"`` is accepted and
    both mean the same math; ``unroll`` and ``remat`` are accepted for spec
    compatibility and do nothing at inference.
    """

    def __init__(
        self,
        in_features: int,
        hidden: int,
        backend: str = "xla",
        unroll: int = 1,
        remat: bool = False,
    ):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"unknown LSTM backend {backend!r}; known {BACKENDS}")
        self.hidden = hidden
        self.w_x = nn.Parameter(torch.empty(in_features, 4 * hidden))
        self.w_h = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.b = nn.Parameter(torch.empty(4 * hidden))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax's init in distribution: lecun-normal ``w_x``, orthogonal
        ``w_h``, forget-gate bias +1."""
        H = self.hidden
        _lecun_normal_(self.w_x, self.w_x.shape[0], generator)
        nn.init.orthogonal_(self.w_h, generator=generator)
        self.b.zero_()
        self.b[H : 2 * H] = 1.0

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs the recurrence's plain version on any device
        (to hold the kernel against it); the default runs ``lstm_scan``."""
        B, T, F = x.shape
        H = self.hidden
        xw = (x.reshape(B * T, F) @ self.w_x).reshape(B, T, 4 * H)
        xw = xw.transpose(0, 1).contiguous()  # time-major: [T, B, 4H]
        if plain:
            hs, _ = lstm_scan_reference(xw, self.w_h, self.b)
        else:
            hs = lstm_scan(xw, self.w_h, self.b)
        return hs.transpose(0, 1)  # back to batch-major [B, T, H]


class Dense(nn.Module):
    """``y = x @ kernel + bias`` in flax layout (``kernel [in, out]``)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class LSTMRegressor(nn.Module):
    """Stacked-LSTM flow regressor: ``num_layers=1, hidden=64`` is LSTM-64,
    ``num_layers=2`` the stacked LSTM. ``readout="sequence"`` emits a
    prediction per step (``[B, T]``), ``"last"`` only the final step
    (``[B]``). Layers are ``lstm_0 .. lstm_{n-1}`` and ``head``, as in flax.
    """

    def __init__(
        self,
        in_features: int,
        hidden: int = 64,
        num_layers: int = 1,
        readout: str = "sequence",
        backend: str = "xla",
        unroll: int = 1,
        remat: bool = False,
    ):
        super().__init__()
        if readout not in READOUTS:
            raise ValueError(f"unknown readout {readout!r}; known {READOUTS}")
        self.readout = readout
        self.num_layers = num_layers
        for layer in range(num_layers):
            self.add_module(
                f"lstm_{layer}",
                LSTMLayer(
                    in_features if layer == 0 else hidden, hidden,
                    backend=backend, unroll=unroll, remat=remat,
                ),
            )
        self.head = Dense(hidden, 1)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for module in self.children():
            module.reset_parameters(generator)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        for layer in range(self.num_layers):
            x = getattr(self, f"lstm_{layer}")(x, plain=plain)
        y = self.head(x)[..., 0]  # [B, T]
        return y[:, -1] if self.readout == "last" else y
