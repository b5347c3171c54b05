"""The causal attention regressor: a small pre-LN transformer encoder.

Counterpart of ``tpuflow/models/attention.py``. Parameters keep flax's
names and layouts (``embed``, ``pos_embed [T, dim]``, ``block_i/{qkv, proj,
LayerNorm_0, LayerNorm_1, Dense_0, Dense_1}``, ``LayerNorm_0``, ``head``;
Dense ``kernel [in, out]``, LayerNorm ``scale``/``bias``), so a checkpoint
maps one to one between the two packages. Each block's attention runs
through ``flash_attention``: the kernels on a GPU, their plain versions on
the CPU. Numerics follow flax: LayerNorm with epsilon 1e-6 and the variance
as E[x^2] - E[x]^2, GELU in its tanh form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuflow_torch.kernels.attention import flash_attention, flash_attention_reference
from tpuflow_torch.models.lstm import READOUTS, Dense

# "full" and "flash" run the same math (the LSTM family's xla/pallas
# pattern): on a GPU both go through the flash kernels.
BACKENDS = ("full", "flash")
RING_IMPLS = ("jnp", "flash")


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """``[B, T, D] -> [B*h, T, D/h]`` (heads folded into the batch, batch
    major)."""
    B, T, D = x.shape
    x = x.reshape(B, T, heads, D // heads)
    return x.transpose(1, 2).reshape(B * heads, T, D // heads)


def _merge_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """``[B*h, T, D/h] -> [B, T, D]``."""
    Bh, T, Dh = x.shape
    x = x.reshape(Bh // heads, heads, T, Dh)
    return x.transpose(1, 2).reshape(Bh // heads, T, heads * Dh)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis: ``scale``/``bias``,
    epsilon 1e-6, variance ``max(0, E[x^2] - E[x]^2)``."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias


def _check_options(backend: str, dropout_rate: float, ring_impl: str) -> None:
    if backend == "ring":
        raise NotImplementedError(
            'backend="ring" (ring attention over a mesh) is not ported yet to '
            "tpuflow_torch: it comes with the ring slice (parallel/ring_attention.py "
            "ring and parallel/sp.py over torch.distributed; ROADMAP.md Queue 1 item 3)"
        )
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; known {BACKENDS + ('ring',)}")
    if ring_impl not in RING_IMPLS:
        raise ValueError(f"unknown ring_impl {ring_impl!r}; known {RING_IMPLS}")
    if dropout_rate > 0:
        raise NotImplementedError(
            f"dropout_rate={dropout_rate} is not ported yet to tpuflow_torch: the two "
            "frameworks draw different random bits (ROADMAP.md Queue 3, dropout)"
        )


class EncoderBlock(nn.Module):
    """Pre-LN block: causal multi-head attention and an MLP, each with a
    residual connection."""

    def __init__(self, dim: int, heads: int = 4, mlp_ratio: int = 4):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim={dim} is not a multiple of heads={heads}")
        self.heads = heads
        self.LayerNorm_0 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, mlp_ratio * dim)
        self.Dense_1 = Dense(mlp_ratio * dim, dim)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for module in self.children():
            module.reset_parameters(generator)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        q, k, v = self.qkv(self.LayerNorm_0(x)).chunk(3, dim=-1)
        q, k, v = (_split_heads(t, self.heads).contiguous() for t in (q, k, v))
        if plain:
            att = flash_attention_reference(q, k, v)[0]
        else:
            att = flash_attention(q, k, v)
        x = x + self.proj(_merge_heads(att, self.heads))
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)


class AttentionRegressor(nn.Module):
    """Causal transformer flow regressor: ``[B, T, F] -> [B, T]`` (or
    ``[B]`` with ``readout="last"``). ``window`` is T, the length of the
    learned position embedding. Defaults are flax's: dim 64, 2 layers, 4
    heads, sequence readout.
    """

    def __init__(
        self,
        in_features: int,
        window: int,
        dim: int = 64,
        num_layers: int = 2,
        heads: int = 4,
        readout: str = "sequence",
        dropout_rate: float = 0.0,
        backend: str = "full",
        ring_impl: str = "jnp",
    ):
        super().__init__()
        if readout not in READOUTS:
            raise ValueError(f"unknown readout {readout!r}; known {READOUTS}")
        _check_options(backend, dropout_rate, ring_impl)
        self.readout = readout
        self.num_layers = num_layers
        self.embed = Dense(in_features, dim)
        self.pos_embed = nn.Parameter(torch.empty(window, dim))
        for i in range(num_layers):
            self.add_module(f"block_{i}", EncoderBlock(dim, heads=heads))
        self.LayerNorm_0 = LayerNorm(dim)
        self.head = Dense(dim, 1)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax's init in distribution: lecun-normal Dense kernels, zero
        biases, LayerNorm ones and zeros, ``pos_embed`` normal(0, 0.02)."""
        for module in self.children():
            module.reset_parameters(generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs the attention's plain version on any device
        (to hold the kernels against it); the default runs
        ``flash_attention``."""
        T = x.shape[1]
        if T != self.pos_embed.shape[0]:
            raise ValueError(
                f"AttentionRegressor was built for windows of "
                f"{self.pos_embed.shape[0]} steps, got {T}"
            )
        h = self.embed(x) + self.pos_embed[None]
        for i in range(self.num_layers):
            h = getattr(self, f"block_{i}")(h, plain=plain)
        y = self.head(self.LayerNorm_0(h))[..., 0]  # [B, T]
        return y[:, -1] if self.readout == "last" else y
