"""The causal attention regressor: a small pre-LN transformer encoder.

Counterpart of ``tpuflow/models/attention.py``. Parameters keep flax's
names and layouts (``embed``, ``pos_embed [T, dim]``, ``block_i/{qkv, proj,
LayerNorm_0, LayerNorm_1, Dense_0, Dense_1}``, ``LayerNorm_0``, ``head``;
Dense ``kernel [in, out]``, LayerNorm ``scale``/``bias``), so a checkpoint
maps one to one between the two packages. Each block's attention runs
through ``flash_attention`` (backends ``full`` and ``flash``: the kernels on
a GPU, their plain versions on the CPU) or, with ``backend="ring"`` and a
``mesh``, through ``ring_attention`` over the mesh's ranks (the ring-round
kernels on a GPU). Numerics follow flax: LayerNorm with epsilon 1e-6 and
the variance as E[x^2] - E[x]^2, GELU in its tanh form, and dropout (after
the attention projection and after the MLP) only in training mode, with
masks drawn from ``dropout_generator`` (torch's default generator when it
is None); in eval mode, as in serving, the model is deterministic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuflow_torch.kernels.attention import flash_attention, flash_attention_reference
from tpuflow_torch.models.lstm import READOUTS, Dense
from tpuflow_torch.parallel.ring_attention import IMPLS as RING_IMPLS
from tpuflow_torch.parallel.ring_attention import ring_attention

# "full" and "flash" run the same math (the LSTM family's xla/pallas
# pattern): on a GPU both go through the flash kernels. "ring" splits the
# time axis over a mesh's ranks.
BACKENDS = ("full", "flash", "ring")


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


def _check_options(backend: str, dropout_rate: float, ring_impl: str, mesh) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; known {BACKENDS}")
    if backend == "ring" and mesh is None:
        raise ValueError('backend="ring" needs a mesh')
    if ring_impl not in RING_IMPLS:
        raise ValueError(f"unknown ring_impl {ring_impl!r}; known {RING_IMPLS}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax's ``nn.Dropout`` in training mode: each unit kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, the others
    zeroed; the keep mask is drawn from ``generator``."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class EncoderBlock(nn.Module):
    """Pre-LN block: causal multi-head attention and an MLP, each with a
    residual connection."""

    def __init__(
        self,
        dim: int,
        heads: int = 4,
        mlp_ratio: int = 4,
        dropout_rate: float = 0.0,
        backend: str = "full",
        mesh=None,
        ring_impl: str = "jnp",
    ):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim={dim} is not a multiple of heads={heads}")
        _check_options(backend, dropout_rate, ring_impl, mesh)
        self.heads = heads
        self.dropout_rate = dropout_rate
        self.backend, self.mesh, self.ring_impl = backend, mesh, ring_impl
        self.LayerNorm_0 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, mlp_ratio * dim)
        self.Dense_1 = Dense(mlp_ratio * dim, dim)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for module in self.children():
            module.reset_parameters(generator)

    def forward(self, x: torch.Tensor, plain: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        q, k, v = self.qkv(self.LayerNorm_0(x)).chunk(3, dim=-1)
        q, k, v = (_split_heads(t, self.heads).contiguous() for t in (q, k, v))
        if plain:
            att = flash_attention_reference(q, k, v)[0]
        elif self.backend == "ring":
            att = ring_attention(self.mesh, q, k, v, causal=True, impl=self.ring_impl)
        else:
            att = flash_attention(q, k, v)
        rate = self.dropout_rate if self.training else 0.0
        x = x + dropout(self.proj(_merge_heads(att, self.heads)), rate, generator)
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + dropout(self.Dense_1(h), rate, generator)


class AttentionRegressor(nn.Module):
    """Causal transformer flow regressor: ``[B, T, F] -> [B, T]`` (or
    ``[B]`` with ``readout="last"``). ``window`` is T, the length of the
    learned position embedding. Defaults are flax's: dim 64, 2 layers, 4
    heads, sequence readout. ``backend="ring"`` needs ``mesh`` (a
    ``tpuflow_torch.parallel.Mesh``), whose ring size must divide the window;
    every rank of the mesh runs the model on the same batch.
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
        mesh=None,
        ring_impl: str = "jnp",
    ):
        super().__init__()
        if readout not in READOUTS:
            raise ValueError(f"unknown readout {readout!r}; known {READOUTS}")
        _check_options(backend, dropout_rate, ring_impl, mesh)
        self.readout = readout
        self.num_layers = num_layers
        self.dropout_generator: torch.Generator | None = None
        self.embed = Dense(in_features, dim)
        self.pos_embed = nn.Parameter(torch.empty(window, dim))
        for i in range(num_layers):
            self.add_module(f"block_{i}", EncoderBlock(
                dim, heads=heads, dropout_rate=dropout_rate, backend=backend,
                mesh=mesh, ring_impl=ring_impl))
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
            h = getattr(self, f"block_{i}")(h, plain=plain, generator=self.dropout_generator)
        y = self.head(self.LayerNorm_0(h))[..., 0]  # [B, T]
        return y[:, -1] if self.readout == "last" else y
