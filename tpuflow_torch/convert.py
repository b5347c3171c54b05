"""Carry weights between a flax ``params`` tree and a port module.

The port keeps flax's parameter names and layouts, so the mapping is by
name: the flax path ``lstm_0/w_x`` is the state-dict key ``lstm_0.w_x``,
with no transposes. A checkpoint stores the leaves in the order
``jax.tree_util.tree_leaves`` gives for the flax tree, which sorts dict keys
at every level; ``flax_leaf_order`` reproduces that order for a module.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """Nested flax ``params`` dict of arrays -> flat torch state dict."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, value in node.items():
            path = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(value, dict):
                walk(value, path)
            else:
                out[path] = torch.from_numpy(np.array(value, copy=True))

    walk(dict(tree), "")
    return out


def params_to_flax(state_dict: dict[str, torch.Tensor]) -> dict:
    """Flat torch state dict -> nested flax ``params`` dict of numpy arrays."""
    tree: dict = {}
    for key, value in state_dict.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().cpu().numpy()
    return tree


def flax_leaf_order(model: nn.Module) -> list[str]:
    """The module's state-dict keys in flax tree-leaves order (sorted path
    components: ``head.bias``, ``head.kernel``, ``lstm_0.b``, ...)."""
    return sorted(model.state_dict(), key=lambda k: tuple(k.split(".")))


def model_leaves(model: nn.Module) -> list[np.ndarray]:
    """The module's parameters as host arrays, in flax leaf order — what a
    checkpoint stores."""
    state = model.state_dict()
    return [state[k].detach().cpu().numpy() for k in flax_leaf_order(model)]


def load_leaves(model: nn.Module, leaves: list[np.ndarray]) -> None:
    """Copy checkpoint leaves (flax leaf order) into ``model``; the leaf
    count and every shape must match, or this raises naming the first
    mismatch."""
    keys = flax_leaf_order(model)
    if len(leaves) != len(keys):
        raise ValueError(
            f"checkpoint carries {len(leaves)} leaves; this model has "
            f"{len(keys)} — different model/config?"
        )
    state = model.state_dict()
    for i, (key, leaf) in enumerate(zip(keys, leaves)):
        want = tuple(state[key].shape)
        if tuple(leaf.shape) != want:
            raise ValueError(
                f"checkpoint leaf {i} ({key}) has shape {tuple(leaf.shape)}; "
                f"this model expects {want} — different model/config?"
            )
    model.load_state_dict(
        {k: torch.from_numpy(np.array(leaf)) for k, leaf in zip(keys, leaves)}
    )
