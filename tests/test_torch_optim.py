"""The port's optimizers against optax over one fixed sequence of gradients.

Both start from the same params and see the same gradients (seeded numpy);
after every update the params must agree, within f32 rounding of the two
frameworks' update formulas (rtol 1e-5, atol 1e-6), and the port's returned
global norm must equal optax's norm of the raw gradients.
"""

import numpy as np
import optax
import pytest
import torch

from tpuflow.train.optim import build_optimizer as jax_build_optimizer
from tpuflow.train.optim import wrap_optimizer as jax_wrap_optimizer
from tpuflow_torch.train.optim import build_optimizer, keras_sgd, wrap_optimizer

SHAPES = {"a": (3, 4), "b": (5,)}
STEPS = 8


def _run_both(name, kwargs, clip_norm=0.0, grad_scale=1.0):
    rng = np.random.default_rng(len(name) + int(clip_norm * 10))
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [
        {k: (rng.standard_normal(s) * grad_scale * (1 + i % 3)).astype(np.float32)
         for k, s in SHAPES.items()}
        for i in range(STEPS)
    ]
    tx = jax_wrap_optimizer(jax_build_optimizer(name, **kwargs), clip_norm=clip_norm)
    jp, state = dict(params), None
    state = tx.init(jp)
    port = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = wrap_optimizer(build_optimizer(name, **kwargs), clip_norm=clip_norm).bind(
        [port["a"], port["b"]]
    )
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in port:
            port[k].grad = torch.from_numpy(g[k].copy())
        gnorm = opt.step()
        np.testing.assert_allclose(gnorm.item(), float(optax.global_norm(g)), rtol=1e-6)
        for k in port:
            np.testing.assert_allclose(
                port[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6
            )
    return opt


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("keras_sgd", {}),
        # A steep decay, so that the per-update schedule shows.
        ("keras_sgd", {"learning_rate": 0.05, "decay": 0.5}),
        ("keras_sgd", {"learning_rate": 0.01, "momentum": 0.9, "nesterov": False}),
        ("adam", {"learning_rate": 0.01}),
        ("adamw", {"learning_rate": 0.01}),
        ("adamw", {"learning_rate": 0.01, "weight_decay": 0.05}),
    ],
)
def test_updates_match_optax(name, kwargs):
    opt = _run_both(name, kwargs)
    assert opt.count == STEPS


@pytest.mark.parametrize("clip_norm", [1.0, 4.0])
def test_clip_norm_matches_optax_clip_by_global_norm(clip_norm):
    """Gradients with norms around the limit: some updates clipped, some
    not; optax scales by max/||g|| with no epsilon."""
    _run_both("keras_sgd", {"learning_rate": 0.05}, clip_norm=clip_norm, grad_scale=0.6)


def test_schedule_counts_from_zero():
    spec = keras_sgd(learning_rate=0.1, decay=1.0)
    got = [spec.schedule(torch.tensor(k)).item() for k in range(3)]
    assert got == [float(np.float32(0.1) / np.float32(d)) for d in (1, 2, 3)]


@pytest.mark.parametrize("decay", [1e-6, 0.1, 0.5])
def test_device_schedule_is_optax_f32_schedule(decay):
    """The learning rate the port computes on the device from its update
    count, as a captured step replays it, against optax's: the update
    optax's keras_sgd (momentum 0) applies to a unit gradient is ``-lr_k``.
    Both in f32, equal to within one f32 rounding."""
    tx = jax_build_optimizer("keras_sgd", learning_rate=0.05, momentum=0.0, decay=decay)
    p = {"w": np.zeros(1, np.float32)}
    state = tx.init(p)
    spec = keras_sgd(learning_rate=0.05, momentum=0.0, decay=decay)
    for k in range(40):
        updates, state = tx.update({"w": np.ones(1, np.float32)}, state, p)
        got = spec.schedule(torch.tensor(k, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(-got.numpy(), np.asarray(updates["w"])[0], rtol=1.2e-7)


def test_refusals():
    with pytest.raises(NotImplementedError, match="accumulate_steps.*not ported yet"):
        wrap_optimizer(keras_sgd(), accumulate_steps=2)
    with pytest.raises(ValueError, match="clip_norm"):
        wrap_optimizer(keras_sgd(), clip_norm=-1.0)
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer("lamb")
