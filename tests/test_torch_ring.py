"""The port's ring attention, over four gloo ranks, against the JAX package.

One group of four ranks (``tpuflow_torch.parallel.spawn``, CPU, gloo) runs
every rank-side check of this file at once, in a module-scoped fixture:
``ring_attention`` with both impls, forward and gradients; the attention
regressor with ``backend="ring"`` on params copied from flax; and a
four-rank ``train()`` that writes one artifact. The JAX side runs in this
process on its four-device test ring (``tests.conftest.ring_mesh``), with
the oracles ``tests/test_ring_attention.py`` uses (``full_attention``'s
gradients, ``backend="full"``). Under pytest-xdist the workers share one
run of the group through a file lock (``_run_once``).
"""

import fcntl
import json
import os
import pickle

import numpy as np
import pytest
import torch

from tpuflow_torch.models import build_model
from tpuflow_torch.parallel import Mesh, pmean, psum, ring_attention
from tpuflow_torch.parallel.ring_attention import ring_attention_spmd

ATOL = 1e-5  # outputs, f32 (tests/test_ring_attention.py)
GRAD_ATOL = 1e-4  # gradients
RANKS = 4  # tests/conftest.py RING_DEVICES
SMALL = {"dim": 16, "num_layers": 1, "heads": 2}
CASES = (("jnp", True), ("flash", True), ("jnp", False))


def _qkv(B=2, T=16, D=8, seed=5):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(3))


def _model_batch():
    return np.random.default_rng(2).standard_normal((2, 16, 5)).astype(np.float32)


def _ranks(mesh, state, root):
    """Every rank's part: ring attention per CASES (output and the
    gradients of sum(out^2)), the ring regressor's output and the gradients
    of mean(y^2), and a small train() into ``root``."""
    from tpuflow_torch.api.config import TrainJobConfig
    from tpuflow_torch.api.train_api import train

    out = {}
    for impl, causal in CASES:
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv())
        o = ring_attention(mesh, q, k, v, causal=causal, impl=impl)
        (o * o).sum().backward()
        out[(impl, causal)] = (o.detach().numpy(), [t.grad.numpy() for t in (q, k, v)])
    model = build_model("attention", 5, window=16, backend="ring", mesh=mesh, **SMALL)
    model.load_state_dict({n: torch.from_numpy(a) for n, a in state.items()})
    y = model(torch.from_numpy(_model_batch()))
    torch.mean(torch.square(y)).backward()
    out["model"] = (y.detach().numpy(), {n: p.grad.numpy() for n, p in model.named_parameters()})
    report = train(TrainJobConfig(
        model="attention", model_kwargs={"backend": "ring", "mesh": mesh, **SMALL},
        window=16, max_epochs=1, batch_size=32, storage_path=root, verbose=False,
        synthetic_wells=2, synthetic_steps=48,
    ), device="cpu")
    x = torch.full((3,), float(mesh.rank + 1), requires_grad=True)
    total, mean = psum(x, mesh), pmean(x, mesh)
    (total.sum() + 2 * mean.sum()).backward()
    out["reduce"] = (total.detach().numpy(), mean.detach().numpy(), x.grad.numpy())
    out["train"] = {
        "test_loss": report.test_loss,
        "params": {n: p.detach().numpy() for n, p in report.result.model.named_parameters()},
    }
    return out


def _run_once(tmp_path_factory, name, compute):
    """``compute()`` once per test run: under pytest-xdist the workers share
    its pickled result through a file lock in the run's shared temp dir."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        return compute()
    shared = tmp_path_factory.getbasetemp().parent
    path = shared / f"{name}-{uid}.pkl"
    with open(shared / f"{name}-{uid}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return pickle.loads(path.read_bytes())
        result = compute()
        path.write_bytes(pickle.dumps(result))
        return result


@pytest.fixture(scope="module")
def flax_small():
    """flax params of the small regressor and their port state dict."""
    import jax

    from tpuflow.models import AttentionRegressor as JaxAttentionRegressor
    from tpuflow_torch.convert import params_from_flax

    params = JaxAttentionRegressor(**SMALL).init(jax.random.PRNGKey(0), _model_batch())["params"]
    state = {n: t.numpy() for n, t in params_from_flax(jax.device_get(params)).items()}
    return params, state


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory, flax_small):
    from tpuflow_torch.parallel import spawn

    def compute():
        root = str(tmp_path_factory.mktemp("ring_train"))
        return root, spawn(_ranks, RANKS, flax_small[1], root, device="cpu", timeout_s=240)

    return _run_once(tmp_path_factory, "torch_ring", compute)


@pytest.mark.parametrize("impl", ["jnp", "flash"])
def test_forward_matches_jax_ring_attention(ring_run, impl):
    import jax.numpy as jnp

    from tests.conftest import ring_mesh
    from tpuflow.parallel import ring_attention as jax_ring_attention

    want = np.asarray(jax_ring_attention(ring_mesh(), *(jnp.asarray(a) for a in _qkv()),
                                         impl=impl))
    for rank in ring_run[1]:
        np.testing.assert_allclose(rank[(impl, True)][0], want, atol=ATOL)


@pytest.mark.parametrize("impl,causal", CASES)
def test_gradients_match_jax_oracle(ring_run, impl, causal):
    """Every rank's full gradients (all-gathered) equal ``jax.grad`` of
    sum(out^2) through ``full_attention``, the oracle of
    tests/test_ring_attention.py; a non-causal ring too (impl jnp)."""
    import jax
    import jax.numpy as jnp

    from tpuflow.parallel import full_attention as jax_full_attention

    qkv = tuple(jnp.asarray(a) for a in _qkv())
    out = jax_full_attention(*qkv, causal=causal)
    grads = jax.grad(lambda *a: jnp.sum(jnp.square(jax_full_attention(*a, causal=causal))),
                     argnums=(0, 1, 2))(*qkv)
    for rank in ring_run[1]:
        got_out, got_grads = rank[(impl, causal)]
        np.testing.assert_allclose(got_out, np.asarray(out), atol=ATOL)
        for g, w, name in zip(got_grads, grads, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL, err_msg=name)


def test_psum_and_pmean_reduce_and_pass_gradients_through(ring_run):
    """The sum and mean over the ranks reach every rank; their results are
    replicated, so the backward is the identity (the mean's divided by the
    ring's size), not a second sum."""
    for rank in ring_run[1]:
        total, mean, grad = rank["reduce"]
        np.testing.assert_array_equal(total, np.full(3, 10.0))
        np.testing.assert_array_equal(mean, np.full(3, 2.5))
        np.testing.assert_allclose(grad, np.full(3, 1.0 + 2.0 / RANKS))


def _mesh_of(size):
    """A mesh for the checks that raise before any communication."""
    return Mesh(group=None, size=size, rank=0, device=torch.device("cpu"), backend="gloo")


def test_the_jax_errors():
    q = torch.zeros((1, 10, 4))
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(_mesh_of(4), q, q, q)
    q = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError, match="unknown impl"):
        ring_attention_spmd(q, q, q, _mesh_of(1), impl="pallas")
    with pytest.raises(ValueError, match="causal"):
        ring_attention_spmd(q, q, q, _mesh_of(1), causal=False, impl="flash")


def test_ring_regressor_matches_jax_full_backend(ring_run, flax_small):
    """``AttentionRegressor(backend="ring")`` on params copied from flax:
    output and parameter gradients of mean(y^2) against JAX's
    ``backend="full"`` (tests/test_ring_attention.py:198-250)."""
    import jax
    import jax.numpy as jnp

    from tpuflow.models import AttentionRegressor as JaxAttentionRegressor
    from tpuflow_torch.convert import params_to_flax

    params, _ = flax_small
    full = JaxAttentionRegressor(**SMALL)
    x = _model_batch()
    want_y = np.asarray(full.apply({"params": params}, x))
    want = jax.grad(lambda p: jnp.mean(jnp.square(full.apply({"params": p}, x))))(params)
    for rank in ring_run[1]:
        y, grads = rank["model"]
        np.testing.assert_allclose(y, want_y, atol=ATOL)
        got = params_to_flax({n: torch.from_numpy(g) for n, g in grads.items()})
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL),
            got, want)


def test_ring_backend_needs_a_mesh():
    with pytest.raises(ValueError, match='backend="ring" needs a mesh'):
        build_model("attention", 5, window=16, backend="ring", **SMALL)


def test_ring_train_writes_one_servable_artifact(ring_run):
    """The counterpart of tests/test_api.py:120-150: a four-rank train()
    leaves one artifact, whose sidecar serves the ring run as "full" with no
    mesh, and the port's Predictor loads it; the ranks end bitwise equal."""
    from tpuflow_torch.api.predict_api import Predictor

    root, ranks = ring_run
    with open(os.path.join(root, "meta", "attention.json")) as f:
        meta = json.load(f)
    assert meta["model_kwargs"] == {"backend": "full", **SMALL}
    assert os.listdir(os.path.join(root, "meta")) == ["attention.json"]
    first = ranks[0]["train"]
    assert np.isfinite(first["test_loss"])
    for rank in ranks[1:]:
        assert rank["train"]["test_loss"] == first["test_loss"]
        for name, p in first["params"].items():
            np.testing.assert_array_equal(rank["train"]["params"][name], p)
    pred = Predictor.load(root, "attention", device="cpu")
    x = np.random.default_rng(3).standard_normal((4, 16, 5)).astype(np.float32)
    assert np.isfinite(pred.forward_prepared(x)).all()
