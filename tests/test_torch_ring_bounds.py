"""The ring rounds' bounds in ``chip_smoke.py``: the allowed pairs a round
counts, and the least time the card could take for a round on the tensor
cores in 3xTF32 (three TF32 products for each f32 operation), which sets
the ring-round kernels' goal at long chunks. Loads the script by path, as
it stands at the repository's root."""

import importlib.util
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bounds", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("Tl,q_off,k_off", [(64, 64, 64), (64, 128, 64), (64, 0, 64),
                                            (100, 130, 100), (250, 95, 100), (12, 7, 37)])
def test_ring_pairs_counts_the_allowed_pairs(smoke, Tl, q_off, k_off):
    q_pos = q_off + np.arange(Tl)[:, None]
    k_pos = k_off + np.arange(Tl)[None, :]
    assert smoke.ring_pairs(Tl, q_off, k_off) == int((k_pos <= q_pos).sum())


def test_ring_pairs_of_the_ring_patterns(smoke):
    for Tl in (1, 64, 1024):
        assert smoke.ring_pairs(Tl, Tl, Tl) == Tl * (Tl + 1) // 2
        assert smoke.ring_pairs(Tl, 2 * Tl, Tl) == Tl * Tl
        assert smoke.ring_pairs(Tl, 0, Tl) == 0


# (BH, Tl, D), pattern -> (forward ms, what sets it), (backward ms, what sets it)
BOUNDS = {
    ((256, 1024, 16), "diagonal"): ((0.0521, "tensor cores"), (0.130, "tensor cores")),
    ((256, 1024, 16), "past"): ((0.104, "tensor cores"), (0.260, "tensor cores")),
    ((80, 64, 16), "diagonal"): ((0.000514, "bytes"), (0.000697, "bytes")),
    ((80, 64, 16), "past"): ((0.000514, "bytes"), (0.000697, "bytes")),
}


@pytest.mark.parametrize("shape,pattern", sorted(BOUNDS))
def test_ring_tensor_core_bounds(smoke, shape, pattern):
    BH, Tl, D = shape
    qo, ko = smoke.RING_PATTERNS[pattern]
    pairs = smoke.ring_pairs(Tl, qo * Tl, ko * Tl)
    got = (smoke.ring_fwd_tc_bound(BH, Tl, D, pairs), smoke.ring_bwd_tc_bound(BH, Tl, D, pairs))
    for (ms, by), (want_ms, want_by) in zip(got, BOUNDS[shape, pattern]):
        assert by == want_by
        assert float(f"{ms:.3g}") == pytest.approx(want_ms, rel=1e-9)
    # The f32 bound of the CUDA cores counts the same bytes and a third of
    # the operations at 67 of 495 TFLOP/s: never below the 3xTF32 one.
    assert smoke.ring_fwd_bound(BH, Tl, D, pairs)[0] >= got[0][0]
    assert smoke.ring_bwd_bound(BH, Tl, D, pairs)[0] >= got[1][0]
