"""Gilbert's-equation physical choke-flow model, in numpy and torch.

Counterpart of ``tpuflow/core/gilbert.py``. Gilbert's (1954) correlation
``P_wh = A * GLR^B * q / S^C`` solved for the liquid rate gives the physical
baseline ``q = P_wh * S^C / (A * GLR^B)``; other (A, B, C) sets give the Ros,
Baxendell and Achong correlations.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ChokeCoefficients(NamedTuple):
    """Coefficients (A, B, C) of the Gilbert-form choke correlation."""

    a: float
    b: float
    c: float


GILBERT = ChokeCoefficients(10.0, 0.546, 1.89)
ROS = ChokeCoefficients(17.4, 0.5, 2.0)
BAXENDELL = ChokeCoefficients(9.56, 0.546, 1.93)
ACHONG = ChokeCoefficients(3.82, 0.65, 1.88)

COEFFICIENTS = {
    "gilbert": GILBERT,
    "ros": ROS,
    "baxendell": BAXENDELL,
    "achong": ACHONG,
}

_EPS = 1e-6


def gilbert_flow(
    wellhead_pressure, choke_size, glr, coeffs: ChokeCoefficients = GILBERT
):
    """Gross liquid rate q [stb/day]: ``q = P_wh * S^c / (a * GLR^b)``.

    Takes torch tensors (computed with torch, on their device) or anything
    numpy accepts (computed with numpy). GLR and choke size are clamped away
    from zero.
    """
    if isinstance(wellhead_pressure, torch.Tensor):
        glr = torch.clamp(torch.as_tensor(glr), min=_EPS)
        choke_size = torch.clamp(torch.as_tensor(choke_size), min=_EPS)
        return (
            wellhead_pressure
            * torch.pow(choke_size, coeffs.c)
            / (coeffs.a * torch.pow(glr, coeffs.b))
        )
    glr = np.maximum(glr, np.float32(_EPS))
    choke_size = np.maximum(choke_size, np.float32(_EPS))
    return (
        np.asarray(wellhead_pressure)
        * np.power(choke_size, np.float32(coeffs.c))
        / (np.float32(coeffs.a) * np.power(glr, np.float32(coeffs.b)))
    )


def append_gilbert_channel(
    series, feature_names, coeffs: ChokeCoefficients = GILBERT
):
    """Append the RAW per-timestep Gilbert prediction as the LAST channel of
    a ``[T, F]`` series whose columns are named by ``feature_names`` (the
    input contract of the physics-informed sequence artifacts)."""
    missing = {"pressure", "choke", "glr"} - set(feature_names)
    if missing:
        raise ValueError(
            f"append_gilbert needs pressure/choke/glr channels; "
            f"missing {sorted(missing)}"
        )
    ip = feature_names.index("pressure")
    ic = feature_names.index("choke")
    ig = feature_names.index("glr")
    q = np.asarray(
        gilbert_flow(series[:, ip], series[:, ic], series[:, ig], coeffs),
        dtype=np.float32,
    )
    return np.concatenate([np.asarray(series), q[:, None]], axis=1)
