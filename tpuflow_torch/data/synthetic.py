"""Synthetic oil-well data generator (numpy).

Counterpart of ``tpuflow/data/synthetic.py``: the same generative story and
the same sequence of draws from ``np.random.default_rng(seed)``, so a seed
gives byte-identical wells in both packages. Per-well logs of wellhead
pressure, choke size, GLR, temperature and water cut plus a categorical
completion type; the true flow is the Gilbert prediction times a correction
from channels Gilbert ignores, plus noise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpuflow_torch.core.gilbert import GILBERT, ChokeCoefficients, gilbert_flow

COMPLETION_TYPES = ("openhole", "cased", "gravelpack")

SYNTHETIC_COLUMN_NAMES = (
    "pressure,choke,glr,temperature,water_cut,completion,flow"
)
SYNTHETIC_COLUMN_TYPES = "float,float,float,float,float,string,float"
SYNTHETIC_TARGET = "flow"


@dataclass(frozen=True)
class WellLog:
    """One well's time series. All arrays are [T]."""

    pressure: np.ndarray  # wellhead pressure [psig]
    choke: np.ndarray  # choke size [64ths inch]
    glr: np.ndarray  # gas-liquid ratio [Mscf/stb]
    temperature: np.ndarray  # wellhead temperature [degF]
    water_cut: np.ndarray  # fraction [0,1]
    completion: str  # categorical well property
    flow: np.ndarray  # TRUE gross liquid rate [stb/day] (the target)

    @property
    def gilbert_flow(self) -> np.ndarray:
        """The physical-baseline prediction for this log."""
        return gilbert_flow(self.pressure, self.choke, self.glr)


def generate_wells(
    n_wells: int = 8,
    steps: int = 512,
    seed: int = 0,
    coeffs: ChokeCoefficients = GILBERT,
) -> list[WellLog]:
    """Generate ``n_wells`` independent well logs of ``steps`` timesteps."""
    rng = np.random.default_rng(seed)
    wells = []
    t = np.arange(steps, dtype=np.float32)
    for _ in range(n_wells):
        # Static well character.
        p0 = rng.uniform(150.0, 400.0)
        decline = rng.uniform(1e-4, 6e-4)
        glr0 = rng.uniform(0.4, 2.5)
        choke0 = rng.choice([16.0, 24.0, 32.0, 40.0, 48.0])
        completion = COMPLETION_TYPES[int(rng.integers(len(COMPLETION_TYPES)))]

        # Slow exponential pressure decline + operational noise.
        pressure = p0 * np.exp(-decline * t) * (
            1.0 + 0.02 * rng.standard_normal(steps)
        )
        # Choke changes occasionally (operator interventions).
        choke = np.full(steps, choke0, dtype=np.float32)
        for step in np.sort(rng.integers(0, steps, size=max(1, steps // 128))):
            choke[step:] = rng.choice([16.0, 24.0, 32.0, 40.0, 48.0])
        # GLR drifts upward as the reservoir depletes.
        glr = glr0 * (1.0 + 0.3 * t / steps) * (
            1.0 + 0.05 * rng.standard_normal(steps)
        )
        glr = np.maximum(glr, 0.05)
        temperature = rng.uniform(90.0, 180.0) + 2.0 * rng.standard_normal(steps)
        water_cut = np.clip(
            rng.uniform(0.05, 0.4)
            + 0.3 * t / steps
            + 0.02 * rng.standard_normal(steps),
            0.0,
            0.95,
        )

        # True flow: Gilbert x learnable correction + noise.
        gilbert_q = (
            pressure
            * np.power(choke, coeffs.c)
            / (coeffs.a * np.power(np.maximum(glr, 1e-6), coeffs.b))
        )
        completion_eff = {
            "openhole": 1.0,
            "cased": 0.92,
            "gravelpack": 0.85,
        }[completion]
        correction = (
            completion_eff
            * (1.0 - 0.45 * water_cut)
            * (1.0 + 0.001 * (temperature - 120.0))
        )
        noise = 1.0 + 0.03 * rng.standard_normal(steps)
        flow = gilbert_q * correction * noise

        wells.append(
            WellLog(
                pressure=pressure.astype(np.float32),
                choke=choke.astype(np.float32),
                glr=glr.astype(np.float32),
                temperature=temperature.astype(np.float32),
                water_cut=water_cut.astype(np.float32),
                completion=completion,
                flow=flow.astype(np.float32),
            )
        )
    return wells


def wells_to_table(wells: list[WellLog]) -> dict[str, np.ndarray]:
    """Flatten well logs into one tabular column dict."""
    return {
        "pressure": np.concatenate([w.pressure for w in wells]),
        "choke": np.concatenate([w.choke for w in wells]),
        "glr": np.concatenate([w.glr for w in wells]),
        "temperature": np.concatenate([w.temperature for w in wells]),
        "water_cut": np.concatenate([w.water_cut for w in wells]),
        "completion": np.concatenate(
            [np.full(len(w.pressure), w.completion) for w in wells]
        ),
        "flow": np.concatenate([w.flow for w in wells]),
    }


def write_csv(path: str, table: dict[str, np.ndarray], names: list[str]) -> None:
    """Write a headerless CSV in the given column order."""
    cols = [table[n] for n in names]
    n = len(cols[0])
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            f.write(",".join(str(c[i]) for c in cols) + "\n")
