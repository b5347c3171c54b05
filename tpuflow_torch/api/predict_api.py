"""Serving: load a trained artifact and predict flow for new data.

Counterpart of ``tpuflow/api/predict_api.py`` for windowed (sequence)
artifacts. An artifact is the best checkpoint (the checksummed-npz store
layout, ``tpuflow_torch.storage.checkpoint``) plus a JSON sidecar at
``{storage}/meta/{name}.json`` with the model config and the fitted
preprocessor state. Windowing, well grouping, normalisation, pow-2 tail
padding and denormalisation follow the JAX package step for step, so both
give the same predictions for one artifact. Tabular artifacts are not ported
yet.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass

import numpy as np
import torch

from tpuflow_torch import resolve_device
from tpuflow_torch.data.csv_io import read_csv
from tpuflow_torch.data.schema import ColumnSpec, Schema
from tpuflow_torch.utils.paths import join_path, open_file


def _meta_path(storage_path: str, name: str) -> str:
    return join_path(storage_path, "meta", f"{name}.json")


def save_artifact_meta(
    storage_path: str,
    name: str,
    model: str,
    model_kwargs: dict,
    kind: str,
    preprocessor: dict,
    sample_shape: tuple,
) -> None:
    """Write the serving sidecar next to the checkpoint tree."""
    with open_file(_meta_path(storage_path, name), "w", encoding="utf-8") as f:
        json.dump(
            {
                "model": model,
                "model_kwargs": model_kwargs,
                "kind": kind,  # "tabular" | "windowed"
                "preprocessor": preprocessor,
                "sample_shape": list(sample_shape),
            },
            f,
        )


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclass
class WindowIndex:
    """Maps windowed predictions back to input rows: prediction ``i`` is
    the window of ``window`` steps starting at ``starts[i]`` (a row index
    into the original input) of well ``wells[i]``."""

    wells: list
    starts: np.ndarray


@dataclass
class Predictor:
    """A loaded artifact: the model on its device plus the preprocessor."""

    model_name: str
    kind: str
    model: torch.nn.Module
    device: torch.device
    _meta: dict
    warm_buckets: tuple = ()  # pow-2 batch sizes run by warmup()

    @classmethod
    def load(cls, storage_path: str, name: str, device=None) -> "Predictor":
        """Read the sidecar, check it, rebuild the model and restore its
        best params onto ``device`` (``None``: the GPU, raising when there
        is none)."""
        from tpuflow_torch.analysis.artifact import ensure_artifact_meta
        from tpuflow_torch.convert import load_leaves
        from tpuflow_torch.models import build_model
        from tpuflow_torch.storage.checkpoint import StoreCheckpointer

        dev = resolve_device(device)
        path = _meta_path(storage_path, name)
        with open_file(path, "r", encoding="utf-8") as f:
            meta = json.load(f)
        ensure_artifact_meta(meta, where=path)
        model = build_model(
            meta["model"], meta["sample_shape"][-1], **meta["model_kwargs"]
        )
        load_leaves(model, StoreCheckpointer(storage_path, name).restore_best())
        model.to(dev).eval()
        return cls(
            model_name=name, kind=meta["kind"], model=model, device=dev,
            _meta=meta,
        )

    # --- input preparation ---

    def _features_windowed(
        self, columns: dict[str, np.ndarray]
    ) -> tuple[np.ndarray, WindowIndex]:
        p = self._meta["preprocessor"]
        names = p["feature_names"]
        window, stride = p["window"], p["stride"]
        series = np.stack(
            [np.asarray(columns[n], np.float32) for n in names], axis=1
        )
        if p.get("append_gilbert"):
            from tpuflow_torch.core.gilbert import append_gilbert_channel

            series = append_gilbert_channel(series, names)
        mean = np.asarray(p["mean"], np.float32)
        std = np.asarray(p["std"], np.float32)
        well_col = p.get("well_column")
        if well_col and well_col in columns:
            ids = np.asarray(columns[well_col])
            # Group each well's rows in time order; groups in order of first
            # appearance, so predictions come out in input order.
            uniq, first_idx, inverse, counts = np.unique(
                ids, return_index=True, return_inverse=True, return_counts=True
            )
            clustered = np.argsort(inverse, kind="stable")
            slices = np.split(clustered, np.cumsum(counts)[:-1])
            groups = [(uniq[i], slices[i]) for i in np.argsort(first_idx)]
        else:
            groups = [(None, np.arange(len(series)))]
        chunks, wells_out, starts_out = [], [], []
        for well, rows in groups:
            s = series[rows]
            if len(s) < window:
                print(
                    f"tpuflow_torch.predict: well {well!r} has {len(s)} rows "
                    f"< window={window}; skipped",
                    file=sys.stderr,
                )
                continue
            starts = np.arange(0, len(s) - window + 1, stride)
            chunks.append(np.stack([s[i : i + window] for i in starts]))
            wells_out.extend([well] * len(starts))
            starts_out.append(rows[starts])
        if not chunks:
            raise ValueError(f"no full {window}-step windows in input")
        x = np.concatenate(chunks, axis=0)
        x = ((x - mean) / std).astype(np.float32)
        return x, WindowIndex(wells_out, np.concatenate(starts_out))

    def schema(self, with_target: bool = True) -> Schema:
        """The trained schema; ``with_target=False`` = serving variant for
        unlabeled CSVs."""
        p = self._meta["preprocessor"]
        cols = [(c["name"], c["kind"]) for c in p["schema_columns"]]
        target = p["target"]
        if not with_target:
            cols = [(n, k) for n, k in cols if n != target]
            target = None
        return Schema(
            columns=tuple(ColumnSpec(n, k) for n, k in cols), target=target
        )

    # --- serving entry points ---

    @torch.inference_mode()
    def _forward_batched(
        self, x: np.ndarray, batch_size: int, plain: bool = False
    ) -> np.ndarray:
        """Chunked forward with pow-2 padding on the ragged tail (the last
        row repeated), as the JAX package pads to bound its compiles."""
        outs = []
        for s in range(0, len(x), batch_size):
            chunk = x[s : s + batch_size]
            n = len(chunk)
            padded = min(_next_pow2(n), batch_size)
            if padded > n:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], padded - n, axis=0)]
                )
            xt = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            pred = self.model(xt, plain=plain).cpu().numpy()
            outs.append(pred[:n])
        return np.concatenate(outs, axis=0)

    def prepare_columns(
        self, columns: dict[str, np.ndarray]
    ) -> tuple[np.ndarray, WindowIndex]:
        """Raw input columns -> normalised windows and their index.
        Request-shaped errors (missing columns, short wells) surface here."""
        return self._features_windowed(columns)

    def forward_prepared(
        self, x: np.ndarray, batch_size: int = 4096, plain: bool = False
    ) -> np.ndarray:
        """Forward over prepared windows, denormalised to raw target units.
        ``plain=True`` runs the kernels' plain versions on this device, to
        hold the kernels against them."""
        if len(x) == 0:
            return np.zeros((0,), np.float32)
        p = self._meta["preprocessor"]
        y = self._forward_batched(x, batch_size, plain=plain)
        return y * float(p["target_std"]) + float(p["target_mean"])

    def warmup(self, top: int = 2, max_rows: int = 4096) -> list[int]:
        """Run the ``top`` largest pow-2 forward buckets <= ``max_rows`` on
        zeros (largest first), so the first requests after a load find the
        kernels built and the allocator warm. Returns the bucket sizes."""
        buckets: list[int] = []
        b = _next_pow2(max(max_rows, 1))
        if b > max_rows:
            b >>= 1
        while b >= 1 and len(buckets) < max(top, 0):
            buckets.append(b)
            b >>= 1
        tail = list(self._meta["sample_shape"][1:])
        for size in buckets:
            self._forward_batched(np.zeros([size] + tail, np.float32), size)
        self.warm_buckets = tuple(buckets)
        return buckets

    def predict_columns(
        self,
        columns: dict[str, np.ndarray],
        batch_size: int = 4096,
        return_index: bool = False,
    ):
        """Predict RAW-unit flow from raw input columns; ``return_index``
        also returns the ``WindowIndex``."""
        x, index = self.prepare_columns(columns)
        y = self.forward_prepared(x, batch_size)
        if return_index:
            return y, index
        return y

    def columns_from_csv(self, path: str) -> dict[str, np.ndarray]:
        """Read a headerless CSV into raw columns — with or without the
        target column (field count selects the schema variant)."""
        with open(path, "r", encoding="utf-8") as f:
            first = f.readline()
        nfields = len(first.rstrip("\n").rstrip("\r").split(","))
        full = self.schema(with_target=True)
        serving = self.schema(with_target=False)
        if nfields == len(full.columns):
            schema = full
        elif nfields == len(serving.columns):
            schema = serving
        else:
            raise ValueError(
                f"{path}: first line has {nfields} fields; expected "
                f"{len(full.columns)} (with target "
                f"{full.target!r}) or {len(serving.columns)} (without)"
            )
        return read_csv(path, schema)

    def predict_csv(
        self, path: str, batch_size: int = 4096, return_index: bool = False
    ):
        """Predict from a headerless CSV — with or without the target."""
        return self.predict_columns(
            self.columns_from_csv(path),
            batch_size=batch_size,
            return_index=return_index,
        )


def predict(
    storage_path: str,
    name: str,
    data_path: str | None = None,
    columns: dict[str, np.ndarray] | None = None,
    return_index: bool = False,
    device=None,
):
    """One-call serving: load artifact, predict raw-unit flow."""
    pred = Predictor.load(storage_path, name, device=device)
    if data_path is not None:
        return pred.predict_csv(data_path, return_index=return_index)
    if columns is not None:
        return pred.predict_columns(columns, return_index=return_index)
    raise ValueError("pass data_path or columns")
