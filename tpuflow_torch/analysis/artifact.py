"""Artifact/config compatibility: static checks for the serving sidecar.

Counterpart of ``tpuflow/analysis/artifact.py``. ``Predictor.load`` reads the
JSON sidecar and rebuilds the model it describes; these checks reject a
stale, hand-edited or mismatched sidecar at load with the field that is
wrong, before the checkpoint is read. Every finding is collected and
``ensure_artifact_meta`` raises one ``ValueError`` naming them all.
"""

from __future__ import annotations

_REQUIRED_KEYS = ("model", "model_kwargs", "kind", "preprocessor",
                  "sample_shape")
_KINDS = ("tabular", "windowed")
# The JAX package's sequence families (TrainJobConfig.is_sequence_model):
# they serve from a "windowed" sidecar, every other family from "tabular".
_SEQUENCE_MODELS = ("dynamic_mlp", "cnn1d", "lstm", "stacked_lstm",
                    "lstm_residual", "attention")
_WINDOWED_PREPROCESSOR_KEYS = ("feature_names", "window", "stride", "mean",
                               "std", "target_mean", "target_std",
                               "schema_columns", "target")


def check_artifact_meta(meta) -> list[str]:
    """Validate a serving sidecar dict; returns ALL findings as
    ``"code: message"`` strings (empty when the sidecar is servable)."""
    from tpuflow_torch.models import MODELS, NOT_PORTED, build_model

    if not isinstance(meta, dict):
        return [f"artifact.meta.type: sidecar must be a JSON object, got "
                f"{type(meta).__name__}: {meta!r}"]
    missing = [k for k in _REQUIRED_KEYS if k not in meta]
    if missing:
        return [f"artifact.keys.missing: sidecar is missing required keys "
                f"{missing}"]
    out = []
    model, kind = meta["model"], meta["kind"]
    if model in NOT_PORTED:
        out.append(f"artifact.model.not_ported: model {model!r} is not ported "
                   f"yet to tpuflow_torch (ported: {sorted(MODELS)}); see "
                   "ROADMAP.md")
    elif model not in MODELS:
        out.append(f"artifact.model.unknown: sidecar names unknown model "
                   f"{model!r}; known {sorted(MODELS)}")
    if kind not in _KINDS:
        out.append(f"artifact.kind.unknown: sidecar kind {kind!r} is not a "
                   f"serving kind {_KINDS}")
    elif kind == "tabular":
        out.append("artifact.kind.not_ported: tabular artifacts are not "
                   "ported yet to tpuflow_torch; see ROADMAP.md")
    elif model in MODELS or model in NOT_PORTED:
        expect = "windowed" if model in _SEQUENCE_MODELS else "tabular"
        if kind != expect:
            out.append(f"artifact.kind.mismatch: model {model!r} serves from a "
                       f"{expect!r} sidecar, got kind {kind!r}")
    kwargs = meta["model_kwargs"]
    if not isinstance(kwargs, dict):
        out.append(f"artifact.model_kwargs.type: sidecar model_kwargs must be "
                   f"a dict, got {type(kwargs).__name__}")
    shape = meta["sample_shape"]
    if (
        not isinstance(shape, (list, tuple))
        or len(shape) != 3
        or not all(isinstance(d, int) and d > 0 for d in shape)
    ):
        out.append(f"artifact.sample_shape.invalid: a windowed sidecar's "
                   f"sample_shape is [N, window, features] of positive ints, "
                   f"got {shape!r}")
    pre = meta["preprocessor"]
    if kind == "windowed":
        absent = (
            list(_WINDOWED_PREPROCESSOR_KEYS) if not isinstance(pre, dict)
            else [k for k in _WINDOWED_PREPROCESSOR_KEYS if k not in pre]
        )
        if absent:
            out.append(f"artifact.preprocessor.keys: windowed preprocessor is "
                       f"missing {absent}")
    if out:
        return out
    try:
        build_model(model, shape[-1], **kwargs)
    except (TypeError, ValueError) as e:
        out.append(f"artifact.init: sidecar model {model!r} with kwargs "
                   f"{kwargs!r} does not build: {type(e).__name__}: {e}")
    return out


def ensure_artifact_meta(meta, where: str = "artifact") -> None:
    """Raise ``ValueError`` naming every sidecar problem."""
    findings = check_artifact_meta(meta)
    if findings:
        raise ValueError(
            f"{where}: incompatible serving sidecar — " + "; ".join(findings)
        )
