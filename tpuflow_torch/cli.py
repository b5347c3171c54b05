"""CLI — the reference's job-submission contract, for the port's train verb.

Counterpart of the train verb of ``tpuflow/cli.py``::

    python -m tpuflow_torch.cli columnNames columnTypes targetColumn storagePath \\
        [--data PATH] [--model lstm|stacked_lstm|attention] [--epochs N] ... [--device cpu]

The positional arguments are the reference's four (reference cnn.py:41-44):
comma-separated column names, comma-separated types (int|float|anything
else = categorical), the target column and the artifact storage path. With
none, the synthetic well schema is used. ``--device`` defaults to the GPU
and fails without one; ``--device cpu`` runs the plain PyTorch path. The
JAX CLI's other flags are refused as not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuflow_torch",
        description="well-flow model training on one NVIDIA GPU (PyTorch/CUDA port)",
    )
    p.add_argument("columnNames", nargs="?", default="", help="comma-separated feature/target column names")
    p.add_argument("columnTypes", nargs="?", default="", help="comma-separated types: int|float|other=categorical")
    p.add_argument("targetColumn", nargs="?", default="flow", help="target column name")
    p.add_argument("storagePath", nargs="?", default=None, help="artifact root; best model saved under {storagePath}/models/")
    p.add_argument("--data", default=None, help="headerless CSV data path (omit for synthetic wells)")
    p.add_argument("--well-column", default=None, help="column grouping CSV rows into per-well logs")
    p.add_argument("--model", default="lstm", help="lstm|stacked_lstm|attention")
    p.add_argument("--model-kwargs", default=None, metavar="JSON",
                   help='JSON dict forwarded to the model family, e.g. \'{"hidden": 32}\'')
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--window", type=int, default=24)
    p.add_argument("--loss", default="mae_clip")
    p.add_argument("--optimizer", default="keras_sgd")
    p.add_argument("--clip-norm", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic-wells", type=int, default=8)
    p.add_argument("--synthetic-steps", type=int, default=512)
    p.add_argument("--device", default=None,
                   help="cuda (default; fails without a GPU), cuda:N or cpu")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args, rest = build_parser().parse_known_args(argv)
    if rest:
        print(
            f"{' '.join(rest)}: not ported yet to tpuflow_torch (the port's "
            "CLI has the train verb with the flags in --help; ROADMAP.md "
            "Queue 1 lists what comes next)",
            file=sys.stderr,
        )
        return 2
    from tpuflow_torch.api.config import TrainJobConfig
    from tpuflow_torch.api.train_api import train
    from tpuflow_torch.models import MODELS

    if args.model not in MODELS:
        print(f"--model: {args.model!r} is not ported yet; ported: "
              f"{', '.join(sorted(MODELS))}", file=sys.stderr)
        return 2
    model_kwargs = {}
    if args.model_kwargs:
        try:
            model_kwargs = json.loads(args.model_kwargs)
        except json.JSONDecodeError as e:
            print(f"--model-kwargs: {args.model_kwargs!r} is not valid JSON: {e}",
                  file=sys.stderr)
            return 2
        if not isinstance(model_kwargs, dict):
            print(f"--model-kwargs must be a JSON object, got {args.model_kwargs!r}",
                  file=sys.stderr)
            return 2
    config = TrainJobConfig(
        column_names=args.columnNames,
        column_types=args.columnTypes,
        target=args.targetColumn,
        storage_path=args.storagePath,
        data_path=args.data,
        well_column=args.well_column,
        model=args.model,
        model_kwargs=model_kwargs,
        max_epochs=args.epochs,
        batch_size=args.batch_size,
        patience=args.patience,
        window=args.window,
        loss=args.loss,
        optimizer=args.optimizer,
        clip_norm=args.clip_norm,
        seed=args.seed,
        synthetic_wells=args.synthetic_wells,
        synthetic_steps=args.synthetic_steps,
        verbose=not args.quiet,
    )
    train(config, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
