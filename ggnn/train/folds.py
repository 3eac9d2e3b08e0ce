"""10-fold evaluation runner (SURVEY.md §2.1 C11: 10 folds; §7.1 L5).

The reference ships 10 preprocessed folds; here each fold is an independent
resample from the task generator (fold-salted seeds,
:func:`ggnn.data.generators.generate_all`).  Reports per-fold accuracy
plus mean/std — the paper's evaluation protocol.

Usage::

    python -m ggnn.train.folds --config babi4 [--folds 10] [...]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def run_folds(config_name: str, n_folds: int = 10, **overrides) -> dict:
    from ggnn.train.config import build_config
    from ggnn.train.loop import Trainer
    from ggnn.train.metrics import MetricsLogger

    accs = []
    for fold in range(1, n_folds + 1):
        cfg = build_config(config_name, fold=fold, **overrides)
        t = Trainer(cfg, MetricsLogger(echo=False))
        result = t.run()
        accs.append(result["test_accuracy"])
        print(f"# fold {fold}: {result['test_accuracy']:.4f}",
              file=sys.stderr)
    return {
        "config": config_name,
        "folds": n_folds,
        "accuracies": accs,
        "mean_accuracy": float(np.mean(accs)),
        "std_accuracy": float(np.std(accs)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ggnn.train.folds")
    ap.add_argument("--config", required=True)
    ap.add_argument("--folds", type=int, default=10)
    ap.add_argument("--epochs", type=int)
    ap.add_argument("--data_root", type=str)
    ap.add_argument("--state_dim", type=int, dest="model_state_dim")
    ap.add_argument("--platform", type=str)
    args = ap.parse_args(argv)
    if args.platform:
        import os
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax
        jax.config.update("jax_platforms", args.platform)
    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("config", "folds", "platform") and v is not None}
    print(json.dumps(run_folds(args.config, args.folds, **overrides)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
