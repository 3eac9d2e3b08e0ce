#!/usr/bin/env python
"""Regenerate docs/RESULTS.json: 10-fold accuracy for every registered
config on the committed babi_data.  (~1h on CPU.)

Run: python scripts/run_report.py [--folds 10]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--folds", type=int, default=10)
    ap.add_argument("--out", type=str, default="docs/RESULTS.json")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")

    from ggnn.train.config import CONFIGS
    from ggnn.train.folds import run_folds

    report = {}
    for name in sorted(CONFIGS):
        res = run_folds(name, n_folds=args.folds, data_root="babi_data")
        report[name] = res
        print(json.dumps(res), flush=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
