"""CLI experiment driver (SURVEY.md §2.1 C1).

Reference interface: ``python main.py --task_id 4 --state_dim 4 ...``
(SURVEY.md §1.2).  Here::

    python -m ggnn.train --config babi4 [--epochs 100] [--lr 1e-3]
           [--state_dim 4] [--n_steps 5] [--batch_size 10] [--seed 0]
           [--question_id 0] [--data_root babi_data] [--backend xla]
           [--platform cpu|gpu] [--metrics out.jsonl] [--checkpoint_dir d]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ggnn.train")
    ap.add_argument("--config", required=True,
                    help="registered config name (babi4/babi15/babi16/babi18/babi19)")
    ap.add_argument("--epochs", type=int)
    ap.add_argument("--lr", type=float)
    ap.add_argument("--batch_size", type=int)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--question_id", type=int)
    ap.add_argument("--fold", type=int)
    ap.add_argument("--n_train", type=int)
    ap.add_argument("--n_test", type=int)
    ap.add_argument("--data_root", type=str)
    ap.add_argument("--backend", type=str,
                    choices=["xla", "onehot"])
    ap.add_argument("--state_dim", type=int, dest="model_state_dim")
    ap.add_argument("--n_steps", type=int, dest="model_n_steps")
    ap.add_argument("--graph_dim", type=int, dest="model_graph_dim",
                    help="gated-readout width (graph-level heads)")
    ap.add_argument("--ggsnn_output", type=str, dest="model_ggsnn_output",
                    choices=["graph", "node"],
                    help="GGS-NN output net: token per round or next-node selection")
    ap.add_argument("--hidden_dim", type=int, dest="model_hidden_dim",
                    help="head MLP hidden width")
    ap.add_argument("--metrics", type=str, dest="metrics_path")
    ap.add_argument("--checkpoint_dir", type=str)
    ap.add_argument("--restore", type=str, help="checkpoint to resume from")
    ap.add_argument("--platform", type=str, default=None,
                    help="force a jax platform (e.g. cpu)")
    ap.add_argument("--profile", type=str, default=None,
                    help="capture a profiler trace into this directory")
    args = ap.parse_args(argv)

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax
        jax.config.update("jax_platforms", args.platform)

    from ggnn.runtime import enable_compile_cache
    from ggnn.train.config import build_config
    from ggnn.train.loop import Trainer

    enable_compile_cache()

    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("config", "restore", "platform", "profile")
                 and v is not None}
    cfg = build_config(args.config, **overrides)
    print(f"config: {cfg}", file=sys.stderr)
    trainer = Trainer(cfg)
    if args.restore:
        trainer.restore(args.restore)
    from ggnn.profiling import trace
    with trace(args.profile):
        result = trainer.run()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
