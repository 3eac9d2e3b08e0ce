#!/usr/bin/env python
"""Throughput benchmark: directed edges per second through T steps of
GGNN propagation (BASELINE.json:2) on a synthetic graph
(BASELINE.json:11), per aggregation backend, forward or a full training
step (fwd + bwd + Adam on a sum(h²) proxy loss).

Prints ONE JSON record as its last line:
  {"metric": "edges_per_sec_per_chip", "value": N, "unit": "edges/s",
   "vs_baseline": R, "backend": ..., "detail": {...}, "times": {...},
   "device": {"platform", "kind", "count", "nvidia_smi"}, ...}
``vs_baseline`` is the best backend over the ``xla`` backend measured in
the same run (1.0 when xla is the only backend measured).

Timing: the first call of each backend (trace + compile + run) is
reported as set-up (``compile_s``); after ``--warmup`` untimed calls,
``--iters`` steady calls are each ended by ``block_until_ready`` and the
median is the step time.

Runs on the GPU and exits non-zero on any other platform, unless the
caller set ``JAX_PLATFORMS=cpu`` explicitly (rehearsals, tests): the
record then says ``"platform": "cpu"``.  A backend that fails makes the
run exit non-zero; the record still carries the backends that finished.

Usage: python bench.py [--nodes N] [--edges M] [--dim D] [--steps T]
                       [--backend auto|xla|onehot|window] [--mode fwd|train]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback


def build_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=262_144)
    ap.add_argument("--edges", type=int, default=4_000_000,
                    help="logical edges (each also runs in reverse)")
    ap.add_argument("--types", type=int, default=8)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "xla", "onehot", "window"],
                    help="auto = xla and onehot on this graph, then window "
                         "on a community graph of the same size")
    ap.add_argument("--communities", type=int, default=0,
                    help="community-structured graph (0 = uniform)")
    ap.add_argument("--p_intra", type=float, default=0.95,
                    help="intra-community edge probability")
    ap.add_argument("--powerlaw", type=float, default=0.0,
                    help="Zipf exponent for scale-free endpoints (0 = off);"
                         " nodes numbered by degree rank")
    ap.add_argument("--window", type=int, default=512,
                    help="table-row window for backend=window")
    ap.add_argument("--block_rows", type=int, default=128,
                    help="dst rows per window tile")
    ap.add_argument("--fuse_gru", action="store_true",
                    help="backend=window: aggregation and GRU as one step "
                         "function (gate matmuls in the compute dtype)")
    ap.add_argument("--q8", action="store_true",
                    help="mode=fwd, backend=window: int8 node-transform "
                         "table (implies --fuse_gru)")
    ap.add_argument("--q8_grads", action="store_true",
                    help="mode=train, backend=window: int8 backward of the "
                         "count product")
    ap.add_argument("--xw_spill", action="store_true",
                    help="backend=window: spilled edges gather h and are "
                         "transformed per type (the XW spill)")
    ap.add_argument("--agg", type=str, default="node_transform",
                    choices=["node_transform", "edge_gather"])
    ap.add_argument("--dtype", type=str, default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="aggregation compute dtype (f32 accumulation)")
    ap.add_argument("--mode", type=str, default="fwd",
                    choices=["fwd", "train"])
    ap.add_argument("--remat", action="store_true",
                    help="mode=train: jax.checkpoint each propagation step")
    ap.add_argument("--profile", type=str, default=None,
                    help="dump a profiler trace of the timed calls here")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = build_args(argv)
    from ggnn.runtime import (enable_compile_cache, gpu_name_and_power_limit,
                              peak_bytes_in_use, require_gpu)
    enable_compile_cache()
    device = require_gpu(allow_explicit_cpu=True)
    if device["platform"] == "gpu":
        device["nvidia_smi"] = gpu_name_and_power_limit()

    import jax
    import optax

    from ggnn import benchlib
    from ggnn.data.synthetic import synthetic_batch
    from ggnn.models import ModelConfig, init_params
    from ggnn.profiling import trace

    def make_batch(communities):
        return synthetic_batch(args.nodes, args.edges, args.types,
                               annotation_dim=8, seed=0,
                               node_mult=max(128, args.block_rows),
                               n_communities=communities,
                               p_intra=args.p_intra,
                               powerlaw_alpha=args.powerlaw)

    def run_backend(backend, batch, block_rows):
        q8 = args.q8 and backend == "window" and args.mode == "fwd"
        cfg = ModelConfig(
            state_dim=args.dim, annotation_dim=8, n_edge_types=args.types,
            n_steps=args.steps, backend=backend, agg_strategy=args.agg,
            compute_dtype=args.dtype,
            remat=args.remat and args.mode == "train",
            fuse_gru=backend == "window" and (args.fuse_gru or q8),
            quantized_table=q8)
        params = init_params(jax.random.PRNGKey(0), cfg)
        lay = benchlib.backend_layout(
            backend, batch, cfg.n_message_types, window=args.window,
            block_rows=block_rows, typed_spill=args.xw_spill,
            grad_quant=args.q8_grads and args.mode == "train")
        if lay is not None and hasattr(lay, "stats"):
            print(f"# {backend} layout: {lay.stats}", file=sys.stderr)
        g = benchlib.graph_args(batch)
        if args.mode == "fwd":
            fwd = benchlib.make_forward(cfg)

            def call():
                return fwd(params["prop"], *g, lay)
        else:
            opt = optax.adam(1e-3)
            opt_state = opt.init(params["prop"])
            step = benchlib.make_train_step(cfg, opt)

            def call():
                return step(params["prop"], opt_state, *g, lay)
        with trace(args.profile):
            t = benchlib.time_call(call, iters=args.iters,
                                   warmup=args.warmup)
        n_dir = int(batch.edge_mask.sum())
        t["edges_per_s"] = n_dir * args.steps / t["median_s"]
        t["directed_edges"] = n_dir
        return t

    plan = []
    if args.backend == "auto":
        uniform = make_batch(args.communities)
        plan += [("xla", lambda: run_backend("xla", uniform, 128)),
                 ("onehot", lambda: run_backend("onehot", uniform, 128))]
        n_comm = max(args.nodes // 512, 1)
        comm_rows = 512 if args.nodes % 512 == 0 else args.block_rows
        plan.append(("window_community", lambda: run_backend(
            "window", make_batch(n_comm), comm_rows)))
    else:
        plan.append((args.backend, lambda: run_backend(
            args.backend, make_batch(args.communities), args.block_rows)))

    t_start = time.perf_counter()
    results, failed = {}, {}
    for name, fn in plan:
        try:
            results[name] = fn()
        except Exception as e:  # record it, run the rest, exit non-zero
            traceback.print_exc(file=sys.stderr)
            failed[name] = f"{type(e).__name__}: {e}"
            continue
        print(f"# {name}: {results[name]['edges_per_s']:.6e} edges/s, "
              f"step {results[name]['median_s']:.6f} s, compile "
              f"{results[name]['compile_s']:.3f} s", file=sys.stderr)

    best_name = max(results, key=lambda k: results[k]["edges_per_s"],
                    default=None)
    best = results[best_name]["edges_per_s"] if best_name else 0.0
    base = results["xla"]["edges_per_s"] if "xla" in results else None
    rec = {
        "metric": "edges_per_sec_per_chip",
        "value": best,
        "unit": "edges/s",
        "vs_baseline": best / base if base else (1.0 if best else 0.0),
        "backend": best_name,
        "detail": {k: v["edges_per_s"] for k, v in results.items()},
        "times": {k: {"median_s": v["median_s"], "compile_s": v["compile_s"]}
                  for k, v in results.items()},
        "config": {"nodes": args.nodes, "logical_edges": args.edges,
                   "types": args.types, "dim": args.dim,
                   "steps": args.steps, "mode": args.mode,
                   "dtype": args.dtype},
        "device": device,
        "peak_bytes_in_use": peak_bytes_in_use(),
        "elapsed_s": time.perf_counter() - t_start,
    }
    if failed:
        rec["failed"] = failed
    print(json.dumps(rec), flush=True)
    return 1 if failed or not results else 0


if __name__ == "__main__":
    raise SystemExit(main())
