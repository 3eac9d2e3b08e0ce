#!/usr/bin/env python
"""Multi-GPU scaling benchmark: edges/sec/device for the sharded
halo-exchange propagation over the 'graph' mesh axis (BASELINE.json:5:
edges/s scaling efficiency from 1 device up; BASELINE.json:11: synthetic
large random graphs, edge-partitioned).

Prints one JSON line with per-device throughput and efficiency vs the
1-shard run, and the device it ran on.  Each shard count is timed over
``--iters`` steady calls ended by ``block_until_ready`` (median); the
first call is reported as compile time.  On one GPU this exercises P=1
only.  It refuses to run on anything but GPUs, except that
``--force_cpu_devices N`` (or an explicit ``JAX_PLATFORMS=cpu``) checks
the sharded path functionally on N virtual CPU devices — the numbers then
measure the CPU backend and the record says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=262_144)
    ap.add_argument("--edges", type=int, default=4_000_000)
    ap.add_argument("--types", type=int, default=8)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--strategy", type=str, default="halo_onehot",
                    choices=["halo", "all_gather", "halo_onehot", "halo_overlap",
                             "halo_window"])
    ap.add_argument("--shards", type=int, nargs="*", default=None,
                    help="shard counts to test (default: 1..device_count)")
    ap.add_argument("--communities", type=int, default=0,
                    help="community-structured graph (0 = uniform)")
    ap.add_argument("--p_intra", type=float, default=0.95)
    ap.add_argument("--force_cpu_devices", type=int, default=0)
    args = ap.parse_args()

    if args.force_cpu_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
            f"{args.force_cpu_devices}").strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
    from ggnn.runtime import enable_compile_cache, require_gpu
    enable_compile_cache()
    device = require_gpu(allow_explicit_cpu=True)
    import jax

    from ggnn.benchlib import time_call

    from ggnn.data.synthetic import synthetic_batch
    from ggnn.models import ModelConfig, init_params
    from ggnn.parallel import make_mesh, partition_batch, sharded_propagate

    n_dev = jax.device_count()
    shard_counts = args.shards or [p for p in (1, 2, 4, 8, 16, 32)
                                   if p <= n_dev]
    batch = synthetic_batch(args.nodes, args.edges, args.types,
                            annotation_dim=8, seed=0,
                            node_mult=128 * max(shard_counts),
                            n_communities=args.communities,
                            p_intra=args.p_intra)
    n_dir = int(batch.edge_mask.sum())
    cfg = ModelConfig(state_dim=args.dim, annotation_dim=8,
                      n_edge_types=args.types, n_steps=args.steps)
    params = init_params(jax.random.PRNGKey(0), cfg)

    results = {}
    for P in shard_counts:
        mesh = make_mesh(n_graph=P, n_data=1)
        parts = partition_batch(batch, P)
        if args.strategy in ("halo_overlap", "halo_window"):
            from ggnn.parallel.partition import split_local_remote
            parts = split_local_remote(parts)  # host-side, before jit
        lay = None
        if args.strategy == "halo_onehot":
            from ggnn.parallel.partition import build_halo_scatter_layouts
            lay = build_halo_scatter_layouts(parts, tile_e=512)
        elif args.strategy == "halo_window":
            from ggnn.parallel.partition import build_halo_window_layouts
            lay = build_halo_window_layouts(
                parts, n_message_types=cfg.n_message_types)
        lay_meta = lay[1] if lay else None

        # parts/layout arrays flow through jit ARGUMENTS, not as baked-in
        # constants
        @jax.jit
        def run(prop, parts, lay_arrays):
            return sharded_propagate(
                prop, cfg, mesh, parts, strategy=args.strategy,
                halo_layouts=(lay_arrays, lay_meta) if lay_arrays else None)

        lay_arrays = lay[0] if lay else None
        t = time_call(lambda: run(params["prop"], parts, lay_arrays),
                      iters=args.iters)
        eps = n_dir * args.steps / t["median_s"]
        results[P] = {"edges_per_sec": eps,
                      "edges_per_sec_per_chip": eps / P,
                      "median_s": t["median_s"],
                      "compile_s": t["compile_s"],
                      "halo_size": parts.halo_size}
        print(f"# P={P}: {eps:.3e} edges/s total, "
              f"{eps / P:.3e} /chip, H={parts.halo_size}", file=sys.stderr)

    base = results[shard_counts[0]]["edges_per_sec_per_chip"]
    for P, r in results.items():
        r["efficiency"] = r["edges_per_sec_per_chip"] / base
    print(json.dumps({
        "metric": "scaling_efficiency",
        "value": results[shard_counts[-1]]["efficiency"],
        "unit": "frac_of_1chip_per_chip_throughput",
        "vs_baseline": results[shard_counts[-1]]["efficiency"] / 0.9,
        "strategy": args.strategy,
        "shards": results,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
