#!/usr/bin/env python
"""Distributed production recipe: sharded training + serving on a device
mesh with every production lever enabled.

Covers the full large-scale surface a reference user needs to migrate:

  1. partition a big graph over P shards (dst-owned edges, deduplicated
     halo plan — add ``--hot_thresh`` on skewed cuts to broadcast hub
     rows via one all_gather instead of padding every all-to-all pair);
  2. TRAIN with the per-shard windowed aggregation inside shard_map
     (optionally ``--q8_grads``: int8 gradients, accuracy-gated);
  3. SERVE the trained weights with the int8 (q8) table per shard.

Runs on any device count: GPUs, or CPU with
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python \\
      examples/distributed_production.py --platform cpu --shards 8
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--edges", type=int, default=32768)
    ap.add_argument("--types", type=int, default=4)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--train_iters", type=int, default=3)
    ap.add_argument("--hot_thresh", type=int, default=None,
                    help="hot-set hybrid exchange threshold (skewed cuts)")
    ap.add_argument("--q8_grads", action="store_true",
                    help="int8 gradient streams in the sharded backward")
    ap.add_argument("--platform", type=str, default=None)
    args = ap.parse_args()
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import optax

    from ggnn.data.synthetic import synthetic_batch
    from ggnn.models import ModelConfig, init_params
    from ggnn.parallel import (make_mesh, make_sharded_train_step,
                                   partition_batch, sharded_propagate)
    from ggnn.parallel.partition import (build_halo_window_layouts,
                                             split_local_remote)

    P = args.shards
    batch = synthetic_batch(args.nodes, args.edges, args.types,
                            annotation_dim=4, seed=0,
                            node_mult=P * 128, n_communities=P,
                            p_intra=0.9)
    cfg = ModelConfig(state_dim=args.dim, annotation_dim=4,
                      n_edge_types=args.types, n_steps=args.steps,
                      compute_dtype="bfloat16")
    params = init_params(jax.random.PRNGKey(0), cfg)
    prop = params["prop"]

    # 1. partition: dst-owned edges, dedup halo (hot-set optional)
    parts = split_local_remote(partition_batch(
        batch, P, hot_thresh=args.hot_thresh))
    print(f"P={P} n_local={parts.n_local} halo={parts.halo_size} "
          f"hot={parts.hot_size}")
    mesh = make_mesh(n_graph=P)

    # 2. sharded TRAIN through the per-shard windowed aggregation
    arrays, meta = build_halo_window_layouts(
        parts, window=128, n_message_types=2 * args.types,
        row_major="block", grad_quant=args.q8_grads)
    optimizer = optax.adam(1e-3)
    step = make_sharded_train_step(cfg, mesh, optimizer,
                                   strategy="halo_window", halo_meta=meta)
    opt_state = optimizer.init(prop)
    for i in range(args.train_iters):
        prop, opt_state, loss = step(prop, opt_state, parts, arrays)
        print(f"train iter {i}: loss={float(loss):.4f}"
              + ("  (int8 gradients)" if args.q8_grads else ""))

    # 3. sharded SERVING with the trained weights, int8 (q8) table
    cfg_q8 = ModelConfig(state_dim=args.dim, annotation_dim=4,
                         n_edge_types=args.types, n_steps=args.steps,
                         compute_dtype="bfloat16", backend="window",
                         fuse_gru=True, quantized_table=True)
    arrays_s, meta_s = build_halo_window_layouts(
        parts, window=128, n_message_types=2 * args.types,
        row_major="block")
    h = sharded_propagate(prop, cfg_q8, mesh, parts,
                          strategy="halo_window",
                          halo_layouts=(arrays_s, meta_s))
    print(f"served h: {h.shape} (int8-table serving per shard)")


if __name__ == "__main__":
    main()
