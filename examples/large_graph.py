#!/usr/bin/env python
"""Large-graph propagation with a layout backend (onehot, or window on
a community graph).

Demonstrates the scaling surface a reference user graduates to: a large
synthetic graph, the host-built layout (passed through jit ARGUMENTS, so
it is not baked into the compiled program as constants), bf16 compute
with f32 accumulation, and optional dst-range chunking when the graph
pushes device memory.

Run: python examples/large_graph.py [--nodes 262144] [--edges 4000000]
     [--platform cpu]   (use tiny sizes on the CPU)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=262_144)
    ap.add_argument("--edges", type=int, default=4_000_000)
    ap.add_argument("--types", type=int, default=8)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--communities", type=int, default=0,
                    help="community-structured graph: switches to the "
                         "windowed block-CSR backend (the clustered-graph "
                         "path)")
    ap.add_argument("--platform", type=str, default=None)
    args = ap.parse_args()
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp

    from ggnn.data.synthetic import synthetic_batch
    from ggnn.models import ModelConfig, init_params
    from ggnn.models.ggnn import propagate
    from ggnn.ops.onehot import (build_chunked_dst_layouts,
                                             build_dst_block_layout)

    print(f"building graph: {args.nodes} nodes, {args.edges} edges ...")
    batch = synthetic_batch(args.nodes, args.edges, args.types,
                            annotation_dim=8, seed=0, node_mult=128,
                            n_communities=args.communities)
    backend = "window" if args.communities else "onehot"
    cfg = ModelConfig(state_dim=args.dim, annotation_dim=8,
                      n_edge_types=args.types, n_steps=args.steps,
                      backend=backend, compute_dtype="bfloat16")
    params = init_params(jax.random.PRNGKey(0), cfg)

    t0 = time.time()
    if args.communities:
        from ggnn.ops.window import build_window_layout
        layout = build_window_layout(
            batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
            batch.spec.n_pad, n_message_types=2 * args.types,
            block_rows=min(512, args.nodes // args.communities))
        print(f"window layout: {layout.stats}")
    elif args.chunks > 1:
        layout = build_chunked_dst_layouts(
            batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
            batch.spec.n_pad, n_chunks=args.chunks, tile_e=2048)
    else:
        layout = build_dst_block_layout(
            batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
            batch.spec.n_pad, tile_e=2048).to_device()
    print(f"scatter layout built in {time.time() - t0:.1f}s (topology-static"
          " — reused across steps and training iterations)")

    @jax.jit
    def run(prop, ann, es, ed, et, em, lay):
        return propagate(prop, cfg, ann, es, ed, et, em, scatter_layout=lay)

    ops = (jnp.asarray(batch.annotations), jnp.asarray(batch.edge_src),
           jnp.asarray(batch.edge_dst), jnp.asarray(batch.edge_type),
           jnp.asarray(batch.edge_mask), layout)
    t0 = time.time()
    s = float(jnp.sum(run(params["prop"], *ops)))
    print(f"compile+first run: {time.time() - t0:.1f}s  (checksum {s:.4g})")
    t0 = time.time()
    run(params["prop"], *ops).block_until_ready()
    dt = time.time() - t0
    n_dir = int(batch.edge_mask.sum())
    print(f"steady state: {dt * 1e3:.1f} ms for {args.steps} steps over "
          f"{n_dir} directed edges = {n_dir * args.steps / dt:.3g} edges/s")


if __name__ == "__main__":
    main()
