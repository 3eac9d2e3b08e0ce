#!/usr/bin/env python
"""Using ggnn as a library on a custom graph task.

Task: "reachability" — given a directed graph with one edge type and a
marked source node, classify whether a marked target node is reachable
within T hops.  Demonstrates the framework surface a reference user needs:
graph dicts → PaddingSpec → BatchLoader → ModelConfig → jitted training.

Run: python examples/custom_task.py  [--platform cpu]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_example(rng, n_lo=5, n_hi=10):
    n = int(rng.integers(n_lo, n_hi))
    m = int(rng.integers(n, 2 * n))
    edges = np.stack([rng.integers(0, n, m), np.zeros(m, np.int64),
                      rng.integers(0, n, m)], axis=1)
    src, dst = rng.choice(n, 2, replace=False)
    # BFS reachability
    adj = {}
    for (u, _, v) in edges:
        adj.setdefault(int(u), set()).add(int(v))
    seen, frontier = {int(src)}, [int(src)]
    while frontier:
        u = frontier.pop()
        for v in adj.get(u, ()):  # noqa: B020
            if v not in seen:
                seen.add(v)
                frontier.append(v)
    ann = np.zeros((n, 2), np.float32)
    ann[src, 0] = 1.0
    ann[dst, 1] = 1.0
    return dict(n_nodes=n, edges=edges, annotations=ann,
                targets={"cls": np.asarray(int(dst in seen), np.int32)})


def main():
    if "--platform" in sys.argv:
        import os
        plat = sys.argv[sys.argv.index("--platform") + 1]
        os.environ["JAX_PLATFORMS"] = plat
        import jax
        jax.config.update("jax_platforms", plat)
    import jax
    import optax

    from ggnn.data.loader import BatchLoader
    from ggnn.graph import PaddingSpec
    from ggnn.models import ModelConfig, init_params
    from ggnn.train.loop import make_eval_step, make_train_step

    rng = np.random.default_rng(0)
    train = [make_example(rng) for _ in range(200)]
    test = [make_example(rng) for _ in range(100)]

    B = 20
    spec = PaddingSpec(n_graphs=B, n_pad=B * 10, e_pad=B * 20 * 2,
                       n_edge_types=1, annotation_dim=2).round_up()
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=1,
                      n_steps=8, head="graph_gated", n_classes=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    optimizer = optax.adam(3e-3)
    opt_state = optimizer.init(params)
    train_step = make_train_step(cfg, B, optimizer)
    eval_step = make_eval_step(cfg, B)

    loader = BatchLoader(train, spec, shuffle=True, seed=0)
    test_loader = BatchLoader(test, spec, shuffle=False)
    for epoch in range(60):
        for batch in loader.epoch_batches():
            params, opt_state, _ = train_step(params, opt_state, batch.arrays)
        if (epoch + 1) % 10 == 0:
            c = n = 0.0
            for batch in test_loader.epoch_batches(0):
                m = eval_step(params, batch.arrays)
                c += float(m["correct"])
                n += float(m["count"])
            print(f"epoch {epoch + 1}: test accuracy {c / n:.3f}")


if __name__ == "__main__":
    main()
