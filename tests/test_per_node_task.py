"""End-to-end training with the per-node head (C7b) on a synthetic
node-labeling task: classify each node by its distance (0/1/2+) from a
marked source — learnable from structure alone."""

import jax
import numpy as np
import optax

from ggnn.data.loader import BatchLoader
from ggnn.graph import PaddingSpec
from ggnn.models import ModelConfig, init_params
from ggnn.train.loop import make_eval_step, make_train_step


def make_example(rng, n_lo=5, n_hi=9):
    n = int(rng.integers(n_lo, n_hi))
    m = int(rng.integers(n, 2 * n))
    edges = np.stack([rng.integers(0, n, m), np.zeros(m, np.int64),
                      rng.integers(0, n, m)], axis=1)
    src = int(rng.integers(0, n))
    # BFS distances
    adj = {}
    for (u, _, v) in edges:
        adj.setdefault(int(u), set()).add(int(v))
    dist = {src: 0}
    frontier = [src]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj.get(u, ()):
                if v not in dist:
                    dist[v] = dist[u] + 1
                    nxt.append(v)
        frontier = nxt
    labels = np.full(n, 2, np.int32)
    for v, d in dist.items():
        labels[v] = min(d, 2)
    ann = np.zeros((n, 1), np.float32)
    ann[src, 0] = 1.0
    return dict(n_nodes=n, edges=edges, annotations=ann,
                targets={"node_labels": labels})


def test_per_node_head_trains(rng):
    train = [make_example(rng) for _ in range(100)]
    test = [make_example(rng) for _ in range(50)]
    B = 10
    spec = PaddingSpec(n_graphs=B, n_pad=B * 9, e_pad=B * 18 * 2,
                       n_edge_types=1, annotation_dim=1).round_up()
    cfg = ModelConfig(state_dim=8, annotation_dim=1, n_edge_types=1,
                      n_steps=4, head="per_node", n_classes=3)
    # node-aligned labels must pad across the flattened node axis: reuse
    # the node_targets channel
    for g in train + test:
        g["node_targets"] = {"node_labels": g["targets"].pop("node_labels")}
    params = init_params(jax.random.PRNGKey(0), cfg)
    optimizer = optax.adam(3e-3)
    opt_state = optimizer.init(params)
    train_step = make_train_step(cfg, B, optimizer)
    eval_step = make_eval_step(cfg, B)
    loader = BatchLoader(train, spec, shuffle=True, seed=0)
    test_loader = BatchLoader(test, spec, shuffle=False)
    for _ in range(40):
        for batch in loader.epoch_batches():
            params, opt_state, _ = train_step(params, opt_state, batch.arrays)
    c = n = 0.0
    for batch in test_loader.epoch_batches(0):
        m = eval_step(params, batch.arrays)
        c += float(m["correct"])
        n += float(m["count"])
    assert c / n > 0.9, f"per-node accuracy {c / n}"
