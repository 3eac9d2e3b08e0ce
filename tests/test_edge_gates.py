"""SDDMM edge-feature gates (BASELINE.json:5): oracle parity for the gated
propagation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ggnn.graph import PaddingSpec, batch_graphs
from ggnn.models import ModelConfig, init_params, propagate
from ggnn.oracle import oracle_propagate


def to_f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def _setup(rng, backend):
    E, A, D = 3, 2, 8
    cfg = ModelConfig(state_dim=D, annotation_dim=A, n_edge_types=E,
                      n_steps=4, edge_gates=True, backend=backend)
    graphs = []
    for _ in range(3):
        n = int(rng.integers(4, 9))
        m = int(rng.integers(2, 2 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, E, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, A)) < 0.5).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann, targets={}))
    spec = PaddingSpec(
        n_graphs=3, n_pad=sum(g["n_nodes"] for g in graphs) + 2,
        e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 4,
        n_edge_types=E, annotation_dim=A).round_up()
    batch = batch_graphs(graphs, spec)
    params = init_params(jax.random.PRNGKey(7), cfg)
    assert "gate_p" in params["prop"] and "gate_q" in params["prop"]
    return cfg, graphs, batch, params


@pytest.mark.parametrize("backend", ["xla"])
def test_gated_propagate_matches_oracle(rng, backend):
    cfg, graphs, batch, params = _setup(rng, backend)
    h = np.asarray(propagate(
        params["prop"], cfg, jnp.asarray(batch.annotations),
        jnp.asarray(batch.edge_src), jnp.asarray(batch.edge_dst),
        jnp.asarray(batch.edge_type), jnp.asarray(batch.edge_mask)))
    p64 = to_f64(params)
    offs = np.concatenate([[0], np.cumsum(batch.n_nodes)])[:-1]
    for gi, g in enumerate(graphs):
        ref = oracle_propagate(p64["prop"], g["annotations"], g["edges"],
                               cfg.n_edge_types, cfg.n_steps)[-1]
        got = h[offs[gi]:offs[gi] + g["n_nodes"]]
        np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-6)
