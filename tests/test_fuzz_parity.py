"""Fuzz parity: many random graph topologies (varied density, types,
self-loops, duplicates, empty-type segments) through all three aggregation
backends vs the oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ggnn.graph import PaddingSpec, batch_graphs
from ggnn.models import ModelConfig, init_params, propagate
from ggnn.oracle import oracle_propagate


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_backends_vs_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    E = int(rng.integers(1, 6))
    A = int(rng.integers(1, 4))
    D = int(rng.integers(3, 12))
    T = int(rng.integers(1, 7))
    graphs = []
    for _ in range(int(rng.integers(1, 5))):
        n = int(rng.integers(2, 14))
        m = int(rng.integers(0, 3 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, E, m),
                          rng.integers(0, n, m)], axis=1) if m else \
            np.zeros((0, 3), np.int64)
        ann = (rng.random((n, A)) < rng.random()).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann, targets={}))
    spec = PaddingSpec(
        n_graphs=len(graphs),
        n_pad=sum(g["n_nodes"] for g in graphs) + int(rng.integers(0, 9)),
        e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
        n_edge_types=E, annotation_dim=A).round_up(
            mult_nodes=128)  # the onehot backend needs 128-row dst blocks
    b = batch_graphs(graphs, spec)
    params = init_params(jax.random.PRNGKey(seed), ModelConfig(
        state_dim=D, annotation_dim=A, n_edge_types=E))
    p64 = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
    args = (jnp.asarray(b.annotations), jnp.asarray(b.edge_src),
            jnp.asarray(b.edge_dst), jnp.asarray(b.edge_type),
            jnp.asarray(b.edge_mask))
    offs = np.concatenate([[0], np.cumsum(b.n_nodes)])[:-1]
    for backend in ("xla", "onehot"):
        cfg = ModelConfig(state_dim=D, annotation_dim=A, n_edge_types=E,
                          n_steps=T, backend=backend)
        h = np.asarray(propagate(params["prop"], cfg, *args))
        for gi, g in enumerate(graphs):
            ref = oracle_propagate(p64["prop"], g["annotations"],
                                   g["edges"], E, T)[-1]
            got = h[offs[gi]:offs[gi] + g["n_nodes"]]
            np.testing.assert_allclose(got, ref, rtol=5e-5, atol=5e-6,
                                       err_msg=f"{backend} seed={seed}")
