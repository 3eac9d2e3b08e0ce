"""halo_onehot strategy: per-shard one-hot scatter kernels inside
shard_map, parity vs single-device propagation (128-multiple shard size)."""

import jax
import numpy as np

from ggnn.graph import PaddingSpec, batch_graphs
from ggnn.models import ModelConfig, init_params, propagate
from ggnn.parallel import make_mesh, partition_batch, sharded_propagate


def test_halo_onehot_matches_single_device(rng):
    n_shards = 4
    n_local = 128  # BLOCK_N multiple per shard
    n_pad = n_shards * n_local
    graphs = []
    total = 0
    while total < n_pad - 40:
        n = int(rng.integers(20, 40))
        m = int(rng.integers(10, 3 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 3, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.4).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann, targets={}))
        total += n
    spec = PaddingSpec(n_graphs=len(graphs), n_pad=n_pad,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
                       n_edge_types=3, annotation_dim=2).round_up()
    b = batch_graphs(graphs, spec)
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3)
    params = init_params(jax.random.PRNGKey(0), cfg)
    ref = np.asarray(propagate(
        params["prop"], cfg, b.annotations, b.edge_src, b.edge_dst,
        b.edge_type, b.edge_mask))

    mesh = make_mesh(n_graph=n_shards)
    parts = partition_batch(b, n_shards)
    got = np.asarray(sharded_propagate(
        params["prop"], cfg, mesh, parts, strategy="halo_onehot",
        scatter_tile_e=8))
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-6)
