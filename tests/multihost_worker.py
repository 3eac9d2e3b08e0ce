"""Worker process for tests/test_multihost.py — NOT a test module.

Runs as one of two `jax.distributed` processes (1 CPU device each):
initializes the multi-host runtime through
ggnn.parallel.multihost.initialize_multihost (the DCN bootstrap path,
SURVEY.md §5.3/§5.8), builds the same seeded batch on both hosts, runs a
sharded halo-exchange propagation over the 2-process global mesh, and
checks it against the locally-computed single-device reference.

Usage: python tests/multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main(pid: int, nproc: int, port: str) -> None:
    from ggnn.parallel.multihost import initialize_multihost, is_primary

    assert initialize_multihost(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
        process_id=pid, init_timeout_s=120)
    assert jax.process_count() == nproc
    assert is_primary() == (pid == 0)

    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ggnn.graph import PaddingSpec, batch_graphs
    from ggnn.models import ModelConfig, init_params, propagate
    from ggnn.parallel import make_mesh, partition_batch, sharded_propagate
    from ggnn.parallel.partition import PartitionedBatch

    # identical seeded batch on every host (multi-host determinism,
    # SURVEY.md §7.2.5)
    rng = np.random.default_rng(42)
    graphs = []
    for _ in range(4):
        n = int(rng.integers(6, 12))
        m = int(rng.integers(4, 3 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 3, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.5).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann,
                           targets={}))
    total = sum(g["n_nodes"] for g in graphs)
    spec = PaddingSpec(n_graphs=4, n_pad=((total + 15) // 16) * 16,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
                       n_edge_types=3, annotation_dim=2).round_up()
    b = batch_graphs(graphs, spec)
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                      n_steps=4)
    params = init_params(jax.random.PRNGKey(0), cfg)

    # single-device reference, computed locally on each host
    ref = np.asarray(propagate(
        params["prop"], cfg, b.annotations, b.edge_src, b.edge_dst,
        b.edge_type, b.edge_mask))

    # global 2-process mesh; each host owns one shard of every [P, ...]
    # partition array
    mesh = make_mesh(n_graph=nproc, n_data=1)
    parts = partition_batch(b, nproc)
    shd = NamedSharding(mesh, P(None, "graph"))

    def globalize(x):
        x = np.asarray(x)
        local = x[pid:pid + 1]
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, P("graph")), local, x.shape)

    gparts = PartitionedBatch(
        n_shards=parts.n_shards, n_local=parts.n_local,
        halo_size=parts.halo_size,
        **{f: globalize(getattr(parts, f))
           for f in ("annotations", "node_mask", "node_graph",
                     "edge_src_global", "edge_src_halo", "edge_dst_local",
                     "edge_type", "edge_mask", "type_offsets",
                     "halo_send_idx")})
    prop_g = multihost_utils.host_local_array_to_global_array(
        params["prop"], mesh, P())

    @jax.jit
    def run(prop, pt):
        return sharded_propagate(prop, cfg, mesh, pt, strategy="halo")

    h = run(prop_g, gparts)
    h_full = np.asarray(multihost_utils.process_allgather(h, tiled=True))
    np.testing.assert_allclose(h_full, ref, rtol=2e-5, atol=1e-6)
    print(f"MULTIHOST_OK pid={pid} h={h_full.shape}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
