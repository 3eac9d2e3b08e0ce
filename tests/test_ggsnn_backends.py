"""GGS-NN with the layout backends inside the round scan:
onehot parity vs the XLA path, gradient parity, and jit-stability
of the static-budget scatter layouts across batches."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ggnn.graph import PaddingSpec, batch_graphs
from ggnn.models import ModelConfig, init_params, loss_and_metrics
from ggnn.models.ggsnn import ggsnn_forward
from ggnn.ops.onehot import layout_for_batch
from ggnn.train.loop import make_train_step


def _rand_graphs(rng, n_graphs=3, n_edge_types=3, annotation_dim=2, seq_k=3):
    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(6, 12))
        m = int(rng.integers(5, 2 * n))
        edges = np.stack([rng.integers(0, n, m),
                          rng.integers(0, n_edge_types, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, annotation_dim)) < 0.5).astype(np.float32)
        tgt = {"seq": np.asarray(
                   [int(rng.integers(0, 5)) for _ in range(seq_k)], np.int32),
               "seq_nodes": np.asarray(
                   [int(rng.integers(0, n)) for _ in range(seq_k)], np.int32)}
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann,
                           targets=tgt))
    return graphs


def _spec(graphs, n_edge_types, annotation_dim):
    return PaddingSpec(
        n_graphs=len(graphs), n_pad=256,
        e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
        n_edge_types=n_edge_types, annotation_dim=annotation_dim).round_up()


def test_ggsnn_backend_parity(rng):
    E, A, K = 3, 2, 3
    graphs = _rand_graphs(rng, n_edge_types=E, annotation_dim=A, seq_k=K)
    spec = _spec(graphs, E, A)
    b = batch_graphs(graphs, spec)
    mk = dict(state_dim=8, annotation_dim=A, n_edge_types=E, n_steps=3,
              head="ggsnn", n_classes=5, n_rounds=K)
    params = init_params(jax.random.PRNGKey(0), ModelConfig(**mk))
    args = (jnp.asarray(b.annotations), jnp.asarray(b.node_graph),
            jnp.asarray(b.node_mask), jnp.asarray(b.edge_src),
            jnp.asarray(b.edge_dst), jnp.asarray(b.edge_type),
            jnp.asarray(b.edge_mask))

    def run(backend, layout=None):
        cfg = ModelConfig(**mk, backend=backend)

        @jax.jit
        def fwd(params, layout, *args):
            return ggsnn_forward(params, cfg, *args, n_graphs=spec.n_graphs,
                                 scatter_layout=layout)[0]

        return np.asarray(fwd(params, layout, *args))

    ref = run("xla")
    got_oh = run("onehot", layout_for_batch(b))
    np.testing.assert_allclose(got_oh, ref, rtol=3e-5, atol=3e-5)


def test_ggsnn_onehot_grad_parity(rng):
    """value_and_grad through the round scan with the onehot layout
    aggregation matches the XLA backend."""
    E, A, K = 3, 2, 2
    graphs = _rand_graphs(rng, n_edge_types=E, annotation_dim=A, seq_k=K)
    spec = _spec(graphs, E, A)
    b = batch_graphs(graphs, spec)
    mk = dict(state_dim=8, annotation_dim=A, n_edge_types=E, n_steps=2,
              head="ggsnn", n_classes=5, n_rounds=K)
    params = init_params(jax.random.PRNGKey(1), ModelConfig(**mk))

    def grads(backend, layout=None):
        cfg = ModelConfig(**mk, backend=backend)

        @jax.jit
        def loss(p, layout, arrays):
            return loss_and_metrics(p, cfg, arrays, spec.n_graphs,
                                    scatter_layout=layout)[0]

        return jax.grad(loss)(params, layout, b.arrays)

    g_ref = grads("xla")
    g_oh = grads("onehot", layout_for_batch(b))
    jax.tree.map(lambda a, c: np.testing.assert_allclose(
        np.asarray(a), np.asarray(c), rtol=2e-4, atol=2e-5), g_oh, g_ref)


def test_static_layout_single_compile(rng):
    """Two batches with different topologies but the same PaddingSpec reuse
    one compiled train step (static tile budgets -> identical layout
    shapes/treedefs)."""
    E, A = 3, 2
    g1 = _rand_graphs(rng, n_edge_types=E, annotation_dim=A, seq_k=2)
    g2 = _rand_graphs(rng, n_edge_types=E, annotation_dim=A, seq_k=2)
    big = _spec(g1 + g2, E, A)
    spec = PaddingSpec(n_graphs=len(g1), n_pad=big.n_pad, e_pad=big.e_pad,
                       n_edge_types=E, annotation_dim=A).round_up()
    b1, b2 = batch_graphs(g1, spec), batch_graphs(g2, spec)
    cfg = ModelConfig(state_dim=8, annotation_dim=A, n_edge_types=E,
                      n_steps=2, head="ggsnn", n_classes=5, n_rounds=2,
                      backend="onehot")
    params = init_params(jax.random.PRNGKey(2), cfg)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    step = make_train_step(cfg, spec.n_graphs, opt)
    l1, l2 = layout_for_batch(b1), layout_for_batch(b2)
    jax.tree.map(lambda a, c: np.testing.assert_array_equal(
        np.asarray(a.shape), np.asarray(c.shape)), l1, l2)
    assert l1.meta == l2.meta
    # adversarial meta stability: all edges into ONE dst block vs spread
    # across blocks must still produce identical static meta (meta is part
    # of the jit cache key — a per-topology value recompiles the step)
    def _batch(dsts):
        g = [dict(n_nodes=10,
                  edges=np.stack([np.zeros(8, np.int64),
                                  np.zeros(8, np.int64),
                                  np.asarray(dsts, np.int64)], axis=1),
                  annotations=np.ones((10, A), np.float32),
                  targets={"seq": np.zeros(2, np.int32),
                           "seq_nodes": np.zeros(2, np.int32)})] * 3
        return batch_graphs(g, spec)
    lc = layout_for_batch(_batch([1] * 8))       # concentrated
    ls = layout_for_batch(_batch(list(range(8))))  # spread
    assert lc.meta == ls.meta
    params, opt_state, m1 = step(params, opt_state, b1.arrays, l1)
    params, opt_state, m2 = step(params, opt_state, b2.arrays, l2)
    assert np.isfinite(float(m1["loss_sum"]))
    assert np.isfinite(float(m2["loss_sum"]))
    assert step._cache_size() == 1


def test_ggsnn_window_backend_parity(rng):
    """GGS-NN round scan on the windowed block-CSR backend matches XLA
    (the layout flows through the same scatter_layout plumbing)."""
    from ggnn.ops.window import build_window_layout
    E, A, K = 3, 2, 2
    graphs = _rand_graphs(rng, n_edge_types=E, annotation_dim=A, seq_k=K)
    spec = _spec(graphs, E, A)
    b = batch_graphs(graphs, spec)
    mk = dict(state_dim=8, annotation_dim=A, n_edge_types=E, n_steps=2,
              head="ggsnn", n_classes=5, n_rounds=K)
    params = init_params(jax.random.PRNGKey(3), ModelConfig(**mk))
    args = (jnp.asarray(b.annotations), jnp.asarray(b.node_graph),
            jnp.asarray(b.node_mask), jnp.asarray(b.edge_src),
            jnp.asarray(b.edge_dst), jnp.asarray(b.edge_type),
            jnp.asarray(b.edge_mask))
    lay = build_window_layout(b.edge_src, b.edge_dst, b.edge_type,
                              b.edge_mask, spec.n_pad, window=64,
                              min_edges_per_tile=4,
                              n_message_types=2 * E)

    def run(backend, layout=None):
        cfg = ModelConfig(**mk, backend=backend)

        @jax.jit
        def fwd(params, layout, *args):
            return ggsnn_forward(params, cfg, *args, n_graphs=spec.n_graphs,
                                 scatter_layout=layout)[0]

        return np.asarray(fwd(params, layout, *args))

    np.testing.assert_allclose(run("window", lay), run("xla"),
                               rtol=3e-5, atol=3e-5)
