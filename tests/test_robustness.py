"""Degenerate-input robustness (SURVEY.md §5.2: NaN guards): empty batches,
isolated nodes, self-loops, duplicate edges — every head must produce
finite losses and the padding invariants must hold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ggnn.graph import PaddingSpec, batch_graphs
from ggnn.models import ModelConfig, init_params, loss_and_metrics


def build(graphs, E=2, A=1, B=None):
    spec = PaddingSpec(
        n_graphs=B or len(graphs),
        n_pad=max(sum(g["n_nodes"] for g in graphs), 1) + 3,
        e_pad=max(2 * sum(g["edges"].shape[0] for g in graphs), 1) + 3,
        n_edge_types=E, annotation_dim=A).round_up()
    return spec, batch_graphs(graphs, spec)


def test_empty_batch_all_heads():
    """A batch with zero graphs: losses are 0/finite, no NaNs."""
    for head, n_classes, tgt in (("node_select", 1, {}),
                                 ("graph_gated", 3, {}),):
        spec, b = build([], B=2)
        cfg = ModelConfig(state_dim=4, annotation_dim=1, n_edge_types=2,
                          n_steps=3, head=head, n_classes=n_classes)
        params = init_params(jax.random.PRNGKey(0), cfg)
        arrays = dict(b.arrays)
        if head == "node_select":
            arrays["targets"] = {"node": np.zeros(2, np.int32)}
        else:
            arrays["targets"] = {"cls": np.zeros(2, np.int32)}
        loss, metrics = loss_and_metrics(params, cfg, arrays, spec.n_graphs)
        assert np.isfinite(float(loss))
        assert float(metrics["count"]) == 0.0


def test_single_node_no_edges():
    g = dict(n_nodes=1, edges=np.zeros((0, 3), np.int64),
             annotations=np.ones((1, 1), np.float32),
             targets={"node": np.asarray(0, np.int32)})
    spec, b = build([g])
    cfg = ModelConfig(state_dim=4, annotation_dim=1, n_edge_types=2, n_steps=5)
    params = init_params(jax.random.PRNGKey(0), cfg)
    loss, metrics = loss_and_metrics(params, cfg, b.arrays, spec.n_graphs)
    assert np.isfinite(float(loss))
    assert float(metrics["correct"]) == 1.0  # only one node to pick


def test_self_loops_and_duplicates():
    edges = np.array([[0, 0, 0], [0, 0, 0], [1, 1, 1], [0, 1, 1], [0, 1, 1]])
    g = dict(n_nodes=3, edges=edges,
             annotations=np.eye(3, 1, dtype=np.float32),
             targets={"node": np.asarray(1, np.int32)})
    spec, b = build([g])
    cfg = ModelConfig(state_dim=4, annotation_dim=1, n_edge_types=2, n_steps=4)
    params = init_params(jax.random.PRNGKey(0), cfg)
    loss, _ = loss_and_metrics(params, cfg, b.arrays, spec.n_graphs)
    assert np.isfinite(float(loss))
    # gradient also finite
    grad = jax.grad(lambda p: loss_and_metrics(p, cfg, b.arrays,
                                               spec.n_graphs)[0])(params)
    for leaf in jax.tree_util.tree_leaves(grad):
        assert np.isfinite(np.asarray(leaf)).all()


def test_extreme_state_values_no_nan():
    """Huge states through segment_softmax / gates stay finite."""
    from ggnn.ops.segment import segment_log_softmax, segment_softmax
    scores = jnp.asarray([1e30, -1e30, 0.0, 1e30])
    seg = jnp.asarray([0, 0, 1, 2], jnp.int32)
    mask = jnp.asarray([1.0, 1.0, 1.0, 0.0])
    p = segment_softmax(scores, seg, 3, mask)
    lp = segment_log_softmax(scores, seg, 3, mask)
    assert np.isfinite(np.asarray(p)).all()
    assert np.isfinite(np.asarray(lp[np.asarray(mask) > 0])).all()
    assert abs(float(p[0] + p[1]) - 1.0) < 1e-6
    assert float(p[3]) == 0.0


def test_quantized_table_training_guard():
    """quantized_table is serving-only (rounding to int8 has a zero
    gradient almost everywhere) — the train-step factories fail loudly
    instead of silently training nothing."""
    import optax

    from ggnn.parallel.halo import make_sharded_train_step
    from ggnn.train.loop import make_train_step
    cfg = ModelConfig(state_dim=128, backend="window", fuse_gru=True,
                      quantized_table=True)
    with pytest.raises(ValueError, match="SERVING"):
        make_train_step(cfg, 4, optax.adam(1e-3))
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:4]), ("graph",))
    with pytest.raises(ValueError, match="SERVING"):
        make_sharded_train_step(cfg, mesh, optax.adam(1e-3),
                                strategy="halo_window", halo_meta={})
