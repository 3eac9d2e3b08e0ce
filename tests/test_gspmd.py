"""GSPMD sharded training step: runs on the 8-virtual-device mesh and
matches the single-device train step exactly (same math, different
partitioning)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ggnn.graph import PaddingSpec, batch_graphs
from ggnn.models import ModelConfig, init_params
from ggnn.parallel import make_mesh
from ggnn.parallel.multihost import initialize_multihost, is_primary
from ggnn.parallel.train import make_gspmd_train_step, shard_batch_arrays
from ggnn.train.loop import make_train_step


def make_batch(rng, B=4, n_per=16, E=3, A=2):
    graphs = []
    for _ in range(B):
        m = 2 * n_per
        edges = np.stack([rng.integers(0, n_per, m), rng.integers(0, E, m),
                          rng.integers(0, n_per, m)], axis=1)
        ann = (rng.random((n_per, A)) < 0.4).astype(np.float32)
        graphs.append(dict(n_nodes=n_per, edges=edges, annotations=ann,
                           targets={"node": np.asarray(
                               int(rng.integers(0, n_per)), np.int32)}))
    spec = PaddingSpec(n_graphs=B, n_pad=B * n_per, e_pad=2 * B * 2 * n_per,
                       n_edge_types=E, annotation_dim=A)
    return spec, batch_graphs(graphs, spec)


def test_gspmd_step_matches_single_device(rng):
    spec, b = make_batch(rng)
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3)
    params = init_params(jax.random.PRNGKey(0), cfg)
    optimizer = optax.adam(1e-3)
    opt_state = optimizer.init(params)
    arrays = jax.tree.map(jnp.asarray, b.arrays)

    # single-device reference
    ref_step = make_train_step(cfg, spec.n_graphs, optimizer)
    p_ref, _, m_ref = ref_step(jax.tree.map(jnp.copy, params),
                               optimizer.init(params), arrays)

    mesh = make_mesh(n_graph=4, n_data=2)
    sharded = shard_batch_arrays(arrays, mesh)
    step = make_gspmd_train_step(cfg, spec.n_graphs, optimizer, mesh)
    p_new, _, m_new = step(jax.tree.map(jnp.copy, params),
                           optimizer.init(params), sharded)

    assert abs(float(m_new["loss_sum"]) - float(m_ref["loss_sum"])) < 1e-4
    # post-Adam params agree to within the fp-reduction-order noise that
    # Adam's normalizer amplifies (bounded by lr)
    for a, r in zip(jax.tree_util.tree_leaves(p_new),
                    jax.tree_util.tree_leaves(p_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                   rtol=5e-3, atol=1e-3)

    # gradients themselves match tightly
    from ggnn.models import loss_and_metrics

    def loss_fn(p, arr):
        return loss_and_metrics(p, cfg, arr, spec.n_graphs)[0]

    g_ref = jax.grad(loss_fn)(params, arrays)
    g_sh = jax.jit(jax.grad(loss_fn))(params, sharded)
    for a, r in zip(jax.tree_util.tree_leaves(g_sh),
                    jax.tree_util.tree_leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                   rtol=1e-4, atol=1e-5)


def test_multihost_noop_single_process():
    assert initialize_multihost() is False
    assert is_primary()
