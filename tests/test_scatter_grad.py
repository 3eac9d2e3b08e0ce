"""Gradient tests for the layout aggregations: parity with the XLA
segment path and with a per-edge NumPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ggnn.models import ModelConfig, init_params
from ggnn.ops.onehot import aggregate_onehot, build_dst_block_layout
from ggnn.ops.segment import typed_aggregate


@pytest.mark.parametrize("tile_e,edge_align", [(8, None), (32, 16)])
@pytest.mark.parametrize("row_order", ["type", "block"])
def test_aggregate_onehot_grad_matches_xla(rng, tile_e, edge_align,
                                           row_order):
    N, E, T2, D = 256, 600, 6, 16
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    typ = rng.integers(0, T2, E).astype(np.int32)
    mask = np.ones(E, np.float32)
    mask[rng.random(E) < 0.15] = 0.0
    lay = build_dst_block_layout(src, dst, typ, mask, N, tile_e=tile_e,
                                 edge_align=edge_align,
                                 n_message_types=T2, row_order=row_order)
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=3)
    params = init_params(jax.random.PRNGKey(0), cfg)
    W = params["prop"]["msg_w"][:T2]
    b = params["prop"]["msg_b"][:T2]
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))
    tgt = jax.random.normal(jax.random.PRNGKey(2), (N, D))

    def loss_xla(h, W, b):
        a = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(typ), jnp.asarray(mask), W, b)
        return jnp.sum((a - tgt) ** 2)

    def loss_onehot(h, W, b):
        a = aggregate_onehot(h, lay, W, b)
        return jnp.sum((a - tgt) ** 2)

    v_ref, g_ref = jax.value_and_grad(loss_xla, argnums=(0, 1, 2))(h, W, b)
    v_got, g_got = jax.value_and_grad(loss_onehot, argnums=(0, 1, 2))(h, W, b)
    np.testing.assert_allclose(float(v_got), float(v_ref), rtol=1e-4)
    for a, r, name in zip(g_got, g_ref, ("dh", "dW", "db")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                   rtol=3e-4, atol=3e-4, err_msg=name)


def test_aggregate_grad_unpadded_da(rng):
    """N not a 128-multiple: the forward output (and so the cotangent da)
    has fewer rows than the layout's padded dst space — the backward must
    handle the shorter cotangent instead of raising a shape error.
    Checked against an independent per-edge numpy oracle."""
    from ggnn.ops.window import aggregate_window, build_window_layout

    N, T2, D, E = 200, 4, 8, 600
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    typ = rng.integers(0, T2, E)
    mask = (rng.random(E) < 0.9).astype(np.float32)
    h = rng.standard_normal((N, D)).astype(np.float32)
    W = (rng.standard_normal((T2, D, D)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((T2, D)) * 0.1).astype(np.float32)
    da = rng.standard_normal((N, D)).astype(np.float32)

    dh_o = np.zeros((N, D))
    dW_o = np.zeros((T2, D, D))
    db_o = np.zeros((T2, D))
    for e in range(E):
        if mask[e] <= 0:
            continue
        u, v, t = src[e], dst[e], typ[e]
        dh_o[u] += W[t] @ da[v]
        dW_o[t] += np.outer(h[u], da[v])
        db_o[t] += da[v]

    n_pad = 256
    lay = build_dst_block_layout(src, dst, typ, mask, n_pad, tile_e=128,
                                 n_message_types=T2,
                                 n_src_rows=N).to_device()
    wlay = build_window_layout(src, dst, typ, mask, n_pad, window=64,
                               min_edges_per_tile=4, n_src_rows=N,
                               n_message_types=T2, row_major="src",
                               force_spill=True,
                               spill_tile_e=16)

    for agg, layout in ((aggregate_onehot, lay), (aggregate_window, wlay)):
        def loss(h, W, b):
            return jnp.sum(agg(h, layout, W, b)[:N] * da)

        g = jax.grad(loss, argnums=(0, 1, 2))(h, W, b)
        for got, want, name in zip(g, (dh_o, dW_o, db_o),
                                   ("dh", "dW", "db")):
            np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                       atol=1e-4, err_msg=name)
