"""Destination-block layouts of the ``onehot`` backend: layout invariants
and parity with the XLA segment path / oracle, forward and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ggnn.graph import PaddingSpec, batch_graphs
from ggnn.models import ModelConfig, init_params, propagate
from ggnn.ops.onehot import (
    BLOCK_N, aggregate_onehot, build_dst_block_layout, onehot_segment_scatter)
from ggnn.ops.segment import typed_aggregate


def random_edges(rng, n_nodes, n_edges, n_types):
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    typ = rng.integers(0, n_types, n_edges).astype(np.int32)
    mask = np.ones(n_edges, np.float32)
    # sprinkle padding edges
    pad = rng.random(n_edges) < 0.1
    mask[pad] = 0.0
    return src, dst, typ, mask


def test_layout_invariants(rng):
    N, E, T2 = 256, 500, 6
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_dst_block_layout(src, dst, typ, mask, N, tile_e=8)
    # every real edge appears once with correct (gather_idx, dst) pairing
    real = mask > 0
    want = sorted(zip((typ[real].astype(np.int64) * N + src[real]).tolist(),
                      dst[real].tolist()))
    got = []
    for pos in range(lay.gather_idx.shape[0]):
        if lay.dst_local[pos] >= 0:
            tile = pos // lay.tile_e
            block = int(np.searchsorted(lay.tile_start, tile, "right")) - 1
            got.append((int(lay.gather_idx[pos]),
                        int(lay.dst_local[pos]) + block * BLOCK_N))
    assert sorted(got) == want
    assert int(lay.tile_start[-1]) * lay.tile_e == lay.gather_idx.shape[0]


def test_scatter_kernel_matches_segment_sum(rng):
    N, D = 256, 16
    E_pack, tile_e = 64, 8
    msgs = rng.standard_normal((E_pack, D)).astype(np.float32)
    # two blocks of edges: block 0 tiles [0,4), block 1 tiles [4, 8)
    tile_start = np.array([0, 4, 8], np.int32)
    dst_local = rng.integers(0, BLOCK_N, E_pack).astype(np.int32)
    dst_local[rng.random(E_pack) < 0.2] = -1  # padding
    out = onehot_segment_scatter(
        jnp.asarray(msgs), jnp.asarray(dst_local), jnp.asarray(tile_start),
        n_blocks=2, tile_e=tile_e)
    # reference
    ref = np.zeros((2 * BLOCK_N, D), np.float32)
    for pos in range(E_pack):
        if dst_local[pos] >= 0:
            block = 0 if pos // tile_e < 4 else 1
            ref[block * BLOCK_N + dst_local[pos]] += msgs[pos]
    np.testing.assert_allclose(np.asarray(out)[:2 * BLOCK_N], ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("row_order", ["type", "block"])
def test_aggregate_onehot_matches_xla(rng, row_order):
    N, E, T2, D = 256, 700, 6, 32
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_dst_block_layout(src, dst, typ, mask, N, tile_e=8,
                                 n_message_types=T2, row_order=row_order)
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=3)
    params = init_params(jax.random.PRNGKey(0), cfg)
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))
    ref = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(typ), jnp.asarray(mask),
                          params["prop"]["msg_w"], params["prop"]["msg_b"])
    got = aggregate_onehot(h, lay, params["prop"]["msg_w"],
                           params["prop"]["msg_b"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("tile_e,align", [(16, 16), (32, 16), (16, 8)])
def test_aggregate_onehot_edge_align(rng, tile_e, align):
    """16-aligned packing (gather reads ~real rows; mono scatter at
    win_stride offsets) matches the XLA path and shrinks the pack."""
    N, E, T2, D = 256, 700, 6, 32
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay_pad = build_dst_block_layout(src, dst, typ, mask, N, tile_e=tile_e)
    lay = build_dst_block_layout(src, dst, typ, mask, N, tile_e=tile_e,
                                 edge_align=align)
    # pack shrinks modulo the one-tile overrun safety margin (dominant
    # only at toy scales like this one)
    assert (lay.gather_idx.shape[0]
            <= lay_pad.gather_idx.shape[0] + tile_e)
    # every block's edges start at an align-multiple of the pack
    starts = np.flatnonzero(np.diff(np.r_[-1, lay.dst_local >= 0]) == 1)
    assert all(s % align == 0 for s in starts
               if s == 0 or lay.dst_local[s - 1] < 0)
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=3)
    params = init_params(jax.random.PRNGKey(0), cfg)
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))
    ref = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(typ), jnp.asarray(mask),
                          params["prop"]["msg_w"], params["prop"]["msg_b"])
    got = aggregate_onehot(h, lay, params["prop"]["msg_w"],
                           params["prop"]["msg_b"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_kernel_variants_agree(rng):
    """The tile-addressed scatter (dst block from ``tile_start``, row from
    ``dst_local``) and the row-addressed one (``dst_global``) express the
    same sum on the same layout."""
    from ggnn.ops.onehot import scatter_rows

    N, E, T2 = 256, 500, 4
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_dst_block_layout(src, dst, typ, mask, N, tile_e=8)
    msgs = jnp.asarray(rng.standard_normal(
        (lay.gather_idx.shape[0], 16)).astype(np.float32))
    tiled = onehot_segment_scatter(
        msgs, jnp.asarray(lay.dst_local), jnp.asarray(lay.tile_start),
        n_blocks=lay.n_blocks, tile_e=8)
    rows = scatter_rows(msgs, jnp.asarray(lay.dst_global), N)
    np.testing.assert_allclose(np.asarray(tiled), np.asarray(rows),
                               rtol=1e-6, atol=1e-6)


def test_propagate_onehot_backend(rng):
    graphs = []
    for _ in range(3):
        n = int(rng.integers(5, 12))
        m = int(rng.integers(3, 2 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 3, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.5).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann, targets={}))
    spec = PaddingSpec(n_graphs=3, n_pad=BLOCK_N,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 4,
                       n_edge_types=3, annotation_dim=2).round_up()
    b = batch_graphs(graphs, spec)
    cfg_x = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3)
    cfg_o = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3,
                        backend="onehot")
    params = init_params(jax.random.PRNGKey(2), cfg_x)
    args = (jnp.asarray(b.annotations), jnp.asarray(b.edge_src),
            jnp.asarray(b.edge_dst), jnp.asarray(b.edge_type),
            jnp.asarray(b.edge_mask))
    ref = propagate(params["prop"], cfg_x, *args)
    got = propagate(params["prop"], cfg_o, *args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("N,T2", [(384, 6), (256, 16)])
def test_typed_pack_aggregate_parity(rng, N, T2):
    """Typed path (gather h directly, aggregate per (type, dst), apply W_t
    as one batched matmul, in-degree bias) matches the XLA segment path,
    forward and gradients."""
    from ggnn.ops.onehot import aggregate_onehot, build_typed_dst_layout
    E, D = 3000, 64
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    typ = rng.integers(0, T2, E).astype(np.int32)
    mask = (rng.random(E) < 0.9).astype(np.float32)
    lay = build_typed_dst_layout(src, dst, typ, mask, N, T2)
    w = jax.random.normal(jax.random.PRNGKey(0), (T2, D, D)) * 0.2
    b = jax.random.normal(jax.random.PRNGKey(1), (T2, D)) * 0.1
    h = jax.random.normal(jax.random.PRNGKey(2), (N, D))
    ref = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(typ), jnp.asarray(mask), w, b)
    got = aggregate_onehot(h, lay, w, b)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
    tgt = jax.random.normal(jax.random.PRNGKey(3), (N, D))

    def loss(agg):
        def f(h, w, b):
            return jnp.sum((agg(h, w, b) - tgt) ** 2)
        return f

    g_ref = jax.grad(loss(lambda h, w, b: typed_aggregate(
        h, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(typ),
        jnp.asarray(mask), w, b)), argnums=(0, 1, 2))(h, w, b)
    g_new = jax.grad(loss(lambda h, w, b: aggregate_onehot(
        h, lay, w, b)), argnums=(0, 1, 2))(h, w, b)
    for a, c, name in zip(g_new, g_ref, ("dh", "dW", "db")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   rtol=3e-4, atol=3e-4, err_msg=name)


def test_typed_pack_hub_graph():
    """A hub graph (one dst block absorbing most edges) through the typed
    layout matches the XLA segment path."""
    from ggnn.ops.onehot import aggregate_onehot, build_typed_dst_layout
    from ggnn.ops.segment import typed_aggregate
    r = np.random.default_rng(11)
    N, E, T2, D = 1024, 6000, 4, 64
    src = r.integers(0, N, E).astype(np.int32)
    dst = np.where(r.random(E) < 0.9, r.integers(0, 64, E),
                   r.integers(0, N, E)).astype(np.int32)
    typ = r.integers(0, T2, E).astype(np.int32)
    mask = np.ones(E, np.float32)
    lay = build_typed_dst_layout(src, dst, typ, mask, N, T2)
    w = jax.random.normal(jax.random.PRNGKey(0), (T2, D, D)) * 0.2
    b = jax.random.normal(jax.random.PRNGKey(1), (T2, D)) * 0.1
    h = jax.random.normal(jax.random.PRNGKey(2), (N, D))
    ref = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(typ), jnp.asarray(mask), w, b)
    got = aggregate_onehot(h, lay, w, b)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seed", [21, 22, 23, 24, 25, 26, 27, 28])
def test_typed_pack_fuzz(seed):
    """Random graph shapes (odd block counts, empty (type, dst) groups,
    unused types) through the typed layout match the XLA segment path,
    forward and dh/dW/db."""
    from ggnn.ops.onehot import aggregate_onehot, build_typed_dst_layout
    r = np.random.default_rng(seed)
    N = 128 * int(r.integers(2, 8))
    E = int(r.integers(800, 6000))
    T2 = int(r.integers(2, 11))
    D = 32
    src = r.integers(0, N, E).astype(np.int32)
    dst = r.integers(0, N, E).astype(np.int32)
    typ = r.integers(0, T2 - 1, E).astype(np.int32)   # top type unused
    mask = (r.random(E) < 0.85).astype(np.float32)
    lay = build_typed_dst_layout(src, dst, typ, mask, N, T2)
    w = jax.random.normal(jax.random.PRNGKey(seed), (T2, D, D)) * 0.2
    b = jax.random.normal(jax.random.PRNGKey(seed + 1), (T2, D)) * 0.1
    h = jax.random.normal(jax.random.PRNGKey(seed + 2), (N, D))

    def ref_agg(h_, w_, b_):
        return typed_aggregate(h_, jnp.asarray(src), jnp.asarray(dst),
                               jnp.asarray(typ), jnp.asarray(mask), w_, b_)

    def got_agg(h_, w_, b_):
        return aggregate_onehot(h_, lay, w_, b_)

    np.testing.assert_allclose(np.asarray(got_agg(h, w, b)),
                               np.asarray(ref_agg(h, w, b)),
                               rtol=2e-4, atol=2e-4)
    g_r = jax.grad(lambda *a: jnp.sum(ref_agg(*a) ** 2),
                   argnums=(0, 1, 2))(h, w, b)
    g_g = jax.grad(lambda *a: jnp.sum(got_agg(*a) ** 2),
                   argnums=(0, 1, 2))(h, w, b)
    for a_, c_, name in zip(g_g, g_r, ("dh", "dW", "db")):
        np.testing.assert_allclose(np.asarray(a_), np.asarray(c_),
                                   rtol=5e-4, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_scatter_rows_drops_padding(rng, dtype):
    """scatter_rows sums rows into their dst in f32 and drops dst < 0."""
    from ggnn.ops.onehot import scatter_rows
    msgs = rng.standard_normal((200, 8)).astype(np.float32)
    dst = rng.integers(-1, 50, 200).astype(np.int32)
    got = scatter_rows(jnp.asarray(msgs, dtype), jnp.asarray(dst), 50)
    assert got.dtype == jnp.float32 and got.shape == (50, 8)
    want = np.zeros((50, 8))
    m = np.asarray(jnp.asarray(msgs, dtype), np.float64)
    for e in range(200):
        if dst[e] >= 0:
            want[dst[e]] += m[e]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("row_order", ["type", "src", "block"])
def test_node_table_row_orders(rng, row_order):
    """node_table puts h[n]·W_t + b_t at the row each layout's gather
    index names."""
    from ggnn.ops.onehot import node_table
    N, T2, D = 256, 3, 8
    h = rng.standard_normal((N, D)).astype(np.float32)
    w = rng.standard_normal((T2, D, D)).astype(np.float32)
    b = rng.standard_normal((T2, D)).astype(np.float32)
    table = np.asarray(node_table(jnp.asarray(h), jnp.asarray(w),
                                  jnp.asarray(b), row_order))
    for n, t in ((0, 0), (5, 2), (130, 1), (255, 2)):
        row = {"type": t * N + n, "src": n * T2 + t,
               "block": (n // 128) * T2 * 128 + t * 128 + n % 128}[row_order]
        np.testing.assert_allclose(table[row], h[n] @ w[t] + b[t],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_chunks", [2, 4])
def test_onehot_chunked_matches_xla(rng, n_chunks):
    """Chunked layouts (contiguous dst ranges, global gather rows) match
    the XLA segment path, directly and through propagate."""
    from ggnn.ops.onehot import (aggregate_onehot_chunked,
                                 build_chunked_dst_layouts)
    N, E, T2, D = 512, 2000, 6, 16
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lays = build_chunked_dst_layouts(src, dst, typ, mask, N, n_chunks,
                                     tile_e=64)
    w = jax.random.normal(jax.random.PRNGKey(0), (T2, D, D)) * 0.2
    b = jax.random.normal(jax.random.PRNGKey(1), (T2, D)) * 0.1
    h = jax.random.normal(jax.random.PRNGKey(2), (N, D))
    ref = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(typ), jnp.asarray(mask), w, b)
    got = aggregate_onehot_chunked(h, lays, w, b)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=3,
                      n_steps=2)
    params = init_params(jax.random.PRNGKey(3), cfg)
    ann = jnp.asarray((rng.random((N, 2)) < 0.5).astype(np.float32))
    args = (ann, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(typ),
            jnp.asarray(mask))
    want = propagate(params["prop"], cfg, *args)
    got = propagate(params["prop"], ModelConfig(
        state_dim=D, annotation_dim=2, n_edge_types=3, n_steps=2,
        backend="onehot"), *args, scatter_layout=lays)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-5, atol=3e-6)
