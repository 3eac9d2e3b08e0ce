"""Windowed block-CSR aggregation (clustered-graph fast path): parity with
the XLA segment path on arbitrary topologies, spill handling, and layout
invariants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ggnn.models import ModelConfig, init_params
from ggnn.ops.segment import typed_aggregate
from ggnn.ops.window import aggregate_window, build_window_layout


def random_edges(rng, n_nodes, n_edges, n_types):
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    typ = rng.integers(0, n_types, n_edges).astype(np.int32)
    mask = np.ones(n_edges, np.float32)
    mask[rng.random(n_edges) < 0.1] = 0.0
    return src, dst, typ, mask


@pytest.mark.parametrize("min_edges", [1, 4, 10_000])
@pytest.mark.parametrize("row_major", ["block", "src", "type"])
def test_window_parity(rng, min_edges, row_major):
    """min_edges=1: everything windowed; 4: mixed window+spill;
    10000: everything spills — all three must match the XLA path."""
    N, E, T2, D = 256, 600, 6, 32
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=64,
                              min_edges_per_tile=min_edges, spill_tile_e=8,
                              n_message_types=T2, row_major=row_major)
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=3)
    params = init_params(jax.random.PRNGKey(0), cfg)
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))
    ref = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(typ), jnp.asarray(mask),
                          params["prop"]["msg_w"], params["prop"]["msg_b"])
    got = aggregate_window(h, lay, params["prop"]["msg_w"],
                           params["prop"]["msg_b"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("typed_spill,min_edges,row_major",
                         [(False, 3, "src"), (True, 3, "block"),
                          (False, 150, "block"), (False, 10_000, "src")])
def test_fused_gru_step_parity(rng, typed_spill, min_edges, row_major):
    """gru_window_step (window aggregation + GRU in one step function)
    matches the unfused aggregate_window + gru_update step — all-dense
    (3), mixed window+spill (150), and all-spill (10000); src- and
    block-major table orders, table and XW spills."""
    from ggnn.models.ggnn import gru_update
    from ggnn.ops.window import gru_window_step
    N, E, T2, D = 512, 3000, 4, 32
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=256,
                              min_edges_per_tile=min_edges, spill_tile_e=8,
                              n_message_types=T2, block_rows=256,
                              typed_spill=typed_spill, row_major=row_major)
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    prop = params["prop"]
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))
    a = aggregate_window(h, lay, prop["msg_w"], prop["msg_b"])
    ref = gru_update(prop["gru"], h, a)
    got = gru_window_step(h, lay, prop["msg_w"], prop["msg_b"], prop["gru"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_quantized_step_extra_init_no_spill(rng):
    """quantized + extra_init on a layout with NO spill population: the
    extra partial alone is added to the aggregation (no spill arrays
    exist to gather from)."""
    from ggnn.models.ggnn import gru_update
    from ggnn.ops.window import gru_window_step
    N, E, T2, D, W = 256, 3000, 4, 128, 256
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=W,
                              min_edges_per_tile=1, n_message_types=T2,
                              block_rows=256, row_major="block")
    assert lay.meta[4] is None  # genuinely spill-free
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    prop = params["prop"]
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))
    extra = jax.random.normal(jax.random.PRNGKey(2), (N, D)) * 0.1
    a = aggregate_window(h, lay, prop["msg_w"], prop["msg_b"])
    ref = gru_update(prop["gru"], h, a + extra)
    got = gru_window_step(h, lay, prop["msg_w"], prop["msg_b"],
                          prop["gru"], quantized=True,
                          extra_init=extra)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0.1, atol=0.08)
    assert float(jnp.mean(jnp.abs(got - ref))) < 1e-2


@pytest.mark.parametrize("min_edges,typed_spill",
                         [(2, False), (120, False), (120, True)])
def test_quantized_fused_step(rng, min_edges, typed_spill):
    """int8-quantized serving step (power-of-2 per-window scales,
    int8×int8→int32 products; the table spill dequantizes through the
    scales vector) tracks the f32 step within quantization tolerance;
    with the XW typed
    spill the spilled contribution is exact (gathers bf16 h, never the
    q8 table)."""
    from ggnn.models.ggnn import gru_update
    from ggnn.ops.window import (gru_window_step,
                                            node_table_block_major_q8)
    N, E, T2, D, W = 256, 3000, 4, 128, 256
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=W,
                              min_edges_per_tile=min_edges, spill_tile_e=16,
                              n_message_types=T2, block_rows=256,
                              row_major="block", typed_spill=typed_spill)
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    prop = params["prop"]
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))
    # table-level check: dequantized table tracks the f32 table
    tq, scales = node_table_block_major_q8(h, prop["msg_w"], prop["msg_b"],
                                           window=W)
    assert tq.shape == (N * T2, D) and scales.shape == (N * T2 // W, 1)
    from ggnn.ops.onehot import node_table
    tf = node_table(h, prop["msg_w"], prop["msg_b"], "block")
    deq = np.asarray(tq, np.float32) \
        * np.repeat(np.asarray(scales)[:, 0], W)[:, None]
    err = np.abs(deq - np.asarray(tf))
    lim = np.repeat(np.asarray(scales)[:, 0], W)[:, None]  # 1 LSB per window
    assert (err <= lim * 0.500001).all()
    # step-level parity within quantization noise
    a = aggregate_window(h, lay, prop["msg_w"], prop["msg_b"])
    ref = gru_update(prop["gru"], h, a)
    got = gru_window_step(h, lay, prop["msg_w"], prop["msg_b"], prop["gru"],
                          quantized=True)
    # int8 window-scale noise propagated through the GRU gates: bounded
    # absolute deviation (relative blows up near zero crossings)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0.1, atol=0.08)
    assert float(jnp.mean(jnp.abs(got - ref))) < 1e-2


def test_propagate_fused_backend(rng):
    """Full T-step propagation with backend='window', fuse_gru=True matches
    the XLA path (scan, layout through jit args)."""
    from ggnn.models import propagate
    N, E, T2 = 512, 2500, 6
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=256,
                              min_edges_per_tile=3, spill_tile_e=8,
                              n_message_types=T2, block_rows=256)
    mk = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3)
    cfg_x = ModelConfig(**mk)
    cfg_f = ModelConfig(**mk, backend="window", fuse_gru=True)
    params = init_params(jax.random.PRNGKey(4), cfg_x)
    ann = jnp.asarray((np.random.default_rng(0).random((N, 2)) < 0.5)
                      .astype(np.float32))
    args = (ann, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(typ),
            jnp.asarray(mask))
    ref = propagate(params["prop"], cfg_x, *args)

    @jax.jit
    def run(p, lay, *args):
        return propagate(p, cfg_f, *args, scatter_layout=lay)

    got = run(params["prop"], lay, *args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("min_edges", [180, 10_000])
def test_window_spill_edge_align(rng, min_edges):
    """16-aligned spill packing (each dst block's spilled edges padded to
    16 rows, not to whole tiles) matches the XLA path — partial (180) and
    full (10000) spill."""
    N, E, T2, D = 512, 3000, 4, 32
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=256,
                              min_edges_per_tile=min_edges, spill_tile_e=16,
                              n_message_types=T2, block_rows=256,
                              force_spill=True)
    assert 0 < lay.stats["spill_frac"] <= 1.0
    assert lay.stats["spill_tiles"] > 0
    assert lay.stats["spill_pack"] % 16 == 0
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))
    ref = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(typ), jnp.asarray(mask),
                          params["prop"]["msg_w"], params["prop"]["msg_b"])
    got = aggregate_window(h, lay, params["prop"]["msg_w"],
                           params["prop"]["msg_b"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    # fused step through the aligned spill init
    from ggnn.models.ggnn import gru_update
    from ggnn.ops.window import gru_window_step
    ref_h = gru_update(params["prop"]["gru"], h, got)
    got_h = gru_window_step(h, lay, params["prop"]["msg_w"],
                            params["prop"]["msg_b"], params["prop"]["gru"])
    np.testing.assert_allclose(np.asarray(got_h), np.asarray(ref_h),
                               rtol=2e-5, atol=2e-5)


def test_window_layout_stats(rng):
    """Community graph: dense tiles capture the intra-community mass and
    the spill fraction tracks the cross-community rate."""
    from ggnn.data.synthetic import synthetic_batch
    b = synthetic_batch(4096, 40_000, 4, annotation_dim=2, seed=0,
                        node_mult=128, n_communities=16, p_intra=0.95)
    lay = build_window_layout(b.edge_src, b.edge_dst, b.edge_type,
                              b.edge_mask, b.spec.n_pad, window=256,
                              min_edges_per_tile=8)
    assert lay.stats["spill_frac"] < 0.25
    # sparse uniform graph (realistic node/edge ratio): nearly everything
    # spills — the builder correctly routes it to the per-edge path
    u = synthetic_batch(32_768, 40_000, 4, annotation_dim=2, seed=0,
                        node_mult=128)
    lay_u = build_window_layout(u.edge_src, u.edge_dst, u.edge_type,
                                u.edge_mask, u.spec.n_pad, window=256,
                                min_edges_per_tile=8)
    assert lay_u.stats["spill_frac"] > 0.9


@pytest.mark.parametrize("window,out_rows", [(64, 128), (128, 256)])
def test_window_kernel_variants_agree(rng, window, out_rows):
    """window_block_spmm on a layout's compact count stream (dummy tiles,
    c_off indirection) equals a per-tile NumPy loop over the same tiles."""
    from ggnn.ops.window import window_block_spmm
    N, E, T2, D = 512, 900, 4, 16
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=window,
                              min_edges_per_tile=1, block_rows=out_rows)
    a = {k: np.asarray(v) for k, v in lay.arrays.items()}
    R = T2 * N
    table = rng.standard_normal((R + (-R) % window, D)).astype(np.float32)
    got = window_block_spmm(
        jnp.asarray(table), lay.arrays["c_stream"],
        lay.arrays["block_of_tile"], lay.arrays["win_of_tile"],
        lay.arrays["c_off"], n_blocks=lay.n_blocks, window=window,
        out_rows=out_rows)
    ref = np.zeros((lay.n_blocks * out_rows, D), np.float32)
    c = a["c_stream"].reshape(-1, out_rows, window).astype(np.float32)
    for t, (blk, w) in enumerate(zip(a["block_of_tile"], a["win_of_tile"])):
        if w >= 0:
            ref[blk * out_rows:(blk + 1) * out_rows] += (
                c[a["c_off"][t]] @ table[w * window:(w + 1) * window])
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-4)


def test_propagate_window_backend(rng):
    """Full T-step propagation with backend='window' matches the XLA path
    (layout through jit args, mixed window+spill)."""
    from ggnn.models import propagate
    N, E, T2 = 256, 500, 6
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=64,
                              min_edges_per_tile=4, spill_tile_e=8)
    cfg_x = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                        n_steps=3)
    cfg_w = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                        n_steps=3, backend="window")
    params = init_params(jax.random.PRNGKey(4), cfg_x)
    ann = jnp.asarray((np.random.default_rng(0).random((N, 2)) < 0.5)
                      .astype(np.float32))
    args = (ann, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(typ),
            jnp.asarray(mask))
    ref = propagate(params["prop"], cfg_x, *args)

    @jax.jit
    def run(p, lay, *args):
        return propagate(p, cfg_w, *args, scatter_layout=lay)

    got = run(params["prop"], lay, *args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("row_major,window",
                         [("block", 64), ("block", 128), ("block", 256),
                          ("src", 64), ("type", 64)])
def test_window_grad_parity(rng, row_major, window):
    """jax.grad through aggregate_window matches the XLA segment path.
    row_major='block' with window % 128 == 0 exercises the FUSED backward
    kernel (dh/dW epilogue, in-degree db); the others exercise the
    Y-materializing fallback + one-hot spill backward."""
    N, E, T2, D = 256, 600, 6, 32
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=window,
                              min_edges_per_tile=4, spill_tile_e=8,
                              n_message_types=T2, row_major=row_major)
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=3)
    params = init_params(jax.random.PRNGKey(0), cfg)
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))
    w, b = params["prop"]["msg_w"], params["prop"]["msg_b"]
    tgt = jax.random.normal(jax.random.PRNGKey(2), (N, D))

    def loss_ref(h, w, b):
        out = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(typ), jnp.asarray(mask), w, b)
        return jnp.sum((out - tgt) ** 2)

    def loss_win(h, w, b):
        out = aggregate_window(h, lay, w, b)
        return jnp.sum((out - tgt) ** 2)

    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(h, w, b)
    g_win = jax.grad(loss_win, argnums=(0, 1, 2))(h, w, b)
    for a, c, name in zip(g_win, g_ref, ("dh", "dW", "db")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def test_window_grad_parity_dummy_first_windows(rng):
    """REGRESSION: fused backward with sparse-ish kept tiles, where many
    backward windows' first tile is the zero-init dummy (no real tile at
    dst block 0) — the fused kernel must zero acc before accumulating
    (caught by the numpy-oracle verify: dh was 36% off without it)."""
    N, E, T2, D = 384, 2000, 4, 64
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=128,
                              min_edges_per_tile=40, spill_tile_e=8,
                              n_message_types=T2, row_major="block",
                              force_spill=True)
    assert 0 < lay.stats["spill_frac"] < 0.5
    w = jax.random.normal(jax.random.PRNGKey(0), (T2, D, D)) * 0.2
    b = jax.random.normal(jax.random.PRNGKey(1), (T2, D)) * 0.1
    h = jax.random.normal(jax.random.PRNGKey(2), (N, D))
    tgt = jax.random.normal(jax.random.PRNGKey(3), (N, D))

    def loss_ref(h, w, b):
        out = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(typ), jnp.asarray(mask), w, b)
        return jnp.sum((out - tgt) ** 2)

    def loss_win(h, w, b):
        out = aggregate_window(h, lay, w, b)
        return jnp.sum((out - tgt) ** 2)

    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(h, w, b)
    g_win = jax.grad(loss_win, argnums=(0, 1, 2))(h, w, b)
    for a, c, name in zip(g_win, g_ref, ("dh", "dW", "db")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def test_window_grad_parity_straddle(rng):
    """Windows that straddle src-block boundaries (T2·128 not a multiple
    of W: T2=3, W=256): the block-level fused backward doesn't apply —
    the gate must route to the Y-materializing fallback, bit-correctly."""
    N, E, T2, D = 256, 700, 3, 32
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=256,
                              min_edges_per_tile=4, spill_tile_e=8,
                              n_message_types=T2, row_major="block")
    w = jax.random.normal(jax.random.PRNGKey(0), (T2, D, D)) * 0.2
    b = jax.random.normal(jax.random.PRNGKey(1), (T2, D)) * 0.1
    h = jax.random.normal(jax.random.PRNGKey(2), (N, D))
    tgt = jax.random.normal(jax.random.PRNGKey(3), (N, D))

    def loss_ref(h, w, b):
        out = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(typ), jnp.asarray(mask), w, b)
        return jnp.sum((out - tgt) ** 2)

    def loss_win(h, w, b):
        out = aggregate_window(h, lay, w, b)
        return jnp.sum((out - tgt) ** 2)

    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(h, w, b)
    g_win = jax.grad(loss_win, argnums=(0, 1, 2))(h, w, b)
    for a, c, name in zip(g_win, g_ref, ("dh", "dW", "db")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def test_window_backend_train_step(rng):
    """End-to-end: jitted value_and_grad through propagate backend='window'
    (scan over T steps, layout through jit args) matches the XLA backend."""
    N, E, T2 = 256, 500, 6
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=64,
                              min_edges_per_tile=4, spill_tile_e=8,
                              n_message_types=T2)
    from ggnn.models import propagate
    mk = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3)
    params = init_params(jax.random.PRNGKey(4), ModelConfig(**mk))
    ann = jnp.asarray((np.random.default_rng(1).random((N, 2)) < 0.5)
                      .astype(np.float32))
    args = (ann, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(typ),
            jnp.asarray(mask))

    def grads(backend, lay=None):
        cfg = ModelConfig(**mk, backend=backend)

        @jax.jit
        def loss(p, lay, *args):
            h = propagate(p, cfg, *args, scatter_layout=lay)
            return jnp.sum(h * h)

        return jax.grad(loss)(params["prop"], lay, *args)

    g_ref = grads("xla")
    g_win = grads("window", lay)
    jax.tree.map(lambda a, c: np.testing.assert_allclose(
        np.asarray(a), np.asarray(c), rtol=3e-4, atol=3e-5), g_win, g_ref)


def test_window_layout_jit_argument(rng):
    """The layout passes through jit arguments as a pytree (no big
    constants baked into the compiled program)."""
    N, E, T2, D = 256, 400, 4, 16
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=64,
                              min_edges_per_tile=2, spill_tile_e=8)
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=2)
    params = init_params(jax.random.PRNGKey(2), cfg)
    h = jax.random.normal(jax.random.PRNGKey(3), (N, D))

    @jax.jit
    def run(h, lay, w, b):
        return aggregate_window(h, lay, w, b)

    got = run(h, lay, params["prop"]["msg_w"], params["prop"]["msg_b"])
    ref = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(typ), jnp.asarray(mask),
                          params["prop"]["msg_w"], params["prop"]["msg_b"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_window_layout_degenerate(rng):
    """Empty and single-edge graphs build valid layouts (dummy tiles only)
    and aggregate to the correct (zero) result."""
    N, D = 256, 16
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))
    # zero real edges
    lay = build_window_layout(np.zeros(4, np.int32), np.zeros(4, np.int32),
                              np.zeros(4, np.int32), np.zeros(4, np.float32),
                              N, window=64, n_message_types=4,
                              force_spill=True)
    out = aggregate_window(h, lay, params["prop"]["msg_w"],
                           params["prop"]["msg_b"])
    np.testing.assert_allclose(np.asarray(out), 0.0, atol=1e-6)
    # one real edge, duplicated 200x (int8 saturation -> spill)
    src = np.full(200, 3, np.int32)
    dst = np.full(200, 7, np.int32)
    typ = np.ones(200, np.int32)
    mask = np.ones(200, np.float32)
    lay2 = build_window_layout(src, dst, typ, mask, N, window=64,
                               min_edges_per_tile=1, n_message_types=4)
    assert lay2.stats["spill_frac"] == 1.0  # >127 duplicates spill
    ref = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(typ), jnp.asarray(mask),
                          params["prop"]["msg_w"], params["prop"]["msg_b"])
    got = aggregate_window(h, lay2, params["prop"]["msg_w"],
                           params["prop"]["msg_b"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("min_edges", [1, 4, 10_000])
@pytest.mark.parametrize("row_major", ["block", "src"])
def test_window_typed_spill_parity(rng, min_edges, row_major):
    """typed_spill=True: the spill gathers h directly and applies W_t in
    the scatter kernel (small-footprint gather) — forward,
    grads, and the fused-GRU serving step all match the XLA path across
    none/mixed/full spill regimes."""
    from ggnn.models.ggnn import gru_update
    from ggnn.ops.window import gru_window_step

    N, E, T2, D = 256, 600, 6, 32
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=64,
                              min_edges_per_tile=min_edges, spill_tile_e=16,
                              n_message_types=T2, row_major=row_major,
                              force_spill=True,
                              typed_spill=True)
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=3)
    params = init_params(jax.random.PRNGKey(0), cfg)
    W, b = params["prop"]["msg_w"], params["prop"]["msg_b"]
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))
    tgt = jax.random.normal(jax.random.PRNGKey(2), (N, D))

    def loss_ref(h, W, b):
        a = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(typ), jnp.asarray(mask), W, b)
        return jnp.sum((a - tgt) ** 2)

    def loss_win(h, W, b):
        a = aggregate_window(h, lay, W, b)
        return jnp.sum((a - tgt) ** 2)

    v_ref, g_ref = jax.value_and_grad(loss_ref, argnums=(0, 1, 2))(h, W, b)
    v_got, g_got = jax.value_and_grad(loss_win, argnums=(0, 1, 2))(h, W, b)
    np.testing.assert_allclose(float(v_got), float(v_ref), rtol=1e-5)
    for a, r, name in zip(g_got, g_ref, ("dh", "dW", "db")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                   rtol=3e-4, atol=3e-4, err_msg=name)

    # fused-GRU serving step rides the typed spill init
    gru = params["prop"]["gru"]
    a_ref = typed_aggregate(h, jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(typ), jnp.asarray(mask), W, b)
    ref_h = gru_update(gru, h, a_ref)
    got_h = gru_window_step(h, lay, W, b, gru)
    np.testing.assert_allclose(np.asarray(got_h), np.asarray(ref_h),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("min_edges,typed_spill",
                         [(3, False), (150, False), (3, True), (150, True)])
def test_fused_gru_step_grads(rng, min_edges, typed_spill):
    """value_and_grad through the fused window+GRU step matches the
    unfused aggregate_window + gru_update step for every input — h,
    msg_w, msg_b, and all GRU weights; dense and window+spill mixes,
    table and XW spills."""
    from ggnn.models.ggnn import gru_update
    from ggnn.ops.window import gru_window_step
    N, E, T2, D = 512, 3000, 4, 128
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=256,
                              min_edges_per_tile=min_edges, spill_tile_e=8,
                              n_message_types=T2, block_rows=256,
                              row_major="block", typed_spill=typed_spill)
    cfg = ModelConfig(state_dim=D, annotation_dim=2, n_edge_types=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    prop = params["prop"]
    h = jax.random.normal(jax.random.PRNGKey(1), (N, D))

    def loss_fused(h, msg_w, msg_b, gru):
        return jnp.sum(gru_window_step(h, lay, msg_w, msg_b, gru) ** 2)

    def loss_ref(h, msg_w, msg_b, gru):
        a = aggregate_window(h, lay, msg_w, msg_b)
        return jnp.sum(gru_update(gru, h, a) ** 2)

    args = (h, prop["msg_w"], prop["msg_b"], prop["gru"])
    vf, gf = jax.value_and_grad(loss_fused, argnums=(0, 1, 2, 3))(*args)
    vr, gr = jax.value_and_grad(loss_ref, argnums=(0, 1, 2, 3))(*args)
    np.testing.assert_allclose(float(vf), float(vr), rtol=1e-5)
    for got, ref in zip(jax.tree.leaves(gf), jax.tree.leaves(gr)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)


def _count_spmm_inputs(rng, dtype):
    from ggnn.ops.window import _stream_tiles
    N, E, T2, D, W = 512, 3000, 4, 16, 256
    src, dst, typ, mask = random_edges(rng, N, E, T2)
    lay = build_window_layout(src, dst, typ, mask, N, window=W,
                              min_edges_per_tile=1, n_message_types=T2,
                              block_rows=256, row_major="block")
    a = lay.arrays
    c = a["c_stream"].reshape(-1, 256, W)
    st_win, st_blk = _stream_tiles(c.shape[0], a["block_of_tile"],
                                   a["win_of_tile"], a["c_off"],
                                   lay.n_blocks)
    table = jnp.asarray(rng.standard_normal((T2 * N, D)), dtype)
    return table, c, st_win, st_blk, lay.n_blocks


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_count_spmm_grad_matches_autodiff(rng, dtype):
    """The count product's custom VJP (transposed product, nothing but
    the layout kept) equals autodiff of the plain einsum formulation."""
    from ggnn.ops.window import _count_spmm
    table, c, st_win, st_blk, nb = _count_spmm_inputs(rng, dtype)
    W = c.shape[-1]

    def plain(t):
        win = t.reshape(-1, W, t.shape[-1])[st_win]
        prod = jnp.einsum("sow,swd->sod", c.astype(t.dtype), win,
                          preferred_element_type=jnp.float32)
        return jax.ops.segment_sum(prod, st_blk, num_segments=nb)

    g = jax.random.normal(jax.random.PRNGKey(0), (nb, 256, table.shape[-1]))
    got = jax.vjp(lambda t: _count_spmm(t, c, st_win, st_blk, nb, False),
                  table)[1](g)[0]
    want = jax.vjp(plain, table)[1](g)[0]
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(
        np.asarray(_count_spmm(table, c, st_win, st_blk, nb, False)),
        np.asarray(plain(table)), rtol=1e-5, atol=1e-4)


def test_count_spmm_int8_backward_tracks_exact(rng):
    """grad_quant: the int8 transposed product tracks the exact backward
    within the per-block int8 rounding (rel-L2 < 2 %)."""
    from ggnn.ops.window import _count_spmm
    table, c, st_win, st_blk, nb = _count_spmm_inputs(rng, jnp.float32)
    g = jax.random.normal(jax.random.PRNGKey(1), (nb, 256, table.shape[-1]))
    exact = jax.vjp(lambda t: _count_spmm(t, c, st_win, st_blk, nb, False),
                    table)[1](g)[0]
    quant = jax.vjp(lambda t: _count_spmm(t, c, st_win, st_blk, nb, True),
                    table)[1](g)[0]
    exact, quant = np.asarray(exact), np.asarray(quant)
    assert not np.array_equal(exact, quant)
    assert np.linalg.norm(quant - exact) < 0.02 * np.linalg.norm(exact)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_pow2(rng, scale):
    """int8 values in [-127, 127], power-of-2 scales, and a dequantization
    error of at most half a step per slice."""
    from ggnn.ops.window import _quantize_pow2
    x = jnp.asarray(rng.standard_normal((6, 32, 16)) * scale, jnp.float32)
    q, s = _quantize_pow2(x, axes=(1, 2))
    q, s = np.asarray(q), np.asarray(s)
    assert q.dtype == np.int8 and np.abs(q.astype(np.int32)).max() <= 127
    assert s.shape == (6, 1, 1)
    np.testing.assert_array_equal(np.exp2(np.round(np.log2(s))), s)
    err = np.abs(q * s - np.asarray(x))
    assert (err <= 0.5 * s + 1e-12).all()
