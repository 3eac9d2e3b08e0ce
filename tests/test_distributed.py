"""Distributed tests on the 8-virtual-device CPU mesh (SURVEY.md §4.4):
partitioning invariants and halo-exchange propagation parity vs the
single-device path."""

import jax
import numpy as np
import pytest

from ggnn.graph import PaddingSpec, batch_graphs
from ggnn.models import ModelConfig, init_params, propagate
from ggnn.parallel import make_mesh, partition_batch, sharded_propagate


def make_random_batch(rng, n_graphs=4, n_edge_types=3, annotation_dim=2,
                      n_mult=16):
    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(4, 12))
        m = int(rng.integers(2, 3 * n))
        edges = np.stack([rng.integers(0, n, m),
                          rng.integers(0, n_edge_types, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, annotation_dim)) < 0.5).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann, targets={}))
    total_n = sum(g["n_nodes"] for g in graphs)
    spec = PaddingSpec(
        n_graphs=n_graphs,
        n_pad=((total_n + n_mult - 1) // n_mult) * n_mult,
        e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
        n_edge_types=n_edge_types, annotation_dim=annotation_dim).round_up()
    return spec, batch_graphs(graphs, spec)


def test_device_count():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"


def test_partition_invariants(rng):
    spec, b = make_random_batch(rng, n_mult=8)
    parts = partition_batch(b, 8)
    assert parts.n_local * 8 == spec.n_pad
    # every real directed edge is present exactly once, on its dst's shard
    total = int(parts.edge_mask.sum())
    assert total == int(b.edge_mask.sum())
    for s in range(8):
        m = parts.edge_mask[s] > 0
        dst_g = parts.edge_dst_local[s, m] + s * parts.n_local
        assert (parts.edge_dst_local[s, m] >= 0).all()
        assert (parts.edge_dst_local[s, m] < parts.n_local).all()
        # halo remap round-trips to the global src id: coords past P·H are
        # self-edges reading h_local (the pool is [recv ∥ h_local])
        halo = parts.edge_src_halo[s, m]
        PH = 8 * parts.halo_size
        is_local = halo >= PH
        owner = np.where(is_local, s, halo // parts.halo_size)
        pos = halo % parts.halo_size
        src_back = np.where(
            is_local, s * parts.n_local + (halo - PH),
            owner * parts.n_local + parts.halo_send_idx[owner, s, pos])
        np.testing.assert_array_equal(src_back, parts.edge_src_global[s, m])
        # and self-edges are exactly the locally-owned sources
        np.testing.assert_array_equal(
            is_local, parts.edge_src_global[s, m] // parts.n_local == s)
        # edges sorted by type within shard
        et = parts.edge_type[s, m]
        assert (np.diff(et) >= 0).all()
        counts = np.bincount(et, minlength=spec.n_message_types)
        np.testing.assert_array_equal(np.diff(parts.type_offsets[s]), counts)
    # annotations reshaped consistently
    np.testing.assert_array_equal(
        parts.annotations.reshape(-1, spec.annotation_dim), b.annotations)


@pytest.mark.parametrize("strategy", ["all_gather", "halo", "halo_overlap"])
def test_sharded_propagate_matches_single_device(rng, strategy):
    spec, b = make_random_batch(rng, n_mult=8)
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=4)
    params = init_params(jax.random.PRNGKey(0), cfg)
    ref = np.asarray(propagate(
        params["prop"], cfg, b.annotations, b.edge_src, b.edge_dst,
        b.edge_type, b.edge_mask))

    mesh = make_mesh(n_graph=8)
    parts = partition_batch(b, 8)
    got = np.asarray(sharded_propagate(params["prop"], cfg, mesh, parts,
                                       strategy=strategy))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_propagate_other_shard_counts(rng, n_shards):
    spec, b = make_random_batch(rng, n_mult=n_shards * 8)
    cfg = ModelConfig(state_dim=4, annotation_dim=2, n_edge_types=3, n_steps=3)
    params = init_params(jax.random.PRNGKey(1), cfg)
    ref = np.asarray(propagate(
        params["prop"], cfg, b.annotations, b.edge_src, b.edge_dst,
        b.edge_type, b.edge_mask))
    mesh = make_mesh(n_graph=n_shards)
    parts = partition_batch(b, n_shards)
    got = np.asarray(sharded_propagate(params["prop"], cfg, mesh, parts,
                                       strategy="halo"))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)


def test_sharded_propagate_halo_window(rng):
    """halo_window: per-shard windowed block-CSR local aggregation +
    typed halo-pool remote aggregation matches the single-device path
    (community graph partitioned along community boundaries)."""
    from ggnn.data.synthetic import synthetic_batch
    from ggnn.parallel.partition import split_local_remote
    b = synthetic_batch(1024, 6000, 3, annotation_dim=2, seed=3,
                        node_mult=1024, n_communities=8, p_intra=0.9)
    # adversarial: mask out every edge of the HIGHEST message type — the
    # layout must still address the model's full [2E·N]-row table (a
    # max-observed-type inference bug returned silently wrong states here)
    b.edge_mask[b.edge_type == 5] = 0.0
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                      n_steps=3)
    params = init_params(jax.random.PRNGKey(2), cfg)
    ref = np.asarray(propagate(
        params["prop"], cfg, b.annotations, b.edge_src, b.edge_dst,
        b.edge_type, b.edge_mask))
    mesh = make_mesh(n_graph=8)
    parts = split_local_remote(partition_batch(b, 8))
    got = np.asarray(sharded_propagate(params["prop"], cfg, mesh, parts,
                                       strategy="halo_window"))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


def test_sharded_propagate_halo_window_uneven_spill(rng):
    """halo_window with NON-degenerate spill distributions: shards spill
    different edge counts, so the stacked per-shard spill arrays must be
    padded to common static shapes (16-aligned packs are per-topology
    unless spill_pad_tiles_to pins them — this raised ValueError on
    np.stack before the fix)."""
    from ggnn.data.synthetic import synthetic_batch
    from ggnn.parallel.partition import (build_halo_window_layouts,
                                             split_local_remote)
    b = synthetic_batch(1024, 6000, 3, annotation_dim=2, seed=5,
                        node_mult=1024, n_communities=8, p_intra=0.6)
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                      n_steps=3)
    params = init_params(jax.random.PRNGKey(2), cfg)
    parts = split_local_remote(partition_batch(b, 8))
    # force heavy, uneven spill: most tiles fall below the threshold
    arrays, meta = build_halo_window_layouts(parts, window=64,
                                             min_edges_per_tile=2000,
                                             spill_tile_e=16)
    assert arrays["s_gather_idx"].ndim == 2  # stacked [P, E_pack_static]
    ref = np.asarray(propagate(
        params["prop"], cfg, b.annotations, b.edge_src, b.edge_dst,
        b.edge_type, b.edge_mask))
    mesh = make_mesh(n_graph=8)
    got = np.asarray(sharded_propagate(
        params["prop"], cfg, mesh, parts, strategy="halo_window",
        halo_layouts=(arrays, meta)))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


def test_window_layout_for_batch_static_shapes(rng):
    """Two different topologies under the same PaddingSpec produce
    identically-shaped layouts (the serving compile-once contract),
    including the 16-aligned spill pack."""
    import jax.tree_util as jtu

    from ggnn.data import TASKS, generate_task_file
    from ggnn.data.babi import parse_graph_text
    from ggnn.graph import PaddingSpec, batch_graphs
    from ggnn.ops.window import window_layout_for_batch

    spec = PaddingSpec(n_graphs=4, n_pad=128, e_pad=256, n_edge_types=4,
                       annotation_dim=1).round_up()
    text = generate_task_file(4, 12, seed=9)
    exs = parse_graph_text(text, TASKS[4])
    graphs = [dict(n_nodes=e.n_nodes, edges=e.edges,
                   annotations=np.zeros((e.n_nodes, 1), np.float32),
                   targets={}) for e in exs]
    shapes = []
    for batch in (batch_graphs(graphs[:4], spec),
                  batch_graphs(graphs[4:8], spec)):
        lay = window_layout_for_batch(batch, window=256,
                                      min_edges_per_tile=4, spill_tile_e=16)
        shapes.append({k: v.shape for k, v in lay.arrays.items()})
        shapes.append(lay.meta)
    assert shapes[0] == shapes[2], "array shapes differ across batches"
    assert shapes[1] == shapes[3], "meta differs across batches"


def test_sharded_train_step_grad_parity(rng):
    """value_and_grad THROUGH the shard_map (reverse all-to-all) matches
    single-device training gradients; one optimizer step agrees."""
    import optax
    from ggnn.parallel import make_sharded_train_step
    from ggnn.parallel.partition import split_local_remote

    spec, b = make_random_batch(rng, n_graphs=6, n_mult=8)
    parts = split_local_remote(partition_batch(b, 8))
    cfg = ModelConfig(state_dim=8, annotation_dim=spec.annotation_dim,
                      n_edge_types=spec.n_edge_types, n_steps=3)
    params = init_params(jax.random.PRNGKey(0), cfg)
    prop = params["prop"]
    optimizer = optax.adam(1e-2)
    opt0 = optimizer.init(prop)
    mesh = make_mesh(8)

    step = make_sharded_train_step(cfg, mesh, optimizer,
                                   strategy="halo_overlap")
    new_prop, _, loss_sh = step(prop, opt0, parts)

    import jax.numpy as jnp

    def loss_single(p):
        h = propagate(p, cfg, jnp.asarray(b.annotations),
                      jnp.asarray(b.edge_src), jnp.asarray(b.edge_dst),
                      jnp.asarray(b.edge_type), jnp.asarray(b.edge_mask))
        return jnp.sum(h * h)

    loss_ref, g_ref = jax.value_and_grad(loss_single)(prop)
    np.testing.assert_allclose(float(loss_sh), float(loss_ref),
                               rtol=1e-5)
    upd_ref, _ = optimizer.update(g_ref, optimizer.init(prop), prop)
    ref_prop = optax.apply_updates(prop, upd_ref)
    jax.tree.map(lambda a, c: np.testing.assert_allclose(
        np.asarray(a), np.asarray(c), rtol=5e-4, atol=5e-5),
        new_prop, ref_prop)


@pytest.mark.parametrize("strategy,row_major,window", [
    ("halo_onehot", None, None),
    ("halo_window", "src", 64),
    ("halo_window", "block", 128),
])
def test_sharded_train_step_kernel_backends(rng, strategy, row_major, window):
    """TRAINING through the layout strategies: value_and_grad through the
    shard_map with the per-shard onehot / windowed aggregations running on
    stacked layouts — loss and one optimizer step match the single-device
    path."""
    import optax

    from ggnn.data.synthetic import synthetic_batch
    from ggnn.parallel import make_sharded_train_step
    from ggnn.parallel.partition import (build_halo_scatter_layouts,
                                             build_halo_window_layouts,
                                             split_local_remote)

    b = synthetic_batch(1024, 6000, 3, annotation_dim=2, seed=7,
                        node_mult=1024, n_communities=8, p_intra=0.7)
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                      n_steps=3)
    params = init_params(jax.random.PRNGKey(2), cfg)
    prop = params["prop"]
    parts = split_local_remote(partition_batch(b, 8))
    if strategy == "halo_onehot":
        arrays, meta = build_halo_scatter_layouts(parts, tile_e=16)
    else:
        arrays, meta = build_halo_window_layouts(
            parts, window=window, min_edges_per_tile=4, spill_tile_e=16,
            n_message_types=cfg.n_message_types, row_major=row_major)

    optimizer = optax.adam(1e-2)
    opt0 = optimizer.init(prop)
    mesh = make_mesh(8)
    step = make_sharded_train_step(cfg, mesh, optimizer, strategy=strategy,
                                   halo_meta=meta)
    new_prop, _, loss_sh = step(prop, opt0, parts, arrays)

    import jax.numpy as jnp

    def loss_single(p):
        h = propagate(p, cfg, jnp.asarray(b.annotations),
                      jnp.asarray(b.edge_src), jnp.asarray(b.edge_dst),
                      jnp.asarray(b.edge_type), jnp.asarray(b.edge_mask))
        return jnp.sum(h * h)

    loss_ref, g_ref = jax.value_and_grad(loss_single)(prop)
    np.testing.assert_allclose(float(loss_sh), float(loss_ref), rtol=1e-5)
    upd_ref, _ = optimizer.update(g_ref, optimizer.init(prop), prop)
    ref_prop = optax.apply_updates(prop, upd_ref)
    jax.tree.map(lambda a, c: np.testing.assert_allclose(
        np.asarray(a), np.asarray(c), rtol=5e-4, atol=5e-5),
        new_prop, ref_prop)


@pytest.mark.parametrize("strategy", ["halo_overlap", "halo_window"])
def test_sharded_task_training_matches_single_device(rng, strategy):
    """END-TO-END sharded task training (real node-selection head + loss,
    cross-shard segment softmax): the 3-step loss curve and final params
    match the single-device train step."""
    import jax.numpy as jnp
    import optax

    from ggnn.parallel import make_sharded_task_train_step
    from ggnn.parallel.partition import (build_halo_window_layouts,
                                             split_local_remote)
    from ggnn.train.loop import make_train_step

    graphs, total = [], 0
    while total < 1024 - 40:
        n = int(rng.integers(20, 40))
        m = int(rng.integers(10, 3 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 3, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.4).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann,
                           targets={"node": np.asarray(
                               int(rng.integers(0, n)), np.int32)}))
        total += n
    spec = PaddingSpec(n_graphs=len(graphs), n_pad=1024,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
                       n_edge_types=3, annotation_dim=2).round_up()
    b = batch_graphs(graphs, spec)
    n_graphs = spec.n_graphs

    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                      n_steps=3, head="node_select")
    params = init_params(jax.random.PRNGKey(3), cfg)
    optimizer = optax.adam(1e-2)

    # single-device reference curve (make_train_step donates its params
    # buffers — keep a live copy for the sharded run)
    p2 = jax.tree.map(jnp.array, params)
    step1 = make_train_step(cfg, n_graphs, optimizer)
    p1, o1 = params, optimizer.init(params)
    ref_losses = []
    for _ in range(3):
        p1, o1, m = step1(p1, o1, jax.tree.map(jnp.asarray, b.arrays))
        ref_losses.append(float(m["loss_sum"]) / float(m["count"]))

    # sharded curve (8 shards; graphs SPAN shard boundaries)
    mesh = make_mesh(8)
    parts = split_local_remote(partition_batch(b, 8))
    halo_arrays = halo_meta = None
    if strategy == "halo_window":
        halo_arrays, halo_meta = build_halo_window_layouts(
            parts, window=64, min_edges_per_tile=4, spill_tile_e=16,
            n_message_types=cfg.n_message_types)
    step2 = make_sharded_task_train_step(cfg, mesh, optimizer, n_graphs,
                                         strategy=strategy,
                                         halo_meta=halo_meta)
    targets = {"node": jnp.asarray(b.arrays["targets"]["node"]),
               "n_nodes": jnp.asarray(b.arrays["n_nodes"])}
    o2 = optimizer.init(p2)
    for i in range(3):
        p2, o2, m2 = step2(p2, o2, parts, targets, halo_arrays)
        got = float(m2["loss_sum"]) / float(m2["count"])
        np.testing.assert_allclose(got, ref_losses[i], rtol=2e-4,
                                   err_msg=f"step {i}")
    # head.b2's ANALYTIC gradient is exactly zero (softmax shift
    # invariance) — Adam amplifies each implementation's roundoff noise
    # into lr-scale steps in arbitrary directions there; bound it by the
    # step budget and compare every other leaf tightly
    import jax.tree_util as jtu
    for (kp, a), (_, c) in zip(jtu.tree_leaves_with_path(p2),
                               jtu.tree_leaves_with_path(p1)):
        if "b2" in jtu.keystr(kp):
            assert np.max(np.abs(np.asarray(a) - np.asarray(c))) \
                < 3 * 1e-2 * 3  # 3 steps of lr=1e-2 Adam
            continue
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   rtol=2e-3, atol=2e-4,
                                   err_msg=jtu.keystr(kp))


def test_sharded_graph_gated_training_matches_single_device(rng):
    """Sharded graph_gated head: the σ·tanh gated pool psums across
    shards; 3-step loss curve matches the single-device train step."""
    import jax.numpy as jnp
    import optax

    from ggnn.parallel import make_sharded_task_train_step
    from ggnn.parallel.partition import split_local_remote
    from ggnn.train.loop import make_train_step

    graphs, total = [], 0
    while total < 256 - 24:
        n = int(rng.integers(10, 20))
        m = int(rng.integers(8, 3 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 3, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.4).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann,
                           targets={"cls": np.asarray(
                               int(rng.integers(0, 3)), np.int32)}))
        total += n
    spec = PaddingSpec(n_graphs=len(graphs), n_pad=256,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
                       n_edge_types=3, annotation_dim=2).round_up()
    b = batch_graphs(graphs, spec)
    n_graphs = spec.n_graphs
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                      n_steps=3, head="graph_gated", n_classes=3)
    params = init_params(jax.random.PRNGKey(4), cfg)
    optimizer = optax.adam(1e-2)

    p2 = jax.tree.map(jnp.array, params)
    step1 = make_train_step(cfg, n_graphs, optimizer)
    p1, o1 = params, optimizer.init(params)
    ref_losses = []
    for _ in range(3):
        p1, o1, m = step1(p1, o1, jax.tree.map(jnp.asarray, b.arrays))
        ref_losses.append(float(m["loss_sum"]) / float(m["count"]))

    mesh = make_mesh(8)
    parts = split_local_remote(partition_batch(b, 8))
    step2 = make_sharded_task_train_step(cfg, mesh, optimizer, n_graphs,
                                         strategy="halo_overlap")
    targets = {"cls": jnp.asarray(b.arrays["targets"]["cls"]),
               "n_nodes": jnp.asarray(b.arrays["n_nodes"])}
    o2 = optimizer.init(p2)
    for i in range(3):
        p2, o2, m2 = step2(p2, o2, parts, targets)
        got = float(m2["loss_sum"]) / float(m2["count"])
        np.testing.assert_allclose(got, ref_losses[i], rtol=2e-4,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("typed_spill", [False, True])
def test_sharded_train_fused_window_step(rng, typed_spill):
    """halo_window sharded TRAINING through the fused window+GRU step
    (cfg.fuse_gru=True, with the remote-edge partial added to a before
    the GRU) — loss and one optimizer step match single-device training
    (1024 nodes / 8 shards, D=128).  typed_spill additionally pins the
    XW spill's type buckets across shards (the offsets are static
    meta)."""
    import optax

    from ggnn.data.synthetic import synthetic_batch
    from ggnn.parallel import make_sharded_train_step
    from ggnn.parallel.partition import (build_halo_window_layouts,
                                             split_local_remote)

    b = synthetic_batch(1024, 6000, 3, annotation_dim=2, seed=7,
                        node_mult=1024, n_communities=8, p_intra=0.7)
    cfg = ModelConfig(state_dim=128, annotation_dim=2, n_edge_types=3,
                      n_steps=3, backend="window", fuse_gru=True)
    # reference runs the plain XLA path with the SAME params
    cfg_ref = ModelConfig(state_dim=128, annotation_dim=2, n_edge_types=3,
                          n_steps=3)
    params = init_params(jax.random.PRNGKey(2), cfg)
    prop = params["prop"]
    parts = split_local_remote(partition_batch(b, 8))
    arrays, meta = build_halo_window_layouts(
        parts, window=128, min_edges_per_tile=4,
        spill_tile_e=(None if typed_spill else 16),
        n_message_types=cfg.n_message_types,
        row_major="block", typed_spill=typed_spill)

    optimizer = optax.adam(1e-2)
    opt0 = optimizer.init(prop)
    mesh = make_mesh(8)
    step = make_sharded_train_step(cfg, mesh, optimizer,
                                   strategy="halo_window", halo_meta=meta)
    new_prop, _, loss_sh = step(prop, opt0, parts, arrays)

    import jax.numpy as jnp

    def loss_single(p):
        h = propagate(p, cfg_ref, jnp.asarray(b.annotations),
                      jnp.asarray(b.edge_src), jnp.asarray(b.edge_dst),
                      jnp.asarray(b.edge_type), jnp.asarray(b.edge_mask))
        return jnp.sum(h * h)

    loss_ref, g_ref = jax.value_and_grad(loss_single)(prop)
    np.testing.assert_allclose(float(loss_sh), float(loss_ref), rtol=1e-5)
    upd_ref, _ = optimizer.update(g_ref, optimizer.init(prop), prop)
    ref_prop = optax.apply_updates(prop, upd_ref)
    jax.tree.map(lambda a, c: np.testing.assert_allclose(
        np.asarray(a), np.asarray(c), rtol=5e-4, atol=5e-5),
        new_prop, ref_prop)


def test_sharded_halo_window_q8_serving(rng):
    """quantized_table through the SHARDED fused halo_window step: each
    shard quantizes its own table windows (int8, power-of-2 per-window
    scales); cross-shard remote edges stay bf16.  The sharded q8 result
    must track the exact bf16 sharded path within the quantization
    error bound (~0.5 % relative per step)."""
    from ggnn.data.synthetic import synthetic_batch
    from ggnn.parallel.partition import (build_halo_window_layouts,
                                             split_local_remote)
    b = synthetic_batch(1024, 6000, 3, annotation_dim=2, seed=11,
                        node_mult=1024, n_communities=8, p_intra=0.9)
    mk = dict(state_dim=128, annotation_dim=2, n_edge_types=3, n_steps=3,
              backend="window", fuse_gru=True)
    cfg_q = ModelConfig(**mk, quantized_table=True)
    cfg_f = ModelConfig(**mk)
    params = init_params(jax.random.PRNGKey(2), cfg_q)
    parts = split_local_remote(partition_batch(b, 8))
    arrays, meta = build_halo_window_layouts(
        parts, window=128, min_edges_per_tile=4, spill_tile_e=16,
        n_message_types=cfg_q.n_message_types, row_major="block",
        typed_spill=True)
    mesh = make_mesh(8)
    ref = np.asarray(sharded_propagate(
        params["prop"], cfg_f, mesh, parts, strategy="halo_window",
        halo_layouts=(arrays, meta)))
    got = np.asarray(sharded_propagate(
        params["prop"], cfg_q, mesh, parts, strategy="halo_window",
        halo_layouts=(arrays, meta)))
    assert not np.array_equal(got, ref)  # actually quantized
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < 0.05, err


def test_sharded_per_node_training_matches_single_device(rng):
    """Sharded per_node head (C7b): per-shard logits/NLL with psum'd
    normalizing sums; 3-step loss curve and metrics match the
    single-device train step."""
    import jax.numpy as jnp
    import optax

    from ggnn.parallel import make_sharded_task_train_step
    from ggnn.parallel.partition import split_local_remote
    from ggnn.train.loop import make_train_step

    graphs, total = [], 0
    while total < 256 - 24:
        n = int(rng.integers(10, 20))
        m = int(rng.integers(8, 3 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 3, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.4).astype(np.float32)
        labels = rng.integers(-1, 3, n).astype(np.int32)  # −1 = unlabeled
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann,
                           targets={},
                           node_targets={"node_labels": labels}))
        total += n
    spec = PaddingSpec(n_graphs=len(graphs), n_pad=256,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
                       n_edge_types=3, annotation_dim=2).round_up()
    b = batch_graphs(graphs, spec)
    n_graphs = spec.n_graphs
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                      n_steps=3, head="per_node", n_classes=3)
    params = init_params(jax.random.PRNGKey(5), cfg)
    optimizer = optax.adam(1e-2)

    p2 = jax.tree.map(jnp.array, params)
    step1 = make_train_step(cfg, n_graphs, optimizer)
    p1, o1 = params, optimizer.init(params)
    ref = []
    for _ in range(3):
        p1, o1, m = step1(p1, o1, jax.tree.map(jnp.asarray, b.arrays))
        ref.append((float(m["loss_sum"]) / float(m["count"]),
                    float(m["correct"]), float(m["count"])))

    mesh = make_mesh(8)
    parts = split_local_remote(partition_batch(b, 8))
    step2 = make_sharded_task_train_step(cfg, mesh, optimizer, n_graphs,
                                         strategy="halo_overlap")
    targets = {"node_labels": jnp.asarray(b.arrays["targets"]["node_labels"]),
               "n_nodes": jnp.asarray(b.arrays["n_nodes"])}
    o2 = optimizer.init(p2)
    for i in range(3):
        p2, o2, m2 = step2(p2, o2, parts, targets)
        got = float(m2["loss_sum"]) / float(m2["count"])
        np.testing.assert_allclose(got, ref[i][0], rtol=2e-4,
                                   err_msg=f"step {i}")
        assert float(m2["correct"]) == ref[i][1], f"step {i}"
        assert float(m2["count"]) == ref[i][2], f"step {i}"


@pytest.mark.parametrize("output,supervised", [("graph", False),
                                               ("node", True)])
def test_sharded_ggsnn_training_matches_single_device(rng, output,
                                                      supervised):
    """Sharded GGS-NN (C7d): the annotation-rewrite round scan inside
    shard_map — per round re-propagate from X^{(k)}, cross-shard output
    (psum'd gated pool token logits, or segment-softmax node selection),
    local annotation rewrite (+ GGS-NN-opt BCE when supervised).  3-step
    loss curve and exact-match metrics equal the single-device train step
   ."""
    import jax.numpy as jnp
    import optax

    from ggnn.parallel import make_sharded_task_train_step
    from ggnn.parallel.partition import split_local_remote
    from ggnn.train.loop import make_train_step

    K = 3
    graphs, total = [], 0
    while total < 256 - 24:
        n = int(rng.integers(10, 20))
        m = int(rng.integers(8, 3 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 3, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.4).astype(np.float32)
        klen = int(rng.integers(1, K + 1))   # variable-length sequences
        seq = np.full(K, -1, np.int32)
        seq[:klen] = rng.integers(0, 5, klen)
        seq_nodes = np.full(K, -1, np.int32)
        seq_nodes[:klen] = rng.integers(0, n, klen)
        g = dict(n_nodes=n, edges=edges, annotations=ann,
                 targets={"seq": seq, "seq_nodes": seq_nodes})
        if supervised:
            g["node_targets"] = {"ann_seq": (rng.random((n, K, 2)) < 0.5)
                                 .astype(np.float32)}
        graphs.append(g)
        total += n
    spec = PaddingSpec(n_graphs=len(graphs), n_pad=256,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
                       n_edge_types=3, annotation_dim=2).round_up()
    b = batch_graphs(graphs, spec)
    n_graphs = spec.n_graphs
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                      n_steps=2, head="ggsnn", n_classes=5, n_rounds=K,
                      ggsnn_output=output, ann_supervision=supervised)
    params = init_params(jax.random.PRNGKey(6), cfg)
    optimizer = optax.adam(1e-2)

    p2 = jax.tree.map(jnp.array, params)
    step1 = make_train_step(cfg, n_graphs, optimizer)
    p1, o1 = params, optimizer.init(params)
    ref = []
    for _ in range(3):
        p1, o1, m = step1(p1, o1, jax.tree.map(jnp.asarray, b.arrays))
        ref.append((float(m["loss_sum"]) / float(m["count"]),
                    float(m["correct"]), float(m["count"])))

    mesh = make_mesh(8)
    parts = split_local_remote(partition_batch(b, 8))
    step2 = make_sharded_task_train_step(cfg, mesh, optimizer, n_graphs,
                                         strategy="halo_overlap")
    tkey = "seq_nodes" if output == "node" else "seq"
    targets = {tkey: jnp.asarray(b.arrays["targets"][tkey]),
               "n_nodes": jnp.asarray(b.arrays["n_nodes"])}
    if supervised:
        targets["ann_seq"] = jnp.asarray(b.arrays["targets"]["ann_seq"])
    o2 = optimizer.init(p2)
    for i in range(3):
        p2, o2, m2 = step2(p2, o2, parts, targets)
        got = float(m2["loss_sum"]) / float(m2["count"])
        np.testing.assert_allclose(got, ref[i][0], rtol=3e-4,
                                   err_msg=f"step {i}")
        assert float(m2["correct"]) == ref[i][1], f"step {i}"
        assert float(m2["count"]) == ref[i][2], f"step {i}"


def test_sharded_ggsnn_per_round_nets(rng):
    """share_round_nets=False: the per-round F_o/F_x stacks ride the round
    scan's xs inside the shard_map; one sharded step matches the
    single-device step."""
    import jax.numpy as jnp
    import optax

    from ggnn.parallel import make_sharded_task_train_step
    from ggnn.parallel.partition import split_local_remote
    from ggnn.train.loop import make_train_step

    K = 2
    graphs, total = [], 0
    while total < 128 - 20:
        n = int(rng.integers(8, 16))
        m = int(rng.integers(6, 2 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 2, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.4).astype(np.float32)
        seq = rng.integers(0, 4, K).astype(np.int32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann,
                           targets={"seq": seq}))
        total += n
    spec = PaddingSpec(n_graphs=len(graphs), n_pad=128,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
                       n_edge_types=2, annotation_dim=2).round_up()
    b = batch_graphs(graphs, spec)
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=2,
                      n_steps=2, head="ggsnn", n_classes=4, n_rounds=K,
                      share_round_nets=False)
    params = init_params(jax.random.PRNGKey(7), cfg)
    optimizer = optax.adam(1e-2)

    p2 = jax.tree.map(jnp.array, params)
    step1 = make_train_step(cfg, spec.n_graphs, optimizer)
    p1, o1 = params, optimizer.init(params)
    p1, o1, m1 = step1(p1, o1, jax.tree.map(jnp.asarray, b.arrays))

    mesh = make_mesh(8)
    parts = split_local_remote(partition_batch(b, 8))
    step2 = make_sharded_task_train_step(cfg, mesh, optimizer, spec.n_graphs,
                                         strategy="halo_overlap")
    targets = {"seq": jnp.asarray(b.arrays["targets"]["seq"]),
               "n_nodes": jnp.asarray(b.arrays["n_nodes"])}
    p2, o2, m2 = step2(p2, optimizer.init(p2), parts, targets)
    np.testing.assert_allclose(
        float(m2["loss_sum"]) / float(m2["count"]),
        float(m1["loss_sum"]) / float(m1["count"]), rtol=3e-4)


def test_sharded_eval_step_matches_single_device(rng):
    """make_sharded_eval_step: forward-only cross-shard metrics equal the
    single-device eval step (node_select and ggsnn heads)."""
    import jax.numpy as jnp

    from ggnn.parallel import make_sharded_eval_step
    from ggnn.parallel.partition import split_local_remote
    from ggnn.train.loop import make_eval_step

    K = 2
    graphs, total = [], 0
    while total < 128 - 20:
        n = int(rng.integers(8, 16))
        m = int(rng.integers(6, 2 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 2, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.4).astype(np.float32)
        graphs.append(dict(
            n_nodes=n, edges=edges, annotations=ann,
            targets={"node": np.asarray(int(rng.integers(0, n)), np.int32),
                     "seq": rng.integers(0, 4, K).astype(np.int32)}))
        total += n
    spec = PaddingSpec(n_graphs=len(graphs), n_pad=128,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
                       n_edge_types=2, annotation_dim=2).round_up()
    b = batch_graphs(graphs, spec)
    mesh = make_mesh(8)
    parts = split_local_remote(partition_batch(b, 8))

    for head, tkey in [("node_select", "node"), ("ggsnn", "seq")]:
        cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=2,
                          n_steps=2, head=head, n_classes=4,
                          n_rounds=K if head == "ggsnn" else 1)
        params = init_params(jax.random.PRNGKey(8), cfg)
        m1 = make_eval_step(cfg, spec.n_graphs)(
            params, jax.tree.map(jnp.asarray, b.arrays))
        step = make_sharded_eval_step(cfg, mesh, spec.n_graphs,
                                      strategy="halo_overlap")
        targets = {tkey: jnp.asarray(b.arrays["targets"][tkey]),
                   "n_nodes": jnp.asarray(b.arrays["n_nodes"])}
        m2 = step(params, parts, targets)
        for k in ("loss_sum", "correct", "count"):
            np.testing.assert_allclose(float(m2[k]), float(m1[k]),
                                       rtol=3e-4, err_msg=f"{head}:{k}")


def test_sharded_grad_quant_training(rng):
    """Sharded halo_window TRAINING with int8 GRADIENT streams
    (build_halo_window_layouts(grad_quant=True) — the int8 backward of
    the count product per shard inside shard_map): one optimizer step
    tracks the single-device exact-gradient path within the q8-grad
    budget."""
    import optax

    from ggnn.data.synthetic import synthetic_batch
    from ggnn.parallel import make_sharded_train_step
    from ggnn.parallel.partition import (build_halo_window_layouts,
                                             split_local_remote)

    b = synthetic_batch(1024, 6000, 3, annotation_dim=2, seed=7,
                        node_mult=1024, n_communities=8, p_intra=0.7)
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                      n_steps=3, compute_dtype="bfloat16")
    params = init_params(jax.random.PRNGKey(2), cfg)
    prop = params["prop"]
    parts = split_local_remote(partition_batch(b, 8))
    arrays, meta = build_halo_window_layouts(
        parts, window=128, min_edges_per_tile=4, spill_tile_e=16,
        n_message_types=cfg.n_message_types,
        row_major="block", grad_quant=True)
    assert meta["full_meta"][7] is True        # grad_quant engaged

    optimizer = optax.adam(1e-2)
    mesh = make_mesh(8)
    step = make_sharded_train_step(cfg, mesh, optimizer,
                                   strategy="halo_window", halo_meta=meta)
    new_prop, _, loss_sh = step(prop, optimizer.init(prop), parts, arrays)

    import jax.numpy as jnp

    def loss_single(p):
        h = propagate(p, cfg, jnp.asarray(b.annotations),
                      jnp.asarray(b.edge_src), jnp.asarray(b.edge_dst),
                      jnp.asarray(b.edge_type), jnp.asarray(b.edge_mask))
        return jnp.sum(h * h)

    loss_ref, g_ref = jax.value_and_grad(loss_single)(prop)
    # primal: quant touches gradients only, but sharded-vs-single bf16
    # rounding differs (~0.1% — the window path reorders accumulation)
    np.testing.assert_allclose(float(loss_sh), float(loss_ref), rtol=5e-3)
    upd_ref, _ = optimizer.update(g_ref, optimizer.init(prop), prop)
    ref_prop = optax.apply_updates(prop, upd_ref)
    for a_, c_ in zip(jax.tree.leaves(new_prop), jax.tree.leaves(ref_prop)):
        a_, c_ = np.asarray(a_, np.float64), np.asarray(c_, np.float64)
        rel = np.linalg.norm(a_ - c_) / (np.linalg.norm(c_) + 1e-12)
        assert rel < 0.05, rel
