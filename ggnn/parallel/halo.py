"""Sharded propagation over the 'graph' mesh axis (SURVEY.md §5.7-5.8).

Five strategies, all XLA collectives inside ``shard_map`` (NCCL over the
devices' interconnect — on a four-H100 host every pair of cards is one
NVLink hop apart, so the all-to-all has no neighbour structure to
exploit; no custom transport, SURVEY.md §5.8); halo states travel in the
compute dtype (bf16 halves the exchange bytes):

- ``all_gather`` — every shard gathers the full node-state array each step
  and aggregates its local (dst-owned) edges.  Simple; bandwidth O(N·D)
  per step.  Near-optimal when average degree ≳ shard count (uniform
  random graphs — every remote node is halo anyway).
- ``halo`` — targeted all-to-all using the precomputed
  ``halo_send_idx[owner, requester, H]`` plan from
  :func:`~ggnn.parallel.partition.partition_batch`.  Bandwidth
  O(P·H·D) with H = max deduplicated request size; the win for
  partitioned/clustered graphs.  Local (diagonal) contributions flow
  through the same uniform gather, and XLA's latency-hiding scheduler can
  overlap the all-to-all with the type-transform matmuls because they are
  dataflow-independent.
- ``halo_onehot`` — the halo plan plus per-shard destination-block
  layouts (``n_local % 128 == 0``), aggregated by
  :func:`ggnn.ops.onehot.aggregate_onehot`.
- ``halo_window`` — the halo_overlap local/remote split with the
  intra-shard edges aggregated by the block-CSR windowed path
  (ops/window.py): community-partitioned shards do their local work
  with NO per-edge random access, and the all-to-all overlaps it.

The T-step recurrence stays a single ``lax.scan`` inside one ``shard_map``
— node states never leave their shard; only halo states move.  Training
runs ``value_and_grad`` straight through the shard_map: XLA transposes
the collectives (the all-to-all's backward is the reverse all-to-all over
the same static plan), and the layout strategies differentiate
per-shard through their stacked layouts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ggnn.models.config import ModelConfig
from ggnn.models.ggnn import fuse_gru, gru_update, init_state
from ggnn.ops.segment import typed_aggregate
from ggnn.parallel.partition import PartitionedBatch

STRATEGIES = ("halo", "all_gather", "halo_onehot", "halo_overlap",
              "halo_window")


def _resolve_layouts(strategy, parts, cfg, halo_layouts, scatter_tile_e):
    """Returns (lay_arrays, lay_meta); builds host-side when missing."""
    lay_arrays, lay_meta = halo_layouts if halo_layouts else (None, None)
    if lay_arrays is not None or strategy not in ("halo_onehot",
                                                  "halo_window"):
        return lay_arrays, lay_meta
    # host-side build — only possible outside jit; under jit, precompute
    # with build_halo_scatter_layouts / build_halo_window_layouts and pass
    # both the parts pytree and halo_layouts through the jitted function's
    # arguments
    if isinstance(parts.edge_src_global, jax.core.Tracer):
        raise ValueError(
            f"{strategy} under jit needs precomputed halo_layouts passed "
            "through the jitted function's arguments")
    if strategy == "halo_onehot":
        from ggnn.parallel.partition import build_halo_scatter_layouts
        return build_halo_scatter_layouts(parts, tile_e=scatter_tile_e)
    from ggnn.parallel.partition import build_halo_window_layouts
    # the model's message-type count, NOT the max observed type: the
    # table stride is msg_w.shape[0] — inferring from the batch silently
    # mis-addresses every window row when the top type is absent
    return build_halo_window_layouts(
        parts, n_message_types=cfg.n_message_types)


def sharded_propagate(prop: dict, cfg: ModelConfig, mesh,
                      parts: PartitionedBatch, strategy: str = "halo",
                      axis_name: str = "graph", scatter_tile_e: int = 512,
                      halo_layouts=None,
                      node_fn=None, node_fn_args=(), body_fn=None):
    """Run T sharded propagation steps; returns h sharded as [n_pad, D].

    ``parts`` arrays cross into shard_map with their leading [P] axis
    mapped onto the mesh's graph axis.  Strategies:

    - ``all_gather`` / ``halo``: XLA typed aggregation per shard.
    - ``halo_onehot``: halo all-to-all + per-shard destination-block
      layouts (ops/onehot.py); needs ``n_local % 128 == 0``.
    - ``halo_window``: block-CSR windowed local aggregation + typed halo
      remote aggregation.

    ``node_fn(h_local, ann_local, node_graph_local, node_mask_local,
    node_fn_args, axis_name) -> pytree`` optionally post-processes the
    final per-shard states INSIDE the shard_map (e.g. a readout head with
    cross-shard collectives — see :func:`sharded_node_select_loss`); its
    output replaces h (every leaf gains a leading per-shard axis).
    ``node_fn_args`` is an arbitrary replicated pytree (head params,
    targets).

    ``body_fn(run_steps, ann_local, node_graph_local, node_mask_local,
    node_fn_args, axis_name) -> pytree`` replaces the whole per-shard
    model body instead: ``run_steps(h0_local) -> h_final_local`` runs the
    T-step strategy recurrence from an arbitrary initial state and may be
    called repeatedly — the hook the sharded GGS-NN round scan uses
    (re-propagate from the rewritten annotations each round,
    :func:`sharded_ggsnn_losses`).  Mutually exclusive with node_fn."""
    if body_fn is not None and node_fn is not None:
        raise ValueError("pass node_fn or body_fn, not both")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy in ("halo_overlap", "halo_window") \
            and parts.local_edges is None:
        if isinstance(parts.edge_src_global, jax.core.Tracer):
            raise ValueError(
                "halo_overlap under jit needs split_local_remote(parts) "
                "called on the host before the jitted function")
        from ggnn.parallel.partition import split_local_remote
        parts = split_local_remote(parts)

    n_local = parts.n_local
    H = parts.halo_size
    Hh = parts.hot_size

    lay_arrays, lay_meta = _resolve_layouts(strategy, parts, cfg,
                                            halo_layouts, scatter_tile_e)

    def body(prop, ann, ngraph, nmask, src_g, src_h, dst_l, etype, emask,
             send_idx, hot_ids, loc, rem, karr, nfa):
        # shapes inside: ann [1, n_local, A], edges [1, E_l],
        # send_idx [1, P, H] (this shard's owner-row of the send plan),
        # hot_ids [1, Hh] (this shard's hot local rows — all_gathered)
        ann = ann[0]
        ngraph, nmask = ngraph[0], nmask[0]
        src_g, src_h = src_g[0], src_h[0]
        dst_l, etype, emask = dst_l[0], etype[0], emask[0]
        send_idx = send_idx[0]
        hot_ids = hot_ids[0]
        fused = fuse_gru(prop["gru"])
        h0 = init_state(ann, cfg.state_dim)
        cdt = jnp.dtype(cfg.compute_dtype)
        karr_l = {k: v[0] for k, v in karr.items()}

        def exchange(h_local):
            # halo states travel in the compute dtype (bf16 halves the
            # exchange bytes); accumulation stays f32 downstream.  Self-edges are NOT
            # exchanged: the pool is [hot ∥ recv ∥ h_local] and their halo
            # coords index past P·Hh + P·H (keeps clustered-graph exchanges
            # proportional to the true cross-shard traffic).  The HOT
            # segment (rows many shards request — hot_thresh partitioning)
            # rides ONE all_gather instead of padding every all-to-all
            # pair to the worst request (the skewed-graph fix).
            segs = []
            if Hh > 0:
                mine = h_local.astype(cdt)[hot_ids]           # [Hh, D]
                segs.append(jax.lax.all_gather(
                    mine, axis_name, tiled=True))             # [P·Hh, D]
            send = h_local.astype(cdt)[send_idx.reshape(-1)].reshape(
                send_idx.shape[0], H, -1)                     # [P, H, D]
            recv = jax.lax.all_to_all(
                send, axis_name, split_axis=0, concat_axis=0,
                tiled=False)                                  # [P, H, D]
            segs += [recv.reshape(-1, h_local.shape[-1]),
                     h_local.astype(cdt)]
            return jnp.concatenate(segs, axis=0)  # [P·Hh+P·H+n_local, D]

        def step(h_local, _):
            if strategy == "all_gather":
                h_src_pool = jax.lax.all_gather(
                    h_local.astype(cdt), axis_name, tiled=True)  # [N, D]
                src_idx = src_g
            else:
                h_src_pool = exchange(h_local)
                src_idx = src_h
            if strategy == "halo_window":
                # intra-shard edges through the block-CSR windowed path
                # (no per-edge random access; reads h_local only, so the
                # all-to-all overlaps it); remote edges via the halo pool
                from ggnn.ops.window import (DeviceWindowLayout,
                                                        aggregate_window,
                                                        gru_window_step)
                wlay = DeviceWindowLayout(
                    meta=lay_meta["full_meta"], arrays=karr_l)
                a_rem = typed_aggregate(
                    h_src_pool, rem["src"][0], rem["dst"][0], rem["type"][0],
                    rem["mask"][0], prop["msg_w"], prop["msg_b"],
                    strategy=cfg.agg_strategy)[:n_local]
                if cfg.fuse_gru:
                    # window+GRU step per shard; the remote-edge partial
                    # is added to a before the GRU.  quantized_table
                    # composes: each shard quantizes its own table
                    # windows (serving only — cross-shard remote edges
                    # stay bf16 through typed_aggregate)
                    h_new = gru_window_step(
                        h_local, wlay, prop["msg_w"].astype(cdt),
                        prop["msg_b"].astype(cdt), prop["gru"],
                        extra_init=a_rem,
                        quantized=cfg.quantized_table)
                    return h_new, None
                a_loc = aggregate_window(
                    h_local.astype(cdt), wlay, prop["msg_w"].astype(cdt),
                    prop["msg_b"].astype(cdt))
                a = a_loc[:n_local] + a_rem
            elif strategy == "halo_overlap":
                # SURVEY.md §5.7: local-edge aggregation reads h_local only
                # — no dependency on the all-to-all, so XLA overlaps them
                a_loc = typed_aggregate(
                    h_local.astype(cdt), loc["src"][0], loc["dst"][0],
                    loc["type"][0], loc["mask"][0], prop["msg_w"],
                    prop["msg_b"], strategy=cfg.agg_strategy)[:n_local]
                a_rem = typed_aggregate(
                    h_src_pool, rem["src"][0], rem["dst"][0], rem["type"][0],
                    rem["mask"][0], prop["msg_w"], prop["msg_b"],
                    strategy=cfg.agg_strategy)[:n_local]
                a = a_loc + a_rem
            elif strategy == "halo_onehot":
                # all edges (local via self-coordinates past P·H) through
                # the destination-block layout
                from ggnn.ops.onehot import (DeviceScatterLayout,
                                                         aggregate_onehot)
                slay = DeviceScatterLayout(
                    meta=lay_meta["scatter_meta"], arrays=karr_l)
                a = aggregate_onehot(
                    h_src_pool, slay, prop["msg_w"].astype(cdt),
                    prop["msg_b"].astype(cdt))[:n_local]
            else:
                a = typed_aggregate(
                    h_src_pool, src_idx, dst_l, etype, emask,
                    prop["msg_w"], prop["msg_b"],
                    strategy=cfg.agg_strategy)[:n_local]
            h_new = gru_update(prop["gru"], h_local, a, fused)
            return h_new, None

        def run_steps(h_init):
            h_final, _ = jax.lax.scan(step, h_init, None,
                                      length=cfg.n_steps)
            return h_final

        if body_fn is not None:
            out = body_fn(run_steps, ann, ngraph, nmask, nfa, axis_name)
            return jax.tree.map(lambda x: x[None], out)
        h_final = run_steps(h0)
        if node_fn is not None:
            out = node_fn(h_final, ann, ngraph, nmask, nfa, axis_name)
            return jax.tree.map(lambda x: x[None], out)
        return h_final[None]  # restore leading shard axis

    shard = jax.shard_map(
        functools.partial(body),
        mesh=mesh,
        in_specs=(P(),                     # prop params replicated
                  P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(axis_name),
                  P()),                    # node_fn_args replicated
        out_specs=P(axis_name),
        check_vma=False,
    )
    zdict = {"src": np.zeros((parts.n_shards, 1), np.int32),
             "dst": np.zeros((parts.n_shards, 1), np.int32),
             "type": np.zeros((parts.n_shards, 1), np.int32),
             "mask": np.zeros((parts.n_shards, 1), np.float32)}
    overlap = strategy in ("halo_overlap", "halo_window")
    loc = parts.local_edges if strategy == "halo_overlap" else zdict
    rem = parts.remote_edges if overlap else zdict
    karr = lay_arrays if strategy in ("halo_onehot", "halo_window") else {}
    hot = (parts.hot_idx if parts.hot_idx is not None
           else np.zeros((parts.n_shards, 0), np.int32))
    out = shard(prop, parts.annotations, parts.node_graph, parts.node_mask,
                parts.edge_src_global, parts.edge_src_halo,
                parts.edge_dst_local, parts.edge_type, parts.edge_mask,
                parts.halo_send_idx, hot, loc, rem, karr, node_fn_args)
    if node_fn is not None or body_fn is not None:
        return out
    return out.reshape(-1, out.shape[-1])


def _check_trainable(cfg: ModelConfig) -> None:
    """The int8 serving table rounds its values, so its gradient is zero
    almost everywhere: training through it would silently learn nothing.
    Sharded training routes through exactly that code path when
    ``cfg.quantized_table`` is set, so fail loudly up front."""
    if cfg.quantized_table:
        raise ValueError(
            "quantized_table=True is a SERVING mode (forward-only int8 "
            "table) and cannot be differentiated; train with "
            "quantized_table=False, then serve the trained weights "
            "quantized (sharded q8 serving works — see "
            "tests/test_distributed.py)")


def make_sharded_train_step(cfg: ModelConfig, mesh, optimizer,
                            strategy: str = "halo_overlap",
                            axis_name: str = "graph", loss_fn=None,
                            halo_meta=None):
    """Jitted SHARDED train step: value_and_grad straight through the
    ``shard_map`` (XLA transposes the collectives — the all-to-all's
    backward is the reverse all-to-all over the same static plan, so the
    exchange schedule of SURVEY.md §5.7 holds for gradients too), then a
    replicated optax update.

    All five strategies are differentiable.  The layout strategies
    (``halo_onehot`` / ``halo_window``) need their stacked per-shard
    layouts (:func:`~ggnn.parallel.partition.build_halo_scatter_layouts`
    / :func:`~ggnn.parallel.partition.build_halo_window_layouts`): pass
    the static ``meta`` here and the array dict to each step call (arrays
    flow through jit ARGUMENTS, not as baked-in constants).

    ``loss_fn(h) -> scalar`` defaults to ``sum(h*h)`` (machinery/bench
    proxy); pass a real head loss for task training (see
    :func:`make_sharded_task_train_step` for the full-model variant).
    Grad parity vs the single-device path is pinned by
    tests/test_distributed.py."""
    import optax

    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    _check_trainable(cfg)
    if strategy in ("halo_onehot", "halo_window") and halo_meta is None:
        raise ValueError(
            f"strategy {strategy!r} needs halo_meta= from "
            "build_halo_scatter_layouts/build_halo_window_layouts; pass "
            "the arrays dict to each step call")
    if loss_fn is None:
        def loss_fn(h):
            return jnp.sum(h * h)

    @functools.partial(jax.jit, donate_argnums=(1,))
    def train_step(prop, opt_state, parts, halo_arrays=None):
        layouts = ((halo_arrays, halo_meta)
                   if halo_arrays is not None else None)

        def objective(p):
            h = sharded_propagate(p, cfg, mesh, parts, strategy=strategy,
                                  axis_name=axis_name, halo_layouts=layouts)
            return loss_fn(h)

        loss, grads = jax.value_and_grad(objective)(prop)
        updates, opt_state_new = optimizer.update(grads, opt_state, prop)
        return optax.apply_updates(prop, updates), opt_state_new, loss

    return train_step


def sharded_node_select_loss(head: dict, h, ann, node_graph, node_mask,
                             n_nodes, target_local, n_graphs: int,
                             axis_name: str):
    """Node-selection softmax-CE over PARTITIONED graphs, inside shard_map.

    The softmax normalizes over each graph's nodes, which may span shards:
    per-shard segment max/sum reduce across the mesh with ``pmax``/``psum``
    (n_graphs+1 scalars each — negligible traffic).  The target's score is
    read by its owning shard and psum'd.  Per-graph argmax (accuracy) uses
    the same two-level reduction.  Returns (loss, correct_sum, count) —
    identical replicated scalars on every shard.  Mirrors
    :func:`ggnn.models.heads.node_select_loss` exactly (pinned by
    tests/test_distributed.py)."""
    from ggnn.models import heads as H

    n_local = h.shape[0]
    base = jax.lax.axis_index(axis_name) * n_local
    scores = H.node_select_scores(head, h, ann)              # [n_local]
    neg = jnp.finfo(scores.dtype).min
    masked = jnp.where(node_mask > 0, scores, neg)
    seg = functools.partial(jax.ops.segment_sum, num_segments=n_graphs + 1)
    # stop_gradient BEFORE the collective: the max-shift cancels out of
    # the log-softmax exactly (standard stable formulation), and pmax has
    # no JAX differentiation rule — it must never see a tangent
    gmax = jax.lax.pmax(
        jax.ops.segment_max(jax.lax.stop_gradient(masked), node_graph,
                            num_segments=n_graphs + 1),
        axis_name)                                           # [G+1]
    # the exp argument must be finite even on padding rows (the padding
    # segment's gmax is finfo.min, and exp(+3e38)=inf in the untaken
    # where-branch poisons the backward with inf·0 = nan)
    shift = jnp.where(node_mask > 0, scores - gmax[node_graph], 0.0)
    ex = jnp.where(node_mask > 0, jnp.exp(shift), 0.0)
    sumexp = jax.lax.psum(seg(ex, node_graph), axis_name)    # [G+1]

    # target score: its owning shard contributes, others add zero
    offs = H.node_offsets(n_nodes)
    tgt_global = offs + target_local                         # [G]
    in_shard = (tgt_global >= base) & (tgt_global < base + n_local)
    tloc = jnp.clip(tgt_global - base, 0, n_local - 1)
    t_score = jax.lax.psum(
        jnp.where(in_shard, scores[tloc], 0.0), axis_name)   # [G]

    graph_mask = (n_nodes > 0).astype(scores.dtype)
    # padding graphs have sumexp 0 and gmax finfo.min — mask before the
    # log, not after (-inf·0 = nan)
    logp_t = jnp.where(graph_mask > 0,
                       t_score - gmax[:n_graphs]
                       - jnp.log(jnp.maximum(sumexp[:n_graphs], 1e-30)),
                       0.0)
    loss = jnp.sum(-logp_t * graph_mask) / jnp.maximum(
        jnp.sum(graph_mask), 1.0)

    # argmax accuracy: first global index achieving the per-graph max
    idx = base + jnp.arange(n_local, dtype=jnp.int32)
    big = jnp.asarray(np.iinfo(np.int32).max, jnp.int32)
    is_max = (masked == gmax[node_graph]) & (node_mask > 0)
    pred = jax.lax.pmin(
        jax.ops.segment_min(jnp.where(is_max, idx, big), node_graph,
                            num_segments=n_graphs + 1)[:n_graphs],
        axis_name)
    correct = (pred == tgt_global) & (n_nodes > 0)
    return (loss, jnp.sum(correct.astype(jnp.float32)),
            jnp.sum(graph_mask))


def sharded_graph_gated_loss(head: dict, h, ann, node_graph, node_mask,
                             n_nodes, target_cls, n_graphs: int,
                             axis_name: str):
    """Graph-level gated-readout classification over PARTITIONED graphs:
    the σ·tanh gated pool is a per-shard segment-sum psum'd across the
    mesh ([G, readout_dim] scalars); the classifier MLP and CE then run
    replicated.  Mirrors heads.graph_gated_logits + graph_class_loss."""
    from ggnn.models import heads as H

    hx = jnp.concatenate([h, ann], axis=1)
    gate = jax.nn.sigmoid(
        jnp.dot(hx, head["gi_w"], preferred_element_type=jnp.float32)
        + head["gi_b"])
    val = jnp.tanh(
        jnp.dot(hx, head["gj_w"], preferred_element_type=jnp.float32)
        + head["gj_b"])
    pooled = jax.lax.psum(
        jax.ops.segment_sum(gate * val * node_mask[:, None], node_graph,
                            num_segments=n_graphs + 1)[:n_graphs],
        axis_name)
    logits = H._mlp2(head, pooled, "c1", "c1b", "c2", "c2b")
    loss, correct, graph_mask = H.graph_class_loss(logits, target_cls,
                                                   n_nodes)
    return (loss, jnp.sum(correct.astype(jnp.float32)),
            jnp.sum(graph_mask))


def sharded_per_node_loss(head: dict, h, ann, node_mask, labels_full,
                          axis_name: str):
    """Per-node classification CE over PARTITIONED nodes (C7b sharded):
    logits and NLL are purely local per shard; only the three normalizing
    sums (nll, valid count, correct count) cross the mesh via ``psum``.
    ``labels_full`` is the replicated [n_pad] label vector (−1 =
    unlabeled/padding) — each shard slices its own n_local rows.  Mirrors
    :func:`ggnn.models.heads.per_node_loss` exactly."""
    from ggnn.models import heads as H

    n_local = h.shape[0]
    base = jax.lax.axis_index(axis_name) * n_local
    labels = jax.lax.dynamic_slice_in_dim(labels_full, base, n_local)
    logits = H.per_node_logits(head, h, ann)
    valid = (labels >= 0) & (node_mask > 0)
    safe = jnp.maximum(labels, 0)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, safe[:, None].astype(jnp.int32),
                               axis=1)[:, 0]
    nll_sum = jax.lax.psum(jnp.sum(jnp.where(valid, nll, 0.0)), axis_name)
    n_valid = jax.lax.psum(jnp.sum(valid.astype(jnp.float32)), axis_name)
    loss = nll_sum / jnp.maximum(n_valid, 1.0)
    correct = (jnp.argmax(logits, axis=-1) == labels) & valid
    correct_sum = jax.lax.psum(jnp.sum(correct.astype(jnp.float32)),
                               axis_name)
    return loss, correct_sum, n_valid


def _sharded_round_node_nll(head: dict, h, X, node_graph, node_mask,
                            tgt_global, valid, n_graphs: int,
                            axis_name: str):
    """One GGS-NN round's node-selection NLL + argmax over PARTITIONED
    graphs: the same stable cross-shard segment-softmax as
    :func:`sharded_node_select_loss`, with per-round validity (``valid`` =
    target exists this round).  Returns (nll [G] — zero where invalid,
    pred [G] global argmax ids)."""
    from ggnn.models import heads as H

    n_local = h.shape[0]
    base = jax.lax.axis_index(axis_name) * n_local
    scores = H.node_select_scores(head, h, X)
    neg = jnp.finfo(scores.dtype).min
    masked = jnp.where(node_mask > 0, scores, neg)
    seg = functools.partial(jax.ops.segment_sum, num_segments=n_graphs + 1)
    gmax = jax.lax.pmax(
        jax.ops.segment_max(jax.lax.stop_gradient(masked), node_graph,
                            num_segments=n_graphs + 1),
        axis_name)
    shift = jnp.where(node_mask > 0, scores - gmax[node_graph], 0.0)
    ex = jnp.where(node_mask > 0, jnp.exp(shift), 0.0)
    sumexp = jax.lax.psum(seg(ex, node_graph), axis_name)
    in_shard = (tgt_global >= base) & (tgt_global < base + n_local)
    tloc = jnp.clip(tgt_global - base, 0, n_local - 1)
    t_score = jax.lax.psum(
        jnp.where(in_shard, scores[tloc], 0.0), axis_name)
    logp_t = jnp.where(valid,
                       t_score - gmax[:n_graphs]
                       - jnp.log(jnp.maximum(sumexp[:n_graphs], 1e-30)),
                       0.0)
    idx = base + jnp.arange(n_local, dtype=jnp.int32)
    big = jnp.asarray(np.iinfo(np.int32).max, jnp.int32)
    is_max = (masked == gmax[node_graph]) & (node_mask > 0)
    pred = jax.lax.pmin(
        jax.ops.segment_min(jnp.where(is_max, idx, big), node_graph,
                            num_segments=n_graphs + 1)[:n_graphs],
        axis_name)
    return -logp_t, pred


def sharded_ggsnn_losses(cfg: ModelConfig, run_steps, ann, node_graph,
                         node_mask, nfa, n_graphs: int, axis_name: str):
    """Sharded GGS-NN (C7d, SURVEY.md §3.4): the annotation-rewrite round
    scan runs INSIDE the shard_map — per round k: re-propagate T steps
    from h = pad(X^{(k)}, D) via ``run_steps``, emit the round output
    (``cfg.ggsnn_output='node'``: cross-shard segment-softmax node
    selection; ``'graph'``: psum'd gated pool → replicated token
    classifier), rewrite X^{(k+1)} = σ(F_x([h ; X^{(k)}])) locally.  Node
    states and annotations never leave their shard; per round the only
    collectives are the softmax/pool reductions (O(G) / O(G·V) scalars)
    plus whatever the propagation strategy exchanges.

    ``nfa`` (replicated): ``out`` / ``ann_net`` round params (leading-K
    stacked when ``cfg.share_round_nets=False``), ``n_nodes`` [G], the
    targets (``seq`` [G, K] token ids or ``seq_nodes`` [G, K] local node
    ids, −1 past each sequence's end), and optionally ``ann_seq``
    [n_pad, K, A] for GGS-NN-opt annotation supervision (each shard
    slices its rows).  Returns ``stack([loss, seq_correct_sum,
    graph_count])`` — identical replicated scalars on every shard,
    matching :func:`ggnn.models.api.loss_and_metrics`'s ggsnn
    branch (pinned by tests/test_distributed.py)."""
    from ggnn.models import heads as H
    from ggnn.models.ggsnn import annotation_update

    n_local = ann.shape[0]
    n_nodes = nfa["n_nodes"]
    graph_mask = (n_nodes > 0)
    use_node = cfg.ggsnn_output == "node"
    tgt = nfa["seq_nodes"] if use_node else nfa["seq"]      # [G, K]
    tgt_T = tgt.T                                           # [K, G]
    use_sup = cfg.ann_supervision and nfa.get("ann_seq") is not None
    xs = {"tgt": tgt_T}
    if not cfg.share_round_nets:
        xs["out"] = nfa["out"]
        xs["ann_net"] = nfa["ann_net"]
    if use_sup:
        base = jax.lax.axis_index(axis_name) * n_local
        # [n_pad, K, A] → this shard's rows, round-major for the scan
        ann_loc = jax.lax.dynamic_slice_in_dim(nfa["ann_seq"], base,
                                               n_local)
        xs["ann_tgt"] = jnp.transpose(ann_loc, (1, 0, 2))   # [K, n_local, A]

    if use_node:
        offs = H.node_offsets(n_nodes)

    def round_fn(carry, x):
        X, nll_sum, valid_sum, seq_ok, bce_sum, w_sum = carry
        out_p = x.get("out", nfa.get("out"))
        ann_p = x.get("ann_net", nfa.get("ann_net"))
        tgt_k = x["tgt"]                                     # [G]
        valid_k = (tgt_k >= 0) & graph_mask
        h = run_steps(init_state(X, cfg.state_dim))
        if use_node:
            tgt_global = offs + jnp.maximum(tgt_k, 0)
            nll_k, pred = _sharded_round_node_nll(
                out_p, h, X, node_graph, node_mask, tgt_global, valid_k,
                n_graphs, axis_name)
            step_ok = (pred == tgt_global) | ~valid_k
        else:
            hx = jnp.concatenate([h, X], axis=1)
            gate = jax.nn.sigmoid(
                jnp.dot(hx, out_p["gi_w"],
                        preferred_element_type=jnp.float32)
                + out_p["gi_b"])
            val = jnp.tanh(
                jnp.dot(hx, out_p["gj_w"],
                        preferred_element_type=jnp.float32)
                + out_p["gj_b"])
            pooled = jax.lax.psum(
                jax.ops.segment_sum(gate * val * node_mask[:, None],
                                    node_graph,
                                    num_segments=n_graphs + 1)[:n_graphs],
                axis_name)
            logits = H._mlp2(out_p, pooled, "c1", "c1b", "c2", "c2b")
            logp = jax.nn.log_softmax(logits, axis=-1)
            nll_k = -jnp.take_along_axis(
                logp, jnp.maximum(tgt_k, 0)[:, None].astype(jnp.int32),
                axis=1)[:, 0]
            nll_k = jnp.where(valid_k, nll_k, 0.0)
            step_ok = (jnp.argmax(logits, axis=-1) == tgt_k) | ~valid_k
        X_next = annotation_update(ann_p, h, X) * node_mask[:, None]
        if use_sup:
            # GGS-NN-opt (paper §4): BCE on the rewritten annotations,
            # weighted by round validity of each node's graph — local
            # sums accumulate in the carry; one psum pair after the scan
            t_k = x["ann_tgt"]                               # [n_local, A]
            p = jnp.clip(X_next, 1e-6, 1.0 - 1e-6)
            bce = -(t_k * jnp.log(p) + (1.0 - t_k) * jnp.log(1.0 - p))
            w = valid_k.astype(p.dtype)[
                jnp.clip(node_graph, 0, n_graphs - 1)] * node_mask
            bce_sum = bce_sum + jnp.sum(bce * w[:, None])
            w_sum = w_sum + jnp.sum(w)
        return (X_next, nll_sum + jnp.sum(nll_k),
                valid_sum + jnp.sum(valid_k.astype(jnp.float32)),
                seq_ok & step_ok, bce_sum, w_sum), None

    zero = jnp.zeros((), jnp.float32)
    carry0 = (ann, zero, zero, jnp.ones((n_graphs,), bool), zero, zero)
    (X, nll_sum, valid_sum, seq_ok, bce_sum, w_sum), _ = jax.lax.scan(
        round_fn, carry0, xs, length=cfg.n_rounds)
    loss = nll_sum / jnp.maximum(valid_sum, 1.0)
    if use_sup:
        loss = loss + cfg.ann_loss_weight \
            * jax.lax.psum(bce_sum, axis_name) \
            / jnp.maximum(jax.lax.psum(w_sum, axis_name), 1.0)
    correct = jnp.sum((seq_ok & graph_mask).astype(jnp.float32))
    count = jnp.sum(graph_mask.astype(jnp.float32))
    return jnp.stack([loss, correct, count])


def make_sharded_task_train_step(cfg: ModelConfig, mesh, optimizer,
                                 n_graphs: int,
                                 strategy: str = "halo_overlap",
                                 axis_name: str = "graph",
                                 halo_meta=None):
    """End-to-end SHARDED task training (SURVEY.md §7.1 L4): the full
    param tree (propagation + head/round nets) trains against a real task
    loss computed INSIDE the shard_map with cross-shard collectives, so
    graphs may span shards.  All four heads are implemented:

    - ``node_select`` → :func:`sharded_node_select_loss` (targets:
      ``{"n_nodes": [G], "node": [G]}`` local target ids),
    - ``graph_gated`` → :func:`sharded_graph_gated_loss` (``"cls"`` [G]),
    - ``per_node`` → :func:`sharded_per_node_loss` (``"node_labels"``
      [n_pad] replicated; each shard slices its rows),
    - ``ggsnn`` → :func:`sharded_ggsnn_losses` (the annotation-rewrite
      round scan inside the shard_map; ``"seq"``/``"seq_nodes"`` [G, K]
      and optionally ``"ann_seq"`` [n_pad, K, A] for GGS-NN-opt).

    Returns ``train_step(params, opt_state, parts, targets,
    halo_arrays=None) -> (params, opt_state, metrics)``; metrics are the
    same (loss_sum, correct, count) sums the single-device
    :func:`ggnn.train.loop.make_train_step` reports — curves match
    (pinned by tests/test_distributed.py)."""
    import optax

    _check_trainable(cfg)
    objective = _make_sharded_objective(cfg, mesh, n_graphs, strategy,
                                        axis_name, halo_meta)

    @functools.partial(jax.jit, donate_argnums=(1,))
    def train_step(params, opt_state, parts, targets, halo_arrays=None):
        (loss, (correct, count)), grads = jax.value_and_grad(
            lambda ps: objective(ps, parts, targets, halo_arrays),
            has_aux=True)(params)
        updates, opt_state_new = optimizer.update(grads, opt_state, params)
        metrics = {"loss_sum": loss * count, "correct": correct,
                   "count": count}
        return optax.apply_updates(params, updates), opt_state_new, metrics

    return train_step


def make_sharded_eval_step(cfg: ModelConfig, mesh, n_graphs: int,
                           strategy: str = "halo_overlap",
                           axis_name: str = "graph", halo_meta=None):
    """Sharded counterpart of :func:`ggnn.train.loop.make_eval_step`:
    the same cross-shard task losses as
    :func:`make_sharded_task_train_step`, forward-only.  Returns
    ``eval_step(params, parts, targets, halo_arrays=None) -> metrics``
    with the (loss_sum, correct, count) sums the single-device eval
    reports."""
    objective = _make_sharded_objective(cfg, mesh, n_graphs, strategy,
                                        axis_name, halo_meta)

    @jax.jit
    def eval_step(params, parts, targets, halo_arrays=None):
        loss, (correct, count) = objective(params, parts, targets,
                                           halo_arrays)
        return {"loss_sum": loss * count, "correct": correct,
                "count": count}

    return eval_step


def _make_sharded_objective(cfg, mesh, n_graphs, strategy, axis_name,
                            halo_meta):
    """Shared loss closure of the sharded train/eval steps: routes the
    configured head to its cross-shard loss (node_fn) or, for GGS-NN, the
    in-shard_map round scan (body_fn); returns (loss, (correct, count))
    as replicated scalars."""
    if cfg.head not in ("node_select", "graph_gated", "per_node", "ggsnn"):
        raise ValueError(f"unknown head {cfg.head!r}")
    if strategy in ("halo_onehot", "halo_window") and halo_meta is None:
        raise ValueError(
            f"strategy {strategy!r} needs halo_meta= from "
            "build_halo_scatter_layouts/build_halo_window_layouts; pass "
            "the arrays dict to each step call")

    def node_fn(h, ann, ngraph, nmask, nfa, ax):
        if cfg.head == "graph_gated":
            loss, correct, count = sharded_graph_gated_loss(
                nfa["head"], h, ann, ngraph, nmask, nfa["n_nodes"],
                nfa["cls"], n_graphs, ax)
        elif cfg.head == "per_node":
            loss, correct, count = sharded_per_node_loss(
                nfa["head"], h, ann, nmask, nfa["node_labels"], ax)
        else:
            loss, correct, count = sharded_node_select_loss(
                nfa["head"], h, ann, ngraph, nmask, nfa["n_nodes"],
                nfa["node"], n_graphs, ax)
        return jnp.stack([loss, correct, count])

    def body_fn(run_steps, ann, ngraph, nmask, nfa, ax):
        return sharded_ggsnn_losses(cfg, run_steps, ann, ngraph, nmask,
                                    nfa, n_graphs, ax)

    def objective(ps, parts, targets, halo_arrays):
        layouts = ((halo_arrays, halo_meta)
                   if halo_arrays is not None else None)
        if cfg.head == "ggsnn":
            nfa = {"out": ps["out"], "ann_net": ps["ann"],
                   "n_nodes": targets["n_nodes"],
                   **{k: targets[k] for k in ("seq", "seq_nodes",
                                              "ann_seq")
                      if k in targets}}
            out = sharded_propagate(
                ps["prop"], cfg, mesh, parts, strategy=strategy,
                axis_name=axis_name, halo_layouts=layouts,
                body_fn=body_fn, node_fn_args=nfa)
        else:
            nfa = {"head": ps["head"], "n_nodes": targets["n_nodes"],
                   **{k: v for k, v in targets.items()
                      if k in ("node", "cls", "node_labels")}}
            out = sharded_propagate(
                ps["prop"], cfg, mesh, parts, strategy=strategy,
                axis_name=axis_name, halo_layouts=layouts,
                node_fn=node_fn, node_fn_args=nfa)
        # every shard returned identical replicated scalars
        return out[0, 0], (out[0, 1], out[0, 2])

    return objective
