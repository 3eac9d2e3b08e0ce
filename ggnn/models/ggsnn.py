"""GGS-NN: sequential outputs via repeated (propagate → output → annotate)
rounds (SURVEY.md §2.1 C7d, §3.4; paper §4; bAbI task 19 per BASELINE.json:10).

The outer loop over output rounds is a ``lax.scan`` carrying the node
annotations X^{(k)}; propagation re-initializes h = pad(X^{(k)}, D) each
round and shares weights across rounds (the paper's shared-weights option).
Loss masks rounds past each example's target length (targets padded with
−1), so variable-length sequences run under a static round count
(SURVEY.md §7.2.2)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ggnn.models.config import ModelConfig
from ggnn.models.ggnn import propagate
from ggnn.models.heads import (_mlp2, graph_gated_logits, node_offsets,
                                   node_select_scores)
from ggnn.ops.segment import segment_log_softmax


def annotation_update(ann: dict, h, annotations) -> jax.Array:
    """X^{(k+1)} = σ(F_x([h ; X^{(k)}])) per node."""
    hx = jnp.concatenate([h, annotations], axis=1)
    return jax.nn.sigmoid(_mlp2(ann, hx, "a1", "a1b", "a2", "a2b"))


def ggsnn_forward(params: dict, cfg: ModelConfig, annotations, node_graph,
                  node_mask, edge_src, edge_dst, edge_type, edge_mask,
                  n_graphs: int, scatter_layout=None):
    """Per-round outputs and annotations: with ``cfg.ggsnn_output='graph'``
    (default) the outputs are token logits [K, B, V]; with ``'node'`` the
    paper's node-selection alternative emits per-node scores [K, N] (the
    round's output is the selected next path node).

    ``scatter_layout`` carries the host-built layout of the ``onehot`` /
    ``window`` backends into the round scan (passed through jit
    arguments; topology is static across rounds)."""

    def round_fn(X, round_params):
        out_p, ann_p = round_params
        h = propagate(params["prop"], cfg, X, edge_src, edge_dst, edge_type,
                      edge_mask, scatter_layout=scatter_layout)
        if cfg.ggsnn_output == "node":
            logits = node_select_scores(out_p, h, X)          # [N]
        else:
            logits = graph_gated_logits(out_p, h, X, node_graph,
                                        node_mask, n_graphs)
        X_next = annotation_update(ann_p, h, X) * node_mask[:, None]
        return X_next, (logits, X_next)

    if cfg.share_round_nets:
        _, (logits, anns) = jax.lax.scan(
            lambda X, _: round_fn(X, (params["out"], params["ann"])),
            annotations, None, length=cfg.n_rounds)
    else:
        # per-round nets: scan consumes the stacked leading-K params
        _, (logits, anns) = jax.lax.scan(
            round_fn, annotations, (params["out"], params["ann"]))
    return logits, anns  # [K, B, V], [K, N, A]


def ggsnn_loss(logits, targets, n_nodes, anns=None, ann_targets=None,
               node_graph=None, node_mask=None, ann_weight: float = 1.0):
    """Σ_k CE(logits_k, target_k) over valid rounds (+ optional GGS-NN-opt
    annotation BCE); exact-match sequence accuracy (SURVEY.md §3.3)."""
    K, B, V = logits.shape
    tgt = targets.T  # [K, B]
    valid = (tgt >= 0) & (n_nodes[None, :] > 0)
    safe = jnp.maximum(tgt, 0)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, safe[..., None].astype(jnp.int32),
                               axis=-1)[..., 0]
    nll = jnp.where(valid, nll, 0.0)
    loss = jnp.sum(nll) / jnp.maximum(jnp.sum(valid), 1)

    if anns is not None and ann_targets is not None:
        # anns [K, N, A]; ann_targets [N, K, A] (node-aligned batching)
        t = jnp.transpose(ann_targets, (1, 0, 2))            # [K, N, A]
        p = jnp.clip(anns, 1e-6, 1.0 - 1e-6)
        bce = -(t * jnp.log(p) + (1.0 - t) * jnp.log(1.0 - p))
        round_valid = valid.astype(logits.dtype)             # [K, B]
        w = round_valid[:, node_graph.clip(0, B - 1)] * node_mask[None, :]
        bce = bce * w[..., None]
        loss = loss + ann_weight * jnp.sum(bce) / jnp.maximum(jnp.sum(w), 1.0)

    step_correct = (jnp.argmax(logits, axis=-1) == tgt) | ~valid
    seq_correct = jnp.all(step_correct, axis=0) & (n_nodes > 0)
    graph_mask = (n_nodes > 0).astype(logits.dtype)
    return loss, seq_correct, graph_mask


def _ann_bce(anns, ann_targets, valid, node_graph, node_mask, B):
    """GGS-NN-opt annotation BCE, masked to valid rounds / real nodes."""
    t = jnp.transpose(ann_targets, (1, 0, 2))                # [K, N, A]
    p = jnp.clip(anns, 1e-6, 1.0 - 1e-6)
    bce = -(t * jnp.log(p) + (1.0 - t) * jnp.log(1.0 - p))
    w = valid.astype(p.dtype)[:, node_graph.clip(0, B - 1)] \
        * node_mask[None, :]
    return jnp.sum(bce * w[..., None]) / jnp.maximum(jnp.sum(w), 1.0)


def ggsnn_node_loss(scores, target_nodes, node_graph, node_mask, n_nodes,
                    n_graphs: int, anns=None, ann_targets=None,
                    ann_weight: float = 1.0):
    """Loss for the node-selection GGS-NN output (cfg.ggsnn_output='node'):
    per round, softmax over each graph's nodes vs the target path node
    (``target_nodes`` [B, K] LOCAL ids, −1 past the path end); exact-match
    sequence accuracy over valid rounds."""
    K, N = scores.shape
    tgt = target_nodes.T                                     # [K, B] local
    valid = (tgt >= 0) & (n_nodes[None, :] > 0)
    offs = node_offsets(n_nodes)
    tgt_global = offs[None, :] + jnp.maximum(tgt, 0)

    logp = jax.vmap(lambda s: segment_log_softmax(
        s, node_graph, n_graphs + 1, node_mask))(scores)      # [K, N]
    nll = -jnp.take_along_axis(logp, tgt_global, axis=1)      # [K, B]
    nll = jnp.where(valid, nll, 0.0)
    loss = jnp.sum(nll) / jnp.maximum(jnp.sum(valid), 1)

    if anns is not None and ann_targets is not None:
        loss = loss + ann_weight * _ann_bce(
            anns, ann_targets, valid, node_graph, node_mask, n_graphs)

    # per-round segment argmax (first max index)
    neg = jnp.finfo(scores.dtype).min
    masked = jnp.where(node_mask[None, :] > 0, scores, neg)
    seg_max = jax.vmap(lambda s: jax.ops.segment_max(
        s, node_graph, num_segments=n_graphs + 1))(masked)    # [K, B+1]
    is_max = (masked == jnp.take_along_axis(
        seg_max, node_graph[None, :].repeat(K, 0), axis=1)) \
        & (node_mask[None, :] > 0)
    idx = jnp.arange(N, dtype=jnp.int32)[None, :].repeat(K, 0)
    big = jnp.asarray(N, jnp.int32)
    pred = jax.vmap(lambda m, i: jax.ops.segment_min(
        jnp.where(m, i, big), node_graph,
        num_segments=n_graphs + 1))(is_max, idx)[:, :n_graphs]  # [K, B]
    step_correct = (pred == tgt_global) | ~valid
    seq_correct = jnp.all(step_correct, axis=0) & (n_nodes > 0)
    graph_mask = (n_nodes > 0).astype(scores.dtype)
    return loss, seq_correct, graph_mask
