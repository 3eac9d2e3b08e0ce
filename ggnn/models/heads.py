"""Readout heads C7a–C7c (SURVEY.md §2.1) on flattened padded batches.

Every head consumes the final node states h [N, D] plus the original
annotations x [N, A] (the reference concatenates them: ``join =
cat([prop_state, annotation])``, SURVEY.md §3.2) and per-node graph ids /
masks from :class:`~ggnn.graph.GraphBatch`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ggnn.ops.segment import segment_log_softmax


def _mlp2(p, x, w1="w1", b1="b1", w2="w2", b2="b2"):
    hidden = jnp.tanh(jnp.dot(x, p[w1], preferred_element_type=jnp.float32) + p[b1])
    return jnp.dot(hidden, p[w2], preferred_element_type=jnp.float32) + p[b2]


def node_select_scores(head: dict, h, annotations) -> jax.Array:
    """o_v = MLP([h_v ; x_v]) → [N] scalar scores (C7a)."""
    hx = jnp.concatenate([h, annotations], axis=1)
    return _mlp2(head, hx)[:, 0]


def per_node_logits(head: dict, h, annotations) -> jax.Array:
    """[N, C] per-node class logits (C7b)."""
    hx = jnp.concatenate([h, annotations], axis=1)
    return _mlp2(head, hx)


def graph_gated_pool(head: dict, h, annotations, node_graph, node_mask,
                     n_graphs: int) -> jax.Array:
    """h_G = Σ_v σ(i([h;x])) ⊙ tanh(j([h;x])) per graph → [B, G] (C7c)."""
    hx = jnp.concatenate([h, annotations], axis=1)
    gate = jax.nn.sigmoid(
        jnp.dot(hx, head["gi_w"], preferred_element_type=jnp.float32) + head["gi_b"])
    val = jnp.tanh(
        jnp.dot(hx, head["gj_w"], preferred_element_type=jnp.float32) + head["gj_b"])
    pooled = jax.ops.segment_sum(gate * val * node_mask[:, None], node_graph,
                                 num_segments=n_graphs + 1)
    return pooled[:n_graphs]


def graph_gated_logits(head: dict, h, annotations, node_graph, node_mask,
                       n_graphs: int) -> jax.Array:
    """[B, C] graph-level logits: gated pool + tanh-hidden classifier."""
    hG = graph_gated_pool(head, h, annotations, node_graph, node_mask, n_graphs)
    return _mlp2(head, hG, "c1", "c1b", "c2", "c2b")


def node_offsets(n_nodes: jax.Array) -> jax.Array:
    """Exclusive cumsum of per-graph node counts → flattened-index base."""
    return jnp.concatenate([jnp.zeros((1,), n_nodes.dtype),
                            jnp.cumsum(n_nodes)[:-1]])


def node_select_loss(scores, node_graph, node_mask, n_nodes, target_local,
                     n_graphs: int):
    """Per-graph softmax-over-nodes cross-entropy + exact-match accuracy.

    ``target_local`` is the 0-indexed node id within each graph; converted
    to flattened indices via the per-batch node offsets (graph.py packs
    graphs tightly, so offsets vary per batch)."""
    offs = node_offsets(n_nodes)
    target_global = offs + target_local
    logp = segment_log_softmax(scores, node_graph, n_graphs + 1, node_mask)
    graph_mask = (n_nodes > 0).astype(scores.dtype)
    nll = -logp[target_global] * graph_mask
    loss = jnp.sum(nll) / jnp.maximum(jnp.sum(graph_mask), 1.0)

    # segment argmax: first index achieving the per-graph max
    neg = jnp.finfo(scores.dtype).min
    masked = jnp.where(node_mask > 0, scores, neg)
    seg_max = jax.ops.segment_max(masked, node_graph, num_segments=n_graphs + 1)
    is_max = (masked == seg_max[node_graph]) & (node_mask > 0)
    idx = jnp.arange(scores.shape[0], dtype=jnp.int32)
    big = jnp.asarray(scores.shape[0], jnp.int32)
    pred_global = jax.ops.segment_min(jnp.where(is_max, idx, big), node_graph,
                                      num_segments=n_graphs + 1)[:n_graphs]
    correct = (pred_global == target_global) & (n_nodes > 0)
    return loss, correct, graph_mask


def graph_class_loss(logits, target, n_nodes):
    """[B, C] logits vs [B] int targets; padding graphs masked out."""
    graph_mask = (n_nodes > 0).astype(logits.dtype)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, target[:, None].astype(jnp.int32),
                               axis=1)[:, 0] * graph_mask
    loss = jnp.sum(nll) / jnp.maximum(jnp.sum(graph_mask), 1.0)
    correct = (jnp.argmax(logits, axis=-1) == target) & (n_nodes > 0)
    return loss, correct, graph_mask


def per_node_loss(logits, labels, node_mask):
    """[N, C] logits vs [N] labels (−1 = unlabeled/padding)."""
    valid = (labels >= 0) & (node_mask > 0)
    safe = jnp.maximum(labels, 0)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, safe[:, None].astype(jnp.int32), axis=1)[:, 0]
    nll = jnp.where(valid, nll, 0.0)
    loss = jnp.sum(nll) / jnp.maximum(jnp.sum(valid), 1)
    correct = (jnp.argmax(logits, axis=-1) == labels) & valid
    return loss, correct, valid
