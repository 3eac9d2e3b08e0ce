"""Top-level model API: forward + loss_and_metrics over a GraphBatch pytree.

``arrays`` is :attr:`ggnn.graph.GraphBatch.arrays` (flattened padded
batch).  ``n_graphs`` is static (from the PaddingSpec)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ggnn.models.config import ModelConfig
from ggnn.models.ggnn import propagate
from ggnn.models import heads as H
from ggnn.models.ggsnn import ggsnn_forward, ggsnn_loss, ggsnn_node_loss


def forward(params: dict, cfg: ModelConfig, arrays: dict, n_graphs: int,
            scatter_layout=None):
    """Task-head outputs: node scores [N] / per-node logits [N,C] /
    graph logits [B,C] / GGS-NN round logits [K,B,V].

    ``scatter_layout`` (built host-side per batch, e.g.
    :func:`ggnn.ops.onehot.layout_for_batch`) carries the layout of the
    ``onehot`` / ``window`` backends."""
    ann = arrays["annotations"]
    e = (arrays["edge_src"], arrays["edge_dst"], arrays["edge_type"],
         arrays["edge_mask"])
    if cfg.head == "ggsnn":
        logits, _ = ggsnn_forward(params, cfg, ann, arrays["node_graph"],
                                  arrays["node_mask"], *e, n_graphs=n_graphs,
                                  scatter_layout=scatter_layout)
        return logits  # [K, B, V]
    h = propagate(params["prop"], cfg, ann, *e,
                  scatter_layout=scatter_layout)
    if cfg.head == "node_select":
        return H.node_select_scores(params["head"], h, ann)
    if cfg.head == "per_node":
        return H.per_node_logits(params["head"], h, ann)
    if cfg.head == "graph_gated":
        return H.graph_gated_logits(params["head"], h, ann,
                                    arrays["node_graph"], arrays["node_mask"],
                                    n_graphs)
    raise ValueError(f"unknown head {cfg.head!r}")


def loss_and_metrics(params: dict, cfg: ModelConfig, arrays: dict,
                     n_graphs: int, scatter_layout=None):
    """(scalar loss, metrics dict with 'correct' and 'count' sums)."""
    tgts = arrays["targets"]
    if cfg.head == "ggsnn":
        e = (arrays["edge_src"], arrays["edge_dst"], arrays["edge_type"],
             arrays["edge_mask"])
        logits, anns = ggsnn_forward(
            params, cfg, arrays["annotations"], arrays["node_graph"],
            arrays["node_mask"], *e, n_graphs=n_graphs,
            scatter_layout=scatter_layout)
        use_sup = cfg.ann_supervision and "ann_seq" in tgts
        if cfg.ggsnn_output == "node":
            loss, correct, mask = ggsnn_node_loss(
                logits, tgts["seq_nodes"], arrays["node_graph"],
                arrays["node_mask"], arrays["n_nodes"], n_graphs,
                anns=anns if use_sup else None,
                ann_targets=tgts.get("ann_seq") if use_sup else None,
                ann_weight=cfg.ann_loss_weight)
        else:
            loss, correct, mask = ggsnn_loss(
                logits, tgts["seq"], arrays["n_nodes"],
                anns=anns if use_sup else None,
                ann_targets=tgts.get("ann_seq") if use_sup else None,
                node_graph=arrays["node_graph"],
                node_mask=arrays["node_mask"],
                ann_weight=cfg.ann_loss_weight)
        metrics = {"loss_sum": loss * jnp.sum(mask),
                   "correct": jnp.sum(correct.astype(jnp.float32)),
                   "count": jnp.sum(mask)}
        return loss, metrics

    out = forward(params, cfg, arrays, n_graphs, scatter_layout=scatter_layout)
    if cfg.head == "node_select":
        loss, correct, mask = H.node_select_loss(
            out, arrays["node_graph"], arrays["node_mask"], arrays["n_nodes"],
            tgts["node"], n_graphs)
    elif cfg.head == "per_node":
        loss, correct, mask = H.per_node_loss(out, tgts["node_labels"],
                                              arrays["node_mask"])
    elif cfg.head == "graph_gated":
        loss, correct, mask = H.graph_class_loss(out, tgts["cls"],
                                                 arrays["n_nodes"])
    else:
        raise ValueError(f"unknown head {cfg.head!r}")
    metrics = {"loss_sum": loss * jnp.sum(mask),
               "correct": jnp.sum(correct.astype(jnp.float32)),
               "count": jnp.sum(mask)}
    return loss, metrics
