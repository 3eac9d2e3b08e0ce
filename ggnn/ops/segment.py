"""Pure-XLA typed aggregation: the jit-native SpMM / SDDMM / segment ops.

This replaces the reference's dense ``bmm(A, states)`` (SURVEY.md §3.2) with
work proportional to |edges| instead of O(n²·E):

- ``typed_aggregate``: a_v = Σ_{(u,t,v)} (h_u · W_t + b_t), two strategies:

  * ``node_transform`` — transform every node's state by every message type
    in one batched matmul (one [2E·D, D]-shaped einsum), then gather
    per-edge results
    and ``segment_sum`` into destinations.  FLOPs O(2E·N·D²); best when
    2E·N ≲ |edges| (bAbI: always, since every node has ≥1 edge per type on
    average is false but N is tiny).
  * ``edge_gather`` — gather per-edge weight matrices and contract per edge.
    FLOPs O(|E|·D²) but moves D² weights per edge; best when the type
    vocabulary is large relative to edge count.

  Both are exactly the same math; parity is tested against the NumPy oracle.

All ops take pre-flattened batch arrays (see :mod:`ggnn.graph`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def typed_aggregate(h: jax.Array, edge_src: jax.Array, edge_dst: jax.Array,
                    edge_type: jax.Array, edge_mask: jax.Array,
                    msg_w: jax.Array, msg_b: jax.Array,
                    strategy: str = "node_transform") -> jax.Array:
    """a[v] = Σ over directed edges (u,t,v): h[u] · msg_w[t] + msg_b[t].

    Args:
      h: [N, D] node states.
      edge_src/edge_dst/edge_type: [E] int32 (padding edges masked).
      edge_mask: [E] float (1.0 real / 0.0 pad).
      msg_w: [T2, D, D]; msg_b: [T2, D].
    Returns: [N, D] aggregated messages (zeros at padding nodes that receive
      nothing — padding edges contribute exactly 0).
    """
    n_pad = h.shape[0]
    if strategy == "node_transform":
        # [T2, N, D] = h · W_t + b_t for all types, in one batched matmul
        transformed = jnp.einsum(
            "nd,tdf->tnf", h, msg_w,
            preferred_element_type=jnp.float32) + msg_b[:, None, :]
        messages = transformed[edge_type, edge_src]          # [E, D] gather
    elif strategy == "edge_gather":
        w_e = msg_w[edge_type]                               # [E, D, D]
        messages = jnp.einsum(
            "ed,edf->ef", h[edge_src], w_e,
            preferred_element_type=jnp.float32) + msg_b[edge_type]
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    messages = messages * edge_mask[:, None]
    return jax.ops.segment_sum(messages, edge_dst, num_segments=n_pad)


def sddmm(h_src_feat: jax.Array, h_dst_feat: jax.Array,
          edge_src: jax.Array, edge_dst: jax.Array,
          edge_mask: jax.Array) -> jax.Array:
    """Sampled dense-dense matmul: per-edge scores ⟨p[src], q[dst]⟩.

    Edge-feature capability extension required by BASELINE.json:5 ("SDDMM
    for edge features"); absent in the reference (its dense A is 0/1,
    SURVEY.md §2.4).  Returns [E] float32."""
    p = h_src_feat[edge_src]
    q = h_dst_feat[edge_dst]
    return jnp.sum(p * q, axis=-1) * edge_mask


def segment_softmax(scores: jax.Array, segment_ids: jax.Array,
                    num_segments: int, mask: jax.Array) -> jax.Array:
    """Numerically-stable softmax within segments (per-graph over nodes).

    Padding entries (mask==0) get probability 0 and do not affect the
    normalizer.  Used by the node-selection loss (SURVEY.md §2.1 C7a)."""
    neg = jnp.finfo(scores.dtype).min
    masked = jnp.where(mask > 0, scores, neg)
    seg_max = jax.ops.segment_max(masked, segment_ids, num_segments=num_segments)
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    shifted = jnp.where(mask > 0, masked - seg_max[segment_ids], neg)
    expd = jnp.exp(shifted) * (mask > 0)
    denom = jax.ops.segment_sum(expd, segment_ids, num_segments=num_segments)
    denom = jnp.maximum(denom, 1e-30)
    return expd / denom[segment_ids]


def segment_log_softmax(scores: jax.Array, segment_ids: jax.Array,
                        num_segments: int, mask: jax.Array) -> jax.Array:
    """log of :func:`segment_softmax` without the intermediate division."""
    neg = jnp.finfo(scores.dtype).min
    masked = jnp.where(mask > 0, scores, neg)
    seg_max = jax.ops.segment_max(masked, segment_ids, num_segments=num_segments)
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    shifted = jnp.where(mask > 0, masked - seg_max[segment_ids], neg)
    expd = jnp.exp(shifted) * (mask > 0)
    denom = jax.ops.segment_sum(expd, segment_ids, num_segments=num_segments)
    log_denom = jnp.log(jnp.maximum(denom, 1e-30))
    return shifted - log_denom[segment_ids]
