"""Sharded training step via GSPMD sharding annotations (SURVEY.md §2.5).

The scaling-book recipe: pick a mesh, annotate input shardings, let XLA
insert the collectives.  For a flattened graph batch, data parallelism and
graph (edge) partitioning are the SAME axis — graphs occupy disjoint node
ranges, so sharding the node/edge axes across the whole mesh splits whole
graphs across devices (dp at graph boundaries) and large graphs within
themselves (the sp/tp analogue).  Parameters and optimizer state are
replicated (GGNN parameter counts are tiny: O(E·D²)).

The explicit shard_map halo-exchange path (:mod:`ggnn.parallel.halo`)
is the hand-scheduled alternative for the propagation hot loop; this module
is the whole-train-step path (loss + backward + Adam update)."""

from __future__ import annotations

import functools

import jax
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from ggnn.models import loss_and_metrics


def batch_shardings(mesh) -> dict:
    """NamedSharding pytree for a GraphBatch.arrays dict: node- and
    edge-axis arrays sharded over every mesh axis, small per-graph arrays
    replicated."""
    flat = P(tuple(mesh.axis_names))  # all axes over the leading dim
    s_flat = NamedSharding(mesh, flat)
    s_rep = NamedSharding(mesh, P())
    return {
        "annotations": s_flat, "node_graph": s_flat, "node_mask": s_flat,
        "n_nodes": s_rep, "type_offsets": s_rep,
        "edge_src": s_flat, "edge_dst": s_flat, "edge_type": s_flat,
        "edge_mask": s_flat,
        "targets": None,  # filled per-key below
    }


def shard_batch_arrays(arrays: dict, mesh) -> dict:
    """Device-put a batch pytree with GSPMD shardings."""
    sh = batch_shardings(mesh)
    s_rep = NamedSharding(mesh, P())
    out = {}
    for k, v in arrays.items():
        if k == "targets":
            out[k] = {tk: jax.device_put(tv, s_rep) for tk, tv in v.items()}
        else:
            out[k] = jax.device_put(v, sh[k])
    return out


def make_gspmd_train_step(model_cfg, n_graphs: int, optimizer, mesh):
    """Jitted whole-batch training step with GSPMD-annotated inputs."""
    s_rep = NamedSharding(mesh, P())

    @functools.partial(jax.jit, donate_argnums=(0, 1),
                       out_shardings=(s_rep, s_rep, s_rep))
    def train_step(params, opt_state, arrays):
        def loss_fn(p):
            return loss_and_metrics(p, model_cfg, arrays, n_graphs)
        (loss, metrics), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state_new = optimizer.update(grads, opt_state, params)
        params_new = optax.apply_updates(params, updates)
        return params_new, opt_state_new, metrics

    return train_step
