"""Pieces shared by the measurement entry points (``bench.py`` and
``chip_smoke.py``): per-backend layouts for a synthetic graph, jitted
propagation / training steps, and steady-state timing."""

from __future__ import annotations

import statistics
import time

import jax
import jax.numpy as jnp
import numpy as np


def backend_layout(backend: str, batch, n_message_types: int, *,
                   window: int = 512, block_rows: int = 128,
                   min_edges_per_tile: int = 32, typed_spill: bool = False,
                   grad_quant: bool = False):
    """Host-built layout of ``backend`` for ``batch`` (None for xla).

    onehot: the typed destination-block layout (table layout when nodes
    are not 128-padded); window: block-major count tiles (src-major when
    nodes are not 128-padded) with ``block_rows``-row dst blocks."""
    n_pad = batch.spec.n_pad
    if backend == "onehot":
        from ggnn.ops.onehot import (build_dst_block_layout,
                                     build_typed_dst_layout)
        if n_pad % 128 == 0:
            return build_typed_dst_layout(
                batch.edge_src, batch.edge_dst, batch.edge_type,
                batch.edge_mask, n_pad, n_message_types)
        n_dst = -(-n_pad // 128) * 128
        return build_dst_block_layout(
            batch.edge_src, batch.edge_dst, batch.edge_type,
            batch.edge_mask, n_dst, n_src_rows=n_pad,
            n_message_types=n_message_types).to_device()
    if backend == "window":
        from ggnn.ops.window import build_window_layout
        return build_window_layout(
            batch.edge_src, batch.edge_dst, batch.edge_type,
            batch.edge_mask, n_pad, window=window, block_rows=block_rows,
            min_edges_per_tile=min_edges_per_tile,
            n_message_types=n_message_types,
            row_major="block" if n_pad % 128 == 0 else "src",
            typed_spill=typed_spill, grad_quant=grad_quant)
    return None


def graph_args(batch):
    """Device arrays of a batch in ``propagate``'s argument order."""
    return tuple(jnp.asarray(x) for x in (
        batch.annotations, batch.edge_src, batch.edge_dst, batch.edge_type,
        batch.edge_mask))


def make_forward(cfg):
    """jit(prop, ann, src, dst, type, mask, layout) -> h [N, D]."""
    from ggnn.models.ggnn import propagate

    @jax.jit
    def forward(prop, ann, es, ed, et, em, lay):
        return propagate(prop, cfg, ann, es, ed, et, em, scatter_layout=lay)

    return forward


def make_train_step(cfg, optimizer):
    """jit(prop, opt_state, ann, src, dst, type, mask, layout) ->
    (prop, opt_state, loss): one Adam step on the sum(h²) proxy loss."""
    import optax

    from ggnn.models.ggnn import propagate

    @jax.jit
    def train_step(prop, opt_state, ann, es, ed, et, em, lay):
        def loss_fn(p):
            h = propagate(p, cfg, ann, es, ed, et, em, scatter_layout=lay)
            return jnp.sum(h * h)
        loss, grads = jax.value_and_grad(loss_fn)(prop)
        updates, opt_state = optimizer.update(grads, opt_state, prop)
        return optax.apply_updates(prop, updates), opt_state, loss

    return train_step


def time_call(fn, iters: int = 5, warmup: int = 1) -> dict:
    """Time ``fn()`` (which returns device arrays): the first call — trace,
    compile and run — is set-up (``compile_s``); then ``warmup`` untimed
    calls; then ``iters`` calls, each ended by ``block_until_ready``.
    Returns compile_s, median_s and every steady time (seconds)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0
    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return {"compile_s": compile_s, "median_s": statistics.median(times),
            "times_s": times}


def finite(tree) -> bool:
    return all(bool(np.all(np.isfinite(np.asarray(x, np.float32))))
               for x in jax.tree.leaves(tree))
