#!/usr/bin/env python
"""Smoke test of the GGNN main path on one GPU: proof that the system
starts, computes the right thing at full width, and how fast.

    python chip_smoke.py                # one GPU, phases 1-6
    python chip_smoke.py --devices 4    # four GPUs: the sharded paths only

Phases on one card (one process; a failed phase makes the exit code
non-zero, the remaining phases still run):

1. device — platform, device kind and count, the card's name and power
   limit (``nvidia-smi``), and whether the native host library was built.
2. trainer — a few epochs of bAbI task 4 (node selection) and task 19
   (GGS-NN) through the train CLI, in-process; losses must be finite.
3. full width, ``xla`` backend — 262,144 nodes, 4M logical / 8M directed
   edges, 8 edge types (16 message types), D=128, T=5, bf16 aggregation,
   node-selection head: forward plus 3 Adam steps through
   ``api.loss_and_metrics``, compared with the f32 path under
   ``jax.default_matmul_precision("highest")`` and, at 4,096 nodes, with
   the NumPy oracle.
4. translated backends at full width — ``onehot`` on the uniform graph,
   ``window`` on a 512-community graph (p_intra 0.95, 512-row dst
   blocks), and ``window`` int8 serving; forward and one train step each,
   compared with the xla f32-highest reference on the same graph.
5. ``Predictor.for_task(4).predict`` on generated bAbI graphs, matched
   against ``api.forward``.
6. times and memory — steady forward and train-step times (median after
   warm-up, each call ended by ``block_until_ready``), compile time as
   set-up, ``peak_bytes_in_use``, and the GRU cell alone; printed as each
   phase runs.

With ``--devices 4`` only the sharded phase runs: ``sharded_propagate``
with all five strategies on 1M nodes / 20M directed edges / 4096
communities / D=128 against single-card ``propagate``, plus one
``make_sharded_task_train_step`` and one ``make_gspmd_train_step`` step
against single-device steps.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Sizes:
    nodes: int = 262_144
    edges: int = 4_000_000          # logical; the batch holds 2× directed
    types: int = 8
    dim: int = 128
    steps: int = 5
    communities: int = 512          # community graph: nodes // 512 each
    block_rows: int = 512
    window: int = 512
    oracle_nodes: int = 4096
    oracle_edges: int = 62_500      # the full graph's mean degree
    iters: int = 5                  # timed steady calls
    trainer_epochs: int = 2
    trainer_examples: int = 20
    predictor_graphs: int = 12


@dataclasses.dataclass(frozen=True)
class ShardSizes:
    nodes: int = 1_000_000
    edges: int = 10_000_000         # 20M directed
    types: int = 8
    dim: int = 128
    steps: int = 5
    communities: int = 4096
    devices: int = 4


# Tolerances, each with its reason (printed beside every comparison).
TOL = {
    "bf16": (2e-2, 1e-1,
             "bf16 aggregation inputs (8-bit mantissa, 3.9e-3 per rounding) "
             "summed over ~30 in-edges and fed through 5 GRU steps, and TF32 "
             "gate matmuls; scores and states are O(1)"),
    "bf16_grad": (5e-2, None,
                  "bf16 forward and backward through 5 steps; the gradient "
                  "is a long chain of rounded products"),
    "q8": (6e-2, 3e-1,
           "int8 table with power-of-2 per-window scales adds ~0.5 % noise "
           "per step on top of the bf16 path"),
    "f32_oracle": (1e-4, 1e-3,
                   "f32 under 'highest' precision against the float64 "
                   "oracle: only summation order and f32 rounding differ"),
    "sharded": (1e-4, 1e-3,
                "same f32 math under 'highest' precision; only the order of "
                "the per-shard partial sums differs"),
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def compare(name: str, got, ref, tol_key: str) -> bool:
    """Print max |Δ| and rel-L2 beside their tolerances; True when
    ``got`` is finite, shaped like ``ref`` and within both."""
    rel_tol, abs_tol, reason = TOL[tol_key]
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    ok = got.shape == ref.shape and bool(np.isfinite(got).all())
    max_abs = float(np.max(np.abs(got - ref))) if ok and got.size else 0.0
    rel = (float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))
           if ok else float("inf"))
    ok = ok and rel <= rel_tol and (abs_tol is None or max_abs <= abs_tol)
    abs_txt = "" if abs_tol is None else f" (tol {abs_tol:g})"
    log(f"  {name}: max|Δ| {max_abs:.6e}{abs_txt}, rel-L2 {rel:.6e} "
        f"(tol {rel_tol:g}) [{tol_key}] {'ok' if ok else 'FAIL'} — {reason}")
    return ok


def compare_tree(name, got, ref, tol_key) -> bool:
    import jax
    g = np.concatenate([np.ravel(np.asarray(x, np.float64))
                        for x in jax.tree.leaves(got)])
    r = np.concatenate([np.ravel(np.asarray(x, np.float64))
                        for x in jax.tree.leaves(ref)])
    return compare(name, g, r, tol_key)


def log_time(name: str, t: dict, edges: int | None = None,
             steps: int | None = None) -> None:
    rate = ""
    if edges:
        rate = f", {edges * steps / t['median_s']:.6e} edges/s"
    log(f"  time {name}: median {t['median_s']:.6f} s over "
        f"{len(t['times_s'])} calls{rate}; compile {t['compile_s']:.3f} s")


def log_memory(tag: str) -> None:
    from ggnn.runtime import peak_bytes_in_use
    peak = peak_bytes_in_use()
    log(f"  peak_bytes_in_use after {tag}: "
        + ("not reported by this platform" if peak is None
           else f"{peak} ({peak / 2**30:.3f} GiB)"))


# ---------------------------------------------------------------- phase 1
def phase_device(expect_count: int = 1, allow_cpu: bool = False) -> dict:
    from ggnn import native
    from ggnn.runtime import device_record, gpu_name_and_power_limit
    rec = device_record()
    log(f"device: platform={rec['platform']} kind={rec['kind']} "
        f"count={rec['count']}")
    if rec["platform"] != "gpu" and not allow_cpu:
        raise SystemExit(f"no GPU: JAX found {rec['platform']!r} only")
    if rec["count"] < expect_count:
        raise SystemExit(f"{expect_count} devices needed, "
                         f"JAX found {rec['count']}")
    log(f"nvidia-smi name, power.limit: {gpu_name_and_power_limit()}")
    log("native host library: "
        + ("built from ggnn/native/ggnn_host.cpp on this machine"
           if native.available() else "unavailable; Python fallbacks run"))
    return rec


# ---------------------------------------------------------------- phase 2
def phase_trainer(sz: Sizes) -> bool:
    from ggnn.train.__main__ import main as train_main
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for config in ("babi4", "babi19"):
            path = os.path.join(tmp, f"{config}.jsonl")
            t0 = time.perf_counter()
            rc = train_main([
                "--config", config, "--epochs", str(sz.trainer_epochs),
                "--n_train", str(sz.trainer_examples),
                "--n_test", str(sz.trainer_examples),
                "--data_root", os.path.join(REPO, "babi_data"),
                "--metrics", path])
            with open(path) as f:
                recs = [json.loads(line) for line in f if line.strip()]
            losses = [r[k] for r in recs for k in ("loss", "test_loss")
                      if k in r]
            good = (rc == 0 and bool(losses)
                    and all(np.isfinite(losses)))
            log(f"  trainer {config}: rc={rc} losses={losses} "
                f"({time.perf_counter() - t0:.1f} s) "
                f"{'ok' if good else 'FAIL'}")
            ok = ok and good
    return ok


# ------------------------------------------------------ helpers (3, 4, 6)
def _model(sz: Sizes, **kw):
    from ggnn.models import ModelConfig
    base = dict(state_dim=sz.dim, annotation_dim=8, n_edge_types=sz.types,
                n_steps=sz.steps, head="node_select",
                compute_dtype="bfloat16")
    base.update(kw)
    return ModelConfig(**base)


def _steps(cfg):
    """jit forward (api.forward) and jit train step (api.loss_and_metrics
    + Adam) for ``cfg``."""
    import jax
    import optax

    from ggnn.models import forward, loss_and_metrics
    opt = optax.adam(1e-3)

    @jax.jit
    def fwd(params, arrays, lay):
        return forward(params, cfg, arrays, 1, scatter_layout=lay)

    @jax.jit
    def step(params, opt_state, arrays, lay):
        (loss, _), grads = jax.value_and_grad(
            lambda p: loss_and_metrics(p, cfg, arrays, 1,
                                       scatter_layout=lay),
            has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    return fwd, step, opt


def _reference(cfg32, params, arrays):
    """xla path in f32 under 'highest' matmul precision: scores, loss and
    grads at ``params``."""
    import jax
    fwd, step, opt = _steps(cfg32)
    with jax.default_matmul_precision("highest"):
        scores = fwd(params, arrays, None)
        _, _, loss, grads = step(params, opt.init(params), arrays, None)
    return np.asarray(scores), float(loss), jax.device_get(grads)


def _run_backend(name, cfg, params, arrays, lay, ref, sz, n_dir,
                 train: bool = True, tol="bf16") -> bool:
    """Forward + train step(s) of one backend against ``ref`` =
    (scores, loss, grads), with steady times."""
    from ggnn import benchlib
    fwd, step, opt = _steps(cfg)
    t = benchlib.time_call(lambda: fwd(params, arrays, lay),
                           iters=sz.iters)
    log_time(f"{name} forward", t, n_dir, sz.steps)
    ok = compare(f"{name} forward scores", fwd(params, arrays, lay),
                 ref[0], tol)
    if not train:
        return ok
    opt_state = opt.init(params)
    t = benchlib.time_call(lambda: step(params, opt_state, arrays, lay),
                           iters=sz.iters)
    log_time(f"{name} train step", t, n_dir, sz.steps)
    p, o, loss, grads = step(params, opt_state, arrays, lay)
    ok &= compare(f"{name} loss", np.float64(loss), np.float64(ref[1]), tol)
    ok &= compare_tree(f"{name} grads", grads, ref[2], "bf16_grad")
    losses = [float(loss)]
    for _ in range(2):                       # 3 Adam steps in all
        p, o, loss, _ = step(p, o, arrays, lay)
        losses.append(float(loss))
    finite = bool(np.isfinite(losses).all()) and benchlib.finite(p)
    log(f"  {name} 3 Adam steps: losses {losses} "
        f"{'ok' if finite else 'FAIL (not finite)'}")
    return ok and finite


def _graph(sz: Sizes, communities: int = 0, nodes=None, edges=None):
    from ggnn.data.synthetic import synthetic_batch
    return synthetic_batch(nodes or sz.nodes, edges or sz.edges, sz.types,
                           annotation_dim=8, seed=0,
                           node_mult=max(128, sz.block_rows),
                           n_communities=communities, p_intra=0.95)


def _device_arrays(batch):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, batch.arrays)


# ---------------------------------------------------------------- phase 3
def phase_full_width(sz: Sizes, keep: dict) -> bool:
    import jax

    from ggnn.models import init_params
    batch = _graph(sz)
    n_dir = int(batch.edge_mask.sum())
    log(f"  uniform graph: {sz.nodes} nodes ({batch.spec.n_pad} padded), "
        f"{n_dir} directed edges, {2 * sz.types} message types, "
        f"D={sz.dim}, T={sz.steps}")
    cfg = _model(sz)
    params = init_params(jax.random.PRNGKey(0), cfg)
    arrays = _device_arrays(batch)
    ref = _reference(_model(sz, compute_dtype="float32"), params, arrays)
    keep["uniform_ref"] = ref
    ok = _run_backend("xla", cfg, params, arrays, None, ref, sz, n_dir)
    log_memory("xla full width")
    ok &= _oracle_check(sz)
    return ok


def _oracle_check(sz: Sizes) -> bool:
    """At ``oracle_nodes``: the f32-highest and bf16 xla paths against
    the float64 NumPy oracle, on the final node states."""
    import jax

    from ggnn.models import init_params
    from ggnn.models.ggnn import propagate
    from ggnn.oracle import oracle_propagate
    batch = _graph(sz, nodes=sz.oracle_nodes, edges=sz.oracle_edges)
    n = sz.oracle_nodes
    real = batch.edge_mask > 0
    fwd_e = (batch.edge_type < sz.types) & real
    edges = np.stack([batch.edge_src[fwd_e], batch.edge_type[fwd_e],
                      batch.edge_dst[fwd_e]], axis=1)
    cfg32 = _model(sz, compute_dtype="float32")
    params = init_params(jax.random.PRNGKey(1), cfg32)
    p64 = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
    t0 = time.perf_counter()
    want = oracle_propagate(p64["prop"], batch.annotations[:n], edges,
                            sz.types, sz.steps)[-1]
    log(f"  oracle: {n} nodes, {2 * len(edges)} directed edges "
        f"({time.perf_counter() - t0:.1f} s in NumPy)")
    args = [jax.numpy.asarray(x) for x in (
        batch.annotations, batch.edge_src, batch.edge_dst, batch.edge_type,
        batch.edge_mask)]
    with jax.default_matmul_precision("highest"):
        h32 = jax.jit(lambda p, *a: propagate(p, cfg32, *a))(
            params["prop"], *args)
    h16 = jax.jit(lambda p, *a: propagate(p, _model(sz), *a))(
        params["prop"], *args)
    ok = compare("xla f32-highest states vs oracle", np.asarray(h32)[:n],
                 want, "f32_oracle")
    ok &= compare("xla bf16 states vs oracle", np.asarray(h16)[:n], want,
                  "bf16")
    return ok


# ---------------------------------------------------------------- phase 4
def phase_backends(sz: Sizes, keep: dict) -> bool:
    import jax

    from ggnn import benchlib
    from ggnn.models import init_params
    ok = True
    # onehot on the uniform graph of phase 3 (same params, same reference)
    batch = _graph(sz)
    n_dir = int(batch.edge_mask.sum())
    cfg = _model(sz, backend="onehot")
    params = init_params(jax.random.PRNGKey(0), cfg)
    arrays = _device_arrays(batch)
    t0 = time.perf_counter()
    lay = benchlib.backend_layout("onehot", batch, cfg.n_message_types)
    log(f"  onehot layout built in {time.perf_counter() - t0:.3f} s "
        "(host, set-up)")
    ok &= _run_backend("onehot", cfg, params, arrays, lay,
                       keep["uniform_ref"], sz, n_dir)
    log_memory("onehot full width")
    del batch, arrays, lay

    # window on the community graph, against the xla reference there
    n_comm = max(sz.nodes // sz.communities, 1)
    batch = _graph(sz, communities=n_comm)
    n_dir = int(batch.edge_mask.sum())
    log(f"  community graph: {n_comm} communities of {sz.communities} "
        f"nodes, p_intra 0.95, {n_dir} directed edges")
    arrays = _device_arrays(batch)
    ref = _reference(_model(sz, compute_dtype="float32"), params, arrays)
    ok &= _run_backend("xla community", _model(sz), params, arrays, None,
                       ref, sz, n_dir)
    t0 = time.perf_counter()
    lay = benchlib.backend_layout("window", batch, cfg.n_message_types,
                                  window=sz.window,
                                  block_rows=sz.block_rows)
    log(f"  window layout built in {time.perf_counter() - t0:.3f} s "
        f"(host, set-up): {lay.stats}")
    ok &= _run_backend("window", _model(sz, backend="window"), params,
                       arrays, lay, ref, sz, n_dir)
    ok &= _run_backend("window q8 serving",
                       _model(sz, backend="window", fuse_gru=True,
                              quantized_table=True),
                       params, arrays, lay, ref, sz, n_dir, train=False,
                       tol="q8")
    log_memory("window full width")
    ok &= _gru_times(sz)
    return ok


def _gru_times(sz: Sizes) -> bool:
    """The jnp GRU cell alone at N = nodes, D = dim (bf16 matmul inputs,
    f32 state): forward, and forward + backward."""
    import jax
    import jax.numpy as jnp

    from ggnn import benchlib
    from ggnn.models import init_params
    from ggnn.models.ggnn import gru_update
    gru = init_params(jax.random.PRNGKey(0), _model(sz))["prop"]["gru"]
    h = jax.random.normal(jax.random.PRNGKey(1), (sz.nodes, sz.dim))
    a = jax.random.normal(jax.random.PRNGKey(2), (sz.nodes, sz.dim))
    fwd = jax.jit(lambda g, h, a: gru_update(g, h, a,
                                             matmul_dtype=jnp.bfloat16))
    vjp = jax.jit(jax.grad(
        lambda g, h, a: jnp.sum(gru_update(g, h, a,
                                           matmul_dtype=jnp.bfloat16) ** 2),
        argnums=(0, 1, 2)))
    log_time(f"GRU cell forward N={sz.nodes} D={sz.dim}",
             benchlib.time_call(lambda: fwd(gru, h, a), iters=sz.iters))
    log_time(f"GRU cell forward+backward N={sz.nodes} D={sz.dim}",
             benchlib.time_call(lambda: vjp(gru, h, a), iters=sz.iters))
    return benchlib.finite(vjp(gru, h, a))


# ---------------------------------------------------------------- phase 5
def phase_predictor(sz: Sizes) -> bool:
    import jax
    import jax.numpy as jnp

    from ggnn.data import TASKS, generate_task_file
    from ggnn.data.babi import parse_graph_text
    from ggnn.graph import batch_graphs
    from ggnn.infer import Predictor
    from ggnn.models import forward
    pred = Predictor.for_task(4)
    exs = parse_graph_text(generate_task_file(4, sz.predictor_graphs,
                                              seed=3), TASKS[4])
    ann_dim = TASKS[4].annotation_dim
    graphs = []
    for e in exs[:sz.predictor_graphs]:
        ann = np.zeros((e.n_nodes, ann_dim), np.float32)
        ann[e.args[0], 0] = 1.0
        graphs.append(dict(n_nodes=e.n_nodes, edges=e.edges,
                           annotations=ann, targets={}))
    got = pred.predict(graphs)
    want = []
    B = pred.spec.n_graphs
    for i in range(0, len(graphs), B):
        b = batch_graphs(graphs[i:i + B], pred.spec)
        scores = np.asarray(forward(pred.params, pred.cfg,
                                    jax.tree.map(jnp.asarray, b.arrays),
                                    B))
        offs = np.concatenate([[0], np.cumsum(b.n_nodes)])
        want += [int(np.argmax(scores[offs[g]:offs[g + 1]]))
                 for g in range(len(graphs[i:i + B]))]
    ok = got == want and len(got) == len(graphs)
    log(f"  predictor task 4: {len(got)} graphs, predictions {got} "
        f"{'match' if ok else 'DIFFER FROM'} api.forward {want}")
    return ok


# ----------------------------------------------------------- --devices 4
def phase_sharded(ss: ShardSizes) -> bool:
    import jax
    import jax.numpy as jnp
    import optax

    from ggnn import benchlib
    from ggnn.data.synthetic import synthetic_batch
    from ggnn.models import ModelConfig, init_params
    from ggnn.models.ggnn import propagate
    from ggnn.parallel import (make_mesh, make_sharded_task_train_step,
                               partition_batch, sharded_propagate)
    from ggnn.parallel.partition import (build_halo_scatter_layouts,
                                         build_halo_window_layouts,
                                         split_local_remote)
    from ggnn.parallel.train import make_gspmd_train_step, shard_batch_arrays
    from ggnn.train.loop import make_train_step

    P = ss.devices
    batch = synthetic_batch(ss.nodes, ss.edges, ss.types, annotation_dim=8,
                            seed=0, node_mult=128 * P,
                            n_communities=ss.communities, p_intra=0.95)
    n_dir = int(batch.edge_mask.sum())
    log(f"  sharded graph: {ss.nodes} nodes ({batch.spec.n_pad} padded), "
        f"{n_dir} directed edges, {ss.communities} communities, "
        f"D={ss.dim}, {P} devices")
    cfg = ModelConfig(state_dim=ss.dim, annotation_dim=8,
                      n_edge_types=ss.types, n_steps=ss.steps,
                      head="node_select")
    params = init_params(jax.random.PRNGKey(0), cfg)
    args = [jnp.asarray(x) for x in (
        batch.annotations, batch.edge_src, batch.edge_dst, batch.edge_type,
        batch.edge_mask)]
    hi = jax.default_matmul_precision("highest")
    with hi:
        ref = np.asarray(jax.jit(lambda p, *a: propagate(p, cfg, *a))(
            params["prop"], *args))
    del args
    mesh = make_mesh(n_graph=P)
    t0 = time.perf_counter()
    parts = split_local_remote(partition_batch(batch, P))
    layouts = {"halo_onehot": build_halo_scatter_layouts(parts, tile_e=512),
               "halo_window": build_halo_window_layouts(
                   parts, n_message_types=cfg.n_message_types)}
    log(f"  partition + per-shard layouts: {time.perf_counter() - t0:.1f} s "
        f"(host, set-up); halo rows H={parts.halo_size}")
    ok = True
    for strategy in ("halo", "all_gather", "halo_overlap", "halo_onehot",
                     "halo_window"):
        lay = layouts.get(strategy)
        lay_meta = lay[1] if lay else None

        @jax.jit
        def run(prop, parts, lay_arrays):
            return sharded_propagate(
                prop, cfg, mesh, parts, strategy=strategy,
                halo_layouts=(lay_arrays, lay_meta) if lay else None)

        with hi:
            t = benchlib.time_call(
                lambda: run(params["prop"], parts, lay[0] if lay else None),
                iters=3)
            got = np.asarray(run(params["prop"], parts,
                                 lay[0] if lay else None))
        log_time(f"sharded {strategy} forward", t, n_dir, ss.steps)
        ok &= compare(f"sharded {strategy} vs single-card propagate",
                      got, ref, "sharded")
    log_memory("sharded forwards")

    # one task train step, sharded (halo_overlap) and GSPMD, against the
    # single-device step.  Plain SGD: the update is lr × gradient, so the
    # comparison is as well conditioned as the gradients themselves (an
    # Adam first step is lr × sign(g), which flips on near-zero entries)
    opt = optax.sgd(0.1)
    targets = {"node": jnp.zeros((1,), jnp.int32),
               "n_nodes": jnp.asarray(batch.n_nodes)}
    arrays = jax.tree.map(jnp.asarray, batch.arrays)
    with hi:
        single = make_train_step(cfg, 1, opt)
        p_ref, _, m_ref = single(jax.tree.map(jnp.array, params),
                                 opt.init(params), arrays)
        sstep = make_sharded_task_train_step(cfg, mesh, opt, 1,
                                             strategy="halo_overlap")
        p_sh, _, m_sh = sstep(jax.tree.map(jnp.array, params),
                              opt.init(params), parts, targets)
        gmesh = make_mesh(n_graph=P // 2, n_data=2) if P % 2 == 0 else mesh
        gstep = make_gspmd_train_step(cfg, 1, opt, gmesh)
        p_gs, _, m_gs = gstep(jax.tree.map(jnp.array, params),
                              opt.init(params),
                              shard_batch_arrays(arrays, gmesh))
    def delta(p_new):
        return jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                            p_new, params)

    for name, p_, m_ in (("sharded task step (halo_overlap)", p_sh, m_sh),
                         ("GSPMD step", p_gs, m_gs)):
        ok &= compare(f"{name} loss vs single device",
                      np.float64(m_["loss_sum"]),
                      np.float64(m_ref["loss_sum"]), "sharded")
        ok &= compare_tree(f"{name} SGD update vs single device",
                           delta(p_), delta(p_ref), "sharded")
    log_memory("sharded train steps")
    return ok


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="4: run only the sharded phase on four GPUs")
    args = ap.parse_args(argv)

    from ggnn.runtime import enable_compile_cache
    enable_compile_cache()
    rec = phase_device(expect_count=args.devices)
    t_all = time.perf_counter()
    if args.devices == 4:
        phases = [("sharded", lambda: phase_sharded(ShardSizes()))]
    else:
        sz, keep = Sizes(), {}
        phases = [("trainer", lambda: phase_trainer(sz)),
                  ("full width xla", lambda: phase_full_width(sz, keep)),
                  ("backends", lambda: phase_backends(sz, keep)),
                  ("predictor", lambda: phase_predictor(sz))]
    failed = []
    for name, fn in phases:
        log(f"phase {name}:")
        t0 = time.perf_counter()
        try:
            good = bool(fn())
        except Exception:  # report, keep going, fail at the end
            traceback.print_exc(file=sys.stdout)
            good = False
        log(f"phase {name}: {'ok' if good else 'FAILED'} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not good:
            failed.append(name)
    log(f"total {time.perf_counter() - t_all:.1f} s; failed phases: "
        f"{failed or 'none'}")
    from ggnn.runtime import gpu_name_and_power_limit
    log(f"nvidia-smi name, power.limit: {gpu_name_and_power_limit()}")
    print(json.dumps({"ok": not failed, "device": rec}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
