"""GGNN propagation core: T-step typed-message + GRU recurrence under lax.scan.

A redesign of the reference's Python step loop over dense ``bmm``
(SURVEY.md §3.2): typed sparse aggregation (:mod:`ggnn.ops`) feeding a
GRU whose three a-projections are fused into one [D, 3D] matmul; the
whole recurrence is a single ``lax.scan`` inside jit (SURVEY.md §2.1
C5/C6).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ggnn.models.config import ModelConfig
from ggnn.ops.segment import typed_aggregate


def init_state(annotations: jax.Array, state_dim: int) -> jax.Array:
    """h^(1) = pad(x, D) (SURVEY.md §2.3)."""
    n, a = annotations.shape
    return jnp.pad(annotations, ((0, 0), (0, state_dim - a)))


def gru_update(gru: dict, h: jax.Array, a: jax.Array,
               fused: tuple | None = None,
               matmul_dtype=None) -> jax.Array:
    """GRU cell (SURVEY.md §2.1 C6).  If ``fused`` is given it is the
    precomputed (W_a[D,3D], b[3D], U_zr[D,2D]) concatenation — one matmul
    for all three a-projections and one for the z/r h-projections.

    ``matmul_dtype`` (e.g. bf16) casts the MATMUL INPUTS only — gates,
    state and accumulation stay f32 (bf16 matmuls run on the tensor cores
    at several times the f32 rate).  Production sets this to the
    aggregation compute dtype; the paper-parity default keeps full f32.

    The cell carries a custom VJP with MINIMAL residuals (z, r, h̃ — in
    ``matmul_dtype`` when set): XLA's default AD keeps the [N, 3D]
    pre-activation projections and every gate intermediate per step,
    about 3× the traffic the math needs.  Gate gradients recompute from
    the saved gates (σ' = z(1−z) etc.)."""
    if fused is None:
        fused = fuse_gru(gru)
    w_a, b_all, u_zr = fused
    mdt = jnp.dtype(matmul_dtype).name if matmul_dtype is not None else None
    return _gru_core(mdt, w_a, b_all, u_zr, gru["uh"], h, a)


def _gru_fwd_math(mdt, w_a, b_all, u_zr, uh, h, a):
    D = h.shape[-1]
    proj_a = _mm(mdt, a, w_a) + b_all
    proj_h = _mm(mdt, h, u_zr)
    az, ar, ah = proj_a[..., :D], proj_a[..., D:2 * D], proj_a[..., 2 * D:]
    hz, hr = proj_h[..., :D], proj_h[..., D:]
    z = jax.nn.sigmoid(az + hz)
    r = jax.nn.sigmoid(ar + hr)
    htil = jnp.tanh(ah + _mm(mdt, r * h, uh))
    return (1.0 - z) * h + z * htil, z, r, htil


def _mm(mdt, x, w):
    if mdt is not None:
        x, w = x.astype(mdt), w.astype(mdt)
    return jnp.dot(x, w, preferred_element_type=jnp.float32)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _gru_core(mdt, w_a, b_all, u_zr, uh, h, a):
    return _gru_fwd_math(mdt, w_a, b_all, u_zr, uh, h, a)[0]


def _gru_core_fwd(mdt, w_a, b_all, u_zr, uh, h, a):
    out, z, r, htil = _gru_fwd_math(mdt, w_a, b_all, u_zr, uh, h, a)
    rdt = h.dtype if mdt is None else mdt
    # `a` only feeds aᵀ·dp matmuls in the backward, which cast to the
    # matmul dtype anyway — storing it narrow is lossless for them and
    # drops a [N, D] f32 residual per scan step (the 0-d witness keeps
    # the da cotangent in the primal's dtype).  `h` is stored narrow too:
    # its backward consumers are matmuls (cast anyway) and elementwise
    # terms against the already-narrow z/r/h̃ — and the narrow copy CSEs
    # with the aggregation VJP's saved h.astype(cdt), so the scan stacks
    # ONE bf16 [N, D] per step instead of bf16 + f32
    res = (w_a, u_zr, uh, h.astype(rdt), jnp.zeros((), h.dtype),
           a.astype(rdt), jnp.zeros((), a.dtype),
           z.astype(rdt), r.astype(rdt), htil.astype(rdt))
    return out, res


def _gru_core_bwd(mdt, res, g):
    w_a, u_zr, uh, h, h_wit, a, a_wit, z, r, htil = res
    h = h.astype(jnp.float32)
    z = z.astype(jnp.float32)
    r = r.astype(jnp.float32)
    htil = htil.astype(jnp.float32)
    D = h.shape[-1]
    dz = g * (htil - h)
    dh = g * (1.0 - z)
    dq = (g * z) * (1.0 - htil * htil)        # grad at the tanh preact
    drh = _mm(mdt, dq, uh.T)
    duh = _mm(mdt, (r * h).T, dq)
    dr = drh * h
    dh = dh + drh * r
    dpz = dz * z * (1.0 - z)
    dpr = dr * r * (1.0 - r)
    if mdt is not None:
        # pre-cast once: each grad row feeds two matmuls below, and the
        # concatenated-[N, 3D] form would materialize 400 MB of f32 at
        # the headline config just to slice it again
        dpz, dpr, dq = (x.astype(mdt) for x in (dpz, dpr, dq))
    da = (_mm(mdt, dpz, w_a[:, :D].T) + _mm(mdt, dpr, w_a[:, D:2 * D].T)
          + _mm(mdt, dq, w_a[:, 2 * D:].T))
    dw_a = jnp.concatenate(
        [_mm(mdt, a.T, dpz), _mm(mdt, a.T, dpr), _mm(mdt, a.T, dq)], axis=1)
    db = jnp.concatenate(
        [jnp.sum(x, axis=0, dtype=jnp.float32) for x in (dpz, dpr, dq)])
    dh = dh + _mm(mdt, dpz, u_zr[:, :D].T) + _mm(mdt, dpr, u_zr[:, D:].T)
    du_zr = jnp.concatenate([_mm(mdt, h.T, dpz), _mm(mdt, h.T, dpr)], axis=1)
    return (dw_a.astype(w_a.dtype), db.astype(w_a.dtype),
            du_zr.astype(u_zr.dtype), duh.astype(uh.dtype),
            dh.astype(h_wit.dtype), da.astype(a_wit.dtype))


_gru_core.defvjp(_gru_core_fwd, _gru_core_bwd)


def fuse_gru(gru: dict) -> tuple:
    """Concatenate gate weights once (outside the scan) for fused matmuls."""
    w_a = jnp.concatenate([gru["wz"], gru["wr"], gru["wh"]], axis=1)
    b_all = jnp.concatenate([gru["bz"], gru["br"], gru["bh"]], axis=0)
    u_zr = jnp.concatenate([gru["uz"], gru["ur"]], axis=1)
    return w_a, b_all, u_zr


def propagate(prop: dict, cfg: ModelConfig, annotations: jax.Array,
              edge_src: jax.Array, edge_dst: jax.Array, edge_type: jax.Array,
              edge_mask: jax.Array, h0: jax.Array | None = None,
              collect_states: bool = False, scatter_layout=None):
    """Run T propagation steps; returns final h [N, D] (and, if
    ``collect_states``, the stacked per-step states [T, N, D] for the
    oracle-parity tests, BASELINE.json:5).

    ``scatter_layout`` is the host-built layout of the ``onehot`` backend
    (a layout, or a list of chunk layouts from
    :func:`ggnn.ops.onehot.build_chunked_dst_layouts`) or of the
    ``window`` backend; pass it through the jitted function's arguments."""
    h = init_state(annotations, cfg.state_dim) if h0 is None else h0
    fused = fuse_gru(prop["gru"])
    # aggregation compute dtype (bf16 halves the gather/scatter memory
    # traffic; accumulation stays f32 via preferred_element_type, GRU
    # state stays f32 — SURVEY.md §7.2.4)
    cdt = jnp.dtype(cfg.compute_dtype)
    msg_w_c = prop["msg_w"].astype(cdt)
    msg_b_c = prop["msg_b"].astype(cdt)
    # GRU matmul-input dtype follows the aggregation compute dtype; gates,
    # state and accumulation stay f32 either way
    gmm = cdt if (cfg.gru_matmul_compute
                  and cdt != jnp.dtype(jnp.float32)) else None

    def edge_gate(h):
        """SDDMM edge-feature gates g_uv = σ(⟨h_u·P, h_v·Q⟩)
        (BASELINE.json:5), folded into the edge mask."""
        if not cfg.edge_gates:
            return edge_mask
        from ggnn.ops.segment import sddmm
        p = jnp.dot(h, prop["gate_p"], preferred_element_type=jnp.float32)
        q = jnp.dot(h, prop["gate_q"], preferred_element_type=jnp.float32)
        return edge_mask * jax.nn.sigmoid(
            sddmm(p, q, edge_src, edge_dst, edge_mask))

    if cfg.backend == "onehot":
        # destination-block layout (ops/onehot.py): host-built, topology-
        # static, reused every step
        from ggnn.ops.onehot import (aggregate_onehot,
                                     aggregate_onehot_chunked,
                                     build_dst_block_layout)
        if isinstance(scatter_layout, (list, tuple)):
            chunks = list(scatter_layout)

            def aggregate(h):
                return aggregate_onehot_chunked(h, chunks, msg_w_c, msg_b_c)
        else:
            if scatter_layout is None:
                if isinstance(edge_src, jax.core.Tracer):
                    raise ValueError(
                        "backend='onehot' inside jit needs a precomputed "
                        "layout: build_dst_block_layout(...).to_device() "
                        "outside jit, passed through the jitted function's "
                        "arguments as scatter_layout")
                scatter_layout = build_dst_block_layout(
                    np.asarray(edge_src), np.asarray(edge_dst),
                    np.asarray(edge_type), np.asarray(edge_mask),
                    h.shape[0])

            def aggregate(h):
                return aggregate_onehot(h, scatter_layout, msg_w_c, msg_b_c)

        def step(h, _):
            a = aggregate(h.astype(cdt))
            h_new = gru_update(prop["gru"], h, a, fused, matmul_dtype=gmm)
            return h_new, h_new if collect_states else None
    elif cfg.backend == "window":
        # block-CSR windowed aggregation (ops/window.py): the clustered-
        # graph path; low-locality edges spill to the per-edge scatter
        from ggnn.ops.window import aggregate_window, gru_window_step
        if scatter_layout is None:
            raise ValueError(
                "backend='window' needs a precomputed layout: "
                "build_window_layout(...) outside jit, passed through the "
                "jitted function's arguments as scatter_layout")

        if cfg.fuse_gru:
            # one step function: aggregation and GRU with its gate matmuls
            # in the compute dtype (and the optional int8 serving table)
            def step(h, _):
                h_new = gru_window_step(h, scatter_layout, msg_w_c, msg_b_c,
                                        prop["gru"],
                                        quantized=cfg.quantized_table)
                return h_new, h_new if collect_states else None
        else:
            def step(h, _):
                a = aggregate_window(h.astype(cdt), scatter_layout, msg_w_c,
                                     msg_b_c)
                h_new = gru_update(prop["gru"], h, a, fused,
                                   matmul_dtype=gmm)
                return h_new, h_new if collect_states else None
    else:
        def step(h, _):
            a = typed_aggregate(h.astype(cdt), edge_src, edge_dst, edge_type,
                                edge_gate(h), msg_w_c, msg_b_c,
                                strategy=cfg.agg_strategy)
            h_new = gru_update(prop["gru"], h, a, fused, matmul_dtype=gmm)
            return h_new, h_new if collect_states else None

    if cfg.remat and not collect_states:
        # trade FLOPs for memory: the backward pass recomputes each step's
        # aggregation instead of keeping T× node-state activations
        step = jax.checkpoint(step)
    h_final, states = jax.lax.scan(step, h, None, length=cfg.n_steps)
    if collect_states:
        return h_final, states
    return h_final
