"""Block-CSR windowed typed aggregation: the clustered-graph path, in plain
JAX.

On graphs with locality (communities, or power-law graphs numbered by
degree rank) the sources feeding one destination block concentrate in a
few ``window``-row ranges of the node-transform table.  This module
collapses the per-edge gather and scatter into one count matrix per
(dst block, source window) pair:

    C[v, w] = #edges (u → v) with table row t·N+u ≡ win·W + w
    out[block] = Σ_win C[block, win] · table[win·W : win·W+W]

i.e. a block-sparse SpMM with dense ``[block_rows, W]`` int8 count tiles,
computed as one batched matmul over the tiles (counts cast to the table's
dtype, f32 accumulation) whose per-tile products are summed into their
dst blocks.  Edges that land in low-occupancy tiles (cross-community
strays) SPILL to the per-edge path of :mod:`ggnn.ops.onehot`, so the
structure degrades gracefully on a uniform random graph.

Serving may quantize the table to int8 with power-of-2 per-window scales
(int8×int8→int32 products); training may quantize the aggregation's
cotangent the same way (``grad_quant``).  Parity with the XLA segment path
is tested on arbitrary topologies.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ggnn.ops.onehot import (BLOCK_N, build_dst_block_layout,
                                 node_table, scatter_rows,
                                 static_tile_budget)


@dataclasses.dataclass
class DeviceWindowLayout:
    """Jit-argument form of the windowed layout (registered pytree).

    ``meta`` = (n_nodes_pad, window, n_tiles, n_blocks, spill_meta,
    row_major, block_rows, grad_quant); ``spill_meta`` is None (no spill)
    or (spill_tile_e, xw_offsets) where ``xw_offsets`` — the static
    type-bucket offsets of the XW spill — is None for the table spill."""

    meta: tuple
    arrays: dict  # c_stream, tile_start, block_of_tile, win_of_tile, c_off
    #               [+ s_gather_idx, s_dst_global (+ sx_src) for the spill]

    @property
    def n_nodes_pad(self):
        return self.meta[0]

    @property
    def window(self):
        return self.meta[1]

    @property
    def n_tiles(self):
        return self.meta[2]

    @property
    def n_blocks(self):
        return self.meta[3]

    @property
    def spill_meta(self):
        return self.meta[4]

    @property
    def row_major(self):
        return self.meta[5]

    @property
    def block_rows(self):
        return self.meta[6]

    @property
    def grad_quant(self):
        return self.meta[7]


jax.tree_util.register_pytree_node(
    DeviceWindowLayout,
    lambda l: ((l.arrays,), l.meta),
    lambda meta, children: DeviceWindowLayout(meta=meta, arrays=children[0]))


def _type_buckets(sp_t, t2: int, bucket: int | None):
    """Static per-type bucket offsets for spilled edges sorted by type:
    each type's run is padded to a multiple of 8 (uniform width when that
    wastes little, so the transform is one batched einsum); ``bucket``
    pins a uniform width (stacking per-shard layouts).  Returns
    (offsets [t2+1], slot of each edge)."""
    cnt = np.bincount(sp_t, minlength=t2)
    if bucket is not None:
        if int(cnt.max(initial=0)) > bucket:
            raise ValueError(f"spill_bucket={bucket} < max per-type spill "
                             f"count {int(cnt.max())}")
        padded = np.full(t2, bucket, np.int64)
    else:
        padded = np.maximum(-(-cnt // 8) * 8, 8)
        pmax = int(padded.max())
        if t2 * pmax <= max(2 * int(padded.sum()), 4096):
            padded = np.full(t2, pmax, np.int64)
    offs = np.zeros(t2 + 1, np.int64)
    np.cumsum(padded, out=offs[1:])
    first_of_t = np.zeros(t2, np.int64)
    first_of_t[1:] = np.cumsum(cnt)[:-1]
    slot = offs[sp_t] + (np.arange(sp_t.shape[0]) - first_of_t[sp_t])
    return offs, slot


def _median_tile(dst, n_nodes_pad: int) -> int:
    """Spill tile size from the spill DENSITY: the median dst block's
    occupancy rounded up to a power of two in [128, 2048] (the median,
    not the mean, so skewed in-degree does not pad the long tail)."""
    cnts = np.bincount((dst // BLOCK_N).astype(np.int64),
                       minlength=n_nodes_pad // BLOCK_N)
    med = int(np.median(cnts)) if dst.size else 0
    tile = 128
    while tile < min(med, 2048):
        tile *= 2
    return tile


def build_window_layout(edge_src, edge_dst, edge_type, edge_mask,
                        n_nodes_pad: int, window: int = 512,
                        min_edges_per_tile: int = 32,
                        n_src_rows: int | None = None,
                        spill_tile_e: int | None = None,
                        n_message_types: int | None = None,
                        row_major: str = "src",
                        pad_tiles_to: int | None = None,
                        spill_pad_tiles_to: int | None = None,
                        force_spill: bool = False,
                        block_rows: int = BLOCK_N,
                        use_native: bool | None = None,
                        spill_bucket: int | None = None,
                        typed_spill: bool = False,
                        grad_quant: bool = False) -> DeviceWindowLayout:
    """Host-side (numpy) layout build: group real edges by
    (dst block, table-row window); tiles holding fewer than
    ``min_edges_per_tile`` edges spill to a per-edge layout.
    Topology-static — built once per batch, reused across steps/rounds.

    ``row_major`` picks the node-transform table layout:
    - ``'block'``: row = (src//128)·T2·128 + t·128 + src%128 — a 128-node
      source block's rows across all types are contiguous; needs
      n_src_rows % 128 == 0 (and serves the int8 table).
    - ``'src'``: row = src·T2 + t — a community's rows across ALL message
      types are contiguous, so one window of ``csize·T2`` rows covers a
      dst block's whole in-edge set.
    - ``'type'``: row = t·N + src — smaller windows when types are sparse.

    ``stats`` (attached to the returned layout as ``.stats``) reports the
    tile count, stream bytes, and spill fraction.

    ``typed_spill`` selects the XW spill: spilled edges gather ``h`` rows
    directly and are transformed in type-major buckets, instead of
    gathering rows of the [T2·N, D] table.  ``spill_bucket`` pins its
    uniform bucket width (per-shard layouts must share static meta).

    ``grad_quant``: the backward pass quantizes the aggregation's
    cotangent to int8 per dst block (power-of-2 scales) and runs the
    transposed count product as int8×int8→int32."""
    if block_rows % BLOCK_N:
        raise ValueError(f"block_rows must be a multiple of {BLOCK_N}")
    if n_nodes_pad % block_rows:
        raise ValueError("n_nodes_pad must be a multiple of block_rows")
    if row_major not in ("block", "src", "type"):
        raise ValueError(
            f"row_major must be 'block', 'src' or 'type': {row_major!r}")
    if n_src_rows is None:
        n_src_rows = n_nodes_pad
    real = np.asarray(edge_mask) > 0
    src = np.asarray(edge_src)[real].astype(np.int64)
    dst = np.asarray(edge_dst)[real].astype(np.int64)
    typ = np.asarray(edge_type)[real].astype(np.int64)
    n_edges = src.shape[0]

    t2 = (n_message_types if n_message_types is not None
          else int(typ.max(initial=0)) + 1)
    if row_major == "block":
        if n_src_rows % 128:
            raise ValueError("row_major='block' needs n_src_rows % 128 == 0")
        rows = (src // 128) * (t2 * 128) + typ * 128 + src % 128
    elif row_major == "src":
        rows = src * t2 + typ
    else:
        rows = typ * n_src_rows + src
    n_wins = -(-t2 * n_src_rows // window)
    win = rows // window
    block = dst // block_rows
    n_blocks = n_nodes_pad // block_rows
    key = block * n_wins + win
    max_count = 127   # int8 counts

    # native (C++) plan: one radix sort replaces the np.unique passes and
    # the count-stream np.add.at fill (np.unique dominates the host build
    # at 8M+ edges); the numpy path is the reference, tested identical
    plan = None
    if use_native is None:
        use_native = n_edges >= 200_000
    if use_native:
        from ggnn import native as _native
        if _native.available():
            plan = _native.WindowPlanNative(
                rows, dst, window, block_rows, n_wins, n_blocks,
                min_edges_per_tile, max_count)
            if not plan.ok:
                plan = None

    if plan is not None:
        keep = plan.keep
    else:
        uniq, inv, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
        keep = (counts >= min_edges_per_tile)[inv]
        # int8 count saturation: multigraph pairs repeating >127 times
        # (hub-hub edges in scale-free graphs) spill to the per-edge
        # path, which handles duplicates naturally
        pair = rows * np.int64(n_nodes_pad) + dst
        _, pinv, pcounts = np.unique(pair, return_inverse=True,
                                     return_counts=True)
        keep &= pcounts[pinv] <= max_count

    def decode_rows(r):
        """table row → (type, src) for this row_major."""
        if row_major == "block":
            rpb = t2 * 128
            return (r % rpb) // 128, (r // rpb) * 128 + r % 128
        if row_major == "src":
            return r % t2, r // t2
        return r // n_src_rows, r % n_src_rows

    spill = None
    xw_offs = None
    sx_src = None
    spill_frac = 1.0 - (float(keep.sum()) / max(n_edges, 1))
    if (~keep).any() or force_spill:
        n_spill = int((~keep).sum())
        sp_d = dst[~keep]
        if spill_tile_e is None:
            spill_tile_e = _median_tile(sp_d, n_nodes_pad)
        if typed_spill:
            # XW spill: transform gathered h rows in type-major static
            # buckets, then scatter the transformed pack; the spill
            # layout's "source row" is each edge's bucket slot
            sp_t, sp_u = decode_rows(rows[~keep])
            order = np.argsort(sp_t * np.int64(n_src_rows) + sp_u,
                               kind="stable")
            spt, spu, sp_d = sp_t[order], sp_u[order], sp_d[order]
            offs, slot = _type_buckets(spt, t2, spill_bucket)
            sx_src = np.full(int(offs[-1]), n_src_rows, np.int64)
            sx_src[slot] = spu                  # pad slots → masked
            xw_offs = tuple(int(o) for o in offs)
            sp_rows, n_rows = slot, int(offs[-1])
        else:
            # spilled edges gather from the SAME table the windows read
            sp_rows, n_rows = rows[~keep], t2 * n_src_rows
        spill = build_dst_block_layout(
            sp_rows, sp_d, np.zeros(n_spill, np.int64),
            np.ones(n_spill, np.float32), n_nodes_pad,
            tile_e=spill_tile_e, n_src_rows=n_rows,
            pad_tiles_to=spill_pad_tiles_to,
            edge_align=(16 if spill_tile_e % 16 == 0 else None))

    # dense tiles (+ one dummy tile per block, so every output block has a
    # tile).  The count STREAM holds REAL tiles only: dummies are marked
    # win_of_tile = -1 and ``c_off`` maps each real tile to its stream
    # slot
    real_keys = (plan.dense_keys if plan is not None
                 else np.unique(key[keep]))
    dummy = np.arange(n_blocks, dtype=np.int64) * n_wins
    uniq_t = np.unique(np.concatenate([real_keys, dummy]))
    n_tiles = uniq_t.shape[0]
    n_real = real_keys.shape[0]
    is_real = np.isin(uniq_t, real_keys, assume_unique=True)
    block_of_tile = (uniq_t // n_wins).astype(np.int32)
    win_of_tile = np.where(is_real, uniq_t % n_wins, -1).astype(np.int32)
    c_off = np.zeros(n_tiles, np.int32)
    c_off[is_real] = np.arange(n_real, dtype=np.int32)
    tile_counts = np.bincount(block_of_tile, minlength=n_blocks)
    tile_start = np.zeros(n_blocks + 1, np.int32)
    np.cumsum(tile_counts, out=tile_start[1:])

    if pad_tiles_to is not None:
        # append no-op dummy tiles to the LAST block (stacking layouts of
        # different topologies — e.g. per-shard — to equal shapes)
        extra = pad_tiles_to - n_tiles
        if extra < 0:
            raise ValueError(f"pad_tiles_to={pad_tiles_to} < {n_tiles}")
        if extra:
            block_of_tile = np.concatenate(
                [block_of_tile, np.full(extra, n_blocks - 1, np.int32)])
            win_of_tile = np.concatenate(
                [win_of_tile, np.full(extra, -1, np.int32)])
            c_off = np.concatenate([c_off, np.zeros(extra, np.int32)])
            tile_start[-1] += extra
            n_tiles = pad_tiles_to

    # static-budget layouts pad the stream too (compiled-once serving
    # needs topology-independent array shapes)
    stream_tiles = (pad_tiles_to if pad_tiles_to is not None
                    else max(n_real, 1))
    if plan is not None:
        c = plan.fill_counts(real_keys, total_tiles=stream_tiles)
    else:
        tile_of_edge = np.searchsorted(real_keys, key[keep])
        c = np.zeros((stream_tiles * block_rows, window), np.int8)
        np.add.at(c, (tile_of_edge * block_rows
                      + (dst[keep] - block[keep] * block_rows),
                      rows[keep] % window), 1)
        if int(c.sum(dtype=np.int64)) != int(keep.sum()):
            raise ValueError("count-matrix overflow: >127 duplicate edges "
                             "for one (dst, table-row) pair within a tile")

    arrays = {"c_stream": jnp.asarray(c),
              "tile_start": jnp.asarray(tile_start),
              "block_of_tile": jnp.asarray(block_of_tile),
              "win_of_tile": jnp.asarray(win_of_tile),
              "c_off": jnp.asarray(c_off)}
    spill_meta = None
    if spill is not None:
        arrays["s_gather_idx"] = jnp.asarray(spill.gather_idx)
        arrays["s_dst_global"] = jnp.asarray(spill.dst_global)
        if sx_src is not None:
            arrays["sx_src"] = jnp.asarray(sx_src.astype(np.int32))
        spill_meta = (spill.tile_e, xw_offs)
    lay = DeviceWindowLayout(
        meta=(n_nodes_pad, window, n_tiles, n_blocks, spill_meta, row_major,
              block_rows, grad_quant),
        arrays=arrays)
    lay.stats = {
        "n_tiles": int(n_tiles), "n_edges": int(n_edges),
        "spill_frac": spill_frac, "window": window,
        "stream_gb": int(c.shape[0]) * c.shape[1] * 1e-9,
        "table_reads_gb": n_real * window * 2 * 1e-9,  # ×D at use time
        "spill_pack": (int(arrays["s_gather_idx"].shape[0])
                       if "s_gather_idx" in arrays else 0),
        "spill_tiles": (int(spill.tile_start[-1]) if spill is not None
                        else 0),
    }
    return lay


def window_layout_for_batch(batch, window: int = 512,
                            min_edges_per_tile: int = 32,
                            spill_tile_e: int = 128,
                            block_rows: int = BLOCK_N) -> DeviceWindowLayout:
    """Static-budget windowed layout for a GraphBatch: tile counts padded
    to topology-independent bounds (dense tiles ≤ e_pad/min_edges + one
    dummy per block; spill ≤ the one-hot static budget), so a jitted
    serving/eval step compiles once across batches."""
    spec = batch.spec
    t2 = 2 * spec.n_edge_types
    n_dst = -(-spec.n_pad // block_rows) * block_rows
    budget = spec.e_pad // min_edges_per_tile + n_dst // block_rows
    # block-major tables need 128-padded nodes; src-major otherwise
    row_major = "block" if spec.n_pad % 128 == 0 else "src"
    return build_window_layout(
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        n_dst, window=window, min_edges_per_tile=min_edges_per_tile,
        spill_tile_e=spill_tile_e, n_message_types=t2, row_major=row_major,
        n_src_rows=spec.n_pad, block_rows=block_rows,
        pad_tiles_to=budget, force_spill=True,
        spill_pad_tiles_to=static_tile_budget(spec.e_pad, n_dst,
                                              spill_tile_e))


def _stream_tiles(n_stream, block_of_tile, win_of_tile, c_off, n_blocks):
    """Window and dst block of each count-stream tile (tile t's counts
    are stream tile ``c_off[t]``).  Dummy tiles (``win_of_tile < 0``) map
    to no stream tile; stream tiles no real tile maps to (static padding)
    get block ``n_blocks``, which the block sum drops."""
    sid = jnp.where(win_of_tile >= 0, c_off, n_stream)
    st_win = jnp.zeros(n_stream, jnp.int32).at[sid].set(
        win_of_tile, mode="drop")
    st_blk = jnp.full(n_stream, n_blocks, jnp.int32).at[sid].set(
        block_of_tile, mode="drop")
    return st_win, st_blk


def _quantize_pow2(x, axes):
    """int8 values with one power-of-2 scale per slice (max over ``axes``):
    q = round(x / 2^e), |q| ≤ 127.  Returns (q int8, scale f32 with
    ``axes`` kept as size-1 dims)."""
    m = jnp.max(jnp.abs(x), axis=axes, keepdims=True)
    e = jnp.clip(jnp.ceil(jnp.log2(jnp.maximum(m, 1e-30) / 127.0)),
                 -100.0, 100.0).astype(jnp.int32)
    # ldexp: exact powers of two (exp2 may round in the last place)
    q = jnp.clip(jnp.round(jnp.ldexp(x, -e)), -127, 127).astype(jnp.int8)
    return q, jnp.ldexp(jnp.ones(e.shape, jnp.float32), e)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def _count_spmm(table, c_tiles, st_win, st_blk, n_blocks, grad_quant):
    """out[b] = Σ_{stream tiles s of block b} C_s · table window(s).

    ``table`` [n_wins·W, D]; ``c_tiles`` [S, block_rows, W] int8 counts;
    returns [n_blocks, block_rows, D] f32.  The backward is the
    transposed product (exact, or int8 with ``grad_quant``) and keeps
    nothing but the layout arrays."""
    W = c_tiles.shape[-1]
    windows = table.reshape(-1, W, table.shape[-1])[st_win]
    prod = jnp.einsum("sow,swd->sod", c_tiles.astype(table.dtype), windows,
                      preferred_element_type=jnp.float32)
    return jax.ops.segment_sum(prod, st_blk, num_segments=n_blocks)


def _count_spmm_fwd(table, c_tiles, st_win, st_blk, n_blocks, grad_quant):
    out = _count_spmm(table, c_tiles, st_win, st_blk, n_blocks, grad_quant)
    witness = jnp.zeros((table.shape[0], 0), table.dtype)
    return out, (witness, c_tiles, st_win, st_blk)


def _count_spmm_bwd(n_blocks, grad_quant, res, g):
    witness, c_tiles, st_win, st_blk = res
    n_rows, D = witness.shape[0], g.shape[-1]
    W = c_tiles.shape[-1]
    if grad_quant:
        q, scale = _quantize_pow2(g, axes=(1, 2))
        qs = jnp.take(q, st_blk, axis=0, mode="fill", fill_value=0)
        d_win = jax.lax.dot_general(
            c_tiles, qs, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32).astype(jnp.float32)
        d_win = d_win * jnp.take(scale, st_blk, axis=0, mode="fill",
                                 fill_value=0)
    else:
        # the cotangent enters in the table's dtype, like the forward's
        # table windows (f32 accumulation either way)
        gs = jnp.take(g.astype(witness.dtype), st_blk, axis=0, mode="fill",
                      fill_value=0)
        d_win = jnp.einsum("sow,sod->swd", c_tiles.astype(witness.dtype),
                           gs, preferred_element_type=jnp.float32)
    d_table = jax.ops.segment_sum(d_win, st_win, num_segments=n_rows // W)
    zero = functools.partial(np.zeros, dtype=jax.dtypes.float0)
    return (d_table.reshape(n_rows, D).astype(witness.dtype),
            zero(c_tiles.shape), zero(st_win.shape), zero(st_blk.shape))


_count_spmm.defvjp(_count_spmm_fwd, _count_spmm_bwd)


def window_block_spmm(table, c_stream, block_of_tile, win_of_tile, c_off,
                      n_blocks: int, window: int, out_rows: int = BLOCK_N):
    """out[b·out_rows:(b+1)·out_rows] = Σ_tiles(b) C_tile ·
    table[win·W:(win+1)·W], in f32.

    ``table`` rows must be a multiple of ``window`` (pad with zeros);
    ``c_stream`` [n_stream·out_rows, window] int8, tile t's counts at
    stream tile ``c_off[t]``.  Dummy tiles (``win_of_tile < 0``)
    contribute nothing."""
    R, D = table.shape
    if R % window:
        raise ValueError("table rows must be a multiple of window")
    c_tiles = c_stream.reshape(-1, out_rows, window)
    st_win, st_blk = _stream_tiles(c_tiles.shape[0], block_of_tile,
                                   win_of_tile, c_off, n_blocks)
    return _count_spmm(table, c_tiles, st_win, st_blk, n_blocks,
                       False).reshape(n_blocks * out_rows, D)


def node_table_block_major_q8(h, msg_w, msg_b, window: int):
    """Block-major node-transform table, int8-quantized per ``window``-row
    group with power-of-2 scales (the quantized SERVING path).  Returns
    (table_q [N·T2, D] int8, scales [n_wins, 1] f32); row r dequantizes
    as ``table_q[r] · scales[r // window]``."""
    N, D = h.shape
    T2 = msg_w.shape[0]
    if N % 128:
        raise ValueError("q8 table needs N % 128 == 0")
    if window % 128 or (T2 * 128) % window:
        raise ValueError("window must be a 128-multiple dividing T2*128")
    t = jnp.einsum("bsd,tdf->btsf", h.reshape(N // 128, 128, D), msg_w,
                   preferred_element_type=jnp.float32) \
        + msg_b.astype(jnp.float32)[None, :, None, :]
    q, scales = _quantize_pow2(t.reshape(-1, window, D), axes=(1, 2))
    return q.reshape(-1, D), scales.reshape(-1, 1)


def _window_product(table, layout: DeviceWindowLayout, scales=None):
    """Dense-tile part of the aggregation, [n_blocks·block_rows, D] f32.
    ``scales`` [n_wins] selects the int8 path (``table`` int8)."""
    W, block_rows, n_blocks = layout.window, layout.block_rows, \
        layout.n_blocks
    arrs = layout.arrays
    pad = (-table.shape[0]) % W
    if pad:
        table = jnp.pad(table, ((0, pad), (0, 0)))
    D = table.shape[-1]
    c_tiles = arrs["c_stream"].reshape(-1, block_rows, W)
    st_win, st_blk = _stream_tiles(c_tiles.shape[0], arrs["block_of_tile"],
                                   arrs["win_of_tile"], arrs["c_off"],
                                   n_blocks)
    if scales is None:
        out = _count_spmm(table, c_tiles, st_win, st_blk, n_blocks,
                          layout.grad_quant)
    else:
        windows = table.reshape(-1, W, D)[st_win]
        prod = jax.lax.dot_general(
            c_tiles, windows, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32).astype(jnp.float32)
        prod = prod * scales[st_win][:, None, None]
        out = jax.ops.segment_sum(prod, st_blk, num_segments=n_blocks)
    return out.reshape(n_blocks * block_rows, D)


def _spill_partial(h, table, layout: DeviceWindowLayout, msg_w, msg_b,
                   scales=None):
    """Spilled-edge aggregation, [n_nodes_pad, D] f32.

    XW layouts (static type-bucket offsets in ``spill_meta``) gather h
    [N, D] rows directly, transform them in type-major buckets (one
    batched einsum + bias when buckets are uniform), then scatter the
    transformed pack.  Table layouts gather rows of ``table``
    (dequantized through ``scales`` when the table is int8)."""
    arrs = layout.arrays
    xw_offs = layout.spill_meta[1]
    if xw_offs is not None:
        T2, D = msg_w.shape[0], msg_w.shape[2]
        N = h.shape[0]
        src = arrs["sx_src"]
        hc = h.astype(msg_w.dtype)
        # pad slots carry src == n_src_rows: zero their rows; their scatter
        # slots are padding and contribute nothing
        hsp = jnp.where((src < N)[:, None], hc[jnp.minimum(src, N - 1)], 0)
        widths = {xw_offs[t + 1] - xw_offs[t] for t in range(T2)}
        if len(widths) == 1:
            P = widths.pop()
            msgs = (jnp.einsum("tpd,tdf->tpf", hsp.reshape(T2, P, D),
                               msg_w, preferred_element_type=jnp.float32)
                    + msg_b[:, None, :].astype(jnp.float32)).reshape(-1, D)
        else:
            msgs = jnp.concatenate(
                [jnp.dot(hsp[xw_offs[t]:xw_offs[t + 1]], msg_w[t],
                         preferred_element_type=jnp.float32)
                 + msg_b[t].astype(jnp.float32) for t in range(T2)], axis=0)
        msgs = msgs.astype(msg_w.dtype)[arrs["s_gather_idx"]]
    elif scales is not None:
        idx = arrs["s_gather_idx"]
        msgs = (table[idx].astype(jnp.float32)
                * scales[idx // layout.window][:, None]).astype(msg_w.dtype)
    else:
        msgs = table[arrs["s_gather_idx"]]
    return scatter_rows(msgs, arrs["s_dst_global"], layout.n_nodes_pad)


def aggregate_window(h, layout: DeviceWindowLayout, msg_w, msg_b):
    """Full typed aggregation via the windowed block-CSR path (+ spill):
    a = Σ_tiles C · table_window (+ scatter of spilled edges), with
    table = h·W_t + b_t in ``h.dtype``.  Returns [N, D] f32."""
    N = h.shape[0]
    table = node_table(h, msg_w, msg_b, layout.row_major)
    out = _window_product(table, layout)
    if layout.spill_meta is not None:
        out = out + _spill_partial(h, table, layout, msg_w, msg_b)
    return out[:N]


def gru_window_step(h, layout: DeviceWindowLayout, msg_w, msg_b, gru: dict,
                    quantized: bool = False, extra_init=None):
    """One propagation step h → h': windowed aggregation in the compute
    dtype (``msg_w.dtype``), then the GRU with its gate matmuls in that
    dtype too (f32 accumulation and state).

    ``quantized``: int8 table with power-of-2 per-window scales
    (:func:`node_table_block_major_q8`) — the serving quantization mode;
    needs a row_major='block' layout.  It adds ~0.5 % relative noise to
    the aggregation; XW-spilled edges gather h and stay exact.

    ``extra_init`` [R ≤ N, D]: an externally-computed partial aggregation
    added into ``a`` before the GRU (the sharded halo path's remote-edge
    contribution)."""
    from ggnn.models.ggnn import gru_update
    N = h.shape[0]
    if extra_init is not None and extra_init.shape[0] > N:
        raise ValueError(
            f"extra_init has {extra_init.shape[0]} rows > h's {N}")
    cdt = msg_w.dtype
    hc = h.astype(cdt)
    if quantized:
        if layout.row_major != "block":
            raise ValueError("quantized serving needs row_major='block'")
        table, scales = node_table_block_major_q8(hc, msg_w, msg_b,
                                                  window=layout.window)
        scales = scales[:, 0]
        a = _window_product(table, layout, scales=scales)
        if layout.spill_meta is not None:
            a = a + _spill_partial(hc, table, layout, msg_w, msg_b,
                                   scales=scales)
        a = a[:N]
    else:
        a = aggregate_window(hc, layout, msg_w, msg_b)
    if extra_init is not None and extra_init.shape[0] > 0:
        a = a.at[:extra_init.shape[0]].add(extra_init.astype(jnp.float32))
    mdt = None if jnp.dtype(cdt) == jnp.dtype(jnp.float32) else cdt
    return gru_update(gru, h, a, matmul_dtype=mdt)
