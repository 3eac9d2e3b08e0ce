"""Destination-block scatter layouts and the ``onehot`` backend's
aggregation, in plain JAX.

A layout groups a batch's real directed edges by 128-row destination block
on the host (numpy, topology-static: built once per batch and reused
across all T steps and training iterations).  Each block's edges are
packed contiguously, padded to whole ``tile_e`` tiles (or to
``edge_align`` rows), so a layout can be padded to a static tile budget
and every batch of a run yields identically-shaped arrays — the jitted
step then compiles once.

The device side is two plain XLA expressions of the same sum the
reference's dense ``bmm`` computed (SURVEY.md §3.2):

- table layouts (:func:`build_dst_block_layout`): gather per-edge rows of
  the node-transform table (``h·W_t + b_t`` for every type), then
  ``segment_sum`` them into their destination rows;
- typed layouts (:func:`build_typed_dst_layout`): gather ``h`` rows
  directly, ``segment_sum`` them into a ``[T2·N, D]`` per-(type, dst)
  buffer, and apply every ``W_t`` afterwards as one batched matmul; the
  bias is ``Σ_t indeg_t(v)·b_t``.

Both are differentiated by JAX's autodiff (the transpose of a gather is a
scatter-add and vice versa).  Parity with the ``xla`` backend and the
NumPy oracle is tested.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

BLOCK_N = 128  # destination rows per layout block


def _rup_block(x: int) -> int:
    return ((x + BLOCK_N - 1) // BLOCK_N) * BLOCK_N


@dataclasses.dataclass
class DstBlockLayout:
    """Host-built, topology-static scatter layout (numpy arrays).

    - ``gather_idx`` [E_pack]: row index into the node-transform table
      (see ``row_order``); padding rows point at 0.
    - ``dst_local`` [E_pack]: ``dst − 128·block`` in [0,128), or −1
      padding.
    - ``dst_global`` [E_pack]: global dst row, or −1 padding.
    - ``tile_start`` [n_blocks+1]: first edge-tile of each dst block.
    - ``block_of_tile`` [n_tiles]: dst block of each packed tile.
    - ``edge_align``: with it, each block's edges are padded to an
      ``edge_align`` multiple instead of whole tiles (a shorter pack).
    """

    n_nodes_pad: int
    tile_e: int
    gather_idx: np.ndarray
    dst_local: np.ndarray
    tile_start: np.ndarray
    block_of_tile: np.ndarray
    dst_global: np.ndarray
    edge_align: "int | None" = None
    # table row space the gather indexes ('type' | 'block')
    row_order: str = "type"

    @property
    def n_blocks(self) -> int:
        return self.n_nodes_pad // BLOCK_N

    def to_device(self) -> "DeviceScatterLayout":
        """Move the arrays the aggregation reads onto the device as a
        jit-traversable pytree.  Pass it through a jitted function's
        ARGUMENTS: arrays closed over inside a traced function become
        compile-time constants baked into the program."""
        arrays = {"gather_idx": jnp.asarray(self.gather_idx),
                  "dst_global": jnp.asarray(self.dst_global)}
        return DeviceScatterLayout(meta=(self.n_nodes_pad, self.row_order),
                                   arrays=arrays)


@dataclasses.dataclass
class DeviceScatterLayout:
    """Jit-argument form of a scatter layout (registered pytree:
    ``arrays`` are leaves, ``meta`` = (n_nodes_pad, row_order) is static
    aux data; ``row_order`` is 'type' | 'block' for table layouts and
    'typed' for :func:`build_typed_dst_layout`)."""

    meta: tuple
    arrays: dict

    @property
    def n_nodes_pad(self):
        return self.meta[0]

    @property
    def row_order(self):
        return self.meta[1]

    @property
    def n_blocks(self):
        return self.meta[0] // BLOCK_N


jax.tree_util.register_pytree_node(
    DeviceScatterLayout,
    lambda l: ((l.arrays,), l.meta),
    lambda meta, children: DeviceScatterLayout(meta=meta, arrays=children[0]))


def static_tile_budget(e_pad: int, n_rows_pad: int, tile_e: int) -> int:
    """Upper bound on the packed tile count of ANY topology with at most
    ``e_pad`` real edges scattering into ``n_rows_pad`` rows: each dst
    block wastes less than one tile, plus one tile per (possibly empty)
    block.  Passing this as ``pad_tiles_to`` makes the layout's array
    shapes a pure function of (e_pad, n_rows_pad, tile_e) — so a jitted
    train step compiles ONCE across batches instead of per topology."""
    return -(-e_pad // tile_e) + n_rows_pad // BLOCK_N


def build_dst_block_layout(edge_src, edge_dst, edge_type, edge_mask,
                           n_nodes_pad: int, tile_e: int = 128,
                           n_message_types: int | None = None,
                           n_src_rows: int | None = None,
                           pad_tiles_to: int | None = None,
                           edge_align: int | None = None,
                           row_order: str = "type") -> DstBlockLayout:
    """Group real directed edges by destination block; pad each group to a
    ``tile_e`` multiple (or, with ``edge_align``, to an ``edge_align``
    multiple).  Pure numpy — run once per batch topology.

    ``n_src_rows`` decouples the source index space from the destination
    space (sharded halo aggregation: sources live in the halo receive
    pool while destinations are the shard's n_local rows); defaults to
    ``n_nodes_pad``.

    ``pad_tiles_to`` pads the pack to a STATIC total tile count (see
    :func:`static_tile_budget`): every batch of a training run then
    produces identically-shaped layouts and the jitted step compiles
    once.  The extra all-padding tiles are appended to the last block.

    ``row_order`` picks the node-transform-table row space the gather
    indexes: ``'type'`` (row = t·N_src + src) or ``'block'``
    (row = (src//128)·T2·128 + t·128 + src%128, the window layouts' table
    order).  'block' needs ``n_message_types`` and
    ``n_src_rows % 128 == 0``."""
    if n_nodes_pad % BLOCK_N:
        raise ValueError(f"n_nodes_pad must be a multiple of {BLOCK_N}")
    if n_src_rows is None:
        n_src_rows = n_nodes_pad
    if row_order not in ("type", "block"):
        raise ValueError(f"row_order must be 'type' or 'block': {row_order!r}")
    if row_order == "block":
        if n_message_types is None:
            raise ValueError("row_order='block' needs n_message_types")
        if n_src_rows % 128:
            raise ValueError("row_order='block' needs n_src_rows % 128 == 0")
    real = np.asarray(edge_mask) > 0
    src = np.asarray(edge_src)[real].astype(np.int64)
    dst = np.asarray(edge_dst)[real].astype(np.int64)
    typ = np.asarray(edge_type)[real].astype(np.int64)

    def table_row(src, typ):
        if row_order == "block":
            return (src // 128) * (n_message_types * 128) \
                + typ * 128 + src % 128
        return typ * n_src_rows + src

    # primary key: destination block; secondary: gather row, so the
    # gather reads near-sequential rows within a block
    grow = table_row(src, typ)
    order = np.lexsort((grow, dst // BLOCK_N))
    src, dst, typ = src[order], dst[order], typ[order]

    n_blocks = n_nodes_pad // BLOCK_N
    block = dst // BLOCK_N
    counts = np.bincount(block, minlength=n_blocks)
    tiles = (counts + tile_e - 1) // tile_e
    # every block gets >=1 (possibly all-padding) tile
    tiles = np.maximum(tiles, 1)
    if pad_tiles_to is not None:
        extra = pad_tiles_to - int(tiles.sum())
        if extra < 0:
            raise ValueError(
                f"pad_tiles_to={pad_tiles_to} < required {int(tiles.sum())}")
        tiles[-1] += extra  # all-padding tiles at the tail of the last block
    tile_start = np.zeros(n_blocks + 1, np.int32)
    np.cumsum(tiles, out=tile_start[1:])

    # packed position of each real edge: block's first slot + rank in block
    block_edge_start = np.zeros(n_blocks + 1, np.int64)
    np.cumsum(counts, out=block_edge_start[1:])
    rank = np.arange(src.shape[0]) - block_edge_start[block]
    if edge_align is not None:
        A = edge_align
        if tile_e % A:
            raise ValueError(f"edge_align={A} must divide tile_e={tile_e}")
        base = np.zeros(n_blocks + 1, np.int64)
        np.cumsum(-(-counts // A) * A, out=base[1:])
        e_pack = int(base[-1]) + tile_e  # margin: a tile may overrun
        if pad_tiles_to is not None:
            # static-budget mode: the pack length must be topology-
            # independent too (halo shards np.stack it; serving batches
            # must not retrace) — pad to the budget's worst case
            e_pack = pad_tiles_to * tile_e + tile_e
        pos = base[block] + rank
    else:
        e_pack = max(int(tile_start[-1]) * tile_e, tile_e)
        pos = tile_start[block].astype(np.int64) * tile_e + rank

    gather_idx = np.zeros(e_pack, np.int32)
    dst_local = np.full(e_pack, -1, np.int32)
    dst_global = np.full(e_pack, -1, np.int32)
    gather_idx[pos] = table_row(src, typ).astype(np.int32)
    dst_local[pos] = (dst - block * BLOCK_N).astype(np.int32)
    dst_global[pos] = dst.astype(np.int32)
    block_of_tile = np.repeat(np.arange(n_blocks, dtype=np.int32),
                              tiles.astype(np.int64))
    return DstBlockLayout(
        n_nodes_pad=n_nodes_pad, tile_e=tile_e, gather_idx=gather_idx,
        dst_local=dst_local, tile_start=tile_start,
        block_of_tile=block_of_tile, dst_global=dst_global,
        edge_align=edge_align, row_order=row_order)


def scatter_rows(msgs, dst, n_rows: int):
    """out[v] = Σ_{e: dst[e] = v} msgs[e], accumulated in f32; rows with
    ``dst < 0`` (padding) contribute nothing.  Returns [n_rows, D] f32."""
    seg = jnp.where(dst >= 0, dst, n_rows)
    return jax.ops.segment_sum(msgs.astype(jnp.float32), seg,
                               num_segments=n_rows)


def onehot_segment_scatter(messages, dst_local, tile_start, n_blocks: int,
                           tile_e: int = 128):
    """Tile-addressed scatter: packed row e lies in tile e // tile_e, whose
    dst block is the one whose ``tile_start`` range holds it;
    ``dst_local`` (−1 = padding) is the row within that block.
    Returns [n_blocks·128, D] f32."""
    tile = jnp.arange(messages.shape[0], dtype=jnp.int32) // tile_e
    block = jnp.searchsorted(tile_start, tile, side="right") - 1
    dst = jnp.where(dst_local >= 0, block * BLOCK_N + dst_local, -1)
    return scatter_rows(messages, dst, n_blocks * BLOCK_N)


def node_table(h, msg_w, msg_b, row_order: str):
    """Node-transform table ``h·W_t + b_t`` for every message type, in the
    row order a layout was built for: 'type' (t·N + n), 'src' (n·T2 + t)
    or 'block' ((n//128)·T2·128 + t·128 + n%128).  Rows in ``h.dtype``
    (matmuls accumulate in f32)."""
    N, D = h.shape
    b = msg_b.astype(jnp.float32)
    if row_order == "block":
        if N % 128:
            raise ValueError("a block-major table needs N % 128 == 0")
        t = jnp.einsum("bsd,tdf->btsf", h.reshape(N // 128, 128, D), msg_w,
                       preferred_element_type=jnp.float32) \
            + b[None, :, None, :]
    elif row_order == "src":
        t = jnp.einsum("nd,tdf->ntf", h, msg_w,
                       preferred_element_type=jnp.float32) + b[None]
    else:
        t = jnp.einsum("nd,tdf->tnf", h, msg_w,
                       preferred_element_type=jnp.float32) + b[:, None, :]
    return t.reshape(-1, D).astype(h.dtype)


def layout_for_batch(batch, tile_e: int = 128) -> DeviceScatterLayout:
    """Static-shape scatter layout for a :class:`~ggnn.graph.GraphBatch`:
    tile counts padded to the :func:`static_tile_budget` of the batch's
    PaddingSpec, so every batch of a training run yields identically-shaped
    layouts and the jitted train/eval step compiles once (the layout passes
    through jit ARGUMENTS as a registered pytree)."""
    spec = batch.spec
    # dst rows pad up to the 128-row block grid; the gather/table space
    # stays spec.n_pad (it must match h's row count)
    n_dst = _rup_block(spec.n_pad)
    return build_dst_block_layout(
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        n_dst, tile_e=tile_e, n_message_types=2 * spec.n_edge_types,
        n_src_rows=spec.n_pad,
        pad_tiles_to=static_tile_budget(spec.e_pad, n_dst, tile_e),
        row_order=("block" if spec.n_pad % 128 == 0 else "type")
    ).to_device()


def build_chunked_dst_layouts(edge_src, edge_dst, edge_type, edge_mask,
                              n_nodes_pad: int, n_chunks: int,
                              tile_e: int = 2048) -> list:
    """Split the scatter layout into ``n_chunks`` contiguous dst-block
    ranges so the per-edge message buffer materializes one chunk at a time
    (peak memory / n_chunks).  Gather rows stay GLOBAL (t·N+src into the
    full table); only destinations are chunk-local."""
    if n_nodes_pad % (BLOCK_N * n_chunks):
        raise ValueError("n_nodes_pad must divide into n_chunks×128 blocks")
    rows_per_chunk = n_nodes_pad // n_chunks
    real = np.asarray(edge_mask) > 0
    src = np.asarray(edge_src)[real]
    dst = np.asarray(edge_dst)[real]
    typ = np.asarray(edge_type)[real]
    chunk_of = dst // rows_per_chunk
    layouts = []
    for c in range(n_chunks):
        sel = chunk_of == c
        layouts.append(build_dst_block_layout(
            src[sel], dst[sel] - c * rows_per_chunk, typ[sel],
            np.ones(int(sel.sum()), np.float32), rows_per_chunk,
            tile_e=tile_e, n_src_rows=n_nodes_pad).to_device())
    return layouts


def aggregate_onehot_chunked(h, chunk_layouts: list, msg_w, msg_b):
    """Chunked forward aggregation over contiguous dst ranges (see
    :func:`build_chunked_dst_layouts`)."""
    N = h.shape[0]
    table = node_table(h, msg_w, msg_b, "type")
    outs = [scatter_rows(table[lay.arrays["gather_idx"]],
                         lay.arrays["dst_global"], lay.n_nodes_pad)
            for lay in chunk_layouts]
    return jnp.concatenate(outs, axis=0)[:N]


def aggregate_onehot(h, layout, msg_w, msg_b):
    """Typed aggregation a[v] = Σ_{(u,t,v)} h[u]·W_t + b_t through a
    scatter layout.

    ``layout`` may be a host :class:`DstBlockLayout` (small graphs — its
    arrays become trace constants) or a :class:`DeviceScatterLayout`
    (required under jit for large graphs; pass it through the jitted
    function's arguments).  Returns [min(N, n_nodes_pad), D] f32 where N
    is h's row count (the halo path's h is a larger source pool)."""
    if isinstance(layout, DstBlockLayout):
        layout = layout.to_device()
    n_nodes_pad, row_order = layout.meta
    arrs = layout.arrays
    N = h.shape[0]
    if row_order == "typed":
        # aggregate-then-transform: Y[t, v] = Σ_{(u,t,v)} h[u], then one
        # batched matmul applies every W_t; the bias term is
        # Σ_t indeg_t(v)·b_t
        T2 = msg_w.shape[0]
        y = scatter_rows(h[arrs["gather_idx"]], arrs["seg"],
                         T2 * n_nodes_pad).reshape(T2, n_nodes_pad, -1)
        out = jnp.einsum("tnd,tdf->nf", y, msg_w.astype(jnp.float32),
                         preferred_element_type=jnp.float32) \
            + jnp.einsum("tn,td->nd", arrs["indeg"],
                         msg_b.astype(jnp.float32))
        return out[:N]
    table = node_table(h, msg_w, msg_b, row_order)
    return scatter_rows(table[arrs["gather_idx"]], arrs["dst_global"],
                        n_nodes_pad)[:N]


def build_typed_dst_layout(edge_src, edge_dst, edge_type, edge_mask,
                           n_nodes_pad: int,
                           n_message_types: int) -> DeviceScatterLayout:
    """Host-side layout for the typed path (see :func:`aggregate_onehot`):
    real edges sorted by (dst block, type, src); ``gather_idx`` indexes h
    ROWS and ``seg`` the (type, dst) row ``t·n_nodes_pad + dst`` of the
    aggregation buffer; ``indeg`` [T2, n_nodes_pad] holds the per-(type,
    dst) edge counts for the bias.  Returns a :class:`DeviceScatterLayout`
    with ``row_order='typed'``."""
    T2 = n_message_types
    if n_nodes_pad % BLOCK_N:
        raise ValueError(f"n_nodes_pad must be a multiple of {BLOCK_N}")
    real = np.asarray(edge_mask) > 0
    src = np.asarray(edge_src)[real].astype(np.int64)
    dst = np.asarray(edge_dst)[real].astype(np.int64)
    typ = np.asarray(edge_type)[real].astype(np.int64)
    order = np.lexsort((src, typ, dst // BLOCK_N))
    src, dst, typ = src[order], dst[order], typ[order]
    seg = typ * n_nodes_pad + dst
    indeg = np.bincount(seg, minlength=T2 * n_nodes_pad).reshape(
        T2, n_nodes_pad).astype(np.float32)
    # one padding row keeps the arrays non-empty for edgeless graphs
    arrays = {"gather_idx": jnp.asarray(
                  np.append(src, 0).astype(np.int32)),
              "seg": jnp.asarray(np.append(seg, -1).astype(np.int32)),
              "indeg": jnp.asarray(indeg)}
    return DeviceScatterLayout(meta=(n_nodes_pad, "typed"), arrays=arrays)
