"""Edge partitioning + halo-exchange plan (SURVEY.md §5.7, BASELINE.json:5).

Partition strategy (the GNN analogue of TP+SP):

- every shard owns a contiguous node range of ``n_local = n_pad / P`` rows
  of the flattened node axis — node state h stays sharded at all times;
- every directed message edge lives on the shard owning its **destination**
  (aggregation is then purely local: ``segment_sum`` into owned rows);
- per propagation step each shard needs the states of remote *source*
  nodes ("halo").  The exchange pattern is topology-static, so the plan is
  precomputed once per batch (SURVEY.md §5.7: "the exchange pattern is
  static across steps — precomputed once per graph batch"):

  * ``halo_send_idx[owner, requester, H]`` — local node indices owner
    sends to requester (deduplicated, padded to the max request size H);
  * edge sources are remapped to halo coordinates
    ``owner · H + position`` so the aggregation gathers straight from the
    all-to-all receive buffer.

  Every shard requests its own needed nodes from itself too (the diagonal),
  so local and remote contributions go through one uniform gather.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ggnn.graph import GraphBatch


@dataclasses.dataclass
class PartitionedBatch:
    """Host-side numpy arrays, all leading-axis sharded by 'graph' except
    where noted.  See module docstring for the halo plan."""

    n_shards: int
    n_local: int
    halo_size: int                 # H
    annotations: np.ndarray        # [P, n_local, A]
    node_mask: np.ndarray          # [P, n_local]
    node_graph: np.ndarray         # [P, n_local]
    edge_src_global: np.ndarray    # [P, E_l] global src ids (all_gather path)
    edge_src_halo: np.ndarray      # [P, E_l] owner*H + pos   (halo path)
    edge_dst_local: np.ndarray     # [P, E_l] dst - shard_base
    edge_type: np.ndarray          # [P, E_l]
    edge_mask: np.ndarray          # [P, E_l]
    type_offsets: np.ndarray       # [P, T2+1]
    halo_send_idx: np.ndarray      # [P(owner), P(requester), H] local ids
    # local/remote split (SURVEY.md §5.7: overlap the all-to-all with
    # aggregation of purely-LOCAL edges — local edges read h_local directly
    # and carry no dataflow dependency on the exchange).  Derived by
    # split_local_remote(); None until then.
    local_edges: "dict | None" = None   # src (shard-local ids), dst, type, mask
    remote_edges: "dict | None" = None  # src (halo coords), dst, type, mask
    # HOT-SET hybrid exchange (skewed graphs — DESIGN.md "halo plan
    # scaling bound"): rows requested by >= hot_thresh distinct
    # shards ride ONE all_gather (no P^2 pair padding); only the cold
    # tail stays in the deduplicated all-to-all, whose H collapses on a
    # skewed cut.  Pool = [hot (P*Hh) || recv (P*H) || h_local];
    # hot_size == 0 means the plain dense plan (exact back-compat).
    hot_size: int = 0              # Hh (static)
    hot_idx: "np.ndarray | None" = None  # [P, Hh] owner's hot local ids

    @property
    def pool_rows(self) -> int:
        """Rows of the per-shard gather pool the halo coords index."""
        return (self.n_shards * self.hot_size
                + self.n_shards * self.halo_size + self.n_local)

    @property
    def arrays(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if not isinstance(getattr(self, f.name), int)}


_PB_ARRAY_FIELDS = ("annotations", "node_mask", "node_graph",
                    "edge_src_global", "edge_src_halo", "edge_dst_local",
                    "edge_type", "edge_mask", "type_offsets",
                    "halo_send_idx", "local_edges", "remote_edges",
                    "hot_idx")

# registered pytree (arrays = leaves, sizes = static aux) so a
# PartitionedBatch can pass through jit ARGUMENTS — closure-captured
# partition arrays would become constants baked into the compiled
# program (see ops/onehot.DeviceScatterLayout)
import jax as _jax  # noqa: E402

_jax.tree_util.register_pytree_node(
    PartitionedBatch,
    lambda p: (tuple(getattr(p, f) for f in _PB_ARRAY_FIELDS),
               (p.n_shards, p.n_local, p.halo_size, p.hot_size)),
    lambda aux, children: PartitionedBatch(
        n_shards=aux[0], n_local=aux[1], halo_size=aux[2],
        hot_size=aux[3],
        **dict(zip(_PB_ARRAY_FIELDS, children))))


def partition_batch(batch: GraphBatch, n_shards: int,
                    edge_mult: int = 8,
                    use_native: bool | None = None,
                    hot_thresh: int | None = None) -> PartitionedBatch:
    """``hot_thresh``: enable the HOT-SET hybrid exchange — owner rows
    requested by >= hot_thresh distinct shards are served by one
    all_gather instead of padding every all-to-all pair to them (the
    skewed-graph fix, DESIGN.md "halo plan scaling bound").  Forces
    the pure-python plan builder (the C++ planner builds dense plans)."""
    spec = batch.spec
    if spec.n_pad % n_shards:
        raise ValueError(f"n_pad={spec.n_pad} not divisible by P={n_shards}")
    n_local = spec.n_pad // n_shards
    T2 = spec.n_message_types
    rup = lambda x, m: ((x + m - 1) // m) * m
    if hot_thresh is not None:
        use_native = False

    if use_native is not False:
        from ggnn import native
        if native.available():
            real = batch.edge_mask > 0
            plan = native.halo_plan_native(
                batch.edge_src[real], batch.edge_dst[real],
                batch.edge_type[real], n_shards, n_local, T2)
            return PartitionedBatch(
                n_shards=n_shards, n_local=n_local,
                halo_size=plan["halo_size"],
                annotations=batch.annotations.reshape(
                    n_shards, n_local, spec.annotation_dim),
                node_mask=batch.node_mask.reshape(n_shards, n_local),
                node_graph=batch.node_graph.reshape(n_shards, n_local),
                edge_src_global=plan["edge_src_global"],
                edge_src_halo=plan["edge_src_halo"],
                edge_dst_local=plan["edge_dst_local"],
                edge_type=plan["edge_type"], edge_mask=plan["edge_mask"],
                type_offsets=plan["type_offsets"],
                halo_send_idx=plan["halo_send_idx"])
        if use_native:
            raise RuntimeError("native library requested but unavailable")

    real = batch.edge_mask > 0
    src = batch.edge_src[real].astype(np.int64)
    dst = batch.edge_dst[real].astype(np.int64)
    typ = batch.edge_type[real].astype(np.int64)
    shard_of = dst // n_local

    per_shard = []
    requests: list[list[np.ndarray]] = []  # [s][o] -> sorted unique local ids
    for s in range(n_shards):
        sel = shard_of == s
        es, ed, et = src[sel], dst[sel], typ[sel]
        order = np.lexsort((ed, et))
        es, ed, et = es[order], ed[order], et[order]
        per_shard.append((es, ed, et))
        reqs = []
        owners = es // n_local
        for o in range(n_shards):
            if o == s:
                # self-edges read h_local directly (pool = recv ∥ h_local);
                # including them in the exchange would pad every chunk to
                # ~n_local on clustered graphs
                reqs.append(np.zeros((0,), np.int64))
            else:
                reqs.append(np.unique(es[owners == o] - o * n_local))
        requests.append(reqs)

    # hot-set extraction: rows many shards want leave the pairwise plan
    hot_sets = [np.zeros(0, np.int64) for _ in range(n_shards)]
    Hh = 0
    if hot_thresh is not None and n_shards > 1:
        for o in range(n_shards):
            all_req = np.concatenate(
                [requests[s][o] for s in range(n_shards)])
            ids, cnt = np.unique(all_req, return_counts=True)
            hot_sets[o] = ids[cnt >= hot_thresh]   # sorted (np.unique)
        for s in range(n_shards):
            for o in range(n_shards):
                requests[s][o] = np.setdiff1d(requests[s][o], hot_sets[o])
        Hh = max((h_.size for h_ in hot_sets), default=0)
        Hh = rup(Hh, 8) if Hh else 0

    H = max((len(r) for reqs in requests for r in reqs), default=1)
    H = max(rup(H, 8), 8)
    e_local = max(rup(max((len(p[0]) for p in per_shard), default=1), edge_mult),
                  edge_mult)

    ann = batch.annotations.reshape(n_shards, n_local, spec.annotation_dim)
    node_mask = batch.node_mask.reshape(n_shards, n_local)
    node_graph = batch.node_graph.reshape(n_shards, n_local)

    edge_src_global = np.zeros((n_shards, e_local), np.int32)
    edge_src_halo = np.zeros((n_shards, e_local), np.int32)
    edge_dst_local = np.zeros((n_shards, e_local), np.int32)
    edge_type = np.zeros((n_shards, e_local), np.int32)
    edge_mask = np.zeros((n_shards, e_local), np.float32)
    type_offsets = np.zeros((n_shards, T2 + 1), np.int32)
    halo_send_idx = np.zeros((n_shards, n_shards, H), np.int32)

    for s in range(n_shards):
        es, ed, et = per_shard[s]
        m = len(es)
        edge_src_global[s, :m] = es
        edge_dst_local[s, :m] = ed - s * n_local
        edge_type[s, :m] = et
        edge_mask[s, :m] = 1.0
        counts = np.bincount(et, minlength=T2)
        np.cumsum(counts, out=type_offsets[s, 1:])
        owners = es // n_local
        halo = np.empty(m, np.int64)
        hot_base = n_shards * Hh      # recv segment starts after hot
        for o in range(n_shards):
            osel = owners == o
            if o == s:
                # self-edges index past hot + receive into h_local
                halo[osel] = hot_base + n_shards * H \
                    + (es[osel] - s * n_local)
                continue
            req = requests[s][o]
            halo_send_idx[o, s, :len(req)] = req
            loc_ids = es[osel] - o * n_local
            pos = np.searchsorted(req, loc_ids)
            coord = hot_base + o * H + np.minimum(pos, max(len(req) - 1, 0))
            hs = hot_sets[o]
            if hs.size:
                hp = np.searchsorted(hs, loc_ids)
                is_hot = (hp < hs.size) & (
                    hs[np.minimum(hp, hs.size - 1)] == loc_ids)
                coord = np.where(is_hot, o * Hh + hp, coord)
            halo[osel] = coord
        edge_src_halo[s, :m] = halo

    hot_idx = None
    if Hh:
        hot_idx = np.zeros((n_shards, Hh), np.int32)
        for o in range(n_shards):
            hot_idx[o, :hot_sets[o].size] = hot_sets[o]

    return PartitionedBatch(
        n_shards=n_shards, n_local=n_local, halo_size=H,
        annotations=ann, node_mask=node_mask, node_graph=node_graph,
        edge_src_global=edge_src_global, edge_src_halo=edge_src_halo,
        edge_dst_local=edge_dst_local, edge_type=edge_type,
        edge_mask=edge_mask, type_offsets=type_offsets,
        halo_send_idx=halo_send_idx, hot_size=Hh, hot_idx=hot_idx)


def split_local_remote(parts: PartitionedBatch,
                       edge_mult: int = 8) -> PartitionedBatch:
    """Populate ``local_edges`` / ``remote_edges`` (SURVEY.md §5.7).

    Local edges (src owned by the dst's shard) are re-indexed to
    shard-LOCAL source ids so their aggregation reads ``h_local`` directly
    — giving XLA's scheduler a compute block that is dataflow-independent
    of the halo all-to-all and can overlap it.  Remote edges keep halo
    coordinates into the receive buffer."""
    P, n_local = parts.n_shards, parts.n_local
    rup = lambda x, m: ((x + m - 1) // m) * m

    sel_local = []
    for s in range(P):
        owner = parts.edge_src_global[s] // n_local
        sel_local.append((owner == s) & (parts.edge_mask[s] > 0))
    n_loc = max(rup(max(int(m.sum()) for m in sel_local), edge_mult),
                edge_mult)
    n_rem = max(rup(max(int(((parts.edge_mask[s] > 0) & ~sel_local[s]).sum())
                        for s in range(P)), edge_mult), edge_mult)

    def alloc(e):
        return {k: np.zeros((P, e), np.int32) for k in ("src", "dst", "type")} \
            | {"mask": np.zeros((P, e), np.float32)}

    loc, rem = alloc(n_loc), alloc(n_rem)
    for s in range(P):
        lm = sel_local[s]
        rm = (parts.edge_mask[s] > 0) & ~lm
        nl, nr = int(lm.sum()), int(rm.sum())
        loc["src"][s, :nl] = parts.edge_src_global[s][lm] - s * n_local
        loc["dst"][s, :nl] = parts.edge_dst_local[s][lm]
        loc["type"][s, :nl] = parts.edge_type[s][lm]
        loc["mask"][s, :nl] = 1.0
        rem["src"][s, :nr] = parts.edge_src_halo[s][rm]
        rem["dst"][s, :nr] = parts.edge_dst_local[s][rm]
        rem["type"][s, :nr] = parts.edge_type[s][rm]
        rem["mask"][s, :nr] = 1.0
    parts.local_edges = loc
    parts.remote_edges = rem
    return parts


def build_halo_scatter_layouts(parts: PartitionedBatch, tile_e: int = 128):
    """Per-shard destination-block layouts for the 'halo_onehot' strategy
    (ops/onehot.py), stacked with a common static shape so they cross
    into shard_map on the 'graph' axis.

    Sources are halo coordinates (``owner·H + rank`` into the [P·H, D]
    all-to-all receive buffer, plus ``P·H + i`` self-coordinates into
    h_local), destinations are the shard's n_local rows (must be a
    multiple of 128).  Tile counts are pinned to the static budget of the
    partition's padded edge count, so every shard's arrays stack and the
    jitted step compiles once.

    Returns (stacked_arrays: dict of [P, ...] numpy arrays, meta: dict
    with the common static ``scatter_meta`` tuple)."""
    from ggnn.ops.onehot import (BLOCK_N, build_dst_block_layout,
                                 static_tile_budget)

    P, n_local = parts.n_shards, parts.n_local
    if n_local % BLOCK_N:
        raise ValueError(
            f"halo_onehot needs n_local % {BLOCK_N} == 0, got {n_local}")
    T2 = parts.type_offsets.shape[1] - 1
    n_src = parts.pool_rows          # [hot ∥ recv ∥ h_local]
    e_local = parts.edge_src_halo.shape[1]
    budget = static_tile_budget(e_local, n_local, tile_e)
    lays = [
        build_dst_block_layout(
            parts.edge_src_halo[s], parts.edge_dst_local[s],
            parts.edge_type[s], parts.edge_mask[s], n_local,
            tile_e=tile_e, n_src_rows=n_src, n_message_types=T2,
            pad_tiles_to=budget,
            edge_align=(16 if tile_e % 16 == 0 else None)).to_device()
        for s in range(P)
    ]
    metas = {l.meta for l in lays}
    assert len(metas) == 1, f"per-shard metas diverged: {metas}"
    arrays = {k: np.stack([np.asarray(l.arrays[k]) for l in lays])
              for k in lays[0].arrays}
    meta = {"scatter_meta": lays[0].meta, "tile_e": tile_e,
            "n_blocks": n_local // BLOCK_N, "halo_rows": n_src}
    return arrays, meta


def build_halo_window_layouts(parts: PartitionedBatch, window: int = 512,
                              min_edges_per_tile: int = 32,
                              spill_tile_e: int = 512,
                              n_message_types: int | None = None,
                              row_major: str = "src",
                              typed_spill: bool = False,
                              grad_quant: bool = False):
    """Per-shard WINDOWED layouts over the shard-LOCAL edges for the
    'halo_window' strategy: community-partitioned shards aggregate their
    intra-shard edges through the block-CSR windowed path (ops/window.py
    — no per-edge random access), while remote edges ride the halo
    receive buffer through the typed-aggregate path.  Like the
    halo_overlap split, the local aggregation reads h_local only, so XLA
    overlaps it with the all-to-all.

    ``typed_spill`` selects the XW spill per shard; its type-bucket
    offsets are static meta, so they are pinned to the cross-shard
    maximum to keep the stacked metas equal.  ``grad_quant`` selects the
    int8 backward of the count product.

    Returns (stacked_arrays: dict of [P, ...] arrays, meta: dict) — all
    shards padded to common static shapes (tile counts and spill packs)."""
    from ggnn.ops.onehot import BLOCK_N
    from ggnn.ops.window import build_window_layout

    if parts.local_edges is None:
        raise ValueError("call split_local_remote(parts) first")
    P, n_local = parts.n_shards, parts.n_local
    if n_local % BLOCK_N:
        raise ValueError(
            f"halo_window needs n_local % {BLOCK_N} == 0, got {n_local}")
    loc = parts.local_edges
    if n_message_types is None:
        n_message_types = int(max(
            int(parts.edge_type[s].max(initial=0)) for s in range(P))) + 1

    def build(s, pad=None, spad=None, bucket=None, stile=None):
        return build_window_layout(
            loc["src"][s], loc["dst"][s], loc["type"][s], loc["mask"][s],
            n_local, window=window, min_edges_per_tile=min_edges_per_tile,
            spill_tile_e=(stile if stile is not None else spill_tile_e),
            n_message_types=n_message_types,
            row_major=row_major, pad_tiles_to=pad, spill_pad_tiles_to=spad,
            force_spill=True, spill_bucket=bucket, typed_spill=typed_spill,
            grad_quant=grad_quant)

    first = [build(s) for s in range(P)]
    n_tiles = max(l.n_tiles for l in first)
    sp_tiles = max(l.stats["spill_tiles"] for l in first)
    # rebuild EVERY shard with the common static pads: the spill pack
    # length is per-topology unless spill_pad_tiles_to pins it
    pins = {}
    if spill_tile_e is None:
        # pin the density-derived spill tile to the cross-shard MAXIMUM:
        # each shard's median-occupancy rule may pick another power of two
        pins["stile"] = max(l.spill_meta[0] for l in first)
    if typed_spill:
        pins["bucket"] = max(
            max(o[t + 1] - o[t] for t in range(len(o) - 1))
            for o in (l.spill_meta[1] for l in first))
    lays = [build(s, pad=n_tiles, spad=sp_tiles, **pins) for s in range(P)]
    metas = {l.meta for l in lays}
    assert len(metas) == 1, f"per-shard window metas diverged: {metas}"
    arrays = {k: np.stack([np.asarray(l.arrays[k]) for l in lays])
              for k in lays[0].arrays}
    meta = {"full_meta": lays[0].meta, "window": window,
            "n_tiles": n_tiles,
            "spill_frac": float(np.mean([l.stats["spill_frac"]
                                         for l in first]))}
    return arrays, meta
