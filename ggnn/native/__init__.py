"""ctypes bindings for the native host runtime (libggnn_host.so).

The reference has no native layer (SURVEY.md §2.4); this framework's host
path — bAbI parsing, edge packing, halo partition planning — runs in C++
when the library is present (``make -C ggnn/native`` or
:func:`build`), with pure-Python fallbacks of identical semantics
(tests/test_native.py asserts equality).

Public surface:
- :func:`available` / :func:`build`
- :func:`parse_graph_text_native` — drop-in for babi.parse_graph_text
- :func:`sort_edges_native`       — drop-in for graph._sort_edges
- :func:`halo_plan_native`        — drop-in for parallel.partition core
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libggnn_host.so")
_lib: Optional[ctypes.CDLL] = None


def build() -> bool:
    """Bring the native library up to date with ``make``, which compares
    file times: it is a no-op when ``libggnn_host.so`` is newer than
    ``ggnn_host.cpp`` and the Makefile, and rebuilds otherwise.  So the
    library loaded is always built from the sources beside it, never a
    copy built from other sources.  Returns False (the Python fallbacks
    then run) when there is no toolchain or the build fails."""
    try:
        subprocess.run(["make", "-C", _DIR, "-s"], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    return os.path.exists(_SO)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    lib = ctypes.CDLL(_SO)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)

    lib.ggnn_parse.restype = ctypes.c_void_p
    lib.ggnn_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_int32, ctypes.c_int32]
    lib.ggnn_parse_num_examples.restype = ctypes.c_int64
    lib.ggnn_parse_num_examples.argtypes = [ctypes.c_void_p]
    lib.ggnn_example_info.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      i32p, i64p, i32p, i64p, i64p]
    lib.ggnn_example_fill.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      i32p, i32p, i32p]
    lib.ggnn_parse_free.argtypes = [ctypes.c_void_p]

    lib.ggnn_sort_edges.argtypes = [ctypes.c_int64, i32p, i32p, i32p,
                                    ctypes.c_int32, i32p, i32p, i32p, i32p]

    lib.ggnn_halo_plan.restype = ctypes.c_void_p
    lib.ggnn_halo_plan.argtypes = [ctypes.c_int64, i32p, i32p, i32p,
                                   ctypes.c_int32, ctypes.c_int64,
                                   ctypes.c_int32]
    lib.ggnn_halo_sizes.argtypes = [ctypes.c_void_p, i64p, i64p]
    lib.ggnn_halo_fill.argtypes = [ctypes.c_void_p, i32p, i32p, i32p, i32p,
                                   f32p, i32p, i32p]
    lib.ggnn_halo_free.argtypes = [ctypes.c_void_p]

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.ggnn_window_plan.restype = ctypes.c_void_p
    lib.ggnn_window_plan.argtypes = [ctypes.c_int64, i64p, i64p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int32,
                                     ctypes.c_int32]
    lib.ggnn_window_plan_sizes.argtypes = [ctypes.c_void_p, i64p, i64p]
    lib.ggnn_window_plan_export.argtypes = [ctypes.c_void_p, u8p, i64p, i64p]
    lib.ggnn_window_fill_counts.argtypes = [ctypes.c_void_p, i64p,
                                            ctypes.c_int64, ctypes.c_int32,
                                            i8p]
    lib.ggnn_window_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def _ptr(a, ty=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def parse_graph_text_native(text: str, spec) -> list:
    """Native counterpart of :func:`ggnn.data.babi.parse_graph_text`."""
    from ggnn.data.babi import Example

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    raw = text.encode()
    target_kind = 1 if spec.target_kind == "seq" else 0
    h = lib.ggnn_parse(raw, len(raw), spec.n_args, target_kind)
    try:
        n = lib.ggnn_parse_num_examples(h)
        out = []
        for i in range(n):
            n_nodes = ctypes.c_int32()
            n_edges = ctypes.c_int64()
            qtype = ctypes.c_int32()
            n_args = ctypes.c_int64()
            n_tgt = ctypes.c_int64()
            lib.ggnn_example_info(h, i, ctypes.byref(n_nodes),
                                  ctypes.byref(n_edges), ctypes.byref(qtype),
                                  ctypes.byref(n_args), ctypes.byref(n_tgt))
            edges = np.empty((n_edges.value, 3), np.int32)
            args = np.empty((n_args.value,), np.int32)
            tgt = np.empty((n_tgt.value,), np.int32)
            lib.ggnn_example_fill(h, i, _ptr(edges), _ptr(args), _ptr(tgt))
            target = (tgt if spec.target_kind == "seq"
                      else np.asarray(tgt[0], np.int32))
            out.append(Example(n_nodes=int(n_nodes.value),
                               edges=edges.astype(np.int64),
                               question_type=int(qtype.value),
                               args=tuple(int(a) for a in args),
                               target=target))
        return out
    finally:
        lib.ggnn_parse_free(h)


def sort_edges_native(src, dst, typ, n_types: int):
    """Native counterpart of graph._sort_edges (sort by type, dst, src)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    src, dst, typ = _i32(src), _i32(dst), _i32(typ)
    n = src.shape[0]
    o_src = np.empty(n, np.int32)
    o_dst = np.empty(n, np.int32)
    o_typ = np.empty(n, np.int32)
    o_off = np.empty(n_types + 1, np.int32)
    lib.ggnn_sort_edges(n, _ptr(src), _ptr(dst), _ptr(typ), n_types,
                        _ptr(o_src), _ptr(o_dst), _ptr(o_typ), _ptr(o_off))
    return o_src, o_dst, o_typ, o_off


def halo_plan_native(src, dst, typ, n_shards: int, n_local: int,
                     n_types: int) -> dict:
    """Native counterpart of the partition core in parallel/partition.py.

    Takes REAL directed edges (unpadded); returns the per-shard arrays."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    src, dst, typ = _i32(src), _i32(dst), _i32(typ)
    h = lib.ggnn_halo_plan(src.shape[0], _ptr(src), _ptr(dst), _ptr(typ),
                           n_shards, n_local, n_types)
    try:
        e_local = ctypes.c_int64()
        H = ctypes.c_int64()
        lib.ggnn_halo_sizes(h, ctypes.byref(e_local), ctypes.byref(H))
        P, E, Hs = n_shards, e_local.value, H.value
        esg = np.empty((P, E), np.int32)
        esh = np.empty((P, E), np.int32)
        edl = np.empty((P, E), np.int32)
        ety = np.empty((P, E), np.int32)
        emk = np.empty((P, E), np.float32)
        tof = np.empty((P, n_types + 1), np.int32)
        hsi = np.empty((P, P, Hs), np.int32)
        lib.ggnn_halo_fill(h, _ptr(esg), _ptr(esh), _ptr(edl), _ptr(ety),
                           _ptr(emk, ctypes.c_float), _ptr(tof), _ptr(hsi))
        return {"edge_src_global": esg, "edge_src_halo": esh,
                "edge_dst_local": edl, "edge_type": ety, "edge_mask": emk,
                "type_offsets": tof, "halo_send_idx": hsi,
                "e_local": E, "halo_size": Hs}
    finally:
        lib.ggnn_halo_free(h)


class WindowPlanNative:
    """Native window-layout plan (see ggnn_host.cpp ggnn_window_plan):
    one radix sort replaces the numpy path's np.unique/np.add.at passes.

    Usage (mirrors the middle of ops.window.build_window_layout):
      plan = WindowPlanNative(rows, dst, window, block_rows, n_wins,
                              n_blocks, min_edges, max_count)
      if plan.ok: plan.keep / plan.dense_keys / plan.fill_counts(uniq_t)
    """

    def __init__(self, rows, dst, window, block_rows, n_wins, n_blocks,
                 min_edges, max_count):
        self._lib = _load()
        self._h = None
        self.ok = False
        if self._lib is None:
            return
        rows = np.ascontiguousarray(rows, np.int64)
        dst = np.ascontiguousarray(dst, np.int64)
        n = rows.shape[0]
        h = self._lib.ggnn_window_plan(
            n, _ptr(rows, ctypes.c_int64), _ptr(dst, ctypes.c_int64),
            window, block_rows, n_wins, n_blocks, min_edges, max_count,
            0)
        if not h:  # composite key would overflow — caller falls back
            return
        self._h = h
        self.ok = True
        self._window, self._block_rows = window, block_rows
        nd = ctypes.c_int64()
        ndt = ctypes.c_int64()
        self._lib.ggnn_window_plan_sizes(h, ctypes.byref(nd),
                                         ctypes.byref(ndt))
        self.keep = np.empty(n, np.uint8)
        self.dense_keys = np.empty(nd.value, np.int64)
        self.dense_keys_t = np.empty(ndt.value, np.int64)
        self._lib.ggnn_window_plan_export(
            h, _ptr(self.keep, ctypes.c_uint8),
            _ptr(self.dense_keys, ctypes.c_int64),
            _ptr(self.dense_keys_t, ctypes.c_int64))
        self.keep = self.keep.astype(bool)

    def fill_counts(self, uniq_t,
                    total_tiles: int | None = None) -> np.ndarray:
        """Int8 count tiles of the dense keys ``uniq_t``; ``total_tiles`` >
        len(uniq_t) appends all-zero padding tiles (the pad_tiles_to
        static-budget case)."""
        uniq_t = np.ascontiguousarray(uniq_t, np.int64)
        n = uniq_t.shape[0]
        total = n if total_tiles is None else total_tiles
        c = np.zeros((total * self._block_rows, self._window), np.int8)
        self._lib.ggnn_window_fill_counts(
            self._h, _ptr(uniq_t, ctypes.c_int64), n, 0,
            _ptr(c, ctypes.c_int8))
        return c

    def close(self):
        if self._h is not None:
            self._lib.ggnn_window_free(self._h)
            self._h = None
            self.ok = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
