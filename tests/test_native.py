"""Native host library tests: builds libggnn_host.so with the in-repo
Makefile and asserts exact equality with the pure-Python host path."""

import numpy as np
import pytest

from ggnn import native
from ggnn.data import TASKS, generate_task_file
from ggnn.data.babi import parse_graph_text
from ggnn.graph import PaddingSpec, _sort_edges, batch_graphs
from ggnn.parallel.partition import partition_batch

pytestmark = pytest.mark.skipif(not native.build(),
                                reason="no C++ toolchain available")


@pytest.mark.parametrize("task_id", sorted(TASKS))
def test_native_parser_matches_python(task_id):
    spec = TASKS[task_id]
    text = generate_task_file(task_id, 25, seed=42)
    py = parse_graph_text(text, spec)
    cc = native.parse_graph_text_native(text, spec)
    assert len(py) == len(cc)
    for a, b in zip(py, cc):
        assert a.n_nodes == b.n_nodes
        np.testing.assert_array_equal(a.edges, b.edges)
        assert a.question_type == b.question_type
        assert a.args == b.args
        np.testing.assert_array_equal(a.target, b.target)


def test_native_sort_edges_matches_python(rng):
    n, T = 5000, 9
    src = rng.integers(0, 300, n)
    dst = rng.integers(0, 300, n)
    typ = rng.integers(0, T, n)
    ps, pd, pt, po = _sort_edges(src, dst, typ, T)
    cs, cd, ct, co = native.sort_edges_native(src, dst, typ, T)
    np.testing.assert_array_equal(ps, cs)
    np.testing.assert_array_equal(pd, cd)
    np.testing.assert_array_equal(pt, ct)
    np.testing.assert_array_equal(po, co)


def test_native_sort_fuzz(rng):
    """Larger randomized sort cases incl. empty types and duplicates."""
    for trial in range(5):
        n = int(rng.integers(1, 20000))
        T = int(rng.integers(1, 12))
        src = rng.integers(0, 500, n)
        dst = rng.integers(0, 500, n)
        typ = rng.integers(0, max(1, T - 2), n)  # leave top types empty
        ps, pd, pt, po = _sort_edges(src, dst, typ, T)
        cs, cd, ct, co = native.sort_edges_native(src, dst, typ, T)
        np.testing.assert_array_equal(ps, cs)
        np.testing.assert_array_equal(pd, cd)
        np.testing.assert_array_equal(pt, ct)
        np.testing.assert_array_equal(po, co)


def test_native_halo_plan_matches_python(rng):
    graphs = []
    for _ in range(4):
        n = int(rng.integers(6, 14))
        m = int(rng.integers(4, 3 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 3, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.5).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann, targets={}))
    total_n = sum(g["n_nodes"] for g in graphs)
    spec = PaddingSpec(n_graphs=4, n_pad=((total_n + 31) // 32) * 32,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
                       n_edge_types=3, annotation_dim=2).round_up()
    b = batch_graphs(graphs, spec)
    py = partition_batch(b, 8, use_native=False)
    cc = partition_batch(b, 8, use_native=True)
    assert py.halo_size == cc.halo_size
    assert py.n_local == cc.n_local
    for name in ("edge_src_global", "edge_src_halo", "edge_dst_local",
                 "edge_type", "edge_mask", "type_offsets", "halo_send_idx",
                 "annotations", "node_mask", "node_graph"):
        np.testing.assert_array_equal(getattr(py, name), getattr(cc, name),
                                      err_msg=name)


@pytest.mark.parametrize("row_major", ["src", "block"])
@pytest.mark.parametrize("typed_spill", [False, True])
def test_native_window_layout_matches_python(rng, row_major, typed_spill):
    """The C++ window plan (radix sort + direct count fill) produces
    bit-identical layouts to the numpy path, incl. saturation spill, both
    spill kinds, and static tile-budget padding."""
    from ggnn.ops.window import build_window_layout
    N, E, T2 = 512, 5000, 6
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    typ = rng.integers(0, T2, E).astype(np.int32)
    mask = (rng.random(E) > 0.1).astype(np.float32)
    # duplicate a handful of edges heavily to exercise saturation spill
    src[:40] = 3; dst[:40] = 7; typ[:40] = 1; mask[:40] = 1.0
    kw = dict(window=256, min_edges_per_tile=3, spill_tile_e=8,
              n_message_types=T2, block_rows=256, row_major=row_major,
              typed_spill=typed_spill, pad_tiles_to=64)
    lay_py = build_window_layout(src, dst, typ, mask, N, use_native=False,
                                 **kw)
    lay_cc = build_window_layout(src, dst, typ, mask, N, use_native=True,
                                 **kw)
    assert lay_py.meta == lay_cc.meta
    assert lay_py.stats == lay_cc.stats
    assert set(lay_py.arrays) == set(lay_cc.arrays)
    for k in lay_py.arrays:
        np.testing.assert_array_equal(np.asarray(lay_py.arrays[k]),
                                      np.asarray(lay_cc.arrays[k]),
                                      err_msg=k)
