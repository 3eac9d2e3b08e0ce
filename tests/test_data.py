"""Data layer tests: generators → text format → parser → padded batches
(SURVEY.md §2.2 contract)."""

import numpy as np
import pytest

from ggnn.data import TASKS, generate_task_file
from ggnn.data.babi import parse_graph_text, examples_to_graphs
from ggnn.data.loader import BatchLoader
from ggnn.graph import PaddingSpec, batch_graphs


@pytest.mark.parametrize("task_id", sorted(TASKS))
def test_generate_parse_roundtrip(task_id):
    spec = TASKS[task_id]
    text = generate_task_file(task_id, 20, seed=123)
    examples = parse_graph_text(text, spec)
    assert len(examples) == 20
    for ex in examples:
        assert ex.n_nodes >= 2
        assert ex.edges.shape[1] == 3
        assert (ex.edges[:, 1] >= 0).all() and (ex.edges[:, 1] < spec.n_edge_types).all()
        assert (ex.edges[:, 0] >= 0).all() and (ex.edges[:, 0] < ex.n_nodes).all()
        assert (ex.edges[:, 2] >= 0).all() and (ex.edges[:, 2] < ex.n_nodes).all()
        assert len(ex.args) == spec.n_args
        for a in ex.args:
            assert 0 <= a < ex.n_nodes
        if spec.target_kind == "node":
            assert 0 <= int(ex.target) < ex.n_nodes
        elif spec.target_kind == "graph_class":
            assert 0 <= int(ex.target) < spec.n_classes
        else:
            assert ex.target.ndim == 1
            assert (ex.target >= 0).all() and (ex.target < spec.n_classes - 1).all()


def test_generator_determinism():
    a = generate_task_file(4, 10, seed=7)
    b = generate_task_file(4, 10, seed=7)
    c = generate_task_file(4, 10, seed=8)
    assert a == b
    assert a != c


def test_batching_structure():
    spec_t = TASKS[15]
    text = generate_task_file(15, 8, seed=1)
    graphs = examples_to_graphs(parse_graph_text(text, spec_t), spec_t)
    max_n = max(g["n_nodes"] for g in graphs)
    max_e = max(g["edges"].shape[0] for g in graphs)
    pspec = PaddingSpec(n_graphs=4, n_pad=4 * max_n, e_pad=4 * max_e * 2,
                        n_edge_types=spec_t.n_edge_types,
                        annotation_dim=spec_t.annotation_dim).round_up()
    batch = batch_graphs(graphs[:4], pspec)
    # edges sorted by type; masked edges zeroed; both directions present
    et = batch.edge_type[batch.edge_mask > 0]
    assert (np.diff(et) >= 0).all()
    n_real = int(batch.edge_mask.sum())
    assert n_real == 2 * sum(g["edges"].shape[0] for g in graphs[:4])
    # type_offsets consistent with counts
    counts = np.bincount(et, minlength=pspec.n_message_types)
    assert (np.diff(batch.type_offsets) == counts).all()
    # node bookkeeping
    assert batch.n_nodes[:4].sum() == sum(g["n_nodes"] for g in graphs[:4])
    assert (batch.node_mask.sum()) == batch.n_nodes.sum()
    # annotations land on the right nodes
    offs = np.concatenate([[0], np.cumsum(batch.n_nodes[:-1])])
    for i, g in enumerate(graphs[:4]):
        np.testing.assert_array_equal(
            batch.annotations[offs[i]:offs[i] + g["n_nodes"]],
            np.asarray(g["annotations"], np.float32))


def test_loader_shapes_and_short_batch():
    spec_t = TASKS[18]
    text = generate_task_file(18, 10, seed=3)
    graphs = examples_to_graphs(parse_graph_text(text, spec_t), spec_t)
    max_n = max(g["n_nodes"] for g in graphs)
    max_e = max(g["edges"].shape[0] for g in graphs)
    pspec = PaddingSpec(n_graphs=4, n_pad=4 * max_n, e_pad=4 * max_e * 2,
                        n_edge_types=spec_t.n_edge_types,
                        annotation_dim=spec_t.annotation_dim).round_up()
    loader = BatchLoader(graphs, pspec, shuffle=True, seed=0)
    batches = list(loader.epoch_batches(0))
    assert len(batches) == 3  # 4+4+2
    for b in batches:
        assert b.annotations.shape == (pspec.n_pad, pspec.annotation_dim)
        assert b.edge_src.shape == (pspec.e_pad,)
    # last batch has 2 real graphs
    assert int((batches[-1].n_nodes > 0).sum()) == 2
    # deterministic replay
    again = list(loader.epoch_batches(0))
    np.testing.assert_array_equal(batches[0].edge_src, again[0].edge_src)


def test_seq_target_padding():
    spec_t = TASKS[19]
    text = generate_task_file(19, 6, seed=5)
    graphs = examples_to_graphs(parse_graph_text(text, spec_t), spec_t)
    max_n = max(g["n_nodes"] for g in graphs)
    max_e = max(g["edges"].shape[0] for g in graphs)
    pspec = PaddingSpec(n_graphs=6, n_pad=6 * max_n, e_pad=6 * max_e * 2,
                        n_edge_types=spec_t.n_edge_types,
                        annotation_dim=spec_t.annotation_dim).round_up()
    batch = batch_graphs(graphs, pspec,
                         {"seq": ((spec_t.max_seq_len,), -1),
                          "seq_nodes": ((spec_t.max_seq_len,), -1)})
    seq = batch.targets["seq"]
    # node-output targets: path nodes for real rounds, -1 padding
    sn = batch.targets["seq_nodes"]
    assert sn.shape == (6, spec_t.max_seq_len)
    assert ((sn[:, :2] >= 0)).all() and (sn[:, 2] == -1).all()
    assert seq.shape == (6, spec_t.max_seq_len)
    # every sequence: 2 direction tokens + end token (= n_classes-1), then -1 pad
    assert ((seq[:, :2] >= 0) & (seq[:, :2] < spec_t.n_classes - 1)).all()
    assert (seq[:, 2] == spec_t.n_classes - 1).all()
