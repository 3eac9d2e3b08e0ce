"""Inference API test: trained task-4 model served through Predictor."""

import numpy as np

from ggnn.data.babi import TASKS, examples_to_graphs, parse_graph_text
from ggnn.data.generators import generate_task_file
from ggnn.infer import Predictor
from ggnn.train import Trainer, build_config
from ggnn.train.metrics import MetricsLogger


def test_predictor_round_trip(tmp_path):
    cfg = build_config("babi4", epochs=60, data_root=str(tmp_path))
    t = Trainer(cfg, MetricsLogger(echo=False))
    result = t.run()
    assert result["test_accuracy"] >= 0.9

    ckpt = str(tmp_path / "model.npz")
    t.save(ckpt)

    pred = Predictor(cfg.model, t.spec, checkpoint_path=ckpt)
    spec = TASKS[4]
    text = generate_task_file(4, 20, seed=999)
    examples = [e for e in parse_graph_text(text, spec)
                if e.question_type == 0][:8]
    graphs = examples_to_graphs(examples, spec)
    preds = pred.predict(graphs)
    assert len(preds) == len(graphs)
    acc = np.mean([p == int(e.target) for p, e in zip(preds, examples)])
    assert acc >= 0.7  # trained on qtype 0; fresh generator draw


def test_predictor_backends_agree(rng):
    """Predictions are backend-independent: xla vs onehot vs window (the
    serving path builds static-budget layouts per batch, one compile)."""
    from ggnn.infer import Predictor
    from ggnn.models.config import ModelConfig
    from ggnn.graph import PaddingSpec

    def graphs(k):
        out = []
        for _ in range(k):
            n = int(rng.integers(5, 12))
            m = int(rng.integers(4, 2 * n))
            edges = np.stack([rng.integers(0, n, m), rng.integers(0, 3, m),
                              rng.integers(0, n, m)], axis=1)
            ann = (rng.random((n, 2)) < 0.5).astype(np.float32)
            out.append(dict(n_nodes=n, edges=edges, annotations=ann,
                            targets={}))
        return out

    gs = graphs(7)
    spec = PaddingSpec(n_graphs=4, n_pad=64, e_pad=96, n_edge_types=3,
                       annotation_dim=2).round_up()
    preds = {}
    for name, backend, fuse in (("xla", "xla", False),
                                ("onehot", "onehot", False),
                                ("window", "window", False),
                                ("window_fused", "window", True)):
        cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                          n_steps=3, head="node_select", backend=backend,
                          fuse_gru=fuse)
        p = Predictor(cfg, spec)
        preds[name] = p.predict(gs)
        if backend != "xla":
            assert p._fwd._cache_size() == 1
    assert preds["onehot"] == preds["xla"]
    assert preds["window"] == preds["xla"]
    assert preds["window_fused"] == preds["xla"]
