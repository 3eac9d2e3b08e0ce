"""GGS-NN node-selection output variant (paper §4's alternative F_o):
shape/loss sanity and a short training run that must make progress."""

import numpy as np

from ggnn.train import Trainer, build_config
from ggnn.train.metrics import MetricsLogger


def test_node_output_trains(tmp_path):
    cfg = build_config("babi19", epochs=40, n_train=50, n_test=20,
                       data_root=str(tmp_path), model_state_dim=8)
    cfg = cfg.with_overrides(model_ggsnn_output="node")
    assert cfg.model.ggsnn_output == "node"
    t = Trainer(cfg, MetricsLogger(echo=False))
    first = t.train_epoch()
    for _ in range(39):
        rec = t.train_epoch()
    assert np.isfinite(rec["loss"])
    assert rec["loss"] < first["loss"]
    ev = t.evaluate()
    assert 0.0 <= ev["accuracy"] <= 1.0
    # learning signal present: better than the ~(1/n)^2 random-path chance
    assert rec["accuracy"] > 0.2
