"""Training-layer tests (SURVEY.md §4.3, §5.4-5.5): end-to-end task-4
integration to paper-level accuracy on CPU, exact checkpoint-resume
continuation, and structured metrics output."""

import json
import os

import numpy as np
import pytest

import jax

from ggnn.train import Trainer, build_config
from ggnn.train.metrics import MetricsLogger


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("babi_data"))


def test_babi4_end_to_end(data_root, tmp_path):
    """SURVEY.md §7.3 minimum slice: task-4 training to ≥95% on CPU."""
    cfg = build_config("babi4", epochs=80, data_root=data_root,
                       metrics_path=str(tmp_path / "m.jsonl"))
    result = Trainer(cfg, MetricsLogger(cfg.metrics_path, echo=False)).run()
    assert result["test_accuracy"] >= 0.95
    # metrics JSONL written and parseable
    lines = [json.loads(l) for l in open(cfg.metrics_path)]
    assert any("test_accuracy" in r for r in lines)
    assert all("ts" in r for r in lines)


def test_checkpoint_resume_exact(data_root, tmp_path):
    """SURVEY.md §5.4: save/restore reproduces the exact training curve."""
    cfg = build_config("babi4", epochs=6, data_root=data_root)
    logger = MetricsLogger(echo=False)

    t1 = Trainer(cfg, logger)
    for _ in range(3):
        t1.train_epoch()
    ckpt = str(tmp_path / "ck.npz")
    t1.save(ckpt)
    for _ in range(3):
        t1.train_epoch()
    final1 = jax.tree.map(np.asarray, t1.params)

    t2 = Trainer(cfg, logger)  # fresh init (different arbitrary state)
    t2.restore(ckpt)
    assert t2.epoch == 3 and t2.step == t1.step - 3 * len(t1.train_loader)
    for _ in range(3):
        t2.train_epoch()
    final2 = jax.tree.map(np.asarray, t2.params)

    leaves1 = jax.tree_util.tree_leaves(final1)
    leaves2 = jax.tree_util.tree_leaves(final2)
    for a, b in zip(leaves1, leaves2):
        np.testing.assert_array_equal(a, b)


def test_all_task_configs_build_and_step(data_root):
    """Every registered config constructs, jits, and takes one train step."""
    for name in ("babi4", "babi15", "babi16", "babi18", "babi19"):
        cfg = build_config(name, epochs=1, n_train=10, n_test=5,
                           data_root=data_root)
        t = Trainer(cfg, MetricsLogger(echo=False))
        rec = t.train_epoch()
        assert np.isfinite(rec["loss"])
        ev = t.evaluate()
        assert 0.0 <= ev["accuracy"] <= 1.0
