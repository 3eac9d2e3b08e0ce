"""CLI and folds-runner smoke tests (in-process)."""

import json

from ggnn.train.__main__ import main as train_main
from ggnn.train.folds import run_folds


def test_train_cli(tmp_path, capsys):
    rc = train_main([
        "--config", "babi15", "--epochs", "5", "--n_train", "20",
        "--n_test", "10", "--data_root", str(tmp_path),
        "--metrics", str(tmp_path / "m.jsonl"),
        "--checkpoint_dir", str(tmp_path / "ck"),
    ])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(out)
    assert result["config"] == "babi15"
    assert (tmp_path / "ck" / "babi15_final.npz").exists()
    assert (tmp_path / "m.jsonl").exists()


def test_folds_runner(tmp_path):
    res = run_folds("babi15", n_folds=2, epochs=5, n_train=15, n_test=10,
                    data_root=str(tmp_path))
    assert res["folds"] == 2
    assert len(res["accuracies"]) == 2
    assert 0.0 <= res["mean_accuracy"] <= 1.0
