"""chip_smoke.py on the CPU: every phase at a tiny size (the comparisons
and their tolerances are the ones the card run uses), and the refusal
to run or claim success without a GPU."""

import os
import subprocess
import sys

import pytest

import chip_smoke

TINY = chip_smoke.Sizes(nodes=1024, edges=4096, types=3, dim=16, steps=2,
                        communities=256, block_rows=256, window=256,
                        oracle_nodes=256, oracle_edges=1000, iters=1,
                        trainer_epochs=1, trainer_examples=4,
                        predictor_graphs=3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(extra)
    return env


def test_chip_smoke_refuses_cpu():
    """On a CPU-only platform the script exits non-zero and prints no
    success record."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=_env(JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr + out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script fails (it needs the package) and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=_env(JAX_PLATFORMS="cpu",
                                  PYTHONPATH=str(tmp_path)))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_device_on_cpu(capsys):
    with pytest.raises(SystemExit):
        chip_smoke.phase_device()
    rec = chip_smoke.phase_device(allow_cpu=True)
    assert rec["platform"] == "cpu" and rec["count"] >= 1
    assert "native host library" in capsys.readouterr().out


def test_phase_trainer_tiny():
    assert chip_smoke.phase_trainer(TINY)


def test_phase_full_width_tiny(capsys):
    keep = {}
    assert chip_smoke.phase_full_width(TINY, keep)
    out = capsys.readouterr().out
    assert "rel-L2" in out and "FAIL" not in out
    assert "time xla forward" in out and "time xla train step" in out
    assert set(keep) == {"uniform_ref"}


def test_phase_backends_tiny(capsys):
    keep = {}
    assert chip_smoke.phase_full_width(TINY, keep)
    assert chip_smoke.phase_backends(TINY, keep)
    out = capsys.readouterr().out
    for name in ("onehot forward", "window forward",
                 "window q8 serving forward", "GRU cell forward"):
        assert f"time {name}" in out, name
    assert "FAIL" not in out


def test_phase_predictor_tiny():
    assert chip_smoke.phase_predictor(TINY)


def test_phase_sharded_four_virtual_devices(capsys):
    ss = chip_smoke.ShardSizes(nodes=2048, edges=8192, types=3, dim=16,
                               steps=2, communities=16, devices=4)
    assert chip_smoke.phase_sharded(ss)
    out = capsys.readouterr().out
    for s in ("halo", "all_gather", "halo_overlap", "halo_onehot",
              "halo_window"):
        assert f"sharded {s} vs single-card propagate" in out
    assert "GSPMD step loss" in out


def test_compare_flags_out_of_tolerance(capsys):
    import numpy as np
    assert chip_smoke.compare("same", np.ones(4), np.ones(4), "sharded")
    assert not chip_smoke.compare("off", np.ones(4) * 1.1, np.ones(4),
                                  "sharded")
    assert not chip_smoke.compare("nan", np.full(4, np.nan), np.ones(4),
                                  "bf16")
    lines = capsys.readouterr().out.splitlines()
    verdicts = [l.split(" — ")[0].split()[-1] for l in lines]
    assert verdicts == ["ok", "FAIL", "FAIL"]
    # each comparison prints the reason for its tolerance
    assert all(l.endswith(chip_smoke.TOL[k][2])
               for l, k in zip(lines, ("sharded", "sharded", "bf16")))
