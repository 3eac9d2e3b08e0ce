"""bench.py output contract: the last line is one JSON record with
metric/value/unit/vs_baseline and the device it ran on."""

import json
import subprocess
import sys


def test_bench_json_contract():
    out = subprocess.run(
        [sys.executable, "bench.py", "--nodes", "512", "--edges", "2048",
         "--dim", "16", "--iters", "1", "--warmup", "0", "--backend", "xla"],
        capture_output=True, text=True, timeout=240,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"})
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "device"):
        assert key in rec
    assert rec["value"] > 0
    assert rec["device"]["platform"] == "cpu"  # JAX_PLATFORMS=cpu above
