"""Multi-host (DCN bootstrap) test: two real `jax.distributed` processes
(SURVEY.md §4.4 / §5.3) run a sharded halo-exchange propagation over the
2-process global mesh and check it against the single-device reference.
Exercises ggnn.parallel.multihost end-to-end — the rendezvous, the
process-spanning mesh, and cross-process collectives (Gloo on CPU)."""

import os
import socket
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_halo_propagation():
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # one CPU device per process (the conftest's 8-virtual-device flag
    # would give each process 8 local devices)
    env["XLA_FLAGS"] = ""
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK pid={pid}" in out, out[-3000:]
