"""The program runs natively on its device: no Pallas import anywhere in
the package, the compile cache follows JAX_COMPILATION_CACHE_DIR, the
benchmark records its device and fails loudly, and the native library is
built from the sources beside it."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS",
                        "JAX_COMPILATION_CACHE_DIR")}
    env.update(extra)
    return env


def test_no_pallas_import_in_package():
    """No module under ggnn/ (nor an entry point) imports
    jax.experimental.pallas."""
    files = sorted((REPO / "ggnn").rglob("*.py")) + [
        REPO / n for n in ("bench.py", "bench_scaling.py", "chip_smoke.py",
                           "__graft_entry__.py")]
    assert len(files) > 20
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [
                    f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            if any(n.startswith("jax.experimental.pallas") for n in names):
                offenders.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert not offenders, offenders


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX uses it and the helper sets
    nothing; unset, the cache is the fixed <checkout>/.jax_cache, which
    .gitignore lists."""
    want = str(tmp_path / env_dir) if env_dir else str(REPO / ".jax_cache")
    extra = {"JAX_COMPILATION_CACHE_DIR": want} if env_dir else {}
    code = ("import jax; from ggnn.runtime import enable_compile_cache; "
            "d = enable_compile_cache(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    env = _env(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), **extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-800:]
    returned, configured = out.stdout.split()[-2:]
    assert returned == want and configured == want
    if not env_dir:
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _bench(args, **env):
    return subprocess.run(
        [sys.executable, "bench.py", "--nodes", "512", "--edges", "2048",
         "--dim", "16", "--iters", "1", "--warmup", "0", *args],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env=_env(**env))


def test_bench_record_names_its_device():
    out = _bench(["--backend", "onehot"], JAX_PLATFORMS="cpu")
    assert out.returncode == 0, out.stderr[-800:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["device"]["platform"] == "cpu"
    assert rec["device"]["kind"] and rec["device"]["count"] >= 1
    assert rec["times"]["onehot"]["compile_s"] > 0
    assert rec["times"]["onehot"]["median_s"] > 0


def test_bench_fails_when_a_backend_raises():
    """A window layout with 192-row blocks is refused when it is built:
    the run exits non-zero and the record names the failure."""
    out = _bench(["--backend", "window", "--block_rows", "192"],
                 JAX_PLATFORMS="cpu")
    assert out.returncode != 0
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert "window" in rec["failed"] and rec["value"] == 0.0


def test_bench_refuses_non_gpu_without_explicit_cpu():
    """JAX_PLATFORMS unset on a machine whose JAX finds no GPU: no
    fallback to the CPU."""
    import jax
    if any(d.platform == "gpu" for d in jax.devices()):
        pytest.skip("a GPU is present: the bench would rightly run on it")
    out = _bench(["--backend", "xla"])
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"metric"' not in out.stdout


def test_native_build_defers_to_make(tmp_path, monkeypatch):
    """build() runs make every time (in a scratch copy of the native
    sources): a library older than its source is rebuilt, an up-to-date
    one is left alone — existence alone never decides."""
    import shutil

    from ggnn import native
    for name in ("ggnn_host.cpp", "Makefile"):
        shutil.copy(pathlib.Path(native._DIR) / name, tmp_path / name)
    so = tmp_path / "libggnn_host.so"
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SO", str(so))
    monkeypatch.setenv("CXXFLAGS", "-O0 -std=c++17 -fPIC")
    if not native.build():
        pytest.skip("no C++ toolchain here")
    src = tmp_path / "ggnn_host.cpp"
    stale = src.stat().st_mtime - 3600
    os.utime(so, (stale, stale))            # a library older than source
    assert native.build()
    fresh = so.stat().st_mtime
    assert fresh > stale                    # rebuilt
    assert native.build()
    assert so.stat().st_mtime == fresh      # up to date: make is a no-op


def test_graft_entry_keeps_the_platform(capsys):
    """_ensure_devices never switches platforms: on this CPU host it
    reports what it runs on, and asking for more devices than exist
    fails instead of falling back."""
    sys.path.insert(0, str(REPO))
    try:
        import __graft_entry__ as ge
    finally:
        sys.path.pop(0)
    import jax
    n = len(jax.devices())
    ge._ensure_devices(n)
    out = capsys.readouterr().out
    assert f"platform={jax.devices()[0].platform}" in out
    with pytest.raises(RuntimeError):
        ge._ensure_devices(n + 1)


@pytest.mark.parametrize("explicit_cpu", [False, True])
def test_require_gpu_on_cpu(monkeypatch, explicit_cpu):
    """On the CPU, require_gpu exits non-zero unless the caller set
    JAX_PLATFORMS=cpu and allowed it; then it names the CPU."""
    from ggnn.runtime import require_gpu
    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()
    if explicit_cpu:
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
        assert require_gpu(allow_explicit_cpu=True)["platform"] == "cpu"
    else:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
        with pytest.raises(SystemExit, match="no GPU"):
            require_gpu(allow_explicit_cpu=True)


def test_time_call_separates_compile():
    """The first call (trace + compile) is set-up; steady calls are timed
    one by one and the median reported."""
    import jax
    import jax.numpy as jnp

    from ggnn.benchlib import time_call
    f = jax.jit(lambda x: jnp.sin(x) @ x.T)
    x = jnp.ones((64, 64))
    t = time_call(lambda: f(x), iters=4, warmup=1)
    assert len(t["times_s"]) == 4 and t["compile_s"] > 0
    assert min(t["times_s"]) <= t["median_s"] <= max(t["times_s"])


@pytest.mark.parametrize("backend", ["xla", "onehot", "window"])
def test_backend_layout_drives_forward(backend):
    """Each backend's benchmark layout runs the jitted forward and agrees
    with the xla forward on the same graph."""
    import jax
    import numpy as np

    from ggnn import benchlib
    from ggnn.data.synthetic import synthetic_batch
    from ggnn.models import ModelConfig, init_params
    b = synthetic_batch(1024, 4096, 3, annotation_dim=8, seed=0,
                        node_mult=256, n_communities=4, p_intra=0.9)
    cfg = ModelConfig(state_dim=16, annotation_dim=8, n_edge_types=3,
                      n_steps=2, backend=backend)
    params = init_params(jax.random.PRNGKey(0), cfg)
    lay = benchlib.backend_layout(backend, b, cfg.n_message_types,
                                  window=256, block_rows=256)
    assert (lay is None) == (backend == "xla")
    g = benchlib.graph_args(b)
    got = benchlib.make_forward(cfg)(params["prop"], *g, lay)
    want = benchlib.make_forward(ModelConfig(
        state_dim=16, annotation_dim=8, n_edge_types=3, n_steps=2))(
            params["prop"], *g, None)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-5, atol=3e-6)
