"""Process set-up shared by the entry points (the train CLI, the
benchmarks and ``chip_smoke.py``)."""

from __future__ import annotations

import os
import pathlib

# fixed, inside the checkout: the cache key includes the path, so a
# directory that moves never hits
CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache lives at ``<checkout>/.jax_cache``
    (listed in ``.gitignore``)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (one line per card), or why they could not be read.  Runs in a child
    process that stays off JAX."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def device_record() -> dict:
    """Platform, device kind and count as JAX reports them."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu(allow_explicit_cpu: bool = False) -> dict:
    """Measurement entry points run on the GPU.  Returns
    :func:`device_record`; exits non-zero on any other platform — except,
    with ``allow_explicit_cpu``, when the caller set ``JAX_PLATFORMS=cpu``
    explicitly (rehearsals and tests), whose records then say "cpu"."""
    rec = device_record()
    if rec["platform"] == "gpu":
        return rec
    if (allow_explicit_cpu and rec["platform"] == "cpu"
            and os.environ.get("JAX_PLATFORMS") == "cpu"):
        return rec
    raise SystemExit(
        f"no GPU: JAX runs on {rec['platform']!r} ({rec['kind']}); "
        "this entry point measures the GPU"
        + (" (set JAX_PLATFORMS=cpu to rehearse on the CPU)"
           if allow_explicit_cpu else ""))


def peak_bytes_in_use():
    """``peak_bytes_in_use`` of device 0, or None where the platform
    keeps no memory statistics (the CPU)."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")
