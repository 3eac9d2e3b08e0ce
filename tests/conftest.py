"""Test harness: the local CPU backend with 8 virtual devices
(SURVEY.md §4.4 — distributed tests without a cluster).

Set before JAX starts its backends, and exported for subprocesses.
Tests that need a card carry the ``gpu`` marker and request the
``gpu_device`` fixture, which decides at run time whether one is present
and skips otherwise; under this harness that is always a skip, so they
run on the card through ``chip_smoke.py`` (see README)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU; this process runs on "
                    f"{jax.devices()[0].platform}")
    return gpus[0]
