"""Multi-host bootstrap + failure detection (SURVEY.md §5.3, §5.8).

The reference is single-process; multi-host here is standard JAX SPMD:
every host runs the same program, ``jax.distributed.initialize`` performs
the rendezvous (its timeout is the liveness check — a host that misses the
barrier fails the job rather than hanging it), and the global mesh spans
all processes' devices.  Collectives (halo all-to-alls) compile to NCCL:
NVLink between the cards of one host, the network across hosts.  The
mesh from :func:`ggnn.parallel.mesh.make_mesh` keeps the graph axis
innermost, so a graph split within one host stays on NVLink.

Recovery model (minimal viable per SURVEY.md §5.3): deterministic
resumable training via :mod:`ggnn.train.checkpoint` — on any host
failure the job restarts from the last checkpoint with identical data
order (epoch-seeded loader) and continues the exact curve."""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         init_timeout_s: int = 300) -> bool:
    """Initialize the JAX distributed runtime; no-op when single-process.

    Returns True when running multi-process.  Env-var driven when args are
    None (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID);
    nothing is autodetected, so a multi-process run passes all three."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None

    if coordinator_address is None and num_processes in (None, 1):
        return False  # single-process

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        initialization_timeout=init_timeout_s)
    return True


def is_primary() -> bool:
    """Host-0 check for metrics aggregation / checkpoint writing."""
    return jax.process_index() == 0
