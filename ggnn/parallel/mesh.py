"""Device mesh construction (SURVEY.md §2.5).

Axes:
- ``data``  — graph-batch data parallelism
- ``graph`` — edge/node partitioning within a (large) graph: the GNN
  analogue of sequence/tensor parallelism (SURVEY.md §5.7)
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_graph: int | None = None, n_data: int = 1,
              devices=None) -> Mesh:
    """2-D ('data', 'graph') mesh; defaults to all devices on the graph axis.

    The graph axis is innermost, so on several hosts a graph is split
    within a host first (NVLink) before crossing the network."""
    devices = devices if devices is not None else jax.devices()
    if n_graph is None:
        n_graph = len(devices) // n_data
    if n_data * n_graph > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_graph} exceeds {len(devices)} devices")
    arr = np.asarray(devices[: n_data * n_graph]).reshape(n_data, n_graph)
    return Mesh(arr, axis_names=("data", "graph"))
