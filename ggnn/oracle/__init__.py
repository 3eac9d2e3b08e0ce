"""Dependency-free NumPy oracle for GGNN/GGS-NN (SURVEY.md §0.2).

The reference mount was empty at build time, so per-layer ``allclose``
parity (BASELINE.json:5) is certified against this oracle — a direct,
dense-math transcription of the paper equations in SURVEY.md §2.3.  When the
real reference appears, validate the oracle against it once (SURVEY.md §0.1.3)
and it becomes a certified stand-in.
"""

from ggnn.oracle.numpy_ggnn import (  # noqa: F401
    oracle_propagate,
    oracle_propagate_dense,
    dense_adjacency,
    oracle_node_select,
    oracle_per_node,
    oracle_graph_gated,
    oracle_ggsnn,
)
