"""ggnn — a Gated Graph (Sequence) Neural Network framework in JAX.

A from-scratch JAX/XLA implementation of the GGNN/GGS-NN model family
(Li, Tarlow, Brockschmidt, Zemel, "Gated Graph Sequence Neural Networks",
ICLR 2016) with the capabilities of the reference repo ``crismolav/ggnn``
(see SURVEY.md; the reference mount was empty at build time, so parity is
certified against the in-repo NumPy oracle per SURVEY.md §0.2).

Layering (SURVEY.md §1.3):

- :mod:`ggnn.graph`      — static-shape padded graph batch containers
- :mod:`ggnn.data`       — bAbI parser, task generators, batching
- :mod:`ggnn.oracle`     — dependency-free NumPy oracle (parity target)
- :mod:`ggnn.ops`        — typed message aggregation (xla / onehot / window)
- :mod:`ggnn.models`     — GGNN cell, readout heads, GGS-NN
- :mod:`ggnn.train`      — configs, jitted train/eval steps, checkpoints, metrics
- :mod:`ggnn.parallel`   — mesh, edge partitioning, halo exchange
"""

__version__ = "0.1.0"

from ggnn.graph import GraphBatch, PaddingSpec  # noqa: F401
