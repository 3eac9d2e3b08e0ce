"""Compute ops: typed message aggregation (the framework's SpMM), all in
plain JAX and validated against each other and the oracle (SURVEY.md
§4.1-2):

- :mod:`ggnn.ops.segment` — per-edge gather / einsum / ``segment_sum``
  (the ``xla`` backend, and SDDMM edge gates).
- :mod:`ggnn.ops.onehot` — host-built destination-block layouts
  (the ``onehot`` backend).
- :mod:`ggnn.ops.window` — block-CSR count tiles for clustered graphs
  (the ``window`` backend), with an int8 serving table.
"""

from ggnn.ops.segment import typed_aggregate, sddmm, segment_softmax  # noqa: F401
