"""Data layer: bAbI graph-task parsing, generation, and static-shape batching.

SURVEY.md §2.1 C2/C10/C11.  The reference ships committed preprocessed bAbI
graph files; the mount was empty (SURVEY.md §0), so this package vendors
deterministic generators that emit the same text format (SURVEY.md §2.2) and
a parser for it.
"""

from ggnn.data.babi import (  # noqa: F401
    TASKS,
    TaskSpec,
    BabiDataset,
    parse_graph_file,
    examples_to_graphs,
)
from ggnn.data.generators import generate_task_file, generate_all  # noqa: F401
from ggnn.data.loader import BatchLoader  # noqa: F401
