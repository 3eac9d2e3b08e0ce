"""Distribution layer (SURVEY.md §2.5, §5.7-5.8): device mesh, edge
partitioning, halo-exchange propagation, sharded training steps.

The reference is single-process/single-device (SURVEY.md §1.1); everything
here is new design: JAX collectives via shard_map and GSPMD sharding
annotations, which XLA lowers to NCCL on GPUs — no hand-written transport.
On a four-H100 host every card reaches every other over NVLink in one
hop, so the mesh order carries no neighbour preference.
"""

from ggnn.parallel.mesh import make_mesh  # noqa: F401
from ggnn.parallel.partition import partition_batch  # noqa: F401
from ggnn.parallel.halo import (make_sharded_eval_step,  # noqa: F401
                                    make_sharded_task_train_step,  # noqa: F401
                                    make_sharded_train_step,  # noqa: F401
                                    sharded_node_select_loss,  # noqa: F401
                                    sharded_propagate)  # noqa: F401
