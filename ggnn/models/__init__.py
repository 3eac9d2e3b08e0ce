"""Model layer: GGNN propagation cell, readout heads, GGS-NN.

Pure-functional (params are nested dicts of arrays, shared layout with the
NumPy oracle — see :mod:`ggnn.oracle.numpy_ggnn` docstring).
"""

from ggnn.models.config import ModelConfig, model_config_for_task  # noqa: F401
from ggnn.models.init import init_params  # noqa: F401
from ggnn.models.ggnn import propagate  # noqa: F401
from ggnn.models.api import forward, loss_and_metrics  # noqa: F401
