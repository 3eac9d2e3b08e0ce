"""Training layer (SURVEY.md §2.1 C8/C9, §5.4-5.6): typed configs, jitted
train/eval steps, checkpoint/resume, structured metrics."""

from ggnn.train.config import TrainConfig, CONFIGS, build_config  # noqa: F401
from ggnn.train.loop import Trainer  # noqa: F401
from ggnn.train.checkpoint import save_checkpoint, load_checkpoint  # noqa: F401
