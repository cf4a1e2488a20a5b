"""Training: step factory (remat/microbatch/compression) + loop."""

from .step import TrainState, make_train_step, train_state_axes
from .loop import TrainLoop, TrainLoopConfig

__all__ = [
    "TrainState",
    "make_train_step",
    "train_state_axes",
    "TrainLoop",
    "TrainLoopConfig",
]
