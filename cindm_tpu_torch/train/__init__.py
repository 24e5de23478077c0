from .checkpoint import CheckpointManager
from .evaluate import prediction_mae_1d, sampling_eval_1d
from .trainer import (
    Optimizer,
    TrainConfig,
    TrainState,
    cosine_decay_schedule,
    init_train_state,
    make_train_step,
    make_train_step_2d,
    make_train_step_from_loss,
    reference_lr_schedule,
)

__all__ = [
    "CheckpointManager",
    "Optimizer",
    "TrainConfig",
    "TrainState",
    "cosine_decay_schedule",
    "init_train_state",
    "make_train_step",
    "make_train_step_2d",
    "make_train_step_from_loss",
    "prediction_mae_1d",
    "reference_lr_schedule",
    "sampling_eval_1d",
]
