from .checkpoints import CheckpointManager, load_params_npz, save_params_npz
from .driver import DriverConfig, make_synthetic_encode_fn, run_training
from .trainer import (
    AdamW,
    Batch,
    Draws,
    NullCond,
    TrainState,
    apply_cond_dropout,
    create_train_state,
    loss_fn,
    make_train_step,
    smoothed_weighted_ce,
)

__all__ = [
    "AdamW",
    "Batch",
    "CheckpointManager",
    "DriverConfig",
    "Draws",
    "NullCond",
    "TrainState",
    "apply_cond_dropout",
    "create_train_state",
    "load_params_npz",
    "loss_fn",
    "make_synthetic_encode_fn",
    "make_train_step",
    "run_training",
    "save_params_npz",
    "smoothed_weighted_ce",
]
