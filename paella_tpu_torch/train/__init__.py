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
    "Draws",
    "NullCond",
    "TrainState",
    "apply_cond_dropout",
    "create_train_state",
    "loss_fn",
    "make_train_step",
    "smoothed_weighted_ce",
]
