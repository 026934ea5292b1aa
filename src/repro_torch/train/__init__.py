"""Training substrate: AdamW, schedules, the train-step builder.

The reference's ``abstract_state`` and ``state_shardings`` wait for the
port of ``parallel/sharding`` and ``launch/dryrun``."""
from .optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    make_schedule,
)
from .step import TrainState, init_state, make_train_step

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "TrainState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "init_state",
    "make_schedule",
    "make_train_step",
]
