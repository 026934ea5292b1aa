"""Training substrate: AdamW, schedules, the train-step builder, the
state's shapes and shardings."""
from .optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    make_schedule,
)
from .step import (
    TrainState,
    abstract_state,
    init_state,
    make_train_step,
    state_shardings,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "TrainState",
    "abstract_state",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "init_state",
    "make_schedule",
    "make_train_step",
    "state_shardings",
]
