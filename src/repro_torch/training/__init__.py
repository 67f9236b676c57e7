"""Training and serving steps (the port's ``repro.training``): AdamW, the
cosine schedule, the train state and the step factories."""

from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.training.schedule import cosine_schedule
from repro_torch.training.state import TrainState
from repro_torch.training.step import init_train_state, make_serve_steps, make_train_step

__all__ = [
    "AdamWState",
    "TrainState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "init_train_state",
    "make_serve_steps",
    "make_train_step",
]
