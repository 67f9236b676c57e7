"""Train state (the port's ``repro/training/state.py``)."""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.models.common import Params
from repro_torch.training.optimizer import AdamWState

__all__ = ["TrainState"]


class TrainState(NamedTuple):
    step: int  # optimizer steps taken (the reference's int32 scalar)
    params: Params
    opt: AdamWState
