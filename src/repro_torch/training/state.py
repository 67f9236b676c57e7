"""Train state (the port's ``repro/training/state.py``)."""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.models.common import Params
from repro_torch.sharding import gather_params
from repro_torch.training.optimizer import AdamWState

__all__ = ["TrainState", "gathered"]


class TrainState(NamedTuple):
    step: int  # optimizer steps taken (the reference's int32 scalar)
    params: Params
    opt: AdamWState


def gathered(state: TrainState) -> TrainState:
    """``state`` with its weights and moments whole: a DTensor's full value
    (a collective every rank of its mesh calls), a plain tensor as it is."""
    return TrainState(step=state.step, params=gather_params(state.params),
                      opt=AdamWState(m=gather_params(state.opt.m), v=gather_params(state.opt.v)))
