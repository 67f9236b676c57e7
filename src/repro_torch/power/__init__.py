"""The closed-loop power controller on top of the allocation engine."""

from repro_torch.power.controller import ControllerConfig, PowerController

__all__ = ["ControllerConfig", "PowerController"]
