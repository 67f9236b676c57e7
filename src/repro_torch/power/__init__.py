"""The closed-loop power controller on top of the allocation engine, the
DVFS model, straggler analysis and the trace-driven simulator."""

from repro_torch.power.controller import ControllerConfig, PowerController
from repro_torch.power.power_model import DvfsModel, arch_power_profile
from repro_torch.power.simulator import DatacenterSim
from repro_torch.power.straggler import job_slowdowns, straggler_report

__all__ = [
    "ControllerConfig",
    "DatacenterSim",
    "DvfsModel",
    "PowerController",
    "arch_power_profile",
    "job_slowdowns",
    "straggler_report",
]
