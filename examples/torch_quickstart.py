"""Quickstart on the PyTorch port: allocate power across a small
oversubscribed datacenter.

Builds a 2-hall PDN, generates one telemetry snapshot, and runs the full
three-phase nvPAX policy on the card (``--device cpu`` for the CPU),
printing the allocation against the requests and both baselines, as
``examples/quickstart.py`` prints them for the JAX package.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.greedy import greedy_allocate, static_allocate
from repro_torch.core.metrics import satisfaction_ratio
from repro_torch.core.nvpax import optimize
from repro_torch.core.problem import AllocProblem
from repro_torch.pdn.telemetry import TelemetrySim, TraceConfig
from repro_torch.pdn.tree import build_from_level_sizes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 2 halls x 4 racks x 4 servers x 8 GPUs = 256 devices, oversub 0.85/level
    pdn = build_from_level_sizes([2, 4, 4], gpus_per_server=8)
    print(
        f"fleet: {pdn.n} GPUs, {pdn.m} PDN nodes, "
        f"oversubscription {pdn.oversubscription_ratio():.2f}x "
        f"(root budget {pdn.node_cap[0] / 1e3:.1f} kW)"
    )

    telemetry = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0)).power(0)
    problem = AllocProblem.build(pdn, telemetry, device=args.device)
    result = optimize(problem)

    r = problem.r.cpu().numpy()
    a = result.allocation
    print(f"\nrequests: total {r.sum() / 1e3:.1f} kW")
    print(f"nvPAX   : total {a.sum() / 1e3:.1f} kW  "
          f"satisfaction {100 * satisfaction_ratio(r, a):.2f}%")
    for name, base in (
        ("Static", static_allocate(pdn)),
        ("Greedy", greedy_allocate(pdn, telemetry)),
    ):
        print(f"{name:8s}: total {base.sum() / 1e3:.1f} kW  "
              f"satisfaction {100 * satisfaction_ratio(r, base):.2f}%")
    print(f"\nsolver: {result.stats['total_solves']} convex solves, "
          f"{result.stats['total_iterations']} PDHG iterations, "
          f"{1000 * result.wall_time_s:.0f} ms wall")
    return result


if __name__ == "__main__":
    main()
