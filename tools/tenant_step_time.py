"""Time the cold four-hall tenant fleet step of ``chip_smoke.py`` phase 12f.

The case: ``build_datacenter()`` cut at its 4 halls with
``appendix_b_layout(seed=0)`` split at the cut, ``TelemetrySim`` seed 0
sample 0, stacked mode, every kernel flag.  After one untimed cold step
the script runs ``--reps`` cold steps (``reset_warm`` before each) and
prints each one's wall, the phase iterations of each hall and the wall per
PDHG iteration of the slowest hall (the lanes run as long as it does).
Then one more cold step under torch.profiler gives the CUDA runtime's
launch calls on the host, per iteration of the slowest hall.  Each hall's
grant left unallocated (grant - its allocation sum) closes the output.

    python3 tools/tenant_step_time.py [--reps 3]

Needs a CUDA card.  The script reads only what the repo's ``src`` held
since the fleet was ported, so a copy placed in ``tools/`` of an older
checkout times that checkout.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.nvpax import NvpaxOptions  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.fleet import FleetOrchestrator  # noqa: E402
from repro_torch.pdn.telemetry import TelemetrySim, TraceConfig  # noqa: E402
from repro_torch.pdn.tenants import appendix_b_layout  # noqa: E402
from repro_torch.pdn.tree import build_datacenter  # noqa: E402

# the runtime's calls that enqueue work on the card
LAUNCH = re.compile(r"^cu(da)?(Launch|GraphLaunch)")


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tenant_step_time: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}; source: {Path(__file__).resolve().parent.parent}", flush=True)
    pdn = build_datacenter()
    sim = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0))
    tele, act = sim.power(0), sim.active_mask(0)
    opts = NvpaxOptions(solver=SolverOptions(use_pallas=True, use_pallas_tree=True,
                                             use_pallas_stats=True))
    orch = FleetOrchestrator(pdn, level=1, tenants=appendix_b_layout(pdn, seed=0),
                             mode="stacked", options=opts, device=torch.device("cuda"))

    def step():
        orch.reset_warm()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orch.step(tele, active=act)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    res, _ = step()
    slowest = int(np.max(np.sum(res.stats["phase_iterations"], 1)))
    for rep in range(args.reps):
        res, wall = step()
        print(f"rep {rep}: {wall * 1e3:.1f} ms, iterations "
              f"{res.stats['phase_iterations'].tolist()}, {wall * 1e3 / slowest:.4f} ms per "
              f"iteration of the slowest hall's {slowest}", flush=True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    launches = sum(bool(LAUNCH.match(e.name)) for e in prof.events())
    print(f"launch calls: {launches} in a cold step, {launches / slowest:.2f} per iteration of "
          "the slowest hall", flush=True)
    offs = np.concatenate([[0], np.cumsum(orch.domain_sizes)])
    left = [float(res.grants[k] - res.allocation[offs[k]:offs[k + 1]].sum())
            for k in range(orch.k)]
    print(f"unallocated per hall: {[round(v, 1) for v in left]} W", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
