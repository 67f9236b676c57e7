"""Trace-driven closed-loop simulation at datacenter scale on the PyTorch
port (paper section 5 in miniature): the full 12k-GPU geometry, a window
of 30 s control steps, nvPAX vs Static vs Greedy, straggler tax, and the
controller's wall time, as ``examples/datacenter_simulation.py`` prints
them for the JAX package.  The paper's figures in brackets are the
paper's, not this port's.

    PYTHONPATH=src python examples/torch_datacenter_simulation.py --steps 20 [--device cpu]
"""

import argparse

from repro_torch.pdn.tree import build_datacenter
from repro_torch.power.simulator import DatacenterSim


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--devices", type=int, default=None,
                    help="override fleet size (default: paper's >12k)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.devices:
        from repro_torch.pdn.hierarchy_gen import random_hierarchy

        pdn = random_hierarchy(args.devices, seed=0)
    else:
        pdn = build_datacenter()
    print(f"fleet: {pdn.n} GPUs, oversubscription "
          f"{pdn.oversubscription_ratio():.2f}x")

    sim = DatacenterSim.build(pdn, seed=0, device=args.device)
    out = sim.run(args.steps)

    s = out["S_nvpax"]
    print(
        f"\nnvPAX  satisfaction: mean {100 * s.mean():.2f}%  "
        f"min {100 * s.min():.2f}%  (paper: 98.92 / 96.49)"
    )
    print(f"Static satisfaction: mean {100 * out['S_static'].mean():.2f}%  "
          f"(paper: 81.30)")
    print(f"Greedy satisfaction: mean {100 * out['S_greedy'].mean():.2f}%  "
          f"(paper: 98.92)")
    print(
        f"controller wall time: mean {out['wall_ms'].mean():.0f} ms  "
        f"(paper: 264.69 ms on an M4 Pro)"
    )
    print(f"straggler tax (fleet mean): "
          f"{100 * out['straggler_tax'].mean():.2f}%")
    return out


if __name__ == "__main__":
    main()
