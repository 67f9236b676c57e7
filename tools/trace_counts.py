"""How far torch.profiler's records of the card can be trusted, on the card.

Profiles ``--pairs`` pairs of paper-fleet steps (an unrecorded and a
recorded ``AllocEngine`` step, held and solved, as ``chip_smoke.py`` phase
13c does) and tallies, per pair, two counts of each step:

- the card's own activity records: ``DtoH`` / ``HtoD`` memcpy records and
  every device record (what phase 13c once read);
- the host-side counts phase 13c reads now (``chip_smoke._host_reads``):
  copies by direction as ATen makes them, and the CUDA runtime's
  synchronize and launch calls.

Then ``--kernel-traces`` runs of ``chip_smoke.device_kernels`` over 5
``tree_matvec`` calls, with the traces it had to take again.

    python3 tools/trace_counts.py [--pairs 10] [--kernel-traces 40]

Needs a CUDA card; prints one line per distinct tuple of counts.  A solved
step's trace holds thousands of records and takes seconds to read, so the
solved pairs set the run time.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def device_records(step) -> tuple[int, int, int]:
    """(DtoH, HtoD, all) records of the card in a trace of ``step()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum("DtoH" in n for n in dev), sum("HtoD" in n for n in dev), len(dev)


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--kernel-traces", type=int, default=40)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_counts: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs._build.build()
    cuda = torch.device("cuda")
    pdn = cs.build_datacenter()
    solver = cs.SolverOptions(use_pallas=True, use_pallas_tree=True, use_pallas_stats=True)
    inc = cs.NvpaxOptions(incremental=True,
                          solver=solver._replace(eps_abs=cs.INC_EPS, eps_rel=cs.INC_EPS))
    plain = cs.NvpaxOptions(solver=solver)
    sim = cs.TelemetrySim(cs.TraceConfig(n_devices=pdn.n, seed=0))
    samples = [sim.power(t) for t in range(cs.REC_SAMPLES + 1)]
    solved = [cs.AllocEngine(pdn, options=plain, recorder=r, device=cuda) for r in (False, True)]
    held = [cs.AllocEngine(pdn, options=inc, recorder=r, device=cuda) for r in (False, True)]
    for e in solved:
        e.step(samples[-1])
        e.step(samples[0])
    for e in held:
        e.step(samples[0])
        if not e.step(samples[0]).stats["skipped"]:
            raise AssertionError("a repeated step did not skip")
    kinds = {"held": (held, samples[0]), "solved": (solved, samples[-1])}
    for kind, ((off, on), power) in kinds.items():
        records, host = collections.Counter(), collections.Counter()
        for _ in range(args.pairs):
            records[device_records(lambda: off.step(power))
                    + device_records(lambda: on.step(power))] += 1
            a, b = cs._host_reads(lambda: off.step(power)), cs._host_reads(lambda: on.step(power))
            host[tuple(a.values()) + tuple(b.values())] += 1
        print(f"{kind}: the card's records (DtoH, HtoD, all) unrecorded + recorded, "
              f"{args.pairs} pairs:")
        for key, n in records.most_common():
            print(f"  {key} x{n}")
        print(f"{kind}: host-side counts (d2h, syncs, h2d, launch calls) unrecorded + "
              f"recorded, {args.pairs} pairs:")
        for key, n in host.most_common():
            print(f"  {key} x{n}")
    x = torch.rand(pdn.n, dtype=torch.float64, device=cuda)
    idx = cs.tk.tree_index(pdn.node_start, pdn.node_end, pdn.n, device=cuda)
    cs.TRACE_RETRIES.clear()
    kept = collections.Counter(len(cs.device_kernels(lambda: cs.tk.tree_matvec(x, idx), 5))
                               for _ in range(args.kernel_traces))
    again = collections.Counter((r["attempt"], r["traced_kernels"]) for r in cs.TRACE_RETRIES)
    print(f"device_kernels, 5 tree_matvec calls, {args.kernel_traces} runs: kernels in the kept "
          f"trace {dict(kept)}; traces taken again (attempt, kernels seen) {dict(again)}")
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
