"""Run one cell of the port's benchmark once and print its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``, ``portbench/`` and
the port (``src/repro_torch``).  The cell's traffic kind names its driver
(``portbench/drivers/<kind>.py``); the driver makes the inputs and weights
from the seed on the card, warms every shape the cell uses, measures for
``--seconds`` and compares what the timed path produced with the plain
references.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` (a run of its own, under ``torch.profiler``) its per-layer metrics and a
breakdown.  The numbers compared are printed beside their limits as the last
lines of standard error, and under ``checks`` as the last key of the result
line, the last line of standard output.  Exit codes: 0 with a result, 2 for
a cell, file or guard that does not hold, 3 without the cards the cell
needs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness

    harness.use_checkout_caches(ROOT)
    try:
        faults = harness.reference_import_faults(ROOT)
        if faults:
            raise harness.HarnessError(f"the references import what they may not: {faults}")
        if not (ROOT / "src" / "repro_torch").is_dir():
            raise harness.HarnessError(f"no port under {ROOT / 'src'}")
        cell = harness.load_cell(args.workload, ROOT)
        drive = harness.driver(cell)
    except harness.HarnessError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    try:
        device = harness.require_chips(cell.chips)
    except harness.HarnessError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3

    import torch

    torch.cuda.synchronize(device)  # the context, before the driver's clock marks
    cuda_ready_s = harness.process_age_s()
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False  # the references' float32
    torch.backends.cudnn.allow_tf32 = False
    out = drive.run(cell, args, device)
    out.notes["cuda_ready_s"] = cuda_ready_s
    line = harness.result_line(cell, out, bool(args.trace), out.notes["setup_s"])
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 2
    for k, v in out.notes.items():
        print(f"portbench: {k} = {v}", file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
