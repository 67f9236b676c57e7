"""Repeat ``chip_smoke.py`` phase 16c for one family: how far the card's
training of a reduced config lands from the port's CPU run, run after run.

Each repetition builds the reduced config's weights from ``torch.Generator``
seed 0 on the CPU, runs the loss, its gradients and three
``make_train_step`` steps on the CPU and on the card from the same weights
and batches, and prints the largest gap of the gradients and of the
parameters after the steps (max |d| / max |CPU leaf|) with the leaf that
sets it.  The spread over repetitions is the card's and the CPU's own run
to run noise on that case.

    python3 tools/reduced_train_spread.py [--arch jamba-v0.1-52b] [--reps 5]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("reduced_train_spread: no CUDA device is available", file=sys.stderr)
        return 2
    _build.library()
    cuda = torch.device("cuda")
    for rep in range(args.reps):
        r, _ = chip_smoke._reduced_train(args.arch, cuda)
        print(f"rep {rep}: gradients {r['grad_err']:.4e} ({r['grad_leaf']}), parameters after "
              f"{chip_smoke.REDUCED_TRAIN_STEPS} steps {r['param_err']:.4e} ({r['param_leaf']})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
