"""How far ``launch.train`` at ``--mesh 1x1`` moves when its embedding
moves by one ulp: the run's own noise floor, against which a run that adds
in another order (a mesh, another device) is held.

Runs the launcher twice from the weights of ``torch.Generator`` seed 0 (drawn
on the CPU, then moved to ``--device``), the second time changed by
``--change``: ``ulp`` moves every element of ``tok_embed`` one float32 ulp
toward +inf; ``bf16-ulp`` one bfloat16 ulp (the size of a rounding of the
bf16 compute); ``microbatch`` splits each batch in two microbatches (the
gradients of the two halves rounded apart, then summed, as ranks that split
the batch do).  Prints the largest relative gap of the losses and, over
every weight and AdamW moment after the last step, the largest gap
element-wise (max |d| / max |leaf|) and in Frobenius norm (|d| / |leaf|),
each with the leaf that sets it.

    python3 tools/launch_ulp_spread.py --device cpu [--steps 3] [--arch qwen3-4b ...]
    python3 tools/launch_ulp_spread.py --arch whisper-tiny --batch 4 --seq 448 --full \
        --change ulp bf16-ulp microbatch

``--full`` runs the published config; without it the reduced one.
``--weights W.npz`` starts both runs from the weights in ``W.npz`` (the
reference's tree flattened as ``{"a/b/c": array}``, as
``tests/test_torch_launch_mesh.py`` writes ``weights_<arch>.npz`` for its
ranks) in place of ``torch.Generator`` seed 0's; the 1x1 runs of that test
start from those.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def _npz_params(path: str, cfg):
    """The weights of ``path`` (a flattened reference tree) as the port's
    ``Params`` on the CPU."""
    import numpy as np

    from repro_torch.convert import encdec_params_from_numpy, lm_params_from_numpy

    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, name = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[name] = z[key]
    from_numpy = encdec_params_from_numpy if cfg.is_encdec else lm_params_from_numpy
    return from_numpy(tree, cfg, "cpu")


def spread(arch: str, steps: int, batch: int, seq: int, device: str, full: bool,
           change: str = "ulp", weights_npz: str | None = None) -> dict:
    import dataclasses

    import torch

    from repro_torch.launch import train

    real, real_step = train.build, train.make_train_step

    def weights(nudge):
        def build(cfg):
            api = real(cfg)

            def init(generator, device_=None):
                p = (_npz_params(weights_npz, cfg) if weights_npz
                     else api.init(torch.Generator().manual_seed(0), "cpu"))
                w = p["tok_embed"].data
                up = torch.full_like(w, float("inf"))
                if nudge and change == "ulp":
                    w.copy_(torch.nextafter(w, up))
                elif nudge and change == "bf16-ulp":
                    w.copy_(torch.nextafter(w.bfloat16(), up.bfloat16()).float())
                return p.to(device_)

            return api._replace(init=init)

        return build

    def step_of(nudge):
        if not (nudge and change == "microbatch"):
            return real_step
        return lambda cfg, api, **kw: real_step(dataclasses.replace(cfg, microbatch=2), api, **kw)

    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
            "--device", device, "--log-every", str(steps)] + ([] if full else ["--reduced"])
    runs = []
    try:
        for nudge in (False, True):
            train.build, train.make_train_step = weights(nudge), step_of(nudge)
            runs.append(train.run(train.parse_args(argv)))
    finally:
        train.build, train.make_train_step = real, real_step
    a, b = runs
    loss = max(abs(x - y) / abs(x) for x, y in zip(a.losses, b.losses))
    elem, fro = (0.0, ""), (0.0, "")
    for tag, ta, tb in (("", a.state.params, b.state.params), ("m/", a.state.opt.m, b.state.opt.m),
                        ("v/", a.state.opt.v, b.state.opt.v)):
        for (name, p), q in zip(ta.named_parameters(), tb.parameters()):
            p, q = p.detach().float(), q.detach().float()
            d = p - q
            elem = max(elem, (float(d.abs().max()) / max(float(p.abs().max()), 1e-30), tag + name))
            fro = max(fro, (float(d.norm()) / max(float(p.norm()), 1e-30), tag + name))
    return {"arch": arch, "change": change, "losses": a.losses, "changed_losses": b.losses,
            "loss": loss, "elementwise": elem, "frobenius": fro}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=["qwen3-4b", "olmoe-1b-7b", "mamba2-1.3b",
                                                  "whisper-tiny"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--weights", default=None, help="start from this npz's weights")
    ap.add_argument("--change", nargs="+", default=["ulp"],
                    choices=["ulp", "bf16-ulp", "microbatch"])
    args = ap.parse_args(argv)
    for arch in args.arch:
        for change in args.change:
            r = spread(arch, args.steps, args.batch, args.seq, args.device, args.full, change,
                       args.weights)
            print(f"{arch}, {change}: losses {r['loss']:.3e} relative; weights and moments "
                  f"{r['elementwise'][0]:.3e} of the leaf's largest magnitude "
                  f"({r['elementwise'][1]}), {r['frobenius'][0]:.3e} in Frobenius norm "
                  f"({r['frobenius'][1]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
