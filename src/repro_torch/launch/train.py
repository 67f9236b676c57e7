"""Training launcher (the port's ``repro/launch/train.py``): the end-to-end
training entry point with checkpoint and restart, a crash drill, optional
power management and int8 gradient compression.

On the card (``--device cuda``, the default; it raises without one):
    python -m repro_torch.launch.train --arch qwen3-4b --steps 100
On the CPU (reduced config):
    python -m repro_torch.launch.train --reduced --steps 50 --device cpu

Restart drill: ``--ckpt-dir D --ckpt-every 2 --fail-at 4`` saves steps 2 and
4, then exits with code 42 as a crashed job would; the same command with
``--resume`` instead of ``--fail-at`` restores step 4 and goes on, and its
steps give the losses of a run that never stopped.  ``--compress-grads``
quantizes the gradients to int8 with error feedback before AdamW, the
error carried from step to step (the reference's jitted step traces its
hook once, so there the error stays at zero after step 0).
``--power-managed`` runs the nvPAX control loop beside training, on the
same device, and reports the DVFS step-time multiplier of its caps.
Weights are drawn from a seeded ``torch.Generator`` (seed 0) on the device.

``--mesh DxM`` past 1x1 trains on a ("data", "model") device mesh of D x M
ranks, as the reference's launcher does on its mesh: the weights and
AdamW moments are DTensors placed by the model's logical spec tree
(:mod:`repro_torch.sharding`), the batch is split on its rows, and every
rank draws the same weights and batches.  The run joins the current process
group, or a ``torchrun``-style world when ``WORLD_SIZE`` is set, or else
spawns the other ranks itself over a ``FileStore`` and is rank 0, which
prints the log lines.  A new group runs on NCCL where each rank has a card
of its own, else on gloo (``compat.world_backend``), which carries a card's
tensors through host memory (:mod:`repro_torch.sharding.hoststaged`), as
four ranks of one card do.  A checkpoint holds whole leaves,
so a run resumes at any mesh:
    python -m repro_torch.launch.train --arch whisper-tiny --batch 4 --seq 448 --mesh 2x2
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch import kernels

from repro_torch.compat import group_backend, resolve_device, staged_on_host, world_backend
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import build
from repro_torch.pdn.tree import build_from_level_sizes
from repro_torch.power.controller import PowerController
from repro_torch.power.power_model import DvfsModel, arch_power_profile
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.sharding import (
    default_rules,
    hoststaged,
    is_distributed,
    param_sharding,
    placements,
    resolve_spec,
    use_rules,
)
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.compression import make_compressor
from repro_torch.training.state import TrainState, gathered
from repro_torch.training.step import init_train_state, make_train_step

__all__ = ["TrainRun", "main", "parse_args", "run"]

GROUP_TIMEOUT_S = 300  # a mesh's collectives and its spawned ranks' join


class TrainRun(NamedTuple):
    losses: list[float]
    grad_norms: list[float]
    slowdowns: list[float]  # the DVFS multiplier per step (1.0 without --power-managed)
    step_ms: list[float]  # host wall of each train step, ending in the loss's read back
    control_ms: list[float]  # host wall of each controller step and its multiplier
    start_step: int
    state: TrainState  # whole (gathered) on a mesh
    grad_err: list | None  # the carried compression error after the last step (whole)
    # on a mesh (None at 1x1): "mesh" its axes, "placements" each weight's at
    # the end (params.tree's layout), "collectives" each step's by kind
    # ({"calls", "bytes"} this rank sent in), "ranks" each rank's
    # "shard_bytes" (its parameters and moments) and kernel "launches"
    mesh_report: dict | None = None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL axis sizes")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--power-managed", action="store_true",
                    help="run the nvPAX control loop alongside training and "
                         "report capped step-time multipliers")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a crash at this step (restart drill)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def run(args: argparse.Namespace) -> TrainRun:
    """Train ``args.steps`` steps (from the latest checkpoint with
    ``--resume``), printing the reference's log lines (on rank 0 of a
    mesh).  Past ``--mesh 1x1`` the run joins the current process group, or
    a ``torchrun``-style world when ``WORLD_SIZE`` is set, or else spawns
    the other ranks itself and is rank 0."""
    d, m = _mesh_shape(args.mesh)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    if d * m == 1:
        return _train(args, cfg, device, None)
    with _world(args, d * m, device):
        return _train(args, cfg, device, make_test_mesh(d, m, device=device))


def _mesh_shape(mesh: str) -> tuple[int, int]:
    try:
        d, m = (int(x) for x in mesh.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {mesh!r}: expected DATAxMODEL, e.g. 2x2") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {mesh!r}: axis sizes must be positive")
    return d, m


def _argv(args: argparse.Namespace) -> list[str]:
    """The command line that parses to ``args`` (for the spawned ranks)."""
    out = []
    for action in _parser()._actions:
        if not action.option_strings or action.dest == "help":
            continue
        value = getattr(args, action.dest)
        if isinstance(action, argparse._StoreTrueAction):
            out += [action.option_strings[0]] if value else []
        elif value is not None:
            out += [action.option_strings[0], str(value)]
    return out


@contextlib.contextmanager
def _world(args, world: int, device: torch.device):
    """A process group of ``world`` ranks for the run: the current one if
    there is one; with ``WORLD_SIZE`` set, this process's place in that
    ``torchrun``-style world (``RANK``, ``env://``); otherwise ``world - 1``
    ranks spawned here over a ``FileStore`` (this process is rank 0), joined
    when the run ends.  Ranks spawned on the CPU share its cores: each takes
    its share of torch's threads (a card's ranks keep torch's default: a
    share made phase 18 slower on the H100)."""
    # DTensor's notes on the collectives it picks (every rank, every step)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"--mesh {args.mesh} needs {world} ranks; the process group has "
                             f"{dist.get_world_size()}")
        _stage(device, group_backend(None, device))
        yield
        return
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"--mesh {args.mesh} needs {world} ranks; WORLD_SIZE is "
                             f"{os.environ['WORLD_SIZE']}")
        with _group("env://", int(os.environ["RANK"]), world, device):
            yield
        return
    tmp = tempfile.mkdtemp(prefix="train_world_")
    store = f"file://{tmp}/store"
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")])))
    threads = torch.get_num_threads()
    if device.type == "cpu":
        share = max(1, min(threads, (os.cpu_count() or 1) // world))
        env.setdefault("OMP_NUM_THREADS", str(share))
        torch.set_num_threads(share)
    code = "import sys; from repro_torch.launch.train import _spawned; _spawned(sys.argv[1:])"
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(1, world)]
    procs = [subprocess.Popen([sys.executable, "-c", code, store, str(r), str(world),
                               *_argv(args)], env=env, stdout=log, stderr=log)
             for r, log in zip(range(1, world), logs)]
    done = False
    try:
        with _group(store, 0, world, device):
            yield
            done = True
    finally:
        failed = []
        for r, (proc, log) in enumerate(zip(procs, logs), start=1):
            try:
                proc.wait(timeout=GROUP_TIMEOUT_S if done else 30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            if done and proc.returncode != 0:
                log.seek(0)
                failed.append(f"rank {r} exited {proc.returncode}: {log.read()[-3000:]}")
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.set_num_threads(threads)
        if failed:
            raise RuntimeError("\n".join(failed))


@contextlib.contextmanager
def _group(init_method: str, rank: int, world: int, device: torch.device):
    """This process as ``rank`` of a new group of ``world`` ranks, on
    ``compat.world_backend``'s backend (NCCL: each rank on a card of its
    own), for the duration of the block."""
    backend = world_backend(device, world)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    _stage(device, backend)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _stage(device: torch.device, backend: str) -> None:
    """Where the group carries ``device``'s tensors through the host, the
    kernels that stage DTensor's collectives there."""
    if staged_on_host(device, backend):
        hoststaged.install()


def _spawned(argv: list[str]) -> None:
    """A rank that :func:`_world` spawned: ``argv`` is the group's init
    method, this rank, the world size and the run's arguments."""
    init_method, rank, world, *rest = argv
    args = parse_args(rest)
    with _group(init_method, int(rank), int(world), resolve_device(args.device)):
        run(args)


def _place(batch: dict, rules) -> dict:
    """Each batch tensor (the same full value on every rank) sharded on its
    rows by the "batch" rule."""
    out = {}
    for k, v in batch.items():
        spec = resolve_spec(("batch",) + (None,) * (v.dim() - 1), v.shape, rules)
        out[k] = distribute_tensor(v, rules.mesh, placements(spec, rules.mesh),
                                   src_data_rank=None)
    return out


def _shard_bytes(state: TrainState) -> int:
    """The bytes of this rank's own parameters and moments."""
    return sum(t.to_local().nbytes if is_distributed(t) else t.nbytes
               for tree in (state.params, state.opt.m, state.opt.v) for t in tree.parameters())


def _train(args, cfg, device, mesh) -> TrainRun:
    api = build(cfg)
    rules = default_rules(mesh) if mesh is not None else None
    leader = mesh is None or dist.get_rank() == 0

    def say(msg):
        if leader:
            print(msg, flush=True)

    data = SyntheticLMData(cfg.vocab, seed=0)
    enc = (cfg.enc_frames, cfg.d_model) if cfg.is_encdec else None
    gen = torch.Generator(device=device).manual_seed(0)
    with _sharded(rules):
        state = init_train_state(cfg, api, gen, device, rules=rules)
    shardings = None if mesh is None else param_sharding(api.specs(), state.params, rules)

    start_step = 0
    if args.resume and args.ckpt_dir:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None:
            state = ckpt_lib.restore(args.ckpt_dir, latest, state, shardings, cfg=cfg)
            start_step = latest
            say(f"resumed from step {latest}")

    grad_hook = None
    comp_state = {}
    if args.compress_grads:
        init_err, apply = make_compressor(cfg)
        comp_state["err"] = init_err(state.params)

        def grad_hook(grads):  # error feedback, carried from step to step
            g_hat, comp_state["err"] = apply(grads, comp_state["err"])
            return g_hat

    step_fn = make_train_step(cfg, api, lr=args.lr, warmup=10, total_steps=args.steps,
                              grad_postprocess=grad_hook)

    controller = None
    dvfs = DvfsModel()
    if args.power_managed and leader:
        # one PDN "job slice": enough servers for this job's devices
        pdn = build_from_level_sizes([2, 2], gpus_per_server=8)
        controller = PowerController(pdn, device=device)
        mean_w, burst_w, burst_p = arch_power_profile(cfg.family)

    losses, grad_norms, slowdowns, step_ms, control_ms, collectives = [], [], [], [], [], []
    t_start = time.time()
    rng = np.random.default_rng(1)
    for step in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in data.batch(step, args.batch, args.seq, enc=enc).items()}
        hoststaged.COLLECTIVES.clear()
        t0 = time.perf_counter()
        with _sharded(rules):
            if rules is not None:
                batch = _place(batch, rules)
            state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        grad_norms.append(float(metrics["grad_norm"]))
        if mesh is not None:
            collectives.append(hoststaged.collective_counts())

        slowdown = 1.0
        if controller is not None:
            draw = mean_w + burst_w * (rng.random(controller.pdn.n) < burst_p)
            t0 = time.perf_counter()
            res = controller.step(draw)
            mult = dvfs.step_time_multiplier(res.allocation)  # read back to the host
            slowdown = float(mult.max())
            control_ms.append((time.perf_counter() - t0) * 1e3)
        if args.power_managed and mesh is not None:  # rank 0's multiplier to every rank
            box = [slowdown]
            dist.broadcast_object_list(box, src=0)
            slowdown = box[0]
        slowdowns.append(slowdown)

        if step % args.log_every == 0 or step == args.steps - 1:
            msg = f"step {step:5d}  loss {losses[-1]:.4f}  gnorm {grad_norms[-1]:.3f}"
            if args.power_managed:
                msg += f"  power-slowdown x{slowdown:.3f}"
            say(msg)

        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt_dir, step + 1, state, cfg=cfg)

        if args.fail_at is not None and step + 1 == args.fail_at:
            say(f"simulating crash at step {step + 1}")
            raise SystemExit(42)

    dt = time.time() - t_start
    if losses:
        say(f"done: {args.steps - start_step} steps in {dt:.1f}s, "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    grad_err = comp_state.get("err")
    mesh_report = None
    if mesh is not None:
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, {
            "shard_bytes": _shard_bytes(state),
            "launches": {k: v for k, v in kernels.launch_counts().items() if v}})
        mesh_report = {
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "placements": state.params.tree(lambda p: tuple(p.placements)),
            "collectives": collectives,
            "ranks": ranks,
        }
        state = gathered(state)
        if grad_err is not None:
            grad_err = [e.full_tensor() for e in grad_err]
    return TrainRun(losses, grad_norms, slowdowns, step_ms, control_ms, start_step, state,
                    grad_err, mesh_report)


@contextlib.contextmanager
def _sharded(rules):
    """On a mesh: the rules in force, and plain tensors (positions, masks)
    taken as replicated beside DTensors."""
    if rules is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with use_rules(rules), implicit_replication():
        yield


def main(argv=None) -> list[float]:
    """Train and return the losses of the steps run."""
    return run(parse_args(argv)).losses


if __name__ == "__main__":
    main()
