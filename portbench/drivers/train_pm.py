"""A power-managed training job: the loop of ``launch/train.py
--power-managed``, run by the benchmark: each iteration one
``training.step.make_train_step`` step, then one ``PowerController.step``
on the same card, serially, so that the controller's wall adds to the
job's.

Set-up makes the weights, the AdamW state, the PDN and the controller and
drives the same step object through the first iterations (the first
controller step is cold and builds its engine), recording each step's loss,
the first gradient as AdamW received it (its first moment over 1 - b1) and,
after them, each weight's change.  The window runs whole iterations until
``--seconds`` have passed (a traced run traces its second half).  The
controller draws each step's telemetry by the launcher's rule, with the
profile of the configuration's ``family``.  Once it has closed and the port's state is
freed, the plain float32 reference follows the recorded steps from the same
weights and batches, and the plain policy reference allocates every
controller step's telemetry."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness, weights as wmod
from portbench.gen import pdn as pdn_gen
from portbench.gen.telemetry import Telemetry
from portbench.gen.traffic import seed_seq
from portbench.reference import policy
from portbench.reference.train import Trainer
from portbench.trace import DeviceTrace, Record, Spans, window_parts


def leaf_norms(tensors) -> np.ndarray:
    return np.array([float(t.detach().double().norm()) for t in tensors])


def worst_leaf_gap(mine: np.ndarray, theirs: np.ndarray, keep=None) -> float:
    """The largest |mine - theirs| over leaves, each against the larger of
    its reference norm and the median leaf's."""
    keep = np.ones(theirs.shape, bool) if keep is None else keep
    floor = np.median(theirs[keep])
    return float(np.max(np.abs(mine - theirs)[keep] / np.maximum(theirs[keep], floor)))


def controller(p: dict, pdn_arrays: dict, device):
    from repro_torch.core.nvpax import NvpaxOptions
    from repro_torch.core.solver import SolverOptions
    from repro_torch.pdn.tree import FlatPDN
    from repro_torch.power.controller import ControllerConfig, PowerController

    c = p["controller"]
    config = ControllerConfig(idle_threshold=c["idle_threshold"],
                              request_margin=c["request_margin"],
                              options=NvpaxOptions(solver=SolverOptions(**c["solver"])))
    return PowerController(FlatPDN(**pdn_arrays), config=config, device=device)


def run(cell, args, device, tiny: bool = False) -> harness.Outcome:
    from repro_torch.models import build
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.state import TrainState
    from repro_torch.training.step import make_train_step

    p = harness.traffic_params(cell.traffic, tiny)
    cfg = harness.arch(cell.config, tiny)
    port = harness.port_fields(cell.config, tiny)
    opt = p["optimizer"]
    api = build(cfg)
    meta = api.init(None, torch.device("meta"))
    leaves = wmod.layout(meta)
    names = [n for n, _ in leaves]
    w = wmod.make(leaves, cell.config["init"], args.seed, device)
    start = {k: v.clone() for k, v in w.items()}
    params = wmod.port_params(meta, w)
    params.requires_grad_(True)
    state = TrainState(step=0, params=params, opt=adamw_init(params, cfg.opt_dtype))
    step_fn = make_train_step(cfg, api, lr=opt["lr"], warmup=opt["warmup"],
                              total_steps=opt["total_steps"])
    pdn_arrays = pdn_gen.build_datacenter(**p["controller"]["datacenter"])
    ctl = controller(p, pdn_arrays, device)
    telemetry = Telemetry(cell.config["family"], p["tdp_w"], pdn_arrays["dev_l"].shape[0],
                          args.seed)
    data = torch.Generator(device=device).manual_seed(
        int(seed_seq(args.seed, 5).generate_state(1)[0]))
    B, S = p["batch"], p["seq"]
    spans = Spans()
    draws, allocs, losses, batches = [], [], [], []

    def iteration(keep_batch: bool) -> float:
        nonlocal state
        seq = torch.randint(0, cfg.vocab, (B, S + 1), generator=data, device=device)
        batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        if keep_batch:
            batches.append(seq)
        with spans.span("train_step"):
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
        draw = telemetry.draw()
        with spans.span("control"):
            res = ctl.step(draw)
            alloc = np.asarray(res.allocation)
        spans.count("control_iterations", res.stats["total_iterations"])
        spans.count("control_steps")
        draws.append(draw)
        allocs.append(alloc)
        losses.append(loss)
        return loss

    t_weights = harness.process_age_s()
    n_ref = p["reference_steps"]
    beta1 = opt["b1"]
    for i in range(p["setup_steps"]):
        iteration(keep_batch=i < n_ref)
        if i == 0:  # the first gradient as AdamW received it
            grad_norms = leaf_norms(state.opt.m.parameters()) / (1 - beta1)
        if i == n_ref - 1:
            change = leaf_norms(p_ - start[n] for n, p_ in zip(names, params.parameters()))
            del start
    if device.type == "cuda":
        torch.cuda.synchronize()

    n_setup = len(losses)
    host = (Spans(), 0.0, [])  # the untraced part's spans, wall and steps
    setup_s = harness.process_age_s()
    tokens = failed = n_window = 0
    t_start = time.perf_counter()
    t_end = t_start
    for until, traced in window_parts(args.seconds, bool(args.trace)):
        spans, items = Spans(traced=traced), []
        with DeviceTrace(traced) as dev:
            t_part = time.perf_counter()
            while True:
                loss = iteration(keep_batch=False)
                t_end = time.perf_counter()
                tokens += B * S
                n_window += 1
                failed += int(not np.isfinite(loss))
                items.append({"B": B, "L": S})
                if t_end - t_start >= until:
                    break
            part_s = t_end - t_part
        if not traced:
            host = (spans, part_s, items)
    window_s = t_end - t_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del state, params, step_fn, w, ctl
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the plain references, after the window
    t_ref = time.perf_counter()
    w0 = wmod.make(leaves, cell.config["init"], args.seed, device)
    hyper = dict(opt, microbatch=cfg.microbatch)
    trainer = Trainer(w0, port, hyper)  # trains w0 in place
    del w0
    ref_losses = []
    for i, seq in enumerate(batches):
        out = trainer.step(seq[:, :-1], seq[:, 1:])
        ref_losses.append(out["loss"])
        if i == 0:
            ref_grads = np.array([out["grad_norms"][n] for n in names])
        del out
    ref_start = wmod.make(leaves, cell.config["init"], args.seed, device)
    ref_change = leaf_norms(trainer.w[n] - ref_start[n] for n in names)
    del trainer, ref_start
    moved = ref_grads >= 1e-3 * np.median(ref_grads)
    c = p["controller"]
    alloc_gap = max(float(np.max(np.abs(a - policy.allocate(
        pdn_arrays, d, margin=c["request_margin"], idle_threshold=c["idle_threshold"]))))
        for d, a in zip(draws, allocs))
    values = {
        "loss_gap": max(abs(a - b) for a, b in zip(losses[:n_ref], ref_losses)),
        "grad_gap": worst_leaf_gap(grad_norms, ref_grads),
        "change_gap": worst_leaf_gap(change, ref_change, moved),
        "alloc_gap_w": alloc_gap,
    }
    reference_s = time.perf_counter() - t_ref
    out = harness.Outcome(
        attempted=n_window, failed=failed,
        metrics={"train_tokens_per_s": tokens / window_s},
        checks=harness.checks_from(values, cell.limits["limits"]),
        memory_peak_bytes=peak,
        notes={"steps": n_window, "window_s": window_s, "setup_s": setup_s,
               "losses": losses, "ref_losses": ref_losses,
               "control_ms_median": 1e3 * float(np.median(host[0].spans["control"])),
               "train_ms_median": 1e3 * float(np.median(host[0].spans["train_step"])),
               "iterations": host[0].counters["control_iterations"] / len(host[2]),
               "setup_iterations": n_setup, "leaves_left_out": int((~moved).sum()),
               "weights_ready_s": t_weights, "reference_s": reference_s})
    if args.trace:
        out.record = Record(part_s, dev.device_ops, dev.host_ranges, items, host[1],
                            dict(host[0].spans), dict(host[0].counters), host[2],
                            cell.config, p, port)
    return out
