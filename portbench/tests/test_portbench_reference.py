"""The plain references against the port on the CPU at tiny widths, both in
float32: the prefill's logits and caches, three training steps, and the
three-phase policy.  They agree to rounding, so a reading on the card that
is more than the configuration's precision would give is the port's."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, weights as wmod
from portbench.gen import pdn as pdn_gen
from portbench.gen.telemetry import Telemetry
from portbench.reference import lm as ref, policy
from portbench.reference.train import Trainer

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def _setup(name, seed=3):
    from repro_torch.models import build

    config = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    cfg = dataclasses.replace(harness.arch(config, tiny=True), compute_dtype=torch.float32)
    port = harness.port_fields(config, tiny=True)
    api = build(cfg)
    meta = api.init(None, torch.device("meta"))
    leaves = wmod.layout(meta)
    return cfg, port, api, meta, leaves, wmod.make(leaves, config["init"], seed, CPU), config


@pytest.mark.parametrize("name,L", [("stablelm-12b", 16), ("stablelm-12b", 48),
                                    ("mamba2-1.3b", 32), ("mamba2-1.3b", 64)])
def test_prefill_reference_matches_the_port(name, L):
    from repro_torch.training.step import make_serve_steps

    cfg, port, api, meta, _, w, _ = _setup(name)
    prefill, _ = make_serve_steps(cfg, api)
    toks = torch.randint(0, cfg.vocab, (3, L), generator=torch.Generator().manual_seed(L))
    with torch.no_grad():
        logits, caches = prefill(wmod.port_params(meta, w), {"tokens": toks})
        r_logits, r_caches = ref.prefill(w, port, toks)
    assert harness.rel_gap(logits[:, -1], r_logits) < 1e-5
    assert len(caches) == len(r_caches) == cfg.n_layers
    for mine, theirs in zip(caches, r_caches):
        for a, b in zip(mine, theirs):
            assert a.shape == b.shape
            assert harness.rel_gap(a.float(), b) < 1e-5


def test_fp8_control_departs_from_float32():
    cfg, port, _, _, _, w, _ = _setup("stablelm-12b")
    toks = torch.randint(0, cfg.vocab, (2, 48), generator=torch.Generator().manual_seed(1))
    a, _ = ref.prefill(w, port, toks)
    b, _ = ref.prefill(w, port, toks, "fp8")
    assert harness.rel_gap(b, a) > 1e-2


def test_training_reference_matches_the_port():
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.state import TrainState
    from repro_torch.training.step import make_train_step

    cfg, port, api, meta, leaves, w, _ = _setup("mamba2-1.3b")
    traffic = json.loads((ROOT / "portbench/traffic/train_pm.json").read_text())
    opt = traffic["optimizer"]
    trainer = Trainer({k: v.clone() for k, v in w.items()}, port,
                      dict(opt, microbatch=cfg.microbatch))
    start = {k: v.clone() for k, v in w.items()}
    params = wmod.port_params(meta, w)
    params.requires_grad_(True)
    state = TrainState(step=0, params=params, opt=adamw_init(params, cfg.opt_dtype))
    step = make_train_step(cfg, api, lr=opt["lr"], warmup=opt["warmup"],
                           total_steps=opt["total_steps"])
    gen = torch.Generator().manual_seed(9)
    names = [n for n, _ in leaves]
    for i in range(3):
        seq = torch.randint(0, cfg.vocab, (4, 33), generator=gen)
        state, metrics = step(state, {"tokens": seq[:, :-1], "targets": seq[:, 1:]})
        out = trainer.step(seq[:, :-1], seq[:, 1:])
        assert float(metrics["loss"]) == pytest.approx(out["loss"], rel=1e-5)
        if i == 0:
            for n, m in zip(names, state.opt.m.parameters()):
                mine = float((m / (1 - opt["b1"])).double().norm())
                assert mine == pytest.approx(out["grad_norms"][n], rel=1e-4), n
    for n, p in zip(names, params.parameters()):
        assert harness.rel_gap(p - start[n], trainer.w[n] - start[n]) < 1e-4, n


@pytest.mark.parametrize("mixed", [False, True])
def test_policy_reference_matches_the_controller(mixed):
    from repro_torch.core.nvpax import NvpaxOptions
    from repro_torch.pdn.tree import FlatPDN
    from repro_torch.power.controller import ControllerConfig, PowerController

    arrays = pdn_gen.build_datacenter(n_halls=2, racks_per_hall=3, servers_per_rack=2,
                                      gpus_per_server=4)
    n = arrays["dev_l"].shape[0]
    traffic = json.loads((ROOT / "portbench/traffic/train_pm.json").read_text())
    tel = Telemetry("ssm", traffic["tdp_w"], n, 5)
    rng = np.random.default_rng(4)
    pri = rng.integers(1, 4, n) if mixed else None
    ctl = PowerController(FlatPDN(**arrays), priority=pri, config=ControllerConfig(
        options=NvpaxOptions()), device="cpu")
    for _ in range(3):
        draw = tel.draw() if not mixed else rng.uniform(50.0, 700.0, n)
        x = ctl.step(draw).allocation
        r = policy.allocate(arrays, draw, margin=1.05, idle_threshold=150.0, priority=pri)
        assert np.max(np.abs(x - r)) < 1e-4  # the solver's tolerance
        caps = np.array([x[s:e].sum() for s, e in zip(arrays["node_start"], arrays["node_end"])])
        assert np.all(caps <= arrays["node_cap"] + 1e-6)
