"""A run driven on the CPU at tiny widths (float32 compute, so that a sound
run reads only rounding), its chip check skipped, with the timed path
broken underneath: ``correct`` comes out false for each fault the cell can
have, against the cell's own limits, and true for the sound run."""

from __future__ import annotations

import argparse

import pytest
import torch

from portbench import harness

SEED = 2**31 + 99


def _run(cell, seconds=0.3, trace=0):
    cell.config["tiny"] = dict(cell.config["tiny"], compute_dtype="float32")
    args = argparse.Namespace(workload=cell.name, seed=SEED, seconds=seconds, trace=trace)
    out = harness.driver(cell).run(cell, args, torch.device("cpu"), tiny=True)
    return out, harness.result_line(cell, out, bool(trace), 1.0)


def _altered_answer(monkeypatch):
    from repro_torch.models import lm

    orig = lm.lm_prefill

    def prefill(params, cfg, tokens):
        logits, caches = orig(params, cfg, tokens)
        logits = logits.clone()
        logits[:, -1, 1] = logits[:, -1].amax(-1) + 1.0  # the served token made 1
        return logits, caches

    monkeypatch.setattr(lm, "lm_prefill", prefill)


def _half_batch(monkeypatch):
    from repro_torch.models import lm

    orig = lm.lm_prefill

    def prefill(params, cfg, tokens):
        half = max(1, tokens.shape[0] // 2)
        logits, caches = orig(params, cfg, tokens[:half])
        idx = torch.arange(tokens.shape[0]) % half
        return logits[idx], [type(c)(*(t[idx] for t in c)) for c in caches]

    monkeypatch.setattr(lm, "lm_prefill", prefill)


def _state_unchanged(monkeypatch):
    from repro_torch.models import lm

    orig = lm.lm_prefill

    def prefill(params, cfg, tokens):
        logits, caches = orig(params, cfg, tokens)
        return logits, [type(c)(*(torch.zeros_like(t) for t in c)) for c in caches]

    monkeypatch.setattr(lm, "lm_prefill", prefill)


@pytest.mark.parametrize("cell", ["stablelm-12b.prefill", "mamba2-1.3b.prefill"])
@pytest.mark.parametrize("fault", [None, _altered_answer, _half_batch, _state_unchanged])
def test_prefill_faults_read_incorrect(cell, fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    _, line = _run(harness.load_cell(cell))
    assert line["correct"] is (fault is None), line["checks"]


def _optimizer_skipped(monkeypatch):
    from repro_torch.training import step
    from repro_torch.training.optimizer import clip_by_global_norm

    def update(grads, opt, params, **kw):  # the state returned unchanged
        return params, opt, clip_by_global_norm(grads, 1.0)[1]

    monkeypatch.setattr(step, "adamw_update", update)


def _half_batch_train(monkeypatch):
    from repro_torch.training import step

    orig = step._microbatch

    def part(v, i, mb):  # half of the batch left out, the mean over the rest
        if mb > 1:
            return orig(v, i % (mb // 2), mb)
        rows = orig(v, i, mb)
        return rows[: max(1, rows.shape[0] // 2)]

    monkeypatch.setattr(step, "_microbatch", part)


def _altered_allocation(monkeypatch):
    from repro_torch.power.controller import PowerController

    orig = PowerController.step

    def step(self, telemetry, **kw):
        res = orig(self, telemetry, **kw)
        res.allocation = res.allocation.copy()
        res.allocation[0] -= 1.0  # one device's cap a watt low
        return res

    monkeypatch.setattr(PowerController, "step", step)


@pytest.mark.parametrize("fault", [None, _optimizer_skipped, _half_batch_train,
                                   _altered_allocation])
def test_training_faults_read_incorrect(train_cell, fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    _, line = _run(train_cell)
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("cell,span,mfu", [("stablelm-12b.prefill", "forward", "mfu.prefill"),
                                           (None, "train_step", "mfu.train")])
def test_a_traced_run_reads_the_host_clock_in_its_untraced_half(cell, span, mfu, train_cell):
    """The profiler runs over the window's second half only: the host-clock
    metrics read the spans and the work of the first half, which no
    profiler slowed, and the traced half's spans are only ranges of the
    trace.  (The CPU leaves the device's metrics with nothing to read.)"""
    cell = harness.load_cell(cell) if cell else train_cell
    out, line = _run(cell, seconds=0.6, trace=1)
    rec = out.record
    assert line["correct"] and rec.host_items and rec.items
    assert 0 < rec.host_window_s and 0 < rec.window_s
    assert len(rec.spans[span]) == len(rec.host_items)
    assert sum(1 for r in rec.host_ranges if r[0] == span) == len(rec.items)
    assert line["metrics"][mfu]["value"] > 0
    assert not any(k.startswith("device_idle.") for k in line["metrics"])
