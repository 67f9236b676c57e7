"""The controls on the card at each cell's own size (``gpu``: skipped
without a card): the reference at the precision below the configuration's
(float8 operands for bf16 compute), read by a run's comparisons, fails the
cell's limits.  On the CPU the same controls at tiny widths, and the
training driver's (float32 for the allocator's float64, and half of each
batch left out), depart from float32 by far more than rounding."""

from __future__ import annotations

import pytest

from portbench import control, harness

SEED = 2**31 + 2024


def _failed(cell, values):
    return [c.name for c in harness.checks_from(values, cell.limits["limits"]) if not c.ok]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stablelm-12b.prefill", "mamba2-1.3b.prefill"])
def test_prefill_control_fails_on_the_card(card, name):
    cell = harness.load_cell(name)
    values = control.prefill_control(cell, SEED, card, tiny=False)
    assert _failed(cell, {k: v for k, v in values.items() if k in cell.limits["limits"]})


def test_controls_depart_at_tiny_widths_on_the_cpu(train_cell):
    import torch

    cpu = torch.device("cpu")
    pre = control.prefill_control(harness.load_cell("stablelm-12b.prefill"), SEED, cpu, True)
    assert pre["logits_rel"] > 1e-2
    train = control.train_control(train_cell, SEED, cpu, True)
    assert train["loss_gap"] > 1e-3 and train["alloc_gap_w"] > 1e-6
    half = control.train_control(train_cell, SEED, cpu, True, fault="half")
    assert half["loss_gap"] > 1e-3
