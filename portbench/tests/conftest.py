"""The benchmark's CPU tests (``python -m pytest portbench/tests``): the
repository root and ``src`` on the path, the ``card`` fixture that a test
marked ``gpu`` takes to skip where no card is visible (decided when the
test runs, never at import), and ``train_cell``, a cell of the
``train_pm`` driver, which no entry of ``BENCHMARK.json`` holds yet."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


# a training cell's limits on the card (PERF.md): the loss of each set-up
# step, the first gradient and three steps' change by the worst leaf, and
# every controller step's allocation in watts
TRAIN_LIMITS = {"loss_gap": 1.2e-3, "grad_gap": 7e-3, "change_gap": 1e-3, "alloc_gap_w": 1e-3}


@pytest.fixture
def train_cell():
    """mamba2-1.3b under ``train_pm``: the cell that waits for the port's
    SSD backward to be finite at the published widths."""
    from portbench import harness

    config = harness.read_json(ROOT / "portbench/configs/mamba2-1.3b.json")
    traffic = harness.read_json(ROOT / "portbench/traffic/train_pm.json")
    e2e = [{"name": "train_tokens_per_s", "unit": "tokens/s"}, {"name": "setup_s", "unit": "s"}]
    per_layer = [{"name": n, "unit": u} for n, u in (
        ("mfu.train", "%"), ("train_step_ms.train", "ms"), ("control_ms.train", "ms"),
        ("control_iterations.train", "count"), ("device_idle.train", "%"))]
    return harness.Cell("mamba2-1.3b.train_pm", 1, config, traffic, {"limits": TRAIN_LIMITS},
                        e2e, per_layer)
