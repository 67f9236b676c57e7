"""What every cell's run shares: finding a cell's files by name, the chip
check, the clock of set-up, the import guard, the comparisons against their
limits, and the result line.

Nothing here names a model, a traffic mix or a metric: a cell is found
through ``BENCHMARK.json`` (its configuration and traffic names), a
configuration in ``configs/<name>.json``, a mix in ``traffic/<name>.json``
and its driver in ``drivers/<kind>.py``, the cell's limits in
``cells/<cell>.json``, and each per-layer metric's reader in
``metrics/<name>.py``.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no process of the benchmark may hold: the JAX
# stack and the JAX package (``repro``; the port's ``repro_torch`` begins
# with the same letters, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# what the plain references may not import: the above and the port
REFERENCE_FORBIDDEN = FORBIDDEN + ("repro_torch",)


class HarnessError(RuntimeError):
    """A cell that cannot run here: its files, the chip, or a guard."""


@dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s workloads with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list  # its per-layer metrics
    root: Path = ROOT

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise HarnessError(f"missing file {path}")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic and limits files (found under ``portbench/`` by name)."""
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise HarnessError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    limits = read_json(root / "portbench" / "cells" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer, root)


def load_module(path: Path, name: str) -> ModuleType:
    """A Python file loaded by path (drivers and metric readers are named
    after entries of BENCHMARK.json, which may hold dots)."""
    if not path.is_file():
        raise HarnessError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell) -> ModuleType:
    return load_module(cell.root / "portbench" / "drivers" / f"{cell.kind}.py",
                       f"portbench_driver_{cell.kind}")


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "portbench" / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


# -- guards ------------------------------------------------------------------

def forbidden_modules(modules=None) -> list[str]:
    """The top-level names in ``sys.modules`` that the benchmark may not
    hold, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def imported_names(path: Path) -> set[str]:
    """The top-level module names a Python file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def reference_import_faults(root: Path = ROOT) -> list[str]:
    """Files under ``portbench/reference/`` that import the port, the JAX
    package or JAX, each with what it imports."""
    faults = []
    for path in sorted((root / "portbench" / "reference").glob("*.py")):
        bad = sorted(imported_names(path) & set(REFERENCE_FORBIDDEN))
        if bad:
            faults.append(f"{path.name}: {', '.join(bad)}")
    return faults


def require_chips(n: int):
    """The run's card (cuda:0), or a HarnessError when fewer than ``n``
    cards are visible."""
    import torch

    if not torch.cuda.is_available():
        raise HarnessError("torch.cuda.is_available() is false: this benchmark runs on the card")
    if torch.cuda.device_count() < n:
        raise HarnessError(f"the cell needs {n} cards; {torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def process_age_s() -> float:
    """Seconds since this process started (Linux: ``/proc/self/stat``'s
    start time against ``/proc/uptime``), 10 ms resolution."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])  # field 22 of the stat line
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def use_checkout_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port builds its kernels into ``build/repro_torch`` by itself), and no
    library loading JAX by itself."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


# -- correctness ---------------------------------------------------------------

@dataclass
class Check:
    """One number compared, beside its limit: correct while ``value <=
    limit`` (a number that is NaN fails)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back: the window's counts and end-to-end
    metrics, the comparisons, and for a traced run the record the per-layer
    readers read."""

    attempted: int
    failed: int
    metrics: dict  # end-to-end name -> value
    checks: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    record: object = None  # a trace.Record with --trace 1
    notes: dict = field(default_factory=dict)  # printed on stderr, not judged


def checks_from(values: dict, limits: dict) -> list[Check]:
    """One Check per number in ``values`` (name -> reading), each against
    the cell's limit of that name."""
    missing = sorted(set(values) - set(limits))
    if missing:
        raise HarnessError(f"no limit for {missing} in the cell's limits file")
    return [Check(k, float(v), float(limits[k])) for k, v in values.items()]


def device_info(count: int, peak: int) -> dict:
    """The run's device (a CPU only where a test drives a run without the
    chip check)."""
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


def result_line(cell: Cell, out: Outcome, trace: bool, setup_s: float) -> dict:
    """The last line of standard output: correct, attempted, failed, the
    end-to-end metrics (``--trace 0``) or the per-layer ones (``--trace 1``),
    the device, with a trace the breakdown, and last the numbers compared
    beside their limits."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"], cell.root).read(out.record)
            if v is not None:
                values[m["name"]] = v
    else:
        values = dict(out.metrics, setup_s=setup_s)
    line = {
        "correct": bool(out.checks) and all(c.ok for c in out.checks)
        and out.failed == 0,
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": {k: {"value": float(v), "unit": units[k]} for k, v in values.items()},
        "device": device_info(cell.chips, out.memory_peak_bytes),
    }
    if trace:
        line["device"]["busy_s"] = out.record.busy_s
        line["device"]["window_s"] = out.record.window_s
        line["breakdown"] = out.record.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line



# -- the port's configuration ---------------------------------------------------

DTYPE_KEYS = ("param_dtype", "compute_dtype", "opt_dtype")


def port_fields(config: dict, tiny: bool = False) -> dict:
    """The configuration file's ``port`` table (with its ``tiny`` overrides,
    the CPU tests' size)."""
    fields = dict(config["port"])
    if tiny:
        fields.update(config["tiny"])
    return fields


def arch(config: dict, tiny: bool = False):
    """The port's ``ArchConfig`` as the configuration file states it: the
    registry's entry with every field of the ``port`` table set."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch

    fields = port_fields(config, tiny)
    for k in DTYPE_KEYS:
        if k in fields:
            fields[k] = getattr(torch, fields[k])
    return dataclasses.replace(get_arch(config["arch"]), **fields)


def traffic_params(traffic: dict, tiny: bool = False) -> dict:
    params = dict(traffic)
    if tiny:
        params.update(traffic.get("tiny", {}))
    return params


def rel_gap(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def quantile(values, q: float) -> float:
    """The q-quantile (0..1) of ``values`` by linear interpolation."""
    import numpy as np

    return float(np.quantile(np.asarray(values, dtype=np.float64), q))
