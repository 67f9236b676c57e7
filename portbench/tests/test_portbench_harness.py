"""The harness finds cells, configurations, mixes and metrics by name;
BENCHMARK.json keeps the contract's shape; the import guards hold; run.py
refuses to run without the port or without a card."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# keys that name a width, which no cut may change
WIDTHS = {"hidden_size", "intermediate_size", "d_model", "d_ff", "d_head", "head_dim",
          "headdim", "d_state", "ssm_state", "expand", "ssm_expand", "d_inner",
          "num_experts_per_tok", "moe_intermediate_size", "kv_lora_rank"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] in {w["config"] for w in BENCH["workloads"] if w["name"] == cell}
    assert harness.driver(c).run
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert harness.metric_reader(m["name"]).read


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert not WIDTHS & set(c["reduced"])
        assert all(not k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_cell_added_from_new_files_is_found(tmp_path):
    """A later PR adds a cell by adding files and entries only."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/stablelm-12b.json").read_text())
    cfg["name"] = "stablelm-12b.d8"
    cfg["port"]["n_layers"] = 8
    (tmp_path / "portbench/configs/stablelm-12b.d8.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "portbench/traffic/prefill_pool.json").read_text())
    traffic["min_len"] = 128
    (tmp_path / "portbench/traffic/prefill_short.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/cells/stablelm-12b.d8.prefill_short.json").write_text(
        json.dumps({"sample": 2, "limits": {"logits_rel": 1.0}}))
    (tmp_path / "portbench/metrics/forwards.short.py").write_text(
        "def read(record):\n    return float(len(record.items))\n")
    bench["configs"].append(dict(bench["configs"][0], name="stablelm-12b.d8",
                                 file="portbench/configs/stablelm-12b.d8.json"))
    bench["workloads"].append({"name": "stablelm-12b.d8.prefill_short", "config": "stablelm-12b.d8",
                               "traffic": "prefill_short", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "forwards.short", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "prefill_tokens_per_s",
                               "workloads": ["stablelm-12b.d8.prefill_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("stablelm-12b.d8.prefill_short", tmp_path)
    assert cell.config["port"]["n_layers"] == 8 and cell.traffic["min_len"] == 128
    assert cell.kind == "prefill_pool" and cell.limits["sample"] == 2
    assert "forwards.short" in [m["name"] for m in cell.per_layer]
    record = type("R", (), {"items": [1, 2, 3]})()
    assert harness.metric_reader("forwards.short", tmp_path).read(record) == 3.0
    with pytest.raises(harness.HarnessError):
        harness.load_cell("no-such-cell", tmp_path)


@pytest.mark.parametrize("modules,found", [
    ({"jax": 1, "numpy": 1}, ["jax"]),
    ({"jaxlib.xla_client": 1}, ["jaxlib"]),
    ({"repro.core.nvpax": 1, "repro_torch.core": 1}, ["repro"]),
    ({"repro_torch": 1, "repro_torch.models.lm": 1, "flaxen": 1, "jaxtyping": 1}, []),
    ({"flax.linen": 1}, ["flax"]),
])
def test_import_guard_compares_top_level_names_whole(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_this_process_holds_no_jax():
    import repro_torch.models  # noqa: F401
    import repro_torch.power.controller  # noqa: F401

    assert harness.forbidden_modules() == []


def test_references_import_nothing_of_the_port(tmp_path):
    assert harness.reference_import_faults(ROOT) == []
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    (tmp_path / "portbench/reference/leak.py").write_text("from repro_torch.models import lm\n")
    assert harness.reference_import_faults(tmp_path) == ["leak.py: repro_torch"]


def _run(cwd, *extra):
    cmd = [sys.executable, "portbench/run.py", "--workload", "stablelm-12b.prefill",
           "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0", *extra]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_refuses_a_checkout_without_the_port(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_run_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    res = _run(ROOT)
    assert res.returncode == 3 and res.stdout.strip() == ""
    assert "cuda" in res.stderr
