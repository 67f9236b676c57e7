"""Flight-record exporters: JSONL flush, Prometheus-style text exposition,
and streaming percentile summaries, on the host.

The twin of the reference's ``repro.obs.export``: for the same flush it
writes the same rows and the same exposition text, metric prefix included,
so a scrape configuration does not change.

The recorder's :func:`repro_torch.obs.recorder.flush` gives per-lane dicts of
time-ordered ring rows + counters + histograms; this module turns those into
artifacts: line-delimited JSON for offline analysis (one row per step, host
span walls merged in by step index when available) and a text exposition in
the Prometheus format for scrape-style consumption.
"""

from __future__ import annotations

import json
from typing import Any, Iterable

import numpy as np

from repro_torch.obs.recorder import rows_as_dicts

__all__ = [
    "flight_rows",
    "write_jsonl",
    "read_jsonl",
    "prometheus_text",
    "StreamSummary",
]


def flight_rows(
    flushes: list[dict[str, Any]] | dict[str, Any],
    walls_ms: Iterable[float] | None = None,
) -> list[dict]:
    """Merge per-lane flushes (and optional per-step host walls) into one
    JSONL-ready row list.  ``walls_ms[i]`` is matched to ring rows whose
    ``step`` field equals ``i`` — host walls are per *interval*, so every
    lane's row for that step gets the same wall."""
    if isinstance(flushes, dict):
        flushes = [flushes]
    walls = None if walls_ms is None else list(walls_ms)
    out: list[dict] = []
    for lane, fl in enumerate(flushes):
        rows = rows_as_dicts(fl, lane=lane if len(flushes) > 1 else None)
        for d in rows:
            if walls is not None and 0 <= d["step"] < len(walls):
                d["wall_ms"] = float(walls[d["step"]])
            out.append(d)
    out.sort(key=lambda d: (d["step"], d.get("lane", 0)))
    return out


def write_jsonl(path: str, rows: Iterable[dict]) -> int:
    n = 0
    with open(path, "w") as fh:
        for row in rows:
            fh.write(json.dumps(row) + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _hist_lines(name: str, hist: np.ndarray, lo_exp: int, labels: str) -> list[str]:
    """Cumulative-bucket exposition (le = right edge in the gauge's unit)."""
    lines = []
    cum = 0
    for b, count in enumerate(np.asarray(hist)):
        cum += int(count)
        le = f"1e{lo_exp + b + 1:+d}"
        sep = "," if labels else ""
        lines.append(f'{name}_bucket{{{labels}{sep}le="{le}"}} {cum}')
    sep = "," if labels else ""
    lines.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {cum}')
    lines.append(f"{name}_count{{{labels}}} {cum}" if labels else f"{name}_count {cum}")
    return lines


def prometheus_text(
    flushes: list[dict[str, Any]] | dict[str, Any],
    *,
    prefix: str = "repro",
) -> str:
    """Render flushed flight records in the Prometheus text exposition
    format (counters + log-bucketed histograms; one ``lane`` label per
    recorder lane)."""
    if isinstance(flushes, dict):
        flushes = [flushes]
    lines: list[str] = []
    lines.append(f"# TYPE {prefix}_steps_total counter")
    for lane, fl in enumerate(flushes):
        c = fl["counters"]
        lab = f'lane="{lane}"' if len(flushes) > 1 else ""
        wrap = f"{{{lab}}}" if lab else ""
        lines.append(f"{prefix}_steps_total{wrap} {c['n_steps']}")
    for key in ("n_skipped", "n_p1_skips", "n_certified", "n_truncated"):
        metric = f"{prefix}_{key[2:]}_total"
        lines.append(f"# TYPE {metric} counter")
        for lane, fl in enumerate(flushes):
            lab = f'lane="{lane}"' if len(flushes) > 1 else ""
            wrap = f"{{{lab}}}" if lab else ""
            lines.append(f"{metric}{wrap} {fl['counters'][key]}")
    for hist_key, metric in (
        ("hist_kkt", f"{prefix}_step_kkt_residual"),
        ("hist_move", f"{prefix}_grant_move_watts"),
        ("solver_hist", f"{prefix}_solver_kkt_score"),
    ):
        lines.append(f"# TYPE {metric} histogram")
        for lane, fl in enumerate(flushes):
            lab = f'lane="{lane}"' if len(flushes) > 1 else ""
            lines.extend(_hist_lines(metric, fl[hist_key], fl["hist_lo_exp"], lab))
    # last-row gauges (most recent step per lane)
    gauge_fields = ("satisfaction", "sla_min_margin", "alloc_W")
    for gf in gauge_fields:
        metric = f"{prefix}_{gf}"
        lines.append(f"# TYPE {metric} gauge")
        for lane, fl in enumerate(flushes):
            if len(fl["rows"]) == 0:
                continue
            idx = fl["fields"].index(gf)
            lab = f'lane="{lane}"' if len(flushes) > 1 else ""
            wrap = f"{{{lab}}}" if lab else ""
            lines.append(f"{metric}{wrap} {float(fl['rows'][-1][idx])}")
    return "\n".join(lines) + "\n"


class StreamSummary:
    """Streaming scalar summary: count/mean/min/max plus exact percentiles
    (values are kept; the flight recorder bounds cardinality upstream, so
    a run's worth of scalars is small)."""

    def __init__(self) -> None:
        self._vals: list[float] = []

    def add(self, value: float) -> None:
        self._vals.append(float(value))

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.add(v)

    def __len__(self) -> int:
        return len(self._vals)

    def percentile(self, q: float) -> float:
        if not self._vals:
            return float("nan")
        return float(np.percentile(np.asarray(self._vals), q))

    def as_dict(self) -> dict[str, float]:
        if not self._vals:
            return {"count": 0}
        arr = np.asarray(self._vals)
        return {
            "count": len(self._vals),
            "mean": float(arr.mean()),
            "min": float(arr.min()),
            "max": float(arr.max()),
            "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "p99": float(np.percentile(arr, 99)),
        }
