"""Flight-record report CLI: render a recorded run's telemetry.

The twin of the reference's ``python -m repro_torch.obs.report``: for the same
file it prints the same report.  Reads the JSONL flight record written by a
recording run (:func:`repro_torch.obs.export.flight_rows` through
:func:`repro_torch.obs.export.write_jsonl`) and renders the operational summary the paper reports: interval wall
percentiles (overall and per certify tier), tier shares / skip rates,
certified fraction, satisfaction percentiles, KKT residuals, restarts,
and grant movement.

Usage::

    python -m repro_torch.obs.report FLIGHT_trace.jsonl
    python -m repro_torch.obs.report FLIGHT_trace.jsonl --prom metrics.prom
"""

from __future__ import annotations

import argparse
from typing import Any

import numpy as np

from repro_torch.obs.export import StreamSummary, read_jsonl

__all__ = ["summarize", "render", "main"]

TIER_NAMES = {0: "full-solve", 1: "phase1-skip", 2: "full-skip"}


def summarize(rows: list[dict[str, Any]]) -> dict[str, Any]:
    """Aggregate flight rows into the report's summary dict."""
    n = len(rows)
    out: dict[str, Any] = {"steps": n}
    if n == 0:
        return out

    tiers = np.asarray([int(r.get("tier", 0)) for r in rows])
    out["tiers"] = {}
    for t, name in TIER_NAMES.items():
        count = int((tiers == t).sum())
        out["tiers"][name] = {"count": count, "share": count / n}
    out["skip_rate"] = float((tiers == 2).mean())
    out["phase1_skip_rate"] = float((tiers == 1).mean())
    out["certified_fraction"] = float(
        np.mean([bool(r.get("certified", False)) for r in rows])
    )
    out["converged_fraction"] = float(
        np.mean([bool(r.get("converged", False)) for r in rows])
    )
    out["restarts_total"] = int(sum(int(r.get("restarts", 0)) for r in rows))

    for field in ("satisfaction", "kkt_res", "grant_move", "sla_min_margin"):
        # +inf margins mean "no SLA rows in this program" — not a sample
        vals = [
            float(r[field])
            for r in rows
            if field in r and np.isfinite(float(r[field]))
        ]
        if vals:
            out[field] = StreamSummary()
            out[field].extend(vals)
            out[field] = out[field].as_dict()

    walls = [float(r["wall_ms"]) for r in rows if "wall_ms" in r]
    if walls:
        s = StreamSummary()
        s.extend(walls)
        out["wall_ms"] = s.as_dict()
        out["wall_ms_by_tier"] = {}
        for t, name in TIER_NAMES.items():
            tw = [
                float(r["wall_ms"])
                for r in rows
                if "wall_ms" in r and int(r.get("tier", 0)) == t
            ]
            if tw:
                st = StreamSummary()
                st.extend(tw)
                out["wall_ms_by_tier"][name] = st.as_dict()
    return out


def _fmt_pct(s: dict[str, float], scale: float = 1.0, unit: str = "") -> str:
    return (
        f"p50={s['p50'] * scale:.4g}{unit}  "
        f"p95={s['p95'] * scale:.4g}{unit}  "
        f"p99={s['p99'] * scale:.4g}{unit}  "
        f"mean={s['mean'] * scale:.4g}{unit}"
    )


def render(summary: dict[str, Any]) -> str:
    """Render the summary dict as the human-readable report."""
    lines = [f"flight record: {summary['steps']} steps"]
    if summary["steps"] == 0:
        return lines[0]
    lines.append("")
    lines.append("certify tiers:")
    for name, d in summary["tiers"].items():
        lines.append(f"  {name:<12} {d['count']:>6}  ({d['share'] * 100:5.1f}%)")
    lines.append(
        f"  skip rate {summary['skip_rate'] * 100:.1f}%  "
        f"phase1-skip rate {summary['phase1_skip_rate'] * 100:.1f}%"
    )
    lines.append(
        f"certified fraction {summary['certified_fraction'] * 100:.1f}%  "
        f"converged {summary['converged_fraction'] * 100:.1f}%  "
        f"restarts {summary['restarts_total']}"
    )
    if "wall_ms" in summary:
        lines.append("")
        lines.append(f"interval wall:  {_fmt_pct(summary['wall_ms'], unit='ms')}")
        for name, s in summary.get("wall_ms_by_tier", {}).items():
            lines.append(f"  {name:<12} {_fmt_pct(s, unit='ms')}")
    if "satisfaction" in summary:
        lines.append("")
        lines.append(f"satisfaction:   {_fmt_pct(summary['satisfaction'], 100.0, '%')}")
    if "kkt_res" in summary:
        lines.append(f"kkt residual:   {_fmt_pct(summary['kkt_res'])}")
    if "grant_move" in summary:
        lines.append(f"grant move (W): {_fmt_pct(summary['grant_move'])}")
    if "sla_min_margin" in summary:
        s = summary["sla_min_margin"]
        lines.append(f"sla min margin: min={s['min']:.4g}W  p50={s['p50']:.4g}W")
    return "\n".join(lines)


def _prom_from_rows(rows: list[dict[str, Any]], prefix: str = "repro") -> str:
    """Counter-style exposition recomputed from flight rows (for runs where
    only the JSONL survived, not the live recorder state)."""
    tiers = [int(r.get("tier", 0)) for r in rows]
    lines = [
        f"# TYPE {prefix}_steps_total counter",
        f"{prefix}_steps_total {len(rows)}",
        f"# TYPE {prefix}_skipped_total counter",
        f"{prefix}_skipped_total {sum(1 for t in tiers if t == 2)}",
        f"# TYPE {prefix}_p1_skips_total counter",
        f"{prefix}_p1_skips_total {sum(1 for t in tiers if t == 1)}",
        f"# TYPE {prefix}_certified_total counter",
        f"{prefix}_certified_total "
        f"{sum(1 for r in rows if r.get('certified', False))}",
        f"# TYPE {prefix}_restarts_total counter",
        f"{prefix}_restarts_total {sum(int(r.get('restarts', 0)) for r in rows)}",
    ]
    if rows:
        last = rows[-1]
        for gf in ("satisfaction", "sla_min_margin", "alloc_W"):
            if gf in last:
                lines.append(f"# TYPE {prefix}_{gf} gauge")
                lines.append(f"{prefix}_{gf} {float(last[gf])}")
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a recorded run's flight record (JSONL).",
    )
    parser.add_argument("flight", help="flight-record JSONL path")
    parser.add_argument(
        "--prom", metavar="PATH", help="also write Prometheus text exposition"
    )
    args = parser.parse_args(argv)
    rows = read_jsonl(args.flight)
    print(render(summarize(rows)))
    if args.prom:
        with open(args.prom, "w") as fh:
            fh.write(_prom_from_rows(rows))
        print(f"\nwrote {args.prom}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
