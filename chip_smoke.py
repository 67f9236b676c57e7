#!/usr/bin/env python3
"""Drive the PyTorch port of nvPAX on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py               # exits non-zero on any failure
    python3 chip_smoke.py --profile     # also profiles one control step
    python3 chip_smoke.py --out DIR     # where the details go

Phases, each of which raises on failure:

1. the card: name, count, ``nvidia-smi`` name and power limit;
2. build the CUDA kernels (``src/repro_torch/kernels/csrc``) and print the
   ``nvcc -Xptxas -v`` summary;
3. every kernel against its plain PyTorch version on the card, at the main
   path's shapes (the paper's fleet: n = 12,288 devices, m = 1,637 tree
   rows) and at block edges, in float64 and float32;
4. the main path: five warm-started control steps of
   ``repro_torch.core.nvpax.optimize`` on ``build_datacenter()`` with
   telemetry requests, through the kernels
   (``SolverOptions(use_pallas=True, use_pallas_tree=True)``), each checked
   for feasibility and KKT certification and against the port's own CPU
   run of the same steps;
5. the paper's iterated max-min LP path (``use_waterfill=False``) on a
   1,536-device fleet, with the same checks;
6. each kernel's time on the card (CUDA events; see :func:`time_calls`)
   beside its plain version's and its bound.

The line before the last is a JSON object listing every kernel; the last
is ``{"ok": true, "device": {...}}``.  Details (the build log and every
measurement) go to ``DIR/chip_smoke.json``, by default under
``artifacts/chip_smoke/``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.kernels as kernels  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions, optimize  # noqa: E402
from repro_torch.core.problem import AllocProblem, FleetTopology  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pdhg_update import kernel as pk  # noqa: E402
from repro_torch.kernels.pdhg_update import ref as pref  # noqa: E402
from repro_torch.kernels.tree_matvec import kernel as tk  # noqa: E402
from repro_torch.kernels.tree_matvec import ref as tref  # noqa: E402
from repro_torch.pdn.telemetry import TelemetrySim, TraceConfig  # noqa: E402
from repro_torch.pdn.tree import build_datacenter  # noqa: E402

# H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM3, 34 TFLOP/s FP64 and
# 67 TFLOP/s FP32 outside the tensor cores, at the 700 W power limit.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}

STEPS = 5
LP_STEPS = 2
FEAS_TOL = 1e-6  # watts: subtree sums <= cap + FEAS_TOL
PARITY_TOL = 1e-6  # watts: card run vs the port's CPU run
# kernel vs plain: elementwise |d| <= tol * max(1, |ref|); tree kernels
# |d| <= tol * sum|input| (the scan adds in another order than cumsum).
# The elementwise kernels round every operation as the plain expression
# does (float32 |d| measured 0 on the H100), so their float32 limit is 4 ulp
# of 1.  The tree kernels' float32 limit, 4 unit roundoffs of sum|input|
# (2.4e-7), is about 7x the largest float32 |d| / sum|input| measured on the
# H100 over the checks below (3.5e-8); phase 3 prints the measured value
# beside each limit.
ELEM_TOL = {"float64": 1e-13, "float32": 4 * 2.0**-23}
TREE_TOL = {"float64": 1e-12, "float32": 4 * 2.0**-24}


def log(*args) -> None:
    print(*args, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def feasibility(pdn_, x):
    csum = np.concatenate([[0.0], np.cumsum(x)])
    sums = csum[pdn_.node_end] - csum[pdn_.node_start]
    over = float(np.max(sums - pdn_.node_cap))
    if over > FEAS_TOL:
        raise AssertionError(f"subtree sum exceeds its cap by {over:.3e} W")
    if (x < pdn_.dev_l - 1e-9).any() or (x > pdn_.dev_u + 1e-9).any():
        raise AssertionError("allocation leaves the device box")
    return over


def telemetry_requests(pdn_, n_steps, seed):
    """Consecutive 30 s samples of the synthetic fleet trace."""
    sim = TelemetrySim(TraceConfig(n_devices=pdn_.n, seed=seed))
    return [sim.power(t) for t in range(n_steps)]


def drifting_requests(pdn_, n_steps, seed):
    """Requests U(100, 650) W, below the root budget on average so the
    max-min phases have head-room to hand out, then drifting by N(0, 5 W)
    from step to step."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(100.0, 650.0, pdn_.n)
    return [base] + [
        np.clip(base + rng.normal(0.0, 5.0, pdn_.n), 100.0, 650.0)
        for _ in range(n_steps - 1)
    ]


def timed_steps(pdn_, requests, priority, options, device):
    """Warm-started control steps on ``device``: [(result, wall s)], the
    wall on the host clock around build + optimize, ending in a sync."""
    topo = FleetTopology.from_pdn(pdn_, device=device)
    out, warm = [], None
    for req in requests:
        sync(device)
        t_step = time.perf_counter()
        ap = AllocProblem.build(pdn_, req, priority=priority, topology=topo)
        res = optimize(ap, options, warm)
        sync(device)
        out.append((res, time.perf_counter() - t_step))
        warm = res.warm_state
    return out


def run_steps(tag, pdn_, requests, options, seed, device="cuda"):
    """Warm-started control steps on ``device`` with three priority levels
    drawn from ``seed``, each checked against the port's CPU run of the same
    steps; returns (rows, launch counts of the run on ``device``)."""
    priority = np.random.default_rng(seed).integers(1, 4, pdn_.n)
    kernels.reset_launch_counts()
    card = timed_steps(pdn_, requests, priority, options, device)
    launches = kernels.launch_counts()
    cpu = timed_steps(pdn_, requests, priority, options, "cpu")
    rows = []
    for t, ((res, wall), (ref, _)) in enumerate(zip(card, cpu)):
        over = feasibility(pdn_, res.allocation)
        st = res.stats
        if not (st["converged"] and st["kkt_certified"]):
            raise AssertionError(f"{tag} step {t} not certified: {dict(st)}")
        diff = float(np.max(np.abs(res.allocation - ref.allocation)))
        if diff > PARITY_TOL:
            raise AssertionError(f"{tag} step {t}: card vs CPU max |d| {diff:.3e} W")
        row = {
            "step": t,
            "wall_ms": wall * 1e3,
            "optimize_ms": res.wall_time_s * 1e3,
            "phase_iterations": list(st["phase_iterations"]),
            "cpu_phase_iterations": list(ref.stats["phase_iterations"]),
            "max_abs_vs_cpu_w": diff,
            "max_cap_excess_w": over,
            "total_w": float(res.allocation.sum()),
        }
        rows.append(row)
        log(f"[{tag}] step {t}: {row['wall_ms']:.1f} ms, iterations "
            f"{row['phase_iterations']} (cpu {row['cpu_phase_iterations']}), "
            f"card vs cpu {diff:.2e} W, cap excess {over:.2e} W, "
            f"{row['total_w']:.0f} W allocated")
    log(f"[{tag}] launches {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    return rows, launches


def _events_ms(fn, reps: int, sleep_cycles: int = 0) -> tuple[float, bool]:
    """CUDA-event time of ``reps`` calls per call.  With ``sleep_cycles``
    the calls are queued behind a sleeping kernel; the flag says whether the
    host had queued all of them before the sleep ended."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    woke = torch.cuda.Event()
    torch.cuda.synchronize()
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
        woke.record()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    covered = bool(sleep_cycles) and not woke.query()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, covered


def time_calls(fn, reps: int = 20, rounds: int = 5) -> tuple[float, float]:
    """(device ms, paced ms) per call, medians over ``rounds``.

    Paced: calls issued back to back from the host; at these sizes the
    host's enqueue rate (Python, ctypes, allocation) sets that number.
    Device: the same calls queued behind a sleeping kernel that outlasts
    their enqueue, so they run back to back on the card and the events time
    the card alone.
    """
    for _ in range(5):
        fn()
    paced = sorted(_events_ms(fn, reps)[0] for _ in range(rounds))[rounds // 2]
    sleep_ms, _ = _events_ms(lambda: torch.cuda._sleep(1_000_000), 5)
    cycles = int(1_000_000 * max(20.0, 8.0 * paced * reps) / sleep_ms)
    samples, missed = [], []
    while len(samples) < rounds:
        ms, covered = _events_ms(fn, reps, cycles)
        if covered:
            samples.append(ms)
        elif len(missed) < 6:
            missed.append(ms)
            cycles *= 2
        else:
            # the host kept the card waiting even behind a 1 s sleep: report
            # the events' time, an upper bound on the device time, and say so
            log(f"[6]   (host-limited: {len(missed)} rounds were not queued ahead)")
            samples.extend(missed[: rounds - len(samples)])
    return sorted(samples)[len(samples) // 2], paced


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true", help="profile one step")
    parser.add_argument("--out", default=str(ROOT / "artifacts" / "chip_smoke"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    report: dict = {}
    cuda = torch.device("cuda")

    # -- 1. the card ------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1] device {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[1] nvidia-smi: {smi}")
    report["device"] = {"name": name, "count": count, "nvidia_smi": smi}

    # -- 2. build ---------------------------------------------------------
    info = _build.build()
    _build.library()
    (out_dir / "build.log").write_text(info.log)
    if info.reused:
        log(f"[2] reused {info.path.name}, built earlier in {info.seconds:.1f} s; its log:")
    else:
        log(f"[2] built {info.path.name} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if line.startswith("==") or any(
            key in line for key in ("entry function", "registers", "spill")
        ):
            log(f"[2]   {line.strip()}")
    report["build_s"] = info.seconds
    report["build_reused"] = info.reused

    # -- 3. kernels vs plain ----------------------------------------------
    pdn = build_datacenter()
    n_main, m_main = pdn.n, pdn.m
    tile = _build.library().tree_scan_tile()
    # past the elementwise grid, the grid-stride loop takes a second pass
    grid = _build.library().elementwise_grid_threads()
    edge_sizes = [1, 31, 32, tile - 1, tile, tile + 1, 3 * tile + 7, 1_000_003, 2 * grid + 1]
    rng = np.random.default_rng(0)
    max_err: dict[str, float] = {}
    worst: dict[str, dict[str, float]] = {"float64": {}, "float32": {}}
    n_checks = [0]

    def on_card(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=cuda)

    def random_rows(n: int, m: int):
        """Row ranges covering the cases the scan must get right: the whole
        range, empty rows, rows at both ends, rows sharing endpoints."""
        s = rng.integers(0, n + 1, m)
        e = rng.integers(0, n + 1, m)
        s, e = np.minimum(s, e), np.maximum(s, e)
        s[:4], e[:4] = [0, 0, n, n // 2], [n, 0, n, n]
        return s, e

    def check(name_, key, got, want, scale, main_shape):
        """Hold |got - want| <= limit * scale, the limit by kernel and dtype.
        Keeps the largest |d| / scale of each kernel and dtype, and the
        largest |d| of each kernel at the main shape in float64."""
        n_checks[0] += 1
        torch.cuda.synchronize()
        limit = (TREE_TOL if name_.startswith("tree") else ELEM_TOL)[key]
        # equal infinities match; a NaN anywhere is a mismatch
        err = torch.where(got == want, 0.0, (got - want).abs())
        rel = err / scale
        bad = ~(rel <= limit)
        if bool(bad.any()):
            raise AssertionError(
                f"{name_} {key} (n={got.numel()}): {int(bad.sum())} mismatches, "
                f"max |d| / scale {float(rel.max()):.3e} > {limit:.3e}"
            )
        worst[key][name_] = max(worst[key].get(name_, 0.0), float(rel.max()))
        if main_shape:
            max_err[name_] = max(max_err.get(name_, 0.0), float(err.max()))

    def check_tree(n, start, end, dtype, main_shape):
        key = str(dtype).split(".")[-1]
        idx = tk.tree_index(start, end, n, cuda)
        x = on_card(rng.normal(size=n), dtype)
        check("tree_matvec", key, tk.tree_matvec(x, idx),
              tref.tree_matvec_ref(x, idx.start.long(), idx.end.long()),
              float(x.abs().sum()), main_shape)
        y = on_card(rng.normal(size=len(start)), dtype)
        check("tree_rmatvec", key, tk.tree_rmatvec(y, idx),
              tref.tree_rmatvec_ref(y, idx.start.long(), idx.end.long(), n),
              float(y.abs().sum()), main_shape)

    def check_elementwise(n, dtype, main_shape):
        key = str(dtype).split(".")[-1]

        def vec():
            return on_card(rng.normal(size=n) * 100.0, dtype)

        x, gx, c, target = vec(), vec(), vec(), vec()
        w = vec().abs()
        lo = vec() - 50.0
        hi = lo + vec().abs() + 1.0
        for tau in (vec().abs() / 100.0 + 0.01, torch.full((), 0.37, dtype=dtype, device=cuda)):
            got = pk.primal_update(x, gx, c, w, target, lo, hi, tau)
            want = pref.primal_update_ref(x, gx, c, w, target, lo, hi, tau)
            for g, r in zip(got, want):
                check("primal_update", key, g, r, r.abs().clamp_min(1.0), main_shape)
        # the solver's row bounds: (-inf, hi] tree rows, [lo, +inf) rows
        y, a, base = vec(), vec(), vec()
        lo = torch.where(vec() > 0, -float("inf"), base)
        hi = torch.where(vec() > 0, float("inf"), base + 10.0)
        for sigma in (vec().abs() / 100.0 + 0.01, torch.full((), 0.21, dtype=dtype, device=cuda)):
            got = pk.dual_prox(y, a, sigma, lo, hi)
            want = pref.dual_prox_ref(y, a, sigma, lo, hi)
            check("dual_prox", key, got, want, want.abs().clamp_min(1.0), main_shape)

    t0 = time.perf_counter()
    for dtype in (torch.float64, torch.float32):
        main = dtype == torch.float64
        check_tree(n_main, pdn.node_start, pdn.node_end, dtype, main)
        check_elementwise(n_main, dtype, main)
        check_elementwise(m_main, dtype, main)
        for n in edge_sizes:
            s, e = random_rows(n, min(2 * n, 5000) + 4)
            check_tree(n, s, e, dtype, False)
            check_elementwise(n, dtype, False)
    log(f"[3] {n_checks[0]} kernel-vs-plain checks passed in {time.perf_counter() - t0:.1f} s "
        f"(tile {tile}, elementwise grid {grid} threads; n in {edge_sizes}); max |d| at "
        f"n={n_main}, m={m_main}, float64: "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(max_err.items())))
    for key, per_kernel in worst.items():
        log(f"[3] {key}, all sizes, largest |d| / scale (limit): "
            + ", ".join(
                f"{k} {v:.3e} ({(TREE_TOL if k.startswith('tree') else ELEM_TOL)[key]:.3e})"
                for k, v in sorted(per_kernel.items())
            ))
    report["kernel_checks"] = {
        "count": n_checks[0],
        "max_abs_err_f64": max_err,
        "max_rel_err": worst,
        "limits": {"elementwise": ELEM_TOL, "tree": TREE_TOL},
    }

    # -- 4/5. control steps on the card vs the port's CPU run ---------------
    kernel_opts = SolverOptions(use_pallas=True, use_pallas_tree=True)

    log(f"[4] main path: n={n_main}, m={m_main}, {STEPS} telemetry steps, "
        "water-fill phases II/III")
    main_rows, main_launches = run_steps(
        "4", pdn, telemetry_requests(pdn, STEPS, 0), NvpaxOptions(solver=kernel_opts), 0
    )
    report["main_path"] = {"n": n_main, "m": m_main, "steps": main_rows, "launches": main_launches}
    # the same steps on the card through plain torch alone, for the step
    # time the kernels replace
    plain = timed_steps(
        pdn, telemetry_requests(pdn, STEPS, 0), np.random.default_rng(0).integers(1, 4, pdn.n),
        NvpaxOptions(), cuda,
    )
    for row, (res, wall) in zip(main_rows, plain):
        row["plain_wall_ms"] = wall * 1e3
        row["plain_phase_iterations"] = list(res.stats["phase_iterations"])
        feasibility(pdn, res.allocation)
        if row["plain_phase_iterations"] != row["phase_iterations"]:
            raise AssertionError(f"plain torch on the card took other iterations: {row}")
    log("[4] the same steps through plain torch on the card: "
        + ", ".join(f"{w * 1e3:.1f} ms" for _, w in plain))

    pdn_lp = build_datacenter(n_halls=2, racks_per_hall=6)
    log(f"[5] LP path: n={pdn_lp.n}, m={pdn_lp.m}, {LP_STEPS} steps of drifting "
        "U(100, 650) W requests, use_waterfill=False")
    lp_rows, lp_launches = run_steps(
        "5",
        pdn_lp,
        drifting_requests(pdn_lp, LP_STEPS, 0),
        NvpaxOptions(solver=kernel_opts, use_waterfill=False),
        0,
    )
    report["lp_path"] = {"n": pdn_lp.n, "m": pdn_lp.m, "steps": lp_rows, "launches": lp_launches}

    # -- 6. timing ----------------------------------------------------------
    f64 = torch.float64
    idx = tk.tree_index(pdn.node_start, pdn.node_end, n_main, cuda)
    start64, end64 = idx.start.long(), idx.end.long()
    xv = on_card(rng.normal(size=n_main), f64)
    yv = on_card(rng.normal(size=m_main), f64)
    args_p = [on_card(rng.normal(size=n_main), f64) for _ in range(8)]
    args_p[3] = args_p[3].abs()
    args_p[7] = args_p[7].abs() + 0.01
    args_p[6] = args_p[5] + args_p[6].abs()
    args_d = [on_card(rng.normal(size=n_main), f64) for _ in range(5)]
    args_d[2] = args_d[2].abs() + 0.01
    args_d[3] = torch.full_like(args_d[3], -float("inf"))
    n_b, m_b = n_main, m_main

    def bound(nbytes, flops, dtype="float64"):
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    timing = [
        ("tree_matvec", "src/repro_torch/kernels/csrc/tree_matvec.cu",
         "src/repro/kernels/tree_matvec/kernel.py:105",
         lambda: tk.tree_matvec(xv, idx),
         lambda: tref.tree_matvec_ref(xv, start64, end64),
         bound(8 * n_b + 8 * m_b + 8 * m_b, n_b + m_b)),
        ("tree_rmatvec", "src/repro_torch/kernels/csrc/tree_matvec.cu",
         "src/repro/kernels/tree_matvec/kernel.py:128",
         lambda: tk.tree_rmatvec(yv, idx),
         lambda: tref.tree_rmatvec_ref(yv, start64, end64, n_b),
         bound(8 * m_b + 8 * m_b + 8 * n_b, 2 * m_b + n_b)),
        ("primal_update", "src/repro_torch/kernels/csrc/pdhg_update.cu",
         "src/repro/kernels/pdhg_update/kernel.py:78",
         lambda: pk.primal_update(*args_p),
         lambda: pref.primal_update_ref(*args_p),
         bound(10 * 8 * n_b, 12 * n_b)),
        ("dual_prox", "src/repro_torch/kernels/csrc/pdhg_update.cu",
         "src/repro/kernels/pdhg_update/kernel.py:101",
         lambda: pk.dual_prox(*args_d),
         lambda: pref.dual_prox_ref(*args_d),
         bound(6 * 8 * n_b, 7 * n_b)),
    ]
    entries = []
    log(f"[6] kernel times on {smi}, float64, n={n_b}, m={m_b} (dual_prox at r=n):")
    log("[6]   name: device time per call, kernel / plain (host-paced kernel / plain) | bound")
    for kname, source, replaces, fn_kernel, fn_plain, (bound_ms, bound_by) in timing:
        # plain, kernel, kernel, plain: the later of each pair is kept
        time_calls(fn_plain)
        time_calls(fn_kernel)
        ms, paced_ms = time_calls(fn_kernel)
        plain_ms, plain_paced_ms = time_calls(fn_plain)
        log(f"[6]   {kname}: {ms * 1e3:.2f} / {plain_ms * 1e3:.2f} us "
            f"({paced_ms * 1e3:.2f} / {plain_paced_ms * 1e3:.2f} us) | "
            f"{bound_ms * 1e3:.3f} us ({bound_by})")
        entries.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_launches[kname], "max_abs_err": max_err[kname],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "paced_ms": paced_ms, "plain_paced_ms": plain_paced_ms,
        })
    d_m = [v[:m_b].contiguous() for v in args_d]
    dm_ms, dm_paced = time_calls(lambda: pk.dual_prox(*d_m))
    dm_plain, dm_plain_paced = time_calls(lambda: pref.dual_prox_ref(*d_m))
    log(f"[6]   dual_prox at r=m={m_b}: {dm_ms * 1e3:.2f} / {dm_plain * 1e3:.2f} us "
        f"({dm_paced * 1e3:.2f} / {dm_plain_paced * 1e3:.2f} us) | "
        f"{bound(6 * 8 * m_b, 7 * m_b)[0] * 1e3:.3f} us")
    report["timing"] = {
        "kernels": entries,
        "dual_prox_rows_m": {"ms": dm_ms, "plain_ms": dm_plain, "paced_ms": dm_paced,
                             "plain_paced_ms": dm_plain_paced},
    }

    if args.profile:
        report["profile"] = profile_step(pdn, kernel_opts)

    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[card] {smi}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


def profile_step(pdn, kernel_opts) -> dict:
    """Device busy time of one warm control step, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    sim = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0))
    priority = np.random.default_rng(0).integers(1, 4, pdn.n)
    topo = FleetTopology.from_pdn(pdn, device="cuda")
    opts = NvpaxOptions(solver=kernel_opts)
    warm = optimize(AllocProblem.build(pdn, sim.power(0), priority=priority, topology=topo),
                    opts).warm_state
    ap = AllocProblem.build(pdn, sim.power(1), priority=priority, topology=topo)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        optimize(ap, opts, warm)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    def dev_us(e):
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(dev_us(e) for e in events)
    launches = sum(e.count for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:12]
    rows = [{"name": e.key, "calls": e.count, "device_us": dev_us(e)} for e in top]
    log(f"[profile] one warm step: wall {wall_us:.0f} us, device busy {device_us:.0f} us "
        f"({100.0 * device_us / wall_us:.1f}%), {launches} kernel launches")
    for r in rows:
        log(f"[profile]   {r['device_us']:9.0f} us  {r['calls']:6d}x  {r['name'][:70]}")
    return {"wall_us": wall_us, "device_us": device_us, "launches": launches, "top": rows}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
