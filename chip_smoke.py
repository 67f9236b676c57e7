#!/usr/bin/env python3
"""Drive the PyTorch port of nvPAX on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py                 # exits non-zero on any failure
    python3 chip_smoke.py --profile       # also profiles a warm control step, a cold tenant step,
                                          # a qwen3-4b prefill and decode step and a
                                          # stablelm-12b prefill (launches per step and,
                                          # for the control steps, per PDHG iteration)
    python3 chip_smoke.py --warm-tenants  # also one warm-carried tenant step
    python3 chip_smoke.py --out DIR       # where the details go

Phases, each of which raises on failure:

1. the card: name, count, ``nvidia-smi`` name and power limit;
2. build the CUDA kernels (``src/repro_torch/kernels/csrc``) and print the
   ``nvcc -Xptxas -v`` summary;
3. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes (the paper's fleet: n = 12,288 devices, m = 1,637 tree
   rows; Appendix B: k = 100 tenants, E = 10,000 edges) and at block edges,
   in float64 and float32 (tree rows that overlap at will up to the paper's
   n, the rows of a random tree past it; ``tree_matvec`` also on both sides
   of its one-cluster path's last size);
   the tenant pair also against its CPU plain version bit for bit, and over
   repeated launches, ``sla_matvec`` also on lists of 0 to 1,000 edges and
   one list holding every edge; the chunk statistics on extra draws
   (several seeds at n = 1, 31, 32 and the paper's n); the fused dual step
   (``dual_update``) and scaled adjoint (``scaled_rmatvec``) against the
   launches they replace, bit for bit, at the paper's shapes with and
   without tenants, with scalar step sizes and with every column pinned,
   and at edge sizes (``dual_update`` also against its CPU plain version);
   ``tree_matvec``, ``sla_matvec`` and the two fused kernels each one
   kernel on the card per call (torch.profiler);
4. the main path: five warm-started control steps of
   ``repro_torch.core.nvpax.optimize`` on ``build_datacenter()`` with
   telemetry requests, through the kernels
   (``SolverOptions(use_pallas=True, use_pallas_tree=True)``), each checked
   for feasibility and KKT certification and against the port's own CPU
   run of the same steps; the PDHG loop launches one ``dual_update`` and
   one ``scaled_rmatvec`` per iteration and no standalone ``dual_prox``,
   ``tree_rmatvec`` or ``sla_rmatvec``;
5. the paper's iterated max-min LP path (``use_waterfill=False``) on a
   1,536-device fleet, with the same checks;
6. each kernel's time on the card (CUDA events; see :func:`time_calls`)
   beside its plain version's, its bound and, for the tree and tenant
   pairs and the scaled adjoint, a CSR sparse matrix-vector product on the
   same incidence; the per-launch floor (``dual_prox`` on one row) and ``tree_matvec``'s two
   paths at their boundary;
7. the serving path on a tenant fleet: ``PowerController.step`` on the
   paper's fleet with the Appendix B tenants (100 x 100 devices), every
   kernel flag on, three cold steps, each checked for certification,
   breaker caps, tenant contracts, and Phase I and useful power against the
   port's CPU run (the caps' distance from it is measured and reported, see
   :func:`tenant_engine_phase`), and the PDHG loop's launches held as in
   phase 4; then a repeated step (identical bits) and a supply re-pin (no
   rebuild).
   ``--warm-tenants`` adds one warm-carried step (iterations and
   certificate only);
8. the data plane's serving path on qwen3-4b at full width (36 layers,
   d_model 2,560, bf16 compute, weights from a seeded ``torch.Generator``
   on the card), see :func:`serving_phase`: (a) parameters and peak memory;
   (b) the flash-attention kernels against their plain version at the
   serving shape (layer 0's q/k/v of a 4 x 2,048-token prompt), at edge
   shapes (head dims 32, 64, 128 and 160) and on views of a packed
   projection: the one the wrapper picks, and the mma.sync kernel too
   wherever that is the Hopper kernel;
   (c) ``make_serve_steps`` prefill of that prompt through the Hopper kernel
   (36 launches, no other flash kernel) and through the plain blocked scan
   (``flash_vjp=False``), logits and KV caches held against each other
   (:func:`prefill_against_plain`);
   (d) the reduced config in float32 on the card (the float32 kernel)
   against the CPU (plain version), and in bf16 (head_dim 32: the Hopper
   kernel) against the card's plain blocked scan; (e) token by token decode
   against the prefill, 4 layers, one 1,152-token request; (f) the launcher
   ``repro_torch.launch.serve.run`` twice with ``--cap 450`` (same greedy
   tokens; it prefills token by token and so runs no flash-attention
   kernel); (h) stablelm-12b at full width (40 layers, d_model 5,120, 32
   heads / 8 KV of head_dim 160, 12.1 B parameters, 48.6 GB in float32; a
   peak of about 55 GB), see :func:`stablelm_phase`: its build, layer 0's
   q/k/v through the Hopper kernel against the plain version, and the
   4 x 2,048-token prefill (40 ``flash_attention_wgmma`` launches) against
   the plain blocked scan at (c)'s bars; (g) the kernels' times beside
   their plain version's, their bound and ``scaled_dot_product_attention``'s:
   plain, Hopper, mma.sync, Hopper, mma.sync, plain at both serving shapes
   (qwen3-4b's dh 128, stablelm-12b's dh 160), the float32 kernel at (e)'s
   float32 prefill shape.

The line before the last is a JSON object listing every kernel; the last
is ``{"ok": true, "device": {...}}``.  Details (the build log and every
measurement) go to ``DIR/chip_smoke.json``, by default under
``artifacts/chip_smoke/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.kernels as kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions, optimize  # noqa: E402
from repro_torch.core.problem import AllocProblem, FleetTopology  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.pdhg_update import kernel as pk  # noqa: E402
from repro_torch.kernels.pdhg_update import ref as pref  # noqa: E402
from repro_torch.kernels.tree_matvec import kernel as tk  # noqa: E402
from repro_torch.kernels.tree_matvec import ref as tref  # noqa: E402
from repro_torch.pdn.telemetry import TelemetrySim, TraceConfig  # noqa: E402
from repro_torch.pdn.tenants import appendix_b_layout  # noqa: E402
from repro_torch.pdn.tree import build_datacenter  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, build  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.power import ControllerConfig, PowerController  # noqa: E402
from repro_torch.training.step import make_serve_steps  # noqa: E402

# H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM3, 34 TFLOP/s FP64 and
# 67 TFLOP/s FP32 outside the tensor cores, 989.4 TFLOP/s dense bf16 in
# them, at the 700 W power limit.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12, "bfloat16": 989.4e12}

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
# The tenant kernels sum each list in edge order, so they equal the CPU
# plain version bit for bit (checked exactly); against the plain version on
# the card, whose index_add_ adds with atomics, they are held to TREE_TOL
# of sum|terms|.  The chunk statistics' accumulator and maxima are exact
# (ELEM_TOL); their sums add in another order than torch.sum and are held
# to 8 unit roundoffs of the sum (all terms are squares), 4x the largest
# |d| / sum measured on an NVIDIA H100 80GB HBM3 (2 unit roundoffs).
STATS_TOL = {"float64": 8 * 2.0**-53, "float32": 8 * 2.0**-24}
# extra chunk-stats draws at n = 1, where one term's rounding shows undamped
STATS_DRAWS = 64
# sla_matvec list lengths around a warp (32 lanes) and past the kernel's
# 128-edge chunk; "all": one tenant holds every edge
LIST_LENGTHS = (0, 1, 31, 32, 33, 1000, "all")
# the fused dual step and scaled adjoint at edge sizes beside the paper's
FUSED_SIZES = (1, 1025, 100_003)
# their outputs are compared bit for bit, as integers of the same width
BITS = {torch.float64: torch.int64, torch.float32: torch.int32}
LIMITS = {
    "tree_matvec": TREE_TOL,
    "tree_rmatvec": TREE_TOL,
    "sla_matvec": TREE_TOL,
    "sla_rmatvec": TREE_TOL,
    "primal_update": ELEM_TOL,
    "dual_prox": ELEM_TOL,
    "primal_chunk_stats": ELEM_TOL,
    "dual_chunk_stats": ELEM_TOL,
    "primal_chunk_stats sums": STATS_TOL,
    "dual_chunk_stats sums": STATS_TOL,
}
# the serving path on the tenant fleet: telemetry samples of its cold steps
ENGINE_SAMPLES = (0, 1, 2)
SLA_FEAS_TOL = 1e-6  # watts: tenant sums inside [b_min, b_max]
# the kernels of the tenant serving path (phase 7); flash attention is
# phase 8's, and dual_prox stands alone (phase 6) since the fused dual step
# took its place in the PDHG loop
ALLOCATOR_KERNELS = (
    "tree_matvec", "tree_rmatvec", "sla_matvec", "sla_rmatvec", "scaled_rmatvec",
    "primal_update", "dual_update", "primal_chunk_stats", "dual_chunk_stats",
)
# the flash-attention kernels: Hopper (TMA + wgmma) and mma.sync bf16, float32
FLASH_KERNELS = ("flash_attention_wgmma", "flash_attention_mma", "flash_attention_f32")

# Phase 8, the data plane's serving path.  Flash attention against its plain
# version (attention_ref), row by row: |d| <= tol * max|plain row|.  Float32:
# 1e-5 (both keep float32 throughout, summing in other orders).  Bfloat16:
# 2^-7 against the plain version run in float32 on the same values (the
# kernel rounds P and its output to bfloat16, one unit roundoff 2^-8 each),
# and 2^-5 against the plain version in bfloat16, which also rounds each
# product q.k to bfloat16 before the scale (up to 2^-8 |q.k| dh^-0.5 in a
# logit; 1.6e-2 measured on the H100 at the serving shape with N(0, 1)
# inputs).
SERVE_ARCH = "qwen3-4b"
STABLELM_ARCH = "stablelm-12b"  # phase 8h: head dim 160 at full width
SERVE_B, SERVE_S = 4, 2_048  # the serving prefill: 4 requests of 2,048 tokens
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2.0**-5}
FLASH_TOL_VS_F32 = 2.0**-7
# B, Sq, Sk, H, KV, dh, causal, dtype: the edge shapes beside the serving one
FLASH_EDGES = [
    (2, 300, 1_000, 32, 8, 128, True, torch.bfloat16),  # Sq < Sk
    (2, 1_000, 300, 32, 8, 128, True, torch.bfloat16),  # Sq > Sk: 700 rows see no key
    (2, 1_000, 1_537, 32, 8, 128, True, torch.bfloat16),  # ragged tiles
    (2, 1_537, 1_537, 32, 1, 128, True, torch.bfloat16),  # MQA
    (2, 1_000, 1_000, 16, 4, 64, True, torch.bfloat16),  # dh = 64
    (2, 1_537, 1_000, 32, 8, 128, False, torch.bfloat16),  # non-causal
    (2, 192, 192, 4, 2, 32, True, torch.bfloat16),  # the reduced configs' head_dim
    (2, 1_000, 300, 8, 2, 32, True, torch.bfloat16),  # dh = 32, Sq > Sk
    # stablelm-12b's head_dim 160 (the Hopper kernel's 64-byte swizzle path)
    (2, 300, 1_000, 32, 8, 160, True, torch.bfloat16),  # Sq < Sk
    (2, 1_000, 300, 32, 8, 160, True, torch.bfloat16),  # Sq > Sk: 700 rows see no key
    (2, 1_000, 1_537, 32, 8, 160, True, torch.bfloat16),  # ragged tiles
    (2, 1_537, 1_537, 32, 1, 160, True, torch.bfloat16),  # MQA
    (2, 1_537, 1_000, 32, 8, 160, False, torch.bfloat16),  # non-causal
    (2, 1_000, 1_537, 32, 8, 128, True, torch.float32),
    (2, 1_537, 1_000, 16, 4, 64, False, torch.float32),
    (2, 192, 192, 4, 2, 32, True, torch.float32),
    (2, 300, 1_000, 32, 8, 160, True, torch.float32),  # Sq < Sk
    (2, 1_000, 300, 32, 8, 160, True, torch.float32),  # Sq > Sk
    (2, 1_000, 1_537, 32, 8, 160, True, torch.float32),  # ragged tiles
    (2, 1_537, 1_537, 32, 1, 160, True, torch.float32),  # MQA
    (2, 1_537, 1_000, 32, 8, 160, False, torch.float32),  # non-causal
]
# reduced qwen3-4b in float32, prefill logits, card (kernel) vs CPU (plain
# version): about 5x the reference's own blocked-vs-plain gap (3.7e-6)
CARD_CPU_TOL = 2e-5
# decode vs prefill: the reference's own bar, rtol = atol = 2e-2
# (tests/test_arch_smoke.py::test_decode_matches_prefill_consistency), in
# float32 compute as that test runs; in bf16 compute the reference's own
# decode and prefill miss it (1.6% of the logits outside it, reduced
# qwen3-4b, S = 192: tests/test_torch_lm.py run as a script), so bf16 is held
# to PATH_TOL below in relative Frobenius norm
SERVE_TOL = 2e-2
# the prefill through the kernel vs through the plain blocked scan: the two
# differ only in the attention arithmetic, whose outputs 8b holds within
# 2^-5 (FLASH_TOL, bf16) of each other; each layer's K and V caches are held
# to the same 2^-5 in relative Frobenius norm (elementwise, two bf16 paths
# differ by a few bf16 ulps: up to 0.07 on keys of magnitude ~4 at layer 1,
# measured on the H100), and layer 0's, computed before any attention, must
# be identical
PATH_TOL = 2.0**-5
DECODE_LAYERS, DECODE_S = 4, 1_152  # S > attn_chunk: the prefill runs the kernel


def log(*args) -> None:
    print(*args, flush=True)


def nested_rows(rng, n: int, m: int):
    """At most m rows of a random tree over [0, n), in random order: three
    levels, each splitting the one above at random cut points (repeated cuts
    give empty rows), so each level covers [0, n) once."""
    cuts = np.array([0, n])
    starts, ends = [], []
    for size in (m // 16, m // 4, m // 2):
        cuts = np.sort(np.concatenate([cuts, rng.integers(0, n + 1, size)]))
        starts.append(cuts[:-1])
        ends.append(cuts[1:])
    s, e = np.concatenate(starts), np.concatenate(ends)
    keep = rng.permutation(s.size)[:m]
    return s[keep], e[keep]


def long_list_edges(rng, n: int, length):
    """Edges of 4 tenants in random edge order: tenant 1 holds ``length``
    edges, tenants 0 and 3 a few, tenant 2 none; or tenant 2 holds all
    300,000 edges.  Devices repeat within a list."""
    if length == "all":
        ten = np.full(300_000, 2)
    else:
        ten = np.concatenate([np.zeros(5), np.ones(length), np.full(3, 3)])
        ten = ten[rng.permutation(ten.size)]
    return rng.integers(0, n, ten.size), ten.astype(np.int64)


def fused_inputs(tidx, sidx, dtype, gen, vector_sigma=True, pinned=False):
    """Arguments of the fused dual step and scaled adjoint over a tree index
    and a tenant index, drawn from ``gen``: (dual_update's, scaled_rmatvec's).
    About 30% of the columns pinned (mov = 0), all with ``pinned``; every
    bound vector partly infinite; step sizes vectors or one 0-d tensor."""
    n, m, k = tidx.n, tidx.start.shape[0], sidx.k
    dev = tidx.start.device
    inf = float("inf")

    def vec(size):
        return torch.as_tensor(gen.normal(size=size), dtype=dtype, device=dev)

    def pos(size):
        return vec(size).abs() + 0.1

    mov = torch.zeros(n, dtype=dtype, device=dev) if pinned else (vec(n) > -0.5).to(dtype)
    sm = pos(n) * mov
    blocks = []
    for size, a in ((m, vec(m)), (k, vec(k)), (n, sm * vec(n))):
        sig = pos(size) if vector_sigma else torch.full((), 0.37, dtype=dtype, device=dev)
        lo = vec(size)
        hi = lo + pos(size)
        lo = torch.where(vec(size) > 0.5, -inf, lo)
        hi = torch.where(vec(size) > 0.5, inf, hi)
        blocks.append(pref.DualBlock(vec(size), a, pos(size), sig, lo, hi))
    scalars = [torch.full((), v, dtype=dtype, device=dev) for v in (1.7, 1.0, 0.6)]
    adjoint = (vec(m), vec(k), vec(n), pos(m), pos(k), pos(n), sm, tidx, sidx)
    return (*blocks, *scalars), adjoint


def on_cpu(args):
    """The fused dual step's arguments, moved to the CPU."""
    return [type(a)(*(v.cpu() for v in a)) if isinstance(a, tuple) else a.cpu() for a in args]


def scaled_adjoint_csr(adjoint, device):
    """S K_mov^T D of the scaled adjoint as one CUDA CSR matrix, n x (m + k + n):
    row i holds s_i mov_i d_j at its covering tree rows j, its tenants and
    its own improvement row, so that ``torch.mv`` of it by (y_tree, y_sla,
    y_imp) is ``scaled_rmatvec``'s gx (the library's yardstick)."""
    _, _, _, d_tree, d_sla, d_imp, sm, tidx, sidx = adjoint
    n, m, k = tidx.n, tidx.start.shape[0], sidx.k
    c_ptr, c_rows = tidx.cover_ptr.cpu().numpy(), tidx.cover_rows.cpu().numpy()
    d_ptr, d_ten = sidx.dev_ptr.cpu().numpy(), sidx.dev_ten.cpu().numpy()
    own = np.arange(n)
    rows = np.concatenate([np.repeat(own, np.diff(c_ptr)), np.repeat(own, np.diff(d_ptr)), own])
    cols = np.concatenate([c_rows, m + d_ten, m + k + own]).astype(np.int64)
    d = torch.cat([d_tree, d_sla, d_imp]).cpu().numpy()
    vals = sm.cpu().numpy()[rows] * d[cols]
    order = np.lexsort((cols, rows))
    crow = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(crow, dtype=torch.int64), torch.as_tensor(cols[order]),
            torch.as_tensor(vals[order]), size=(n, m + k + n), check_invariants=True,
        ).to(device)


def device_kernels(fn, calls: int) -> list[str]:
    """Names of the kernels the card ran during ``calls`` calls of ``fn``
    (warmed first), from torch.profiler's CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


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


# the kernels of the tree-only optimize paths (phases 4 and 5)
OPTIMIZE_KERNELS = ("tree_matvec", "tree_rmatvec", "scaled_rmatvec", "primal_update", "dual_update")


def check_loop_launches(tag, launches, iterations: int) -> None:
    """The PDHG loop launches one fused dual step and one fused adjoint per
    iteration and no standalone ``dual_prox``; the standalone adjoints run
    only outside it (step sizes, KKT checks, repair), so fewer times than
    the loop iterates."""
    log(f"[{tag}] PDHG loop: {iterations} iterations, dual_update {launches['dual_update']}, "
        f"scaled_rmatvec {launches['scaled_rmatvec']}, dual_prox {launches['dual_prox']}; "
        f"outside it tree_rmatvec {launches['tree_rmatvec']}, "
        f"sla_rmatvec {launches['sla_rmatvec']}")
    if not (launches["dual_update"] == launches["scaled_rmatvec"] == iterations
            and launches["dual_prox"] == 0
            and launches["tree_rmatvec"] < iterations and launches["sla_rmatvec"] < iterations):
        raise AssertionError(f"[{tag}] the PDHG loop's launches are not one fused dual step and "
                             f"one fused adjoint per iteration: {launches}")


def run_steps(tag, pdn_, requests, options, seed, device="cuda"):
    """Warm-started control steps on ``device`` with three priority levels
    drawn from ``seed``, each checked against the port's CPU run of the same
    steps; returns (rows, launch counts of the run on ``device``), and fails
    if a kernel of the path never launched."""
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
    missing = [k for k in OPTIMIZE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    check_loop_launches(tag, launches, sum(sum(r["phase_iterations"]) for r in rows))
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
    parser.add_argument(
        "--profile", action="store_true",
        help="profile a warm control step, a cold tenant step, prefills and a decode step"
    )
    parser.add_argument(
        "--warm-tenants",
        action="store_true",
        help="also run one warm-carried step on the tenant fleet (iterations only)",
    )
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
    one_cluster = _build.library().tree_cluster_tiles() * tile
    tree_sizes = [one_cluster, one_cluster + 1]
    rng = np.random.default_rng(0)
    max_err: dict[str, float] = {}
    worst: dict[str, dict[str, float]] = {"float64": {}, "float32": {}}
    n_checks = [0]

    def on_card(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=cuda)

    def random_rows(n: int, m: int):
        """Row ranges covering the cases the kernels must get right: the
        whole range, empty rows, rows at both ends, rows sharing endpoints.
        Up to the paper's n they overlap at will; past it they nest as a
        tree's do, so that the adjoint's covering-rows index (the rows'
        total length, n x depth for a tree) fits int32."""
        s = rng.integers(0, n + 1, m)
        e = rng.integers(0, n + 1, m)
        s, e = np.minimum(s, e), np.maximum(s, e)
        if n > n_main:
            # a generator of its own, so that the draws of `rng` and the
            # data of every other check stay as they were
            s, e = nested_rows(np.random.default_rng(n), n, m)
        s[:4], e[:4] = [0, 0, n, n // 2], [n, 0, n, n]
        return s, e

    def check(name_, key, got, want, scale, main_shape):
        """Hold |got - want| <= limit * scale, the limit by kernel and dtype.
        Keeps the largest |d| / scale of each kernel and dtype, and the
        largest |d| of each kernel at the main shape in float64."""
        n_checks[0] += 1
        torch.cuda.synchronize()
        limit = LIMITS[name_][key]
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
            kernel_name = name_.split()[0]
            max_err[kernel_name] = max(max_err.get(kernel_name, 0.0), float(err.max()))

    def same_bits(name_, got, want):
        """The kernel's result is the plain CPU version's, bit for bit."""
        n_checks[0] += 1
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name_} (n={got.numel()}) differs from the CPU plain version")

    def check_sla(n, k, e, dtype, main_shape, dev=None, ten=None, gen=None, cpu_only=False):
        """Tenant sums over e edges: devices may sit in several tenants.
        Draws from ``gen`` (by default the phase's generator).  With
        ``cpu_only`` the kernels are held to the CPU plain version's bits
        alone: the card's plain version adds with atomics, in a new order
        every run, so its distance from the ordered sum on a list of
        300,000 float32 terms changes from run to run; equal bits are the
        stronger check."""
        gen = rng if gen is None else gen
        key = str(dtype).split(".")[-1]
        if dev is None:
            dev, ten = gen.integers(0, n, e), gen.integers(0, k, e)
        idx = tk.sla_index(dev, ten, k, n, cuda)
        dev64, ten64 = idx.dev.long(), idx.ten.long()
        x = on_card(gen.normal(size=n), dtype)
        y = on_card(gen.normal(size=k), dtype)
        for name_, fn, ref, v, gather in (
            ("sla_matvec", tk.sla_matvec, lambda v_, d, t: tref.sla_matvec_ref(v_, d, t, k),
             x, dev64),
            ("sla_rmatvec", tk.sla_rmatvec, lambda v_, d, t: tref.sla_rmatvec_ref(v_, d, t, n),
             y, ten64),
        ):
            got = fn(v, idx)
            if e == 0:
                n_checks[0] += 1
                if bool(got.any()):
                    raise AssertionError(f"{name_} without edges is not zero")
                continue
            if not cpu_only:
                check(name_, key, got, ref(v, dev64, ten64), float(v[gather].abs().sum()),
                      main_shape)
            same_bits(name_, got, ref(v.cpu(), dev64.cpu(), ten64.cpu()))
            for _ in range(3):  # no atomics: every launch gives the same bits
                n_checks[0] += 1
                if not torch.equal(fn(v, idx), got):
                    raise AssertionError(f"{name_} (n={n}) differs between launches")

    def check_stats(n, dtype, main_shape, gen=None, cnt=3.0):
        gen = rng if gen is None else gen
        key = str(dtype).split(".")[-1]
        vecs = [on_card(gen.normal(size=n) * 100.0, dtype) for _ in range(4)]
        for name_, fn, ref, args, n_max in (
            ("primal_chunk_stats", pk.primal_chunk_stats, pref.primal_chunk_stats_ref, vecs, 2),
            ("dual_chunk_stats", pk.dual_chunk_stats, pref.dual_chunk_stats_ref, vecs[:3], 0),
        ):
            got, want = fn(*args, cnt), ref(*args, cnt)
            # accumulator and maxima exact, sums to STATS_TOL of the sum
            for i, (g, r) in enumerate(zip(got, want)):
                if i <= n_max:
                    check(name_, key, g, r, r.abs().clamp_min(1.0), main_shape)
                else:
                    check(f"{name_} sums", key, g, r, r.clamp_min(1e-300), main_shape)

    def check_tree(n, start, end, dtype, main_shape, gen=None):
        gen = rng if gen is None else gen
        key = str(dtype).split(".")[-1]
        idx = tk.tree_index(start, end, n, cuda)
        x = on_card(gen.normal(size=n), dtype)
        check("tree_matvec", key, tk.tree_matvec(x, idx),
              tref.tree_matvec_ref(x, idx.start.long(), idx.end.long()),
              float(x.abs().sum()), main_shape)
        y = on_card(gen.normal(size=len(start)), dtype)
        check("tree_rmatvec", key, tk.tree_rmatvec(y, idx),
              tref.tree_rmatvec_ref(y, idx.start.long(), idx.end.long(), n),
              float(y.abs().sum()), main_shape)

    def check_fused(tidx, sidx, dtype, main_shape, gen, vector_sigma=True, pinned=False):
        """dual_update and scaled_rmatvec against the launches they replace
        (their plain compositions on the card, whose adjoint sums are the
        deterministic segment-sum kernels), and dual_update against its CPU
        plain version: the same bits (max |d| = 0)."""
        dual, adjoint = fused_inputs(tidx, sidx, dtype, gen, vector_sigma, pinned)
        got_d = pk.dual_update(*dual)
        got_a = tk.scaled_rmatvec(*adjoint)
        for name_, got, want in (
            ("dual_update", got_d, pref.dual_update_ref(*dual)),
            ("dual_update", got_d, pref.dual_update_ref(*on_cpu(dual))),
            ("scaled_rmatvec", got_a, tref.scaled_rmatvec_ref(*adjoint)),
        ):
            for g, w in zip(got, want):
                n_checks[0] += 1
                g, w = g.cpu(), w.cpu()
                if not torch.equal(g.view(BITS[dtype]), w.view(BITS[dtype])):
                    raise AssertionError(
                        f"{name_} (n={tidx.n}, k={sidx.k}, {dtype}) differs from its plain "
                        f"composition in {int((g != w).sum())} of {g.numel()} values")
                if main_shape:
                    err = torch.where(g == w, 0.0, (g - w).abs())
                    max_err[name_] = max(max_err.get(name_, 0.0),
                                         float(err.max()) if err.numel() else 0.0)

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

    layout = appendix_b_layout(pdn, seed=0)
    b_dev = np.nonzero(layout.tenant_of >= 0)[0]
    b_ten = layout.tenant_of[b_dev]
    idx_main = tk.tree_index(pdn.node_start, pdn.node_end, n_main, cuda)
    sidx_main = tk.sla_index(b_dev, b_ten, layout.n_tenants, n_main, cuda)
    sidx_none = tk.sla_index([], [], 0, n_main, cuda)
    x_main = on_card(np.random.default_rng(12_288).normal(size=n_main), torch.float64)
    dual_main, adjoint_main = fused_inputs(idx_main, sidx_main, torch.float64,
                                           np.random.default_rng(18))
    t0 = time.perf_counter()
    for dtype in (torch.float64, torch.float32):
        main = dtype == torch.float64
        check_tree(n_main, pdn.node_start, pdn.node_end, dtype, main)
        check_elementwise(n_main, dtype, main)
        check_elementwise(m_main, dtype, main)
        check_sla(n_main, layout.n_tenants, b_dev.size, dtype, main, b_dev, b_ten)
        check_stats(n_main, dtype, main)
        check_stats(m_main, dtype, main)
        check_sla(1000, 7, 0, dtype, False)  # no edges
        for n in edge_sizes:
            s, e = random_rows(n, min(2 * n, 5000) + 4)
            check_tree(n, s, e, dtype, False)
            check_elementwise(n, dtype, False)
            check_sla(n, max(1, n // 50), min(3 * n, 300_000), dtype, False)
            check_stats(n, dtype, False)
        # Added checks, each from a generator of its own, so that the draws
        # above stay as they were.  sla_matvec's warp per tenant on lists
        # around a warp and past its chunk, and one tenant holding every
        # edge: the CPU's bits (check_sla), the same bits on every launch.
        for length in LIST_LENGTHS:
            gen = np.random.default_rng(7 if length == "all" else length)
            dev, ten = long_list_edges(gen, n_main, length)
            check_sla(n_main, 4, dev.size, dtype, False, dev, ten, gen, cpu_only=True)
        # the chunk statistics over several draws, one term per sum at n = 1
        for n in (1, 31, 32, n_main):
            for seed in range(STATS_DRAWS if n == 1 else 3):
                gen = np.random.default_rng(10_000 * n + seed)
                check_stats(n, dtype, False, gen, cnt=float(1 + seed % 7))
        # tree_matvec on both sides of its one-cluster path's last size
        for n in tree_sizes:
            gen = np.random.default_rng(n)
            s, e = nested_rows(gen, n, 5004)
            s[:4], e[:4] = [0, 0, n, n // 2], [n, 0, n, n]
            check_tree(n, s, e, dtype, False, gen)
        # the fused dual step and scaled adjoint: the paper's tenant fleet,
        # no tenants, scalar step sizes, every column pinned; then edge
        # sizes with random rows and edges
        gen = np.random.default_rng(17)
        check_fused(idx_main, sidx_main, dtype, main, gen)
        check_fused(idx_main, sidx_none, dtype, False, gen)
        check_fused(idx_main, sidx_main, dtype, False, gen, vector_sigma=False)
        check_fused(idx_main, sidx_main, dtype, False, gen, pinned=True)
        for n in FUSED_SIZES:
            if n > n_main:
                s, e = nested_rows(gen, n, 5004)
            else:
                s, e = np.sort(gen.integers(0, n + 1, (2, min(2 * n, 5000) + 4)), axis=0)
            k_n = max(1, n // 50)
            check_fused(tk.tree_index(s, e, n, cuda),
                        tk.sla_index(gen.integers(0, n, 3 * n), gen.integers(0, k_n, 3 * n),
                                     k_n, n, cuda),
                        dtype, False, gen)
    log(f"[3] {n_checks[0]} kernel-vs-plain checks passed in {time.perf_counter() - t0:.1f} s "
        f"(tile {tile}, elementwise grid {grid} threads; n in {edge_sizes} and "
        f"{tree_sizes} for tree_matvec, {FUSED_SIZES} for the fused pair; sla_matvec lists of "
        f"{LIST_LENGTHS} edges; "
        f"{STATS_DRAWS} chunk-stats draws at n=1); max |d| at "
        f"n={n_main}, m={m_main}, float64: "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(max_err.items())))
    for key, per_kernel in worst.items():
        log(f"[3] {key}, all sizes, largest |d| / scale (limit): "
            + ", ".join(
                f"{k} {v:.3e} ({LIMITS[k][key]:.3e})" for k, v in sorted(per_kernel.items())
            ))
    # the redesigned kernels: one kernel on the card per call, nothing else
    one_launch = {}
    for name_, fn in (
        ("tree_matvec", lambda: tk.tree_matvec(x_main, idx_main)),
        ("sla_matvec", lambda: tk.sla_matvec(x_main, sidx_main)),
        ("dual_update", lambda: pk.dual_update(*dual_main)),
        ("scaled_rmatvec", lambda: tk.scaled_rmatvec(*adjoint_main)),
    ):
        ran = device_kernels(fn, 5)
        if len(ran) != 5:
            raise AssertionError(f"{name_}: 5 calls ran {len(ran)} kernels on the card: {ran}")
        one_launch[name_] = sorted(set(ran))
    log(f"[3] one kernel on the card per call (torch.profiler, 5 calls): {one_launch}")
    report["kernel_checks"] = {
        "count": n_checks[0],
        "device_kernels_per_call": one_launch,
        "max_abs_err_f64": max_err,
        "max_rel_err": worst,
        "limits": LIMITS,
    }

    # -- 4/5. control steps on the card vs the port's CPU run ---------------
    kernel_opts = SolverOptions(use_pallas=True, use_pallas_tree=True)

    log(f"[4] main path: n={n_main}, m={m_main}, {STEPS} telemetry steps, "
        "water-fill phases II/III")
    main_rows, main_launches = run_steps(
        "4", pdn, telemetry_requests(pdn, STEPS, 0), NvpaxOptions(solver=kernel_opts), 0
    )
    report["main_path"] = {"n": n_main, "m": m_main, "steps": main_rows, "launches": main_launches}
    # the same steps on the card with the kernel flags off, for the step
    # time the kernels replace (the scatter sums keep their deterministic
    # kernels there too, see repro_torch.core.treeops)
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
    log("[4] the same steps with the kernel flags off on the card: "
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
    k_b, e_b = layout.n_tenants, b_dev.size
    sidx = tk.sla_index(b_dev, b_ten, k_b, n_main, cuda)
    sdev64, sten64 = sidx.dev.long(), sidx.ten.long()
    ys = on_card(rng.normal(size=k_b), f64)
    stat_args = [on_card(rng.normal(size=n_main) * 100.0, f64) for _ in range(4)]
    # the library's yardstick: one CSR sparse matrix-vector product by the
    # same incidence (interval rows for the tree, tenant rows for the SLAs)
    tree_rows = np.repeat(np.arange(m_main), pdn.node_end - pdn.node_start)
    tree_cols = np.concatenate([np.arange(a, b) for a, b in zip(pdn.node_start, pdn.node_end)])
    a_tree, a_tree_t = csr_pair(tree_rows, tree_cols, m_main, n_main, cuda)
    a_sla, a_sla_t = csr_pair(b_ten, b_dev, k_b, n_main, cuda)
    for name_, got, want in (
        ("tree_matvec", torch.mv(a_tree, xv), tk.tree_matvec(xv, idx)),
        ("tree_rmatvec", torch.mv(a_tree_t, yv), tk.tree_rmatvec(yv, idx)),
        ("sla_matvec", torch.mv(a_sla, xv), tk.sla_matvec(xv, sidx)),
        ("sla_rmatvec", torch.mv(a_sla_t, ys), tk.sla_rmatvec(ys, sidx)),
    ):
        d = float((got - want).abs().max())
        if not d <= 1e-9 * max(1.0, float(want.abs().max())):
            raise AssertionError(f"the CSR product disagrees with {name_}: {d:.3e}")
    n_touched = np.unique(b_dev).size
    args_p = [on_card(rng.normal(size=n_main), f64) for _ in range(8)]
    args_p[3] = args_p[3].abs()
    args_p[7] = args_p[7].abs() + 0.01
    args_p[6] = args_p[5] + args_p[6].abs()
    args_d = [on_card(rng.normal(size=n_main), f64) for _ in range(5)]
    args_d[2] = args_d[2].abs() + 0.01
    args_d[3] = torch.full_like(args_d[3], -float("inf"))
    n_b, m_b = n_main, m_main
    # the fused pair at the tenant fleet's shapes (phase 3's main-shape
    # inputs); the library's yardstick for the adjoint is one CSR product by
    # S K_mov^T D on the stacked duals
    rows_b = m_b + k_b + n_b
    cover_b = idx_main.cover_rows.numel()
    a_adj = scaled_adjoint_csr(adjoint_main, cuda)
    y_cat = torch.cat(adjoint_main[:3])
    gx_main = tk.scaled_rmatvec(*adjoint_main)[0]
    d = float((torch.mv(a_adj, y_cat) - gx_main).abs().max())
    if not d <= 1e-9 * max(1.0, float(gx_main.abs().max())):
        raise AssertionError(f"the CSR product disagrees with scaled_rmatvec: {d:.3e}")

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
        # tenant sums at Appendix B: the x entries the edges touch, the CSR
        # list (k + 1 pointers, E ids) and the k sums; the adjoint reads the
        # k duals, n + 1 pointers and E ids and writes n sums
        ("sla_matvec", "src/repro_torch/kernels/csrc/tree_matvec.cu",
         "src/repro/kernels/tree_matvec/kernel.py:166",
         lambda: tk.sla_matvec(xv, sidx),
         lambda: tref.sla_matvec_ref(xv, sdev64, sten64, k_b),
         bound(8 * n_touched + 4 * (k_b + 1) + 4 * e_b + 8 * k_b, e_b),
         lambda: torch.mv(a_sla, xv)),
        ("sla_rmatvec", "src/repro_torch/kernels/csrc/tree_matvec.cu",
         "src/repro/kernels/tree_matvec/kernel.py:187",
         lambda: tk.sla_rmatvec(ys, sidx),
         lambda: tref.sla_rmatvec_ref(ys, sdev64, sten64, n_b),
         bound(8 * k_b + 4 * (n_b + 1) + 4 * e_b + 8 * n_b, e_b),
         lambda: torch.mv(a_sla_t, ys)),
        # 4 vectors read, the accumulator and 4 scalars written
        ("primal_chunk_stats", "src/repro_torch/kernels/csrc/pdhg_update.cu",
         "src/repro/kernels/pdhg_update/kernel.py:154",
         lambda: pk.primal_chunk_stats(*stat_args, 3.0),
         lambda: pref.primal_chunk_stats_ref(*stat_args, 3.0),
         bound(5 * 8 * n_b + 4 * 8, 13 * n_b),
         None),
        # 3 vectors read, the accumulator and 3 scalars written (r = n)
        ("dual_chunk_stats", "src/repro_torch/kernels/csrc/pdhg_update.cu",
         "src/repro/kernels/pdhg_update/kernel.py:190",
         lambda: pk.dual_chunk_stats(*stat_args[:3], 3.0),
         lambda: pref.dual_chunk_stats_ref(*stat_args[:3], 3.0),
         bound(4 * 8 * n_b + 3 * 8, 10 * n_b),
         None),
        # the fused dual step over the m + k + n rows: six vectors read and
        # one written per row (y, a, d, sigma, lo, hi; out) and 3 scalars;
        # 7 operations a row, one more on the improvement rows
        ("dual_update", "src/repro_torch/kernels/csrc/pdhg_update.cu",
         "src/repro/kernels/pdhg_update/kernel.py:101",
         lambda: pk.dual_update(*dual_main),
         lambda: pref.dual_update_ref(*dual_main),
         bound(7 * 8 * rows_b + 3 * 8, 7 * rows_b + n_b),
         None),
        # the fused scaled adjoint: both CSR lists (n + 1 pointers each, the
        # covering rows and the E tenant ids), the m and k duals and row
        # scales, y_imp, d_imp and s*mov read; gx and yi written; a product
        # and an add per list entry, four operations per device
        ("scaled_rmatvec", "src/repro_torch/kernels/csrc/tree_matvec.cu",
         "src/repro/kernels/tree_matvec/kernel.py:187",
         lambda: tk.scaled_rmatvec(*adjoint_main),
         lambda: tref.scaled_rmatvec_ref(*adjoint_main),
         bound(8 * (n_b + 1) + 4 * (cover_b + e_b) + 16 * (m_b + k_b) + 40 * n_b,
               2 * (cover_b + e_b) + 4 * n_b),
         lambda: torch.mv(a_adj, y_cat)),
    ]
    library = {
        "tree_matvec": lambda: torch.mv(a_tree, xv),
        "tree_rmatvec": lambda: torch.mv(a_tree_t, yv),
    }
    entries = []
    log(f"[6] kernel times on {smi}, float64, n={n_b}, m={m_b}, k={k_b}, E={e_b} "
        "(dual_prox and dual_chunk_stats at r=n; dual_update over m + k + n rows, "
        "scaled_rmatvec over n devices, each beside the plain composition it replaces):")
    log("[6]   name: device time per call, kernel / plain (host-paced kernel / plain) | bound"
        " | CSR SpMV")
    for kname, source, replaces, fn_kernel, fn_plain, (bound_ms, bound_by), *lib in timing:
        fn_lib = lib[0] if lib else library.get(kname)
        # plain, kernel, kernel, plain: the later of each pair is kept
        time_calls(fn_plain)
        time_calls(fn_kernel)
        ms, paced_ms = time_calls(fn_kernel)
        plain_ms, plain_paced_ms = time_calls(fn_plain)
        lib_ms = None if fn_lib is None else time_calls(fn_lib)[0]
        log(f"[6]   {kname}: {ms * 1e3:.2f} / {plain_ms * 1e3:.2f} us "
            f"({paced_ms * 1e3:.2f} / {plain_paced_ms * 1e3:.2f} us) | "
            f"{bound_ms * 1e3:.3f} us ({bound_by}) | "
            + ("none" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"))
        entries.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": max_err[kname],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "paced_ms": paced_ms, "plain_paced_ms": plain_paced_ms,
        })
    d_m = [v[:m_b].contiguous() for v in args_d]
    dm_ms, dm_paced = time_calls(lambda: pk.dual_prox(*d_m))
    dm_plain, dm_plain_paced = time_calls(lambda: pref.dual_prox_ref(*d_m))
    log(f"[6]   dual_prox at r=m={m_b}: {dm_ms * 1e3:.2f} / {dm_plain * 1e3:.2f} us "
        f"({dm_paced * 1e3:.2f} / {dm_plain_paced * 1e3:.2f} us) | "
        f"{bound(6 * 8 * m_b, 7 * m_b)[0] * 1e3:.3f} us")
    s_m = [v[:m_b].contiguous() for v in stat_args[:3]]
    sm_ms, sm_paced = time_calls(lambda: pk.dual_chunk_stats(*s_m, 3.0))
    sm_plain, sm_plain_paced = time_calls(lambda: pref.dual_chunk_stats_ref(*s_m, 3.0))
    log(f"[6]   dual_chunk_stats at r=m={m_b}: {sm_ms * 1e3:.2f} / {sm_plain * 1e3:.2f} us "
        f"({sm_paced * 1e3:.2f} / {sm_plain_paced * 1e3:.2f} us) | "
        f"{bound(4 * 8 * m_b + 3 * 8, 10 * m_b)[0] * 1e3:.3f} us")
    # the per-launch floor: dual_prox on one row does no work to speak of
    d_1 = [v[:1].contiguous() for v in args_d]
    floor_ms, floor_paced = time_calls(lambda: pk.dual_prox(*d_1))
    log(f"[6]   per-launch floor, dual_prox at r=1: {floor_ms * 1e3:.2f} us "
        f"({floor_paced * 1e3:.2f} us host-paced)")
    # tree_matvec's two paths at their boundary, m rows of a random tree
    # each: one cluster of its largest size, the cooperative grid one tile on
    tree_paths = {}
    for n_p in tree_sizes:
        gen = np.random.default_rng(n_p)
        s_p, e_p = nested_rows(gen, n_p, m_b)
        idx_p = tk.tree_index(s_p, e_p, n_p, cuda)
        x_p = on_card(gen.normal(size=n_p), f64)
        tree_paths[n_p] = time_calls(lambda: tk.tree_matvec(x_p, idx_p))[0]
    log(f"[6]   tree_matvec at its paths' boundary, m<={m_b}: one cluster (n={tree_sizes[0]}) "
        f"{tree_paths[tree_sizes[0]] * 1e3:.2f} us, cooperative grid (n={tree_sizes[1]}) "
        f"{tree_paths[tree_sizes[1]] * 1e3:.2f} us")
    report["timing"] = {
        "kernels": entries,
        "floor_dual_prox_r1": {"ms": floor_ms, "paced_ms": floor_paced},
        "tree_matvec_paths_ms": {"cluster": tree_paths[tree_sizes[0]],
                                 "cooperative": tree_paths[tree_sizes[1]]},
        "dual_prox_rows_m": {"ms": dm_ms, "plain_ms": dm_plain, "paced_ms": dm_paced,
                             "plain_paced_ms": dm_plain_paced},
        "dual_chunk_stats_rows_m": {"ms": sm_ms, "plain_ms": sm_plain, "paced_ms": sm_paced,
                                    "plain_paced_ms": sm_plain_paced},
    }

    # -- 7. the serving path on the tenant fleet -----------------------------
    engine_opts = kernel_opts._replace(use_pallas_stats=True)  # all eight kernels
    engine_launches, engine_report = tenant_engine_phase(
        pdn, layout, engine_opts, cuda, args.warm_tenants
    )
    report["engine_path"] = engine_report
    for entry in entries:
        entry["launches"] = engine_launches[entry["name"]]
        entry["launches_optimize_path"] = main_launches[entry["name"]]

    # -- 8. the data plane's serving path -------------------------------------
    flash_entries, report["serving_path"] = serving_phase(cuda, smi, args.profile)
    entries.extend(flash_entries)

    if args.profile:
        report["profile"] = profile_step(pdn, kernel_opts)
        report["profile_tenant"] = profile_tenant_step(pdn, layout, engine_opts)

    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[card] {smi}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


def csr_pair(rows, cols, n_rows, n_cols, device):
    """The 0/1 incidence matrix with ones at (rows, cols), and its
    transpose, as CUDA CSR tensors."""

    def csr(r, c, shape):
        order = np.lexsort((c, r))
        crow = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=shape[0]))])
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                torch.as_tensor(crow, dtype=torch.int64),
                torch.as_tensor(c[order], dtype=torch.int64),
                torch.ones(len(r), dtype=torch.float64),
                size=shape,
                check_invariants=True,
            ).to(device)

    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    return csr(rows, cols, (n_rows, n_cols)), csr(cols, rows, (n_cols, n_rows))


def tenant_engine_phase(pdn, layout, kernel_opts, cuda, warm_tenants: bool):
    """Phase 7: cold ``PowerController`` steps on the Appendix B tenant fleet
    through every kernel, against the port's CPU run of the same steps.
    Returns (launch counts of the card's cold steps, report).

    Fails unless every step certifies, keeps the breaker caps and tenant
    contracts to 1e-6 W, and lands within ``PARITY_TOL`` of the CPU run in
    Phase I (a strictly convex QP) and in every device's useful power,
    min(request, cap).  The caps themselves are measured against the same
    bar, per device and with equal per-phase iterations, and reported as
    met or missed, not failed: Phase II/III here are epsilon-degenerate
    max-min LPs that spread the surplus above the requests differently, at
    equal quality, when the reference's own input moves by one ulp (up to
    2e-2 W per device, ROADMAP Queue 3), so a summation order changed from
    CPU to card moves it too."""
    sim = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0))
    samples = [sim.power(t) for t in ENGINE_SAMPLES]
    config = ControllerConfig(options=NvpaxOptions(solver=kernel_opts))
    owned = layout.tenant_of >= 0

    def controller(device):
        return PowerController(
            pdn, sla=layout.sla_topo(device=device), priority=layout.priority,
            config=config, device=device,
        )

    def cold_steps(ctl, device):
        out = []
        for tele in samples:
            ctl.reset_warm()
            sync(device)
            t0 = time.perf_counter()
            res = ctl.step(tele)
            sync(device)
            out.append((res, time.perf_counter() - t0))
        return out

    log(f"[7] serving path: PowerController.step on n={pdn.n}, Appendix B tenants "
        f"k={layout.n_tenants}, E={int(owned.sum())}, cold steps on samples {ENGINE_SAMPLES}")
    card = controller(cuda)
    kernels.reset_launch_counts()
    card_runs = cold_steps(card, cuda)
    launches = kernels.launch_counts()
    cpu_runs = cold_steps(controller("cpu"), "cpu")
    rows = []
    for t, ((res, wall), (ref, _)) in zip(ENGINE_SAMPLES, zip(card_runs, cpu_runs)):
        st = res.stats
        if not (st["converged"] and st["kkt_certified"]):
            raise AssertionError(f"[7] sample {t} not certified: {dict(st)}")
        phase1_gap = float(np.max(np.abs(res.phase1 - ref.phase1)))
        if phase1_gap > PARITY_TOL:
            raise AssertionError(f"[7] sample {t}: Phase I card vs CPU {phase1_gap:.3e} W")
        req = np.asarray(samples[t], np.float64) * config.request_margin
        active = req >= config.idle_threshold
        r_eff = np.where(active, np.clip(req, pdn.dev_l, pdn.dev_u), 0.0)
        useful_gap = float(np.max(np.abs(
            np.minimum(r_eff, res.allocation) - np.minimum(r_eff, ref.allocation)
        )))
        if useful_gap > PARITY_TOL:
            raise AssertionError(f"[7] sample {t}: useful power card vs CPU {useful_gap:.3e} W")
        over = feasibility(pdn, res.allocation)
        sums = np.bincount(layout.tenant_of[owned], weights=res.allocation[owned],
                           minlength=layout.n_tenants)
        sla_gap = float(max(np.max(layout.b_min - sums), np.max(sums - layout.b_max)))
        if sla_gap > SLA_FEAS_TOL:
            raise AssertionError(f"[7] sample {t}: a tenant sum leaves its bounds by {sla_gap:.3e} W")
        per_tenant = metrics.tenant_satisfaction(
            r_eff, res.allocation, layout.tenant_of, layout.n_tenants
        )
        row = {
            "sample": t,
            "wall_ms": wall * 1e3,
            "phase_iterations": list(st["phase_iterations"]),
            "cpu_phase_iterations": list(ref.stats["phase_iterations"]),
            "certified": bool(st["kkt_certified"]),
            "max_abs_vs_cpu_w": float(np.max(np.abs(res.allocation - ref.allocation))),
            "phase1_max_abs_vs_cpu_w": phase1_gap,
            "useful_max_abs_vs_cpu_w": useful_gap,
            "total_vs_cpu_w": float(res.allocation.sum() - ref.allocation.sum()),
            "satisfaction_vs_cpu": metrics.satisfaction_ratio(r_eff, res.allocation)
            - metrics.satisfaction_ratio(r_eff, ref.allocation),
            "max_cap_excess_w": over,
            "max_tenant_bound_excess_w": sla_gap,
            "satisfaction": metrics.satisfaction_ratio(r_eff, res.allocation),
            "tenant_satisfaction_min": float(per_tenant.min()),
            "tenant_satisfaction_mean": float(per_tenant.mean()),
            "sla_margin_min": float(metrics.sla_margin(
                res.allocation, layout.tenant_of, layout.n_tenants, layout.b_min, layout.b_max
            ).min()),
            "total_w": float(res.allocation.sum()),
        }
        row["parity_bar_met"] = (
            row["max_abs_vs_cpu_w"] <= PARITY_TOL
            and row["phase_iterations"] == row["cpu_phase_iterations"]
        )
        rows.append(row)
        log(f"[7] sample {t}: {row['wall_ms']:.1f} ms, iterations {row['phase_iterations']} "
            f"(cpu {row['cpu_phase_iterations']}), certified, cap excess {over:.2e} W, tenant "
            f"bound excess {sla_gap:.2e} W, satisfaction {row['satisfaction']:.6f} (tenants min "
            f"{row['tenant_satisfaction_min']:.4f}, mean {row['tenant_satisfaction_mean']:.4f})")
        log(f"[7]   card vs cpu: phase I {phase1_gap:.2e} W, useful power {useful_gap:.2e} W; "
            f"caps {row['max_abs_vs_cpu_w']:.2e} W per device, total "
            f"{row['total_vs_cpu_w']:+.3e} W, satisfaction "
            f"{row['satisfaction_vs_cpu']:+.2e}; <= {PARITY_TOL:.0e} W with equal iterations: "
            + ("met" if row["parity_bar_met"] else "missed"))
    log(f"[7] launches {launches}")
    missing = [k for k in ALLOCATOR_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"[7] kernels never launched: {missing}")
    check_loop_launches("7", launches, sum(sum(r["phase_iterations"]) for r in rows))

    # the same cold step again: the same bits (no atomics on the path)
    card.reset_warm()
    again = card.step(samples[0])
    if not np.array_equal(again.allocation, card_runs[0][0].allocation):
        d = float(np.max(np.abs(again.allocation - card_runs[0][0].allocation)))
        raise AssertionError(f"[7] a repeated cold step differs by {d:.3e} W")
    # a supply drop re-pins the engine's caps: no rebuild
    card.set_supply_scale(0.9)
    derated = card.step(samples[0])
    scaled = dataclasses.replace(pdn, node_cap=pdn.node_cap * 0.9)
    feasibility(scaled, derated.allocation)
    if card.rebuild_count() != 1:
        raise AssertionError(f"[7] rebuild_count {card.rebuild_count()} after a re-pin")
    log(f"[7] repeated sample 0: identical bits; supply 0.9: iterations "
        f"{derated.stats['phase_iterations']}, certified {derated.stats['kkt_certified']}, "
        f"rebuild_count {card.rebuild_count()}")
    report = {
        "samples": rows,
        "launches": launches,
        "repeat_identical": True,
        "derated": {"phase_iterations": list(derated.stats["phase_iterations"]),
                    "certified": bool(derated.stats["kkt_certified"]),
                    "rebuild_count": card.rebuild_count()},
    }
    if warm_tenants:
        warm = controller(cuda)
        warm.step(samples[0])
        t0 = time.perf_counter()
        res = warm.step(samples[1])
        sync(cuda)
        report["warm_step"] = {
            "phase_iterations": list(res.stats["phase_iterations"]),
            "certified": bool(res.stats["kkt_certified"]),
            "converged": bool(res.stats["converged"]),
            "wall_ms": (time.perf_counter() - t0) * 1e3,
        }
        log(f"[7] warm-carried sample 1 after sample 0: {report['warm_step']}")
    return launches, report


def _row_err(got, want) -> float:
    """max |got - want| / max|want row| over the rows of the last axis."""
    scale = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((got.float() - want.float()).abs() / scale).max())


def check_flash(tag, q, k, v, causal) -> list[dict]:
    """Phase 8b: every kernel that takes these inputs against the plain
    version on one shape (see ``FLASH_TOL``): the one the wrapper picks and,
    where that is the Hopper kernel, the mma.sync kernel too (its private
    entry); a causal row that sees no key must give the mean of V."""
    dtype = str(q.dtype).split(".")[-1]
    (B, Sq, H, dh), (Sk, KV) = q.shape, k.shape[1:3]
    plain = attention_ref(q, k, v, causal=causal)
    exact = (attention_ref(q.float(), k.float(), v.float(), causal=causal)
             if q.dtype == torch.bfloat16 else None)
    picked = fk.variant(q, k, v)
    runs = [(picked, fk.flash_attention)]
    if picked == "wgmma":
        runs.append(("mma", fk._flash_attention_mma))
    rows = []
    for kind, fn in runs:
        got = fn(q, k, v, causal=causal)
        row = {
            "tag": tag, "kernel": f"flash_attention_{kind}", "shape": [B, Sq, Sk, H, KV, dh],
            "causal": causal, "dtype": dtype,
            "max_abs": float((got.float() - plain.float()).abs().max()),
            "rel": _row_err(got, plain), "tol": FLASH_TOL[dtype],
        }
        bad = row["rel"] > row["tol"]
        if exact is not None:
            row["rel_vs_f32"] = _row_err(got, exact)
            bad |= row["rel_vs_f32"] > FLASH_TOL_VS_F32
        if causal and Sq > Sk:
            blind = got[:, : Sq - Sk]
            mean_v = v.float().mean(1).repeat_interleave(H // KV, dim=1)[:, None].expand(blind.shape)
            row["rel_mean_v"] = _row_err(blind, mean_v)
            bad |= row["rel_mean_v"] > FLASH_TOL[dtype]
        log(f"[8b] {tag} B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} dh={dh} "
            f"{'causal' if causal else 'non-causal'} {dtype}, {kind}: max |d| {row['max_abs']:.3e}, "
            f"|d| / max|plain row| {row['rel']:.3e} (limit {row['tol']:.3e})"
            + (f", vs plain in float32 {row['rel_vs_f32']:.3e} (limit {FLASH_TOL_VS_F32:.3e})"
               if "rel_vs_f32" in row else "")
            + (f", blind rows vs mean of V {row['rel_mean_v']:.3e}" if "rel_mean_v" in row else ""))
        if bad:
            raise AssertionError(f"[8b] flash attention disagrees with its plain version: {row}")
        rows.append(row)
    return rows


def _timed(fn):
    """(result, host seconds) of ``fn()``, ending in a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def prefill_against_plain(tag, cfg, params, tokens):
    """Phases 8c and 8h-c: ``make_serve_steps`` prefill of ``tokens``
    through the Hopper kernel (one ``flash_attention_wgmma`` launch per
    layer, no other kernel of the port) and through the plain blocked scan
    (``flash_vjp=False``) on the same weights: where the top-2 margin
    exceeds twice the logits' gap the greedy tokens agree, each layer's K/V
    caches are within ``PATH_TOL`` in relative Frobenius norm and layer 0's
    are identical.  Returns (report, the kernel's launches)."""
    B, S = tokens.shape
    prefill, _ = make_serve_steps(cfg, build(cfg))
    batch = {"tokens": tokens}
    prefill(params, batch)  # warm-up: cuBLAS handles, the caching allocator
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    (logits, caches), wall = _timed(lambda: prefill(params, batch))
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if (launches["flash_attention_wgmma"] != cfg.n_layers
            or any(launches[k] for k in ALLOCATOR_KERNELS + FLASH_KERNELS[1:])):
        raise AssertionError(
            f"[{tag}] prefill launched {launches}, not {cfg.n_layers} flash_attention_wgmma")
    if logits.shape != (B, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[{tag}] prefill logits {tuple(logits.shape)}, finite {torch.isfinite(logits).all()}")
    plain_cfg = dataclasses.replace(cfg, flash_vjp=False)
    plain_prefill, _ = make_serve_steps(plain_cfg, build(plain_cfg))
    kernels.reset_launch_counts()
    (logits_p, caches_p), wall_p = _timed(lambda: plain_prefill(params, batch))
    if any(kernels.launch_counts()[k] for k in FLASH_KERNELS):
        raise AssertionError(f"[{tag}] the plain blocked prefill launched a flash kernel")
    gap = float((logits - logits_p).abs().max())
    top = logits[:, 0].topk(2, dim=-1).values
    same_top1 = logits.argmax(-1) == logits_p.argmax(-1)
    # where the top-2 margin exceeds twice the gap, the greedy token must agree
    decided = (top[:, 0] - top[:, 1]) > 2 * gap
    if not bool(same_top1[:, 0][decided].all()):
        raise AssertionError(f"[{tag}] greedy tokens differ where the margin exceeds 2x the gap {gap:.3e}")
    cache_rel, cache_gap = [], 0.0
    for layer, (c, cp) in enumerate(zip(caches, caches_p)):
        for name_, a, b in (("k", c.k, cp.k), ("v", c.v, cp.v)):
            if layer == 0 and not torch.equal(a, b):
                raise AssertionError(f"[{tag}] layer 0's {name_} cache differs (same input, same projection)")
            rel = float((a.float() - b.float()).norm() / b.float().norm())
            if not rel <= PATH_TOL:
                raise AssertionError(f"[{tag}] layer {layer} {name_} cache: relative |d| {rel:.3e} > {PATH_TOL:.3e}")
            cache_rel.append(rel)
            cache_gap = max(cache_gap, float((a.float() - b.float()).abs().max()))
    report = {
        "arch": cfg.name, "batch": B, "seq": S, "wall_ms": wall * 1e3, "tokens_per_s": B * S / wall,
        "peak_gb": peak, "launches": launches["flash_attention_wgmma"],
        "plain_blocked_wall_ms": wall_p * 1e3, "logit_gap": gap,
        "logit_scale": float(logits.abs().max()), "top1_agree": float(same_top1.float().mean()),
        "top1_decided": int(decided.sum()), "cache_gap": cache_gap,
        "cache_rel_by_layer": cache_rel,  # k, v of layer 0, then of layer 1, ...
        "logit_rel": float((logits - logits_p).norm() / logits_p.norm()),
    }
    log(f"[{tag}] {cfg.name} prefill B={B} S={S}: {wall * 1e3:.1f} ms "
        f"({B * S / wall:,.0f} tokens/s), {launches['flash_attention_wgmma']} "
        f"flash_attention_wgmma launches (no other flash kernel), peak device memory {peak:.2f} GB; plain blocked scan {wall_p * 1e3:.1f} ms; "
        f"last-position logits gap {gap:.3e} (scale {report['logit_scale']:.2f}), top-1 "
        f"agreement {int(same_top1.sum())}/{B} ({int(decided.sum())} decided by the margin); "
        f"KV caches: layer 0 identical, relative |d| per layer at most {max(cache_rel):.3e} "
        f"(limit {PATH_TOL:.3e}; layer {cfg.n_layers - 1}: k {cache_rel[-2]:.3e}, v "
        f"{cache_rel[-1]:.3e}), largest elementwise |d| {cache_gap:.3e}")
    return report, launches["flash_attention_wgmma"]


def serving_phase(cuda, smi, profile: bool = False):
    """Phase 8: the data plane's serving path on qwen3-4b at full width.
    Returns (the ``kernels`` line's flash-attention entries, report).  With
    ``profile``, also a torch.profiler breakdown of one prefill and of one
    decode step of the launcher's batch."""
    report: dict = {}
    cfg = get_arch(SERVE_ARCH)
    api = build(cfg)
    prefill, _ = make_serve_steps(cfg, api)

    # (a) the model, from a seeded generator on the card
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_s = _timed(lambda: api.init(torch.Generator(device=cuda).manual_seed(0), cuda))
    n_params = sum(p.numel() for p in params.parameters())
    report["model"] = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "params": n_params,
        "init_s": init_s, "peak_gb_after_build": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(f"[8a] {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads (kv {cfg.n_kv}) of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}: {n_params:,} parameters ({4 * n_params / 1e9:.2f} GB float32), built in "
        f"{init_s:.2f} s; peak device memory {report['model']['peak_gb_after_build']:.2f} GB")

    # (b) the kernel vs its plain version: layer 0's q/k/v of the prompt, edges
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (SERVE_B, SERVE_S)), device=cuda
    )
    layer0 = params["layers"][0]
    h = rms_norm(params["tok_embed"][tokens].to(cfg.compute_dtype), layer0["ln1"], cfg.norm_eps)
    positions = torch.arange(SERVE_S, device=cuda).expand(SERVE_B, SERVE_S)
    q, k, v = attention._project_qkv(layer0["attn"], cfg, h, positions)
    del h
    if fk.variant(q, k, v) != "wgmma":
        raise AssertionError("[8b] the serving shape's q/k/v do not go to the Hopper kernel")
    rows = check_flash("serving shape", q, k, v, True)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for B, Sq, Sk, H, KV, dh, causal, dtype in FLASH_EDGES:
        qe, ke, ve = (
            torch.randn(B, S, n, dh, generator=gen, device=cuda).to(dtype)
            for S, n in ((Sq, H), (Sk, KV), (Sk, KV))
        )
        rows += check_flash("edge", qe, ke, ve, causal)
    # q, k and v as views of one packed [B, S, H + 2 KV, dh] projection, at
    # qwen3-4b's and stablelm-12b's head dims
    B, S, H, KV = 2, 1_000, 32, 8
    for dh in (128, 160):
        packed = torch.randn(B, S, H + 2 * KV, dh, generator=gen, device=cuda).bfloat16()
        qe, ke, ve = packed[:, :, :H], packed[:, :, H : H + KV], packed[:, :, H + KV :]
        rows += check_flash("packed qkv views", qe, ke, ve, True)
    del qe, ke, ve, packed
    # the float32 kernel's largest |d| over its shapes (the serving shape is bf16)
    f32_err = max(r["max_abs"] for r in rows if r["kernel"] == "flash_attention_f32")

    # (c) the prefill of the serving prompt, through the kernel and through
    # the plain blocked scan (flash_vjp=False), on the same weights
    report["prefill"], launches = prefill_against_plain("8c", cfg, params, tokens)
    if profile:
        batch = {"tokens": tokens}
        report["profile_prefill"] = profiled(f"one prefill B={SERVE_B} S={SERVE_S}",
                                             lambda: prefill(params, batch))
        step_caches = api.init_decode_cache(SERVE_B, 48, cuda)
        step_tokens = tokens[:, :1]
        report["profile_decode"] = profiled(f"one decode step B={SERVE_B}",
                                            lambda: api.decode_step(params, step_caches, step_tokens, 0))
        del step_caches
    del params

    # (d) reduced, float32: the card (kernel) against the CPU (plain version)
    small = get_arch(SERVE_ARCH).reduced()
    sapi = build(small)
    sparams = sapi.init(torch.Generator().manual_seed(0), "cpu")
    stoks = torch.as_tensor(np.random.default_rng(1).integers(0, small.vocab, (2, 192)))
    cpu_logits, cpu_caches = sapi.prefill(sparams, stoks)
    sparams.to(cuda)
    kernels.reset_launch_counts()
    card_logits, card_caches = sapi.prefill(sparams, stoks.to(cuda))
    small_counts = kernels.launch_counts()
    small_launches = small_counts["flash_attention_f32"]
    small_gap = max(
        [float((card_logits.cpu() - cpu_logits).abs().max())]
        + [float((c.cpu() - r).abs().max()) for cc, rc in zip(card_caches, cpu_caches)
           for c, r in zip(cc, rc)]
    )
    if (small_launches != small.n_layers or any(small_counts[k] for k in FLASH_KERNELS[:2])
            or not small_gap <= CARD_CPU_TOL):
        raise AssertionError(f"[8d] card vs CPU {small_gap:.3e} (limit {CARD_CPU_TOL}), "
                             f"launches {small_counts}")
    report["card_vs_cpu"] = {"arch": small.name, "seq": 192, "max_abs": small_gap,
                             "logit_scale": float(cpu_logits.abs().max()), "launches": small_launches}
    log(f"[8d] {small.name} float32, S=192 > attn_chunk {small.attn_chunk}: card "
        f"(flash_attention_f32, {small_launches} launches) vs CPU (plain) logits and caches max |d| "
        f"{small_gap:.3e} (limit {CARD_CPU_TOL}; logits scale "
        f"{report['card_vs_cpu']['logit_scale']:.2f})")
    # the same in bf16 compute: head_dim 32 goes to the Hopper kernel (its
    # 64-byte swizzle path); held to the card's plain blocked scan
    # (flash_vjp=False) as 8c is
    bsmall = dataclasses.replace(small, compute_dtype=torch.bfloat16)
    kernels.reset_launch_counts()
    b_logits, _ = build(bsmall).prefill(sparams, stoks.to(cuda))
    b_counts = kernels.launch_counts()
    b_launches = b_counts["flash_attention_wgmma"]
    kernels.reset_launch_counts()
    bp_logits, _ = build(dataclasses.replace(bsmall, flash_vjp=False)).prefill(sparams, stoks.to(cuda))
    b_rel = float((b_logits.float() - bp_logits.float()).norm() / bp_logits.float().norm())
    if (b_launches != small.n_layers or any(b_counts[k] for k in FLASH_KERNELS[1:])
            or any(kernels.launch_counts()[k] for k in FLASH_KERNELS) or not b_rel <= PATH_TOL):
        raise AssertionError(f"[8d] bf16: kernel vs plain blocked scan relative |d| {b_rel:.3e} "
                             f"(limit {PATH_TOL:.3e}), launches {b_counts}")
    report["reduced_bf16"] = {"arch": small.name, "seq": 192, "logit_rel": b_rel,
                              "launches": b_launches}
    log(f"[8d] {small.name} bf16 compute: prefill through flash_attention_wgmma ({b_launches} "
        f"launches, head_dim {small.head_dim}) vs the plain blocked scan on the card, logits "
        f"relative |d| {b_rel:.3e} (limit {PATH_TOL:.3e})")
    del sparams

    # (e) token-by-token decode against the prefill (through the kernel), on
    # one set of weights in float32 and in bf16 compute
    dcfg = dataclasses.replace(cfg, n_layers=DECODE_LAYERS)
    dparams = build(dcfg).init(torch.Generator(device=cuda).manual_seed(2), cuda)
    dtoks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (1, DECODE_S)), device=cuda)
    report["decode_vs_prefill"] = []
    for compute in (torch.float32, torch.bfloat16):
        dapi = build(dataclasses.replace(dcfg, compute_dtype=compute))
        kernels.reset_launch_counts()
        full, _ = dapi.prefill(dparams, dtoks)
        kind = "flash_attention_f32" if compute == torch.float32 else "flash_attention_wgmma"
        if (kernels.launch_counts()[kind] != DECODE_LAYERS
                or sum(kernels.launch_counts()[k] for k in FLASH_KERNELS) != DECODE_LAYERS):
            raise AssertionError(f"[8e] the prefill launched {kernels.launch_counts()}")
        dcaches = dapi.init_decode_cache(1, DECODE_S, cuda)

        def decode_all():
            out = None
            for i in range(DECODE_S):
                out, _ = dapi.decode_step(dparams, dcaches, dtoks[:, i : i + 1], i)
            return out

        last, dwall = _timed(decode_all)
        d = (last - full).abs()
        row = {
            "compute": str(compute).split(".")[-1], "n_layers": DECODE_LAYERS, "seq": DECODE_S,
            "max_abs": float(d.max()), "rel": float((last - full).norm() / full.norm()),
            "outside_ref_bar": float((d > SERVE_TOL + SERVE_TOL * full.abs()).float().mean()),
            "logit_scale": float(full.abs().max()), "decode_ms_per_token": dwall * 1e3 / DECODE_S,
        }
        report["decode_vs_prefill"].append(row)
        log(f"[8e] {DECODE_LAYERS} layers at full width, {row['compute']} compute, one request of "
            f"{DECODE_S} tokens: decode token by token ({row['decode_ms_per_token']:.2f} ms/token) vs "
            f"prefill, last-position logits max |d| {row['max_abs']:.3e} (scale "
            f"{row['logit_scale']:.2f}), relative |d| {row['rel']:.3e}, outside rtol = atol = "
            f"{SERVE_TOL}: {row['outside_ref_bar']:.2%}")
        if compute == torch.float32:
            torch.testing.assert_close(last, full, rtol=SERVE_TOL, atol=SERVE_TOL,
                                       msg=lambda m: f"[8e] float32 decode vs prefill: {m}")
        elif not row["rel"] <= PATH_TOL:
            raise AssertionError(f"[8e] bf16 decode vs prefill: relative |d| {row['rel']:.3e} > {PATH_TOL:.3e}")
        del dcaches
    del dparams

    # (f) the launcher, with the reference's defaults and a 450 W cap, twice
    argv = ["--requests", "4", "--prompt-len", "32", "--gen", "16", "--cap", "450"]
    runs = []
    for _ in range(2):
        torch.cuda.empty_cache()
        r = serve.run(serve.parse_args(argv))
        runs.append({"tokens": r.tokens.tolist(), "prefill_ms": r.prefill_ms,
                     "decode_ms_per_token": r.decode_ms_per_token, "tok_s": r.tok_s,
                     "cap_multiplier": r.cap_multiplier})
        log(f"[8f] {r.arch} on {r.device}: prefill {r.prefill_ms:.1f} ms, decode "
            f"{r.decode_ms_per_token:.2f} ms/token, {r.tok_s:.1f} tok/s; capped at 450 W -> "
            f"x{r.cap_multiplier:.2f} step time -> {r.tok_s / r.cap_multiplier:.1f} tok/s")
        log(f"[8f]   on {smi}")
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError("[8f] two launcher runs gave other greedy tokens")
    report["launcher"] = {"argv": argv, "runs": runs}
    log(f"[8f] both runs: the same {len(runs[0]['tokens'])} x {len(runs[0]['tokens'][0])} greedy tokens")

    # (h) stablelm-12b at full width: head dim 160 on the Hopper kernel
    big = stablelm_phase(cuda, profile)
    report["stablelm"] = big["report"]
    rows += big["rows"]
    report["flash_checks"] = rows

    # (g) the kernels' times: both bf16 kernels at the two serving shapes
    # (qwen3-4b's dh 128, stablelm-12b's dh 160), the float32 kernel at 8e's
    # float32 prefill shape
    source = {
        "flash_attention_wgmma": "src/repro_torch/kernels/csrc/flash_attention_hopper.cu",
        "flash_attention_mma": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "flash_attention_f32": "src/repro_torch/kernels/csrc/flash_attention.cu",
    }
    # launches on each kernel's own path: the serving prefills (8c, 8h-c)
    # and the reduced float32 prefill (8d); no main-path input reaches the
    # mma.sync kernel since every bf16 head dim has the Hopper kernel
    path_launches = {
        "flash_attention_wgmma": (
            launches + big["launches"],
            f"8c qwen3-4b prefill {launches} + 8h-c stablelm-12b prefill {big['launches']}"),
        "flash_attention_mma": (
            0, "no main-path input: it takes only bf16 inputs no tensor map can read (a strided "
               "head dim, strides or base not in 16-byte steps, heads outside sequence); 8b runs "
               "it through its private entry beside the Hopper kernel"),
        "flash_attention_f32": (small_launches, "8d reduced prefill, float32"),
    }
    # the bf16 kernels' largest |d| over both serving shapes (8b, 8h-b)
    serving_err = {
        name_: max(r["max_abs"] for r in rows if r["kernel"] == name_
                   and r["tag"] in ("serving shape", f"{STABLELM_ARCH} serving shape"))
        for name_ in FLASH_KERNELS[:2]
    }
    max_err = {**serving_err, "flash_attention_f32": f32_err}
    entries, report["timing"] = [], {}

    def attention_bound(q_, k_, dtype):
        B_, Sq_, H_, dh_ = q_.shape
        flops = 4 * B_ * H_ * dh_ * Sq_ * (Sq_ + 1) / 2  # QK^T and PV over the causal triangle
        nbytes = q_.element_size() * (2 * q_.numel() + 2 * k_.numel())
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S
        return flops, nbytes, max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    def entry(name_, ms, plain_ms, lib_ms, paced_ms, plain_paced_ms, bound_ms, bound_by, **extra):
        n_launch, where = path_launches[name_]
        return {
            "name": name_, "route": "cuda", "source": source[name_],
            "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
            "launches": n_launch, "launches_path": where, "max_abs_err": max_err[name_],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "paced_ms": paced_ms, "plain_paced_ms": plain_paced_ms, **extra,
        }

    def sdpa_of(q_, k_, v_):
        qt, kt, vt = (x.transpose(1, 2) for x in (q_, k_, v_))
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True
        )

    def time_bf16(tag, q_, k_, v_):
        """plain, Hopper, mma.sync, Hopper, mma.sync, plain (the later of each
        pair is kept) and SDPA at one bf16 serving shape; the Hopper kernel
        must beat the mma.sync kernel"""
        (B_, Sq_, H_, dh_), KV_ = q_.shape, k_.shape[2]
        flops, nbytes, bound_ms, bound_by = attention_bound(q_, k_, "bfloat16")
        sdpa = sdpa_of(q_, k_, v_)
        # the yardstick computes the same function: both within 2^-7 of float32
        sdpa_err = _row_err(sdpa().transpose(1, 2), fk.flash_attention(q_, k_, v_))
        if not sdpa_err <= 2 * FLASH_TOL_VS_F32:
            raise AssertionError(f"[8g] scaled_dot_product_attention disagrees with the kernel: {sdpa_err:.3e}")
        calls = {
            "plain": lambda: attention_ref(q_, k_, v_),
            "flash_attention_wgmma": lambda: fk.flash_attention(q_, k_, v_),
            "flash_attention_mma": lambda: fk._flash_attention_mma(q_, k_, v_),
        }
        times = {}
        for name_ in ("plain", "flash_attention_wgmma", "flash_attention_mma",
                      "flash_attention_wgmma", "flash_attention_mma", "plain"):
            times[name_] = time_calls(calls[name_])
        lib_ms = time_calls(sdpa)[0]
        log(f"[8g] {tag}: B={B_} Sq=Sk={Sq_} H={H_} KV={KV_} dh={dh_} bf16 causal on {smi}: plain "
            f"{times['plain'][0]:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {flops:.3e} flops, {nbytes / 1e6:.1f} MB)")
        for name_ in ("flash_attention_wgmma", "flash_attention_mma"):
            ms = times[name_][0]
            log(f"[8g]   {name_}: {ms:.4f} ms per call ({flops / ms / 1e9:.1f} TFLOP/s useful), "
                f"/ SDPA {ms / lib_ms:.2f}, / bound {ms / bound_ms:.2f}; on {smi}")
        if not times["flash_attention_wgmma"][0] < times["flash_attention_mma"][0]:
            raise AssertionError(f"[8g] {tag}: the Hopper kernel is not faster than the mma.sync kernel")
        return {"shape": tag, "B": B_, "Sq": Sq_, "H": H_, "KV": KV_, "dh": dh_, "flops": flops,
                "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by, "sdpa_ms": lib_ms,
                "sdpa_rel_err": sdpa_err, "ms": {k_: t[0] for k_, t in times.items()},
                "paced_ms": {k_: t[1] for k_, t in times.items()}}

    shapes = [time_bf16(f"{SERVE_ARCH} serving shape", q, k, v),
              time_bf16(f"{STABLELM_ARCH} serving shape", *big["qkv"])]
    report["timing"]["serving"] = shapes[0]
    report["timing"]["stablelm"] = shapes[1]
    del big
    for name_ in ("flash_attention_wgmma", "flash_attention_mma"):
        # the qwen3-4b shape's numbers at the top level, each shape's in by_shape
        t = shapes[0]
        entries.append(entry(
            name_, t["ms"][name_], t["ms"]["plain"], t["sdpa_ms"], t["paced_ms"][name_],
            t["paced_ms"]["plain"], t["bound_ms"], t["bound_by"],
            by_shape=[{"shape": sh["shape"], "dh": sh["dh"], "ms": sh["ms"][name_],
                       "plain_ms": sh["ms"]["plain"], "bound_ms": sh["bound_ms"],
                       "bound_by": sh["bound_by"], "library_ms": sh["sdpa_ms"],
                       "tflops": sh["flops"] / sh["ms"][name_] / 1e9} for sh in shapes],
        ))

    (B, Sq, H, dh), KV = q.shape, k.shape[2]
    gen = torch.Generator(device=cuda).manual_seed(3)
    q32, k32, v32 = (
        torch.randn(1, DECODE_S, n, dh, generator=gen, device=cuda) for n in (H, KV, KV)
    )
    flops, nbytes, bound_ms, bound_by = attention_bound(q32, k32, "float32")
    # plain, kernel, kernel, plain
    time_calls(lambda: attention_ref(q32, k32, v32))
    time_calls(lambda: fk.flash_attention(q32, k32, v32))
    ms, paced = time_calls(lambda: fk.flash_attention(q32, k32, v32))
    plain_ms, plain_paced = time_calls(lambda: attention_ref(q32, k32, v32))
    lib_ms = time_calls(sdpa_of(q32, k32, v32))[0]
    log(f"[8g] B=1 Sq=Sk={DECODE_S} H={H} KV={KV} dh={dh} float32 causal on {smi}: "
        f"flash_attention_f32 {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {lib_ms:.4f} ms (kernel / SDPA {ms / lib_ms:.2f}), bound "
        f"{bound_ms:.4f} ms ({bound_by}, float32 outside the tensor cores)")
    entries.append(entry("flash_attention_f32", ms, plain_ms, lib_ms, paced, plain_paced,
                         bound_ms, bound_by))
    report["timing"]["float32"] = {"flops": flops, "bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
                                   "sdpa_ms": lib_ms}
    return entries, report


def stablelm_phase(cuda, profile: bool = False) -> dict:
    """Phase 8h: stablelm-12b (40 layers, d_model 5,120, 32 heads / 8 KV of
    160, d_ff 13,824, vocab 100,352) at full width, weights from a seeded
    generator on the card: (a) the build, its time and peak memory; (b)
    layer 0's q/k/v of a 4 x 2,048-token prompt go to the Hopper kernel and
    are held to the plain version (``check_flash``); (c) the prefill through
    the kernel (40 ``flash_attention_wgmma`` launches, nothing else of the
    port) against the plain blocked scan, at 8c's bars; with ``profile``, a
    torch.profiler breakdown of one prefill.  Returns the report, the 8b
    rows, the prefill's launches and (b)'s q/k/v for 8g's timing."""
    cfg = get_arch(STABLELM_ARCH)
    api = build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_s = _timed(lambda: api.init(torch.Generator(device=cuda).manual_seed(0), cuda))
    n_params = sum(p.numel() for p in params.parameters())
    report = {"model": {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "head_dim": cfg.head_dim,
        "params": n_params, "init_s": init_s,
        "peak_gb_after_build": torch.cuda.max_memory_allocated() / 1e9,
    }}
    log(f"[8h-a] {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads (kv {cfg.n_kv}) of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}: {n_params:,} parameters ({4 * n_params / 1e9:.2f} GB float32), built in "
        f"{init_s:.2f} s; peak device memory {report['model']['peak_gb_after_build']:.2f} GB")

    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (SERVE_B, SERVE_S)), device=cuda
    )
    layer0 = params["layers"][0]
    h = rms_norm(params["tok_embed"][tokens].to(cfg.compute_dtype), layer0["ln1"], cfg.norm_eps)
    positions = torch.arange(SERVE_S, device=cuda).expand(SERVE_B, SERVE_S)
    q, k, v = attention._project_qkv(layer0["attn"], cfg, h, positions)
    del h
    if fk.variant(q, k, v) != "wgmma":
        raise AssertionError(f"[8h-b] {cfg.name}'s q/k/v (head dim {cfg.head_dim}) do not go to the Hopper kernel")
    rows = check_flash(f"{cfg.name} serving shape", q, k, v, True)

    torch.cuda.reset_peak_memory_stats()
    report["prefill"], launches = prefill_against_plain("8h-c", cfg, params, tokens)
    report["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[8h] peak device memory over the kernel's and the plain blocked scan's prefills "
        f"{report['peak_gb']:.2f} GB")
    if profile:
        prefill, _ = make_serve_steps(cfg, api)
        report["profile_prefill"] = profiled(f"one {cfg.name} prefill B={SERVE_B} S={SERVE_S}",
                                             lambda: prefill(params, {"tokens": tokens}))
    del params
    torch.cuda.empty_cache()
    return {"report": report, "rows": rows, "launches": launches, "qkv": (q, k, v)}


def profiled(tag: str, step) -> dict:
    """Device busy time, launches and the top kernels of ``step()`` (which
    ends in a sync), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a control step's PDHG iterations, over all its solves
    stats = getattr(out, "stats", None)
    iterations = sum(stats["phase_iterations"]) if stats is not None else None
    del out
    calls = {k: v for k, v in kernels.launch_counts().items() if v}

    def dev_us(e):
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(dev_us(e) for e in events)
    launches = sum(e.count for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:12]
    rows = [{"name": e.key, "calls": e.count, "device_us": dev_us(e)} for e in top]
    log(f"[profile] {tag}: wall {wall_us:.0f} us, device busy {device_us:.0f} us "
        f"({100.0 * device_us / wall_us:.1f}%), {launches} device launches"
        + (f" ({launches / iterations:.2f} per PDHG iteration over {iterations})"
           if iterations else "")
        + f"; the port's kernels' calls {calls}")
    for r in rows:
        log(f"[profile]   {r['device_us']:9.0f} us  {r['calls']:6d}x  {r['name'][:70]}")
    return {"wall_us": wall_us, "device_us": device_us, "launches": launches,
            "pdhg_iterations": iterations, "kernel_calls": calls, "top": rows}


def profile_step(pdn, kernel_opts) -> dict:
    """One warm control step of the host driver on the paper fleet."""
    sim = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0))
    priority = np.random.default_rng(0).integers(1, 4, pdn.n)
    topo = FleetTopology.from_pdn(pdn, device="cuda")
    opts = NvpaxOptions(solver=kernel_opts)
    warm = optimize(AllocProblem.build(pdn, sim.power(0), priority=priority, topology=topo),
                    opts).warm_state
    ap = AllocProblem.build(pdn, sim.power(1), priority=priority, topology=topo)
    return profiled("one warm phase-4 step", lambda: optimize(ap, opts, warm))


def profile_tenant_step(pdn, layout, solver_opts) -> dict:
    """One cold PowerController step on the Appendix B tenant fleet."""
    ctl = PowerController(
        pdn, sla=layout.sla_topo(device="cuda"), priority=layout.priority,
        config=ControllerConfig(options=NvpaxOptions(solver=solver_opts)), device="cuda",
    )
    tele = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0)).power(0)
    ctl.step(tele)  # builds the engine
    ctl.reset_warm()
    return profiled("one cold tenant step", lambda: ctl.step(tele))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
