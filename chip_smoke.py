#!/usr/bin/env python3
"""Drive the PyTorch port of nvPAX on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py                 # exits non-zero on any failure
    python3 chip_smoke.py --profile       # also profiles a warm control step, a cold tenant step,
                                          # a qwen3-4b prefill and decode step, a
                                          # stablelm-12b prefill and a qwen3-4b training
                                          # step (launches per step and, for the control
                                          # steps, per PDHG iteration)
    python3 chip_smoke.py --warm-tenants  # also one warm-carried tenant step
    python3 chip_smoke.py --out DIR       # where the details go
    python3 chip_smoke.py --stats-digest  # only phases 1-2 and phase 3's digest of the chunk
                                          # statistics (a copy of this file placed in an
                                          # older checkout runs it on that checkout's kernels)

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
   (several seeds at n = 1, 31, 32 and the paper's n), the dual ones also
   as the solver's pair of vectors in one call (``dual_chunk_stats_pair``,
   each vector's bits those of the single-vector call), and all of a KKT
   check's in one call (``check_chunk_stats``: the primal block, both dual
   blocks and the t and tenant accumulators, with the bits of the primal
   call, the pair and torch's two adds, the ticket counters back at zero),
   with a digest of their bits at fixed seeds, the same through the
   separate calls, the pair and the one call (``--stats-digest`` prints it
   alone, so that an older checkout's kernels can be compared); the fused dual step
   (``dual_update``), scaled adjoint (``scaled_rmatvec``) and primal step
   (``primal_step``: that adjoint with the primal update as its epilogue)
   against the launches they replace, bit for bit, at the paper's shapes
   with and without tenants, with scalar step sizes and with every column
   pinned, and at edge sizes (``dual_update`` also against its CPU plain
   version); ``tree_matvec``, ``sla_matvec``, the three fused kernels, the
   chunk-stats pair, the primal chunk statistics and the one-launch check
   statistics each one kernel on the card per call (torch.profiler);
4. the main path: five warm-started control steps of
   ``repro_torch.core.nvpax.optimize`` on ``build_datacenter()`` with
   telemetry requests, through the kernels
   (``SolverOptions(use_pallas=True, use_pallas_tree=True)``), each checked
   for feasibility and KKT certification and against the port's own CPU
   run of the same steps; the PDHG loop launches one ``primal_step`` and
   one ``dual_update`` per iteration and no standalone ``scaled_rmatvec``,
   ``primal_update`` or ``dual_prox``, and ``tree_rmatvec`` and
   ``sla_rmatvec`` only outside it;
5. the paper's iterated max-min LP path (``use_waterfill=False``) on a
   1,536-device fleet, with the same checks;
6. each kernel's time on the card (CUDA events; see :func:`time_calls`)
   beside its plain version's, its bound and, for the tree and tenant
   pairs and the scaled adjoint, a CSR sparse matrix-vector product on the
   same incidence; the fused primal step beside the three launches it
   replaces, the dual chunk-stats pair beside two single-vector calls, the
   one-launch check statistics beside the separate launches it replaces; the
   per-launch floor (``dual_prox`` on one row), ``tree_matvec``'s two paths
   at their boundary, and ``torch.cumsum`` at the paper's n beside the
   bound of the scan inside ``tree_matvec``;
7. the serving path on a tenant fleet: ``PowerController.step`` on the
   paper's fleet with the Appendix B tenants (100 x 100 devices), every
   kernel flag on, three cold steps, each checked for certification,
   breaker caps, tenant contracts, and Phase I and useful power against the
   port's CPU run (the caps' distance from it is measured and reported, see
   :func:`tenant_engine_phase`), and the PDHG loop's launches held as in
   phase 4, with one statistics launch per KKT check (``check_chunk_stats``)
   and no standalone primal or dual chunk statistics; then a
   repeated step (identical bits) and a supply re-pin (no rebuild).
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
   float32 prefill shape;
9. certify-first incremental stepping, see :func:`incremental_phase`:
   (a) two ``AllocEngine`` on the paper fleet at KKT tolerance 1e-9, one
   with ``incremental=True``, over 25 steps of telemetry refreshed every 5
   (``TelemetrySim`` seed 0, samples 0-4) with a brownout (root cap x 0.9)
   at step 12: per step within max(1e-6 W, 5 x the always-full engine's
   own drift on held steps) of each other, a held step equal to its anchor,
   at least 60% skips, every breaker kept, no rebuild; each skipped step
   launches only the certify pass's two ``tree_matvec`` and the repair's
   ``tree_rmatvec`` per tree depth (no PDHG kernel),
   one skipped step is profiled, and the median walls of skipped and
   solved steps are printed; (b) an incremental ``PowerController`` on the
   Appendix B tenant fleet: sample 0 cold, sample 0 again (a full skip whose
   certify pass launches ``sla_matvec`` too, contracts and breakers kept),
   then ``reset_warm()`` and sample 1 solved cold with phase 7's
   iterations;
10. the paper's trace experiment, see :func:`simulation_phase`:
   ``DatacenterSim`` on the paper fleet (``TelemetrySim`` seed 0) with the
   Static and Greedy baselines for 60 control intervals through every
   kernel flag, the first 4 against the port's CPU run (allocations and
   the three satisfaction ratios), S_nvpax >= S_static and every breaker
   on every step; the means of the ratios and the straggler tax, and the
   wall per interval.

11. the K-scenario path (one solve for K scenarios, each kernel launch over
   the K lanes), see :func:`batched_phase`: (a) ``PowerController.what_if``
   on the paper fleet with 8 ``TelemetrySim`` samples and every kernel flag,
   each lane against the card's own cold one-scenario step (equal
   iterations per phase, 1e-9 W, feasible, certified) and lanes 0-1 against
   the port's CPU run; (b) the Appendix B tenant fleet, 4 cold lanes, each
   held to phase 7's bars against its one-scenario step; (c) the
   incremental engine's ``step_batched`` on 8 lanes: an identical batch
   skips every lane, one dirty lane re-solves alone; (d) the wall of (a)
   against 8 one-scenario steps, launches per batched step and per PDHG
   iteration against the one-scenario step's (at most 1.25x), the card's
   busy share, ``calibrate_phase_cost`` and a ``deadline_s`` truncation on
   the card.  Phase 3 also holds every allocator kernel's lane axis at the
   paper's shapes for K in 1, 2, 8 and 33: one launch per call, each lane
   the bits of a launch on that lane alone, the ticket counters back at
   zero.
12. the multi-domain fleet, see :func:`fleet_phase`: (a) the tree and
   tenant kernels over an index of 4 hall topologies of the paper fleet
   (hall 3 rebuilt to 20 racks, Appendix B's tenants split at the cut),
   each lane the bits of a one-lane launch on its own index, each kernel
   held to its plain version on the same ``[K, ...]`` topology, with their
   device times at K = 4 and K = 1; (b) ``FleetOrchestrator(build_datacenter(),
   level=1)`` stacked with every kernel flag for 5 steps against loop mode
   on the card and the port's CPU run (1e-9 W, equal iterations), every
   row of the datacenter kept, its walls, launches per PDHG iteration and
   busy share beside the monolithic engine's; (c) the reference's subtree
   parity case at paper size (1e-6 W); (d) churn with one rebuild within
   the padding (``rebuild_count()`` moves only there); (e) ``DatacenterSim``
   in fleet mode for 4 intervals, with prefetch (the same S values), and
   the cross-tenant scenario, also through every kernel flag against the
   CPU run at the quality level; (f) one cold stacked step of the paper's
   datacenter with Appendix B's tenants split at the cut (its launches are
   the kernels line's ``launches_tenant_fleet``), its wall and
   ``primal_step``'s share of the device time; no hall's grant left
   unallocated past 250 W, and every hall's lane the bits and iterations
   of its one-lane solve; the same cold step with the kernel flags off
   (the default options) is reported beside it.
13. the flight recorder, see :func:`recorder_phase`: (a) an incremental
   ``AllocEngine(build_datacenter(), recorder=True)`` over 10 steps of held
   telemetry, every row against the host oracle and the first 3 against
   the CPU, and a cold Appendix B step's SLA margin through
   ``PowerController(recorder=True)`` (the kernels line's
   ``launches_recorder``); (b) the recorder's own cost over a warm step
   (bar 1.05x) and a held step, and whole recorded over unrecorded walls
   (reported); (c) no added device-to-host copy or synchronization, one
   added host-to-device copy and the same added launches on solved and
   held steps; (d) ``what_if`` lanes, a stacked
   fleet against loop mode, and ``DatacenterSim``'s flight through the
   report CLI; (e) one ``record_step`` replayed in a CUDA graph to the
   eager bits.
14. the sharded fleet dispatch, see :func:`sharded_phase`: (a)
   ``FleetOrchestrator(build_datacenter(), level=1, mode="sharded")`` at
   one NCCL rank with every kernel flag against stacked mode on the card
   (1e-6 W, equal iterations; its launches are the kernels line's
   ``launches_sharded``), one all-reduce and one all-gather a step, the
   walls and a cold step's device launches of both, and the coordinator
   tree's ``tree_matvec`` at K = 4 against its plain version; (b) four gloo
   ranks on the one card, a hall each (this script again with
   ``--shard-rank``; their launches summed are ``launches_sharded_4_ranks``):
   14a's allocations, the same grants on every rank, the recorder's lanes
   gathered only at the flush, and a cold step of (12f)'s tenant fleet held
   to the stacked step at the quality level and to the same step at one
   NCCL rank bit for bit, that stacked step and the one NCCL rank's leaving
   no hall's grant unallocated past 250 W; (c) churn on 14a's fleets
   without a rebuild; (d) the flight recorder, sharded against stacked;
   (e) ``examples/torch_quickstart.py`` and
   ``examples/torch_datacenter_simulation.py --steps 5``.

16. the training path, see :func:`training_phase`: (a) the flash kernels
   asked for the rows' log-sum-exp (``return_lse=True``) at qwen3-4b's
   training shape, head dims 160 and 32, float32, whisper's non-causal
   1,500 frames, a cross shape and rows that see no key: lse against the
   plain version in float32 (1e-5 of max(1, |lse|); those rows at the
   masked -1e30), out the same bits as without lse; the kernel with and
   without lse timed at dh 128 and in float32 beside the plain version
   and the efficient-attention operator that also returns the lse; (b)
   ``models.flash_vjp``'s gradients on the card against autograd through
   the plain blocked scan (float32 2e-5, bf16 2^-5 in relative Frobenius
   norm); (c) every family's reduced config, loss, gradients and three
   AdamW steps on the card against the port's CPU run (2e-5); (d) qwen3-4b
   at its published widths (36 layers, float32 parameters and moments, bf16
   compute, remat, microbatch 4): five ``make_train_step`` steps on 4 x
   2,048 tokens of ``SyntheticLMData``, each finite and launching
   ``flash_attention_wgmma_lse`` 36 x 4 x 2 = 288 times (forward and
   recompute) and no other flash kernel, the median step, tokens per second
   and peak memory (``--profile``: one step's busy share and top device
   operations); (e) ``examples/torch_train_power_managed.py --steps 60``
   (its loss down by more than half the reference example's 0.202) and the
   reference's ``test_loss_decreases`` through the port's train step
   (down by more than 0.5).
   The kernels line takes ``flash_attention_wgmma_lse`` (16d's launches)
   and ``flash_attention_f32_lse`` (16c's).
17. the training launcher, see :func:`launcher_phase`: (a) whisper-tiny's
   full-width train state after one step saved from the card and restored
   onto it (``training.checkpoint``: every leaf the same bits, the keys,
   shapes and dtypes of the port's CPU save), the walls and bytes; (b) the
   restart drill as users run it, each run a fresh process through
   ``launch.train``'s main path: ``--arch whisper-tiny --batch 4 --seq 448
   --steps 6 --ckpt-every 2`` uninterrupted, with ``--fail-at 4`` in a fresh
   directory (exit code 42), then ``--resume`` (steps 4-5 within 1e-5
   relative of the uninterrupted run's, and whether they are its bits);
   a ``--compress-grads`` run of 4 steps (finite), and the reduced config's
   against the port's CPU run (2e-5: whisper-tiny computes in bf16); (c)
   ``launch.train.main`` in process at qwen3-4b's full width, ``--batch 4
   --seq 2048 --steps 3 --lr 3e-4 --power-managed``: each loss finite, 288
   ``flash_attention_wgmma_lse`` launches a step and no other flash kernel,
   the median step, tokens/s, peak memory, the controller's step wall and
   its slowdowns; (d) ``compressed_psum`` of a ``[151,936, 2,560]`` float32
   gradient at one NCCL rank (the bits of the int8 round trip) and on four
   gloo ranks of the one card (this script again with ``--launch-rank``;
   every rank the bits of the CPU oracle), each beside a plain float32
   all-reduce; (e) the GPipe forward (``training.pipeline``) of qwen3-4b's
   36 layers on those four ranks, 9 a rank, 4 microbatches of 1 x 2,048
   hidden states: every rank the bits of the sequential stack on the card.
   The kernels line's ``flash_attention_wgmma_lse`` takes
   ``launches_launcher`` (17b, 17c) and ``flash_attention_wgmma``
   ``launches_pipeline`` (17e).
18. the launcher on a mesh, see :func:`mesh_phase`: (a) 17b's whisper-tiny
   run (``--batch 4 --seq 448``, 4 steps) at ``--mesh 2x2`` on four gloo
   ranks of the one card (``launch.train.run`` from this process, which
   spawns the other three ranks itself, as a user's command does),
   the weights and AdamW moments DTensors on the model's logical spec tree
   (``repro_torch.sharding``), every collective DTensor issues staged through
   host memory (``sharding.hoststaged``); each loss within 1.7e-4 relative
   of 17b's uninterrupted 1x1 run (ten times that run's spread under a
   1-ulp change of its embedding), every rank launching
   ``flash_attention_wgmma_lse`` on its own shard as often as the 1x1 run
   does and no other flash kernel; every rank's shard bytes, the collectives
   of each step by kind and bytes, the step walls against 1x1's; (b) the
   elastic drill: the launcher's 2x2 run (its ranks spawned anew) crashing
   at step 2 after its checkpoint (exit code 42), then ``--mesh 1x1
   --resume`` in this process, its steps within the same bar of 17b's.  The
   kernels line's ``flash_attention_wgmma_lse`` takes ``launches_mesh``
   (18a, in all and per rank).
19. the cost analysis held to the card's own programs, see
   :func:`analysis_phase`: (a) ``repro_torch.analysis.flops.CostCounter``
   on phase 8c's qwen3-4b prefill (4 x 2,048) and on one more step of
   16d's training state, on the card's tensors: FLOPs, bytes, FLOPs by op,
   the flash calls it saw against the kernel's launches (36 a prefill, 288
   a step), each launch's counted FLOPs against row 10's count at its shape,
   the model FLOPs, the roofline on one H100 and the share of the compute
   bound the measured wall reached (``analysis.roofline.
   model_flops_utilization``); (b) the dry run's argument bytes of 16d's
   state and batch against what the card allocated for them, and the
   counted peak of a step's intermediates against the card's
   ``max_memory_allocated`` over that step; (c) ``python -m
   repro_torch.launch.dryrun`` in subprocesses that see no card (started
   with phase 16): whisper-tiny ``decode_32k`` and qwen3-4b ``train_4k`` on
   the 256-rank pod mesh, each an ``OK`` record, the train cell's argument
   bytes within the card's memory.  The kernels line's flash entries take
   ``launches_analysis``.

The line before the last is a JSON object listing every kernel; the last
is ``{"ok": true, "device": {...}}``.  Details (the build log and every
measurement) go to ``DIR/chip_smoke.json``, by default under
``artifacts/chip_smoke/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import gc
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import repro_torch.kernels as kernels  # noqa: E402
from repro_torch.analysis.flops import CostCounter  # noqa: E402
from repro_torch.analysis.roofline import model_flops_utilization, roofline_terms  # noqa: E402
from repro_torch.configs import ShapeSpec, get_arch  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.convert import encdec_params_to_numpy, lm_params_to_numpy  # noqa: E402
from repro_torch.core.batched import (  # noqa: E402
    batch_meta,
    calibrate_phase_cost,
    optimize_batched,
    stack_problems,
)
from repro_torch.core.engine import AllocEngine  # noqa: E402
from repro_torch.core.nvpax import NvpaxOptions, optimize  # noqa: E402
from repro_torch.core.problem import AllocProblem, FleetTopology  # noqa: E402
from repro_torch.core.solver import SolverOptions  # noqa: E402
from repro_torch.core.solver.options import KKT_HIST_BUCKETS  # noqa: E402
from repro_torch.fleet import FleetLifecycle, FleetOrchestrator, split_pdn  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.pdhg_update import kernel as pk  # noqa: E402
from repro_torch.kernels.pdhg_update import ref as pref  # noqa: E402
from repro_torch.kernels.tree_matvec import kernel as tk  # noqa: E402
from repro_torch.kernels.tree_matvec import ref as tref  # noqa: E402
from repro_torch.pdn.hierarchy_gen import homogeneous_fleet  # noqa: E402
from repro_torch.pdn.telemetry import TelemetrySim, TraceConfig  # noqa: E402
from repro_torch.pdn.tenants import appendix_b_layout, assign_cross_domain_tenants  # noqa: E402
from repro_torch.pdn.tree import build_datacenter  # noqa: E402
from repro_torch.launch import dryrun, serve  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import attention, blocks, build, encdec, moe  # noqa: E402
from repro_torch.models.common import rms_norm, sinusoidal_positions  # noqa: E402
from repro_torch.obs import recorder as obs_recorder  # noqa: E402
from repro_torch.obs.export import flight_rows, write_jsonl  # noqa: E402
from repro_torch.power import ControllerConfig, DatacenterSim, PowerController  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models import flash_vjp  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.training.compression import compressed_psum, quantize_dequantize  # noqa: E402
from repro_torch.training.pipeline import pipeline_forward  # noqa: E402
from repro_torch.training.step import (  # noqa: E402
    init_train_state,
    make_serve_steps,
    make_train_step,
)

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
# the fused dual step, scaled adjoint and primal step at edge sizes beside
# the paper's
FUSED_SIZES = (1, 1025, 100_003)
# the digest of the chunk statistics: (n, m, k) of one KKT check's primal
# and improvement rows, tree rows and tenants at fixed seeds, the paper's
# tenant fleet among them
DIGEST_SHAPES = ((12_288, 1_637, 100), (5, 0, 0), (1, 1, 1), (0, 7, 2), (2_162_689, 31, 3))
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
    # the one-launch check statistics: accumulators and maxima exact
    "check_chunk_stats": {"float64": 0.0, "float32": 0.0},
    "check_chunk_stats sums": STATS_TOL,
}
# the serving path on the tenant fleet: telemetry samples of its cold steps
ENGINE_SAMPLES = (0, 1, 2)
SLA_FEAS_TOL = 1e-6  # watts: tenant sums inside [b_min, b_max]
# phase 9: the quasi-static trace of benchmarks/incremental_bench.py (a
# telemetry refresh every INC_HOLD steps) at its KKT tolerance, with a
# brownout; the bench's gate on the skip share; a held step returns its
# anchor's allocation through the exact repair (within SKIP_TOL watts)
INC_STEPS = 25
INC_HOLD = 5
INC_BROWNOUT_STEP = 12
INC_BROWNOUT = 0.9
INC_EPS = 1e-9
INC_MIN_SKIP_SHARE = 0.6
SKIP_TOL = 1e-9
# the kernels a PDHG solve launches and a certified skip must not
PDHG_KERNELS = ("primal_step", "dual_update", "check_chunk_stats", "scaled_rmatvec",
                "primal_update", "dual_prox", "primal_chunk_stats", "dual_chunk_stats")
# phase 10: DatacenterSim control intervals on the card, the first
# SIM_HELD of them also on the CPU; the ratios' bar
SIM_STEPS = 60
SIM_HELD = 4
RATIO_TOL = 1e-9
# torch.profiler traces of one one-kernel-per-call check before a trace
# with fewer kernels than the wrappers launched fails it, and those seen
TRACE_ATTEMPTS = 3
TRACE_RETRIES: list[dict] = []
# phase 3: the lane axis of every allocator kernel, at these lane counts
LANE_COUNTS = (1, 2, 8, 33)
# phase 3's digest of the chunk statistics' bits (PRs 19-20's kernels)
STATS_DIGEST = "94bde1eca9f19d76"
# phase 11: the K-scenario path; what_if lanes on the paper fleet, cold
# tenant lanes, the incremental engine's lanes; the launches per PDHG
# iteration of the K-lane step against the one-scenario step's
WHATIF_K = 8
TENANT_K = 4
LANE_ITER_RATIO = 1.25
# the kernels of the tenant serving path (phase 7); flash attention is
# phase 8's, and dual_prox, scaled_rmatvec, primal_update and the standalone
# chunk statistics stand alone (phases 3 and 6) since the fused dual step,
# primal step and check statistics took their place in the solver
ALLOCATOR_KERNELS = (
    "tree_matvec", "tree_rmatvec", "sla_matvec", "sla_rmatvec", "primal_step",
    "dual_update", "check_chunk_stats",
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


def step_inputs(adjoint, gen, vector_tau=True):
    """The fused primal step's inputs over the scaled adjoint's, drawn from
    ``gen``: (x, y_tree, y_sla, y_imp, tau, PrimalStepData); a third of the
    columns linear (w = 0); the step size a vector or one 0-d tensor."""
    y_tree, y_sla, y_imp, d_tree, d_sla, d_imp, sm, tidx, sidx = adjoint

    def vec():
        return torch.as_tensor(gen.normal(size=tidx.n), dtype=sm.dtype, device=sm.device)

    x, c, target = vec(), vec(), vec()
    w = vec().abs()
    w[::3] = 0
    lo = vec() - 1.0
    hi = lo + vec().abs() + 0.1
    tau = (vec().abs() + 0.05 if vector_tau
           else torch.full((), 0.37, dtype=sm.dtype, device=sm.device))
    return x, y_tree, y_sla, y_imp, tau, tk.PrimalStepData(c, w, target, lo, hi, d_tree, d_sla,
                                                           d_imp, sm, tidx, sidx)


def step_composition(x, y_tree, y_sla, y_imp, tau, data):
    """The three launches the fused primal step replaces: the scaled adjoint
    kernel, the primal update kernel and the column scaling xm = sm * xe."""
    gx, yi = tk.scaled_rmatvec(y_tree, y_sla, y_imp, data.d_tree, data.d_sla, data.d_imp,
                               data.sm, data.tree_idx, data.sla_idx)
    x1, xe = pk.primal_update(x, gx, *data[:5], tau)
    return x1, xe, data.sm * xe, yi


def check_inputs(gen, n: int, m: int, k: int, dtype, device):
    """One KKT check's chunk-statistics inputs drawn from ``gen``: the
    primal (x, px, rx, ax) of n rows, the tree and improvement rows'
    (y, ry, ay) of m and n rows, t and its accumulator (0-d), the k tenant
    duals and their accumulator."""

    def vec(r):
        return torch.as_tensor(gen.normal(size=r) * 100.0, dtype=dtype, device=device)

    primal = tuple(vec(n) for _ in range(4))
    tree = tuple(vec(m) for _ in range(3))
    imp = tuple(vec(n) for _ in range(3))
    t, at = (torch.as_tensor(gen.normal() * 100.0, dtype=dtype, device=device) for _ in range(2))
    return primal, tree, imp, t, at, vec(k), vec(k)


def separate_stats(primal, tree, imp, t, at, ys, ays, pair: bool = True):
    """A check's chunk statistics through the calls every version of the
    port has: the primal call, the dual pair (or, without ``pair``, one
    call per dual block) and torch's two adds."""
    duals = (pk.dual_chunk_stats_pair(tree, imp, 3.0) if pair
             else [pk.dual_chunk_stats(*v, 3.0) for v in (tree, imp)])
    return (pk.primal_chunk_stats(*primal, 3.0), *duals, at + t, ays + ys)


def flat(out) -> list:
    """A call's outputs as a flat list of tensors."""
    return [v for o in out for v in (o if isinstance(o, tuple) else (o,))]


def stats_digest(device, route: str = "calls") -> str:
    """A digest of the chunk statistics' bits (accumulators, maxima and
    sums, float64 and float32) of one KKT check at ``DIGEST_SHAPES``, each
    from a seed of its own: through the separate calls every version of the
    port has (the primal call, one call per dual block, torch's two adds),
    through the dual pair in place of the two dual calls (``pair``), or
    through one ``check_chunk_stats`` call (``check``)."""
    h = hashlib.sha256()
    for dtype in (torch.float64, torch.float32):
        for j, (n, m, k) in enumerate(DIGEST_SHAPES):
            args = check_inputs(np.random.default_rng(20_000 + j), n, m, k, dtype, device)
            outs = (pk.check_chunk_stats(*args, 3.0) if route == "check"
                    else separate_stats(*args, pair=route == "pair"))
            for v in flat(outs):
                h.update(v.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
    (warmed first), from torch.profiler's CUDA activity.  A trace that
    holds no kernel, or fewer than the wrappers counted launches in it (a
    trace can drop the card's records, from some to all of them), is traced
    again, up to ``TRACE_ATTEMPTS`` times, and each such trace is logged and
    kept in ``TRACE_RETRIES``; any other trace is returned as it is, extra
    kernels included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        counted = sum(kernels.launch_counts().values())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counted = sum(kernels.launch_counts().values()) - counted
        ran = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ran and len(ran) >= counted:
            break
        TRACE_RETRIES.append({"attempt": attempt, "calls": calls, "counted_launches": counted,
                              "traced_kernels": len(ran)})
        log(f"[trace] attempt {attempt} of {TRACE_ATTEMPTS}: torch.profiler saw {len(ran)} "
            f"kernels in {calls} calls whose wrappers counted {counted} launches")
    return ran


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
OPTIMIZE_KERNELS = ("tree_matvec", "tree_rmatvec", "primal_step", "dual_update")


def check_loop_launches(tag, launches, iterations: int, stats: bool = False) -> None:
    """The PDHG loop launches one fused primal step and one fused dual step
    per iteration and no standalone ``scaled_rmatvec``, ``primal_update`` or
    ``dual_prox``; the standalone adjoints run only outside it (step sizes,
    KKT checks, repair), so fewer times than the loop iterates.  With
    ``stats`` (the chunk-statistics flag) each KKT check, one per
    ``check_every`` iterations, makes one statistics launch
    (``check_chunk_stats``: the primal and both dual blocks, the t and
    tenant accumulators) and no standalone primal or dual chunk
    statistics."""
    checks = iterations // SolverOptions().check_every
    log(f"[{tag}] PDHG loop: {iterations} iterations, {checks} checks; primal_step "
        f"{launches['primal_step']}, dual_update {launches['dual_update']}, scaled_rmatvec "
        f"{launches['scaled_rmatvec']}, primal_update {launches['primal_update']}, dual_prox "
        f"{launches['dual_prox']}, check_chunk_stats {launches['check_chunk_stats']}, "
        f"primal_chunk_stats {launches['primal_chunk_stats']}, dual_chunk_stats "
        f"{launches['dual_chunk_stats']}; outside it tree_rmatvec "
        f"{launches['tree_rmatvec']}, sla_rmatvec {launches['sla_rmatvec']}")
    per_check = checks if stats else 0
    if not (launches["primal_step"] == launches["dual_update"] == iterations
            and launches["scaled_rmatvec"] == launches["primal_update"] == 0
            and launches["dual_prox"] == 0
            and launches["check_chunk_stats"] == per_check
            and launches["primal_chunk_stats"] == launches["dual_chunk_stats"] == 0
            and launches["tree_rmatvec"] < iterations and launches["sla_rmatvec"] < iterations):
        raise AssertionError(f"[{tag}] the PDHG loop's launches are not one fused primal step "
                             f"and one fused dual step per iteration and {per_check} "
                             f"statistics launches: {launches}")


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
    parser.add_argument(
        "--stats-digest", action="store_true",
        help="build, print phase 3's digest of the chunk statistics and stop",
    )
    parser.add_argument("--out", default=str(ROOT / "artifacts" / "chip_smoke"))
    parser.add_argument("--shard-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--launch-rank", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.shard_rank is not None:  # one of phase 14b's ranks
        return shard_rank_main(args.shard_rank, out_dir)
    if args.launch_rank is not None:  # one of phase 17d/e's ranks
        return launch_rank_main(args.launch_rank, out_dir)
    report: dict = {"phase_started_s": {}}
    cuda = torch.device("cuda")
    t_start = time.perf_counter()

    def mark(phase: str) -> None:
        """Log and keep the script's wall clock as a phase starts."""
        report["phase_started_s"][phase] = elapsed = time.perf_counter() - t_start
        log(f"[time] {elapsed:.1f} s at the start of phase {phase}")

    # -- 1. the card ------------------------------------------------------
    mark("1")
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
    mark("2")
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
    if args.stats_digest:
        log(f"[3] chunk-stats digest at seeds 20000.. over (n, m, k) in {DIGEST_SHAPES}, "
            f"float64 and float32, separate calls: {stats_digest(cuda)}")
        return 0

    # -- 3. kernels vs plain ----------------------------------------------
    mark("3")
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

    def check_pair(m, n, dtype, main_shape, gen):
        """The dual statistics of two vectors in one launch against their
        plain version (accumulators exact, sums to STATS_TOL), each vector's
        bits those of the single-vector call, on repeated launches too."""
        key = str(dtype).split(".")[-1]
        vecs = [tuple(on_card(gen.normal(size=r) * 100.0, dtype) for _ in range(3))
                for r in (m, n)]
        got = pk.dual_chunk_stats_pair(*vecs, 3.0)
        again = pk.dual_chunk_stats_pair(*vecs, 3.0)
        want = pref.dual_chunk_stats_pair_ref(*vecs, 3.0)
        for g, w, v, g2 in zip(got, want, vecs, again):
            if v[0].numel():  # an empty vector's accumulator is empty
                check("dual_chunk_stats", key, g[0], w[0], w[0].abs().clamp_min(1.0),
                      main_shape)
            for gs, ws in zip(g[1:], w[1:]):
                # an empty vector's sums are 0: the scale's floor is the
                # dtype's least normal number (1e-300 is 0 in float32)
                check("dual_chunk_stats sums", key, gs, ws, ws.clamp_min(torch.finfo(dtype).tiny),
                      main_shape)
            for other in (pk.dual_chunk_stats(*v, 3.0), g2):
                n_checks[0] += 1
                if not all(torch.equal(a, b) for a, b in zip(other, g)):
                    raise AssertionError(f"dual_chunk_stats_pair (m={m}, n={n}, {dtype}) is not "
                                         "the single-vector call's bits, or differs between "
                                         "launches")

    def check_check(n, m, k, dtype, main_shape, gen):
        """Every chunk statistic of one KKT check in one launch against its
        plain version (the accumulators and maxima exact, the sums to
        STATS_TOL), its bits those of the separate calls (the primal call,
        the dual pair, torch's two adds) and of a repeated launch, and the
        three ticket counters back at zero after each launch."""
        key = str(dtype).split(".")[-1]
        args = check_inputs(gen, n, m, k, dtype, cuda)
        got = pk.check_chunk_stats(*args, 3.0)
        tickets = [pk._tickets(cuda).clone()]
        again = pk.check_chunk_stats(*args, 3.0)
        tickets.append(pk._tickets(cuda).clone())
        want = pref.check_chunk_stats_ref(*args, 3.0)
        exact = [(g[i], w[i]) for g, w, n_exact in zip(got, want, (3, 1, 1))
                 for i in range(n_exact)] + list(zip(got[3:], want[3:]))
        for g, w in exact:
            if g.numel():  # an empty block's accumulator is empty
                check("check_chunk_stats", key, g, w, w.abs().clamp_min(1.0), main_shape)
        for g, w, n_exact in zip(got, want, (3, 1, 1)):
            for gs, ws in zip(g[n_exact:], w[n_exact:]):
                check("check_chunk_stats sums", key, gs, ws,
                      ws.clamp_min(torch.finfo(dtype).tiny), main_shape)
        for other in (separate_stats(*args), again):
            n_checks[0] += 1
            if not all(torch.equal(a, b) for a, b in zip(flat(other), flat(got))):
                raise AssertionError(f"check_chunk_stats (n={n}, m={m}, k={k}, {dtype}) is not "
                                     "the separate calls' bits, or differs between launches")
        n_checks[0] += 1
        if any(bool(t.any()) for t in tickets):
            raise AssertionError(f"check_chunk_stats left its ticket counters at {tickets}")

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
        """dual_update, scaled_rmatvec and primal_step against the launches
        they replace (dual_update's and scaled_rmatvec's plain compositions
        on the card, whose adjoint sums are the deterministic segment-sum
        kernels; primal_step's three launches, scaled_rmatvec, primal_update
        and the column scaling, and its plain version on the card), and
        dual_update against its CPU plain version: the same bits (max |d| =
        0).  The primal step's step size is a vector with ``vector_sigma``,
        else one scalar."""
        dual, adjoint = fused_inputs(tidx, sidx, dtype, gen, vector_sigma, pinned)
        step = step_inputs(adjoint, gen, vector_sigma)
        got_d = pk.dual_update(*dual)
        got_a = tk.scaled_rmatvec(*adjoint)
        got_s = tk.primal_step(*step[:-1], tk.primal_step_plan(step[-1]))
        for name_, got, want in (
            ("dual_update", got_d, pref.dual_update_ref(*dual)),
            ("dual_update", got_d, pref.dual_update_ref(*on_cpu(dual))),
            ("scaled_rmatvec", got_a, tref.scaled_rmatvec_ref(*adjoint)),
            ("primal_step", got_s, step_composition(*step)),
            ("primal_step", got_s, tref.primal_step_ref(*step)),
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
    step_main = step_inputs(adjoint_main, np.random.default_rng(21))
    plan_main = tk.primal_step_plan(step_main[-1])
    gen = np.random.default_rng(22)
    pair_main = [tuple(on_card(gen.normal(size=r) * 100.0, torch.float64) for _ in range(3))
                 for r in (m_main, n_main)]
    check_main = check_inputs(np.random.default_rng(24), n_main, m_main, layout.n_tenants,
                              torch.float64, cuda)
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
        # the dual statistics of the solver's two dual vectors in one launch:
        # the paper's tree and improvement rows, an empty vector, one row,
        # and a vector past the elementwise grid
        gen = np.random.default_rng(19)
        check_pair(m_main, n_main, dtype, main, gen)
        for m_p, n_p in ((0, n_main), (1, 1), (n_main, 0), (1_025, 2 * grid + 1)):
            check_pair(m_p, n_p, dtype, False, gen)
        # every statistic of a KKT check in one launch: the tenant fleet's
        # shapes, an empty primal block, one row each, no tree rows, and
        # blocks past the elementwise grid
        gen = np.random.default_rng(23)
        check_check(n_main, m_main, layout.n_tenants, dtype, main, gen)
        for n_c, m_c, k_c in ((0, 5, 0), (1, 1, 1), (1_025, 0, 257), (2 * grid + 1, 1_025, 3)):
            check_check(n_c, m_c, k_c, dtype, False, gen)
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
        f"{tree_sizes} for tree_matvec, {FUSED_SIZES} for the fused kernels; sla_matvec lists of "
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
        ("primal_step", lambda: tk.primal_step(*step_main[:-1], plan_main)),
        ("dual_chunk_stats", lambda: pk.dual_chunk_stats_pair(*pair_main, 3.0)),
        ("primal_chunk_stats", lambda: pk.primal_chunk_stats(*check_main[0], 3.0)),
        ("check_chunk_stats", lambda: pk.check_chunk_stats(*check_main, 3.0)),
    ):
        ran = device_kernels(fn, 5)
        if len(ran) != 5:
            raise AssertionError(f"{name_}: 5 calls ran {len(ran)} kernels on the card: {ran}")
        one_launch[name_] = sorted(set(ran))
    log(f"[3] one kernel on the card per call (torch.profiler, 5 calls): {one_launch}")
    digest = stats_digest(cuda)
    for route in ("pair", "check"):
        if stats_digest(cuda, route) != digest:
            raise AssertionError(f"[3] the chunk statistics' bits through {route} are not the "
                                 "separate calls'")
    log(f"[3] chunk-stats digest at seeds 20000.. over (n, m, k) in {DIGEST_SHAPES}, float64 "
        f"and float32: {digest} (the separate calls'; the pair's and check_chunk_stats' the "
        "same)")
    if digest != STATS_DIGEST:
        raise AssertionError(f"[3] the chunk statistics' digest {digest} is not {STATS_DIGEST}")
    lane_report = lane_checks(cuda, idx_main, sidx_main)
    report["kernel_checks"] = {
        "count": n_checks[0],
        "device_kernels_per_call": one_launch,
        "chunk_stats_digest": digest,
        "lanes": lane_report,
        "max_abs_err_f64": max_err,
        "max_rel_err": worst,
        "limits": LIMITS,
    }

    # -- 4/5. control steps on the card vs the port's CPU run ---------------
    mark("4")
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
    mark("5")
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
    mark("6")
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
        # the solver's two dual vectors (r = m + n rows) in one launch: 3
        # vectors read, the accumulator and 3 scalars written per vector
        ("dual_chunk_stats", "src/repro_torch/kernels/csrc/pdhg_update.cu",
         "src/repro/kernels/pdhg_update/kernel.py:190",
         lambda: pk.dual_chunk_stats_pair(*pair_main, 3.0),
         lambda: pref.dual_chunk_stats_pair_ref(*pair_main, 3.0),
         bound(4 * 8 * (m_b + n_b) + 6 * 8, 10 * (m_b + n_b)),
         None),
        # every statistic of a KKT check in one launch at the tenant fleet's
        # shapes: the primal block's and both dual blocks' reads and writes
        # as above, t, at and at + t, the k tenant duals, their accumulator
        # and its sum with them; one add per accumulator value
        ("check_chunk_stats", "src/repro_torch/kernels/csrc/pdhg_update.cu",
         "src/repro/kernels/pdhg_update/kernel.py:154",
         lambda: pk.check_chunk_stats(*check_main, 3.0),
         lambda: pref.check_chunk_stats_ref(*check_main, 3.0),
         bound(40 * n_b + 32 * (m_b + n_b) + 24 * k_b + 24 + 10 * 8,
               13 * n_b + 10 * (m_b + n_b) + k_b + 1),
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
        # the fused primal step: scaled_rmatvec's reads and its yi write, the
        # prox's seven vectors (x, c, w, target, lo, hi, tau) read and x1,
        # xe, xm written; gx stays in a register.  scaled_rmatvec's
        # operations, ten for the prox and one for xm per device
        ("primal_step", "src/repro_torch/kernels/csrc/tree_matvec.cu",
         "src/repro/kernels/pdhg_update/kernel.py:78",
         lambda: tk.primal_step(*step_main[:-1], plan_main),
         lambda: tref.primal_step_ref(*step_main),
         bound(8 * (n_b + 1) + 4 * (cover_b + e_b) + 16 * (m_b + k_b) + 112 * n_b,
               2 * (cover_b + e_b) + 15 * n_b),
         None),
    ]
    library = {
        "tree_matvec": lambda: torch.mv(a_tree, xv),
        "tree_rmatvec": lambda: torch.mv(a_tree_t, yv),
    }
    entries = []
    log(f"[6] kernel times on {smi}, float64, n={n_b}, m={m_b}, k={k_b}, E={e_b} "
        "(dual_prox at r=n; dual_chunk_stats over the m + n rows of the dual pair; "
        "dual_update over m + k + n rows; scaled_rmatvec and primal_step over n devices, each "
        "beside the plain composition it replaces):")
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
    # what the fused kernels replace in the loop: the primal step's three
    # launches, the two single-vector calls of the dual statistics
    step_ms, step_paced = time_calls(lambda: step_composition(*step_main))
    log(f"[6]   primal_step's three launches (scaled_rmatvec, primal_update, sm * xe): "
        f"{step_ms * 1e3:.2f} us ({step_paced * 1e3:.2f} us host-paced)")
    sep_ms, sep_paced = time_calls(lambda: separate_stats(*check_main))
    log(f"[6]   check_chunk_stats' separate launches (primal_chunk_stats, dual_chunk_stats_pair, "
        f"at + t, ays + ys): {sep_ms * 1e3:.2f} us ({sep_paced * 1e3:.2f} us host-paced)")
    _, _, _, t_c, at_c, ys_c, ays_c = check_main
    adds_ms, adds_paced = time_calls(lambda: (at_c + t_c, ays_c + ys_c))
    log(f"[6]   torch's two adds alone (at + t, ays + ys at k={k_b}): {adds_ms * 1e3:.2f} us "
        f"({adds_paced * 1e3:.2f} us host-paced)")
    two_ms, two_paced = time_calls(lambda: [pk.dual_chunk_stats(*v, 3.0) for v in pair_main])
    log(f"[6]   dual_chunk_stats as two single-vector calls (r=m, r=n): {two_ms * 1e3:.2f} us "
        f"({two_paced * 1e3:.2f} us host-paced)")
    sn_ms, sn_paced = time_calls(lambda: pk.dual_chunk_stats(*stat_args[:3], 3.0))
    sn_plain, sn_plain_paced = time_calls(lambda: pref.dual_chunk_stats_ref(*stat_args[:3], 3.0))
    log(f"[6]   dual_chunk_stats at r=n={n_b}: {sn_ms * 1e3:.2f} / {sn_plain * 1e3:.2f} us "
        f"({sn_paced * 1e3:.2f} / {sn_plain_paced * 1e3:.2f} us) | "
        f"{bound(4 * 8 * n_b + 3 * 8, 10 * n_b)[0] * 1e3:.3f} us")
    # the scan inside tree_matvec (the reference's _blocked_prefix) has no
    # launch of its own: torch.cumsum of the same n values beside its bound
    # (n values read, n written)
    cumsum_ms, cumsum_paced = time_calls(lambda: torch.cumsum(xv, 0))
    log(f"[6]   the scan of tree_matvec (_blocked_prefix): torch.cumsum at n={n_b}: "
        f"{cumsum_ms * 1e3:.2f} us ({cumsum_paced * 1e3:.2f} us host-paced) | "
        f"{bound(16 * n_b, n_b)[0] * 1e3:.3f} us")
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
        "dual_chunk_stats_rows_n": {"ms": sn_ms, "plain_ms": sn_plain, "paced_ms": sn_paced,
                                    "plain_paced_ms": sn_plain_paced},
        "dual_chunk_stats_two_calls": {"ms": two_ms, "paced_ms": two_paced},
        "check_chunk_stats_separate_launches": {"ms": sep_ms, "paced_ms": sep_paced},
        "check_chunk_stats_torch_adds": {"ms": adds_ms, "paced_ms": adds_paced},
        "primal_step_three_launches": {"ms": step_ms, "paced_ms": step_paced},
        "blocked_prefix_cumsum": {"ms": cumsum_ms, "paced_ms": cumsum_paced,
                                  "bound_ms": bound(16 * n_b, n_b)[0]},
    }

    # -- 7. the serving path on the tenant fleet -----------------------------
    mark("7")
    engine_opts = kernel_opts._replace(use_pallas_stats=True)  # every kernel of the path
    engine_launches, engine_report = tenant_engine_phase(
        pdn, layout, engine_opts, cuda, args.warm_tenants
    )
    report["engine_path"] = engine_report
    for entry in entries:
        entry["launches"] = engine_launches[entry["name"]]
        entry["launches_optimize_path"] = main_launches[entry["name"]]

    # -- 8. the data plane's serving path -------------------------------------
    mark("8")
    flash_entries, report["serving_path"] = serving_phase(cuda, smi, args.profile)

    # -- 9. certify-first incremental stepping --------------------------------
    mark("9")
    certify_launches, report["incremental"] = incremental_phase(
        pdn, layout, engine_opts, cuda, engine_report["samples"]
    )
    for entry in entries:
        if entry["name"] in ("tree_matvec", "tree_rmatvec", "sla_matvec"):
            entry["launches_certify"] = certify_launches.get(entry["name"], 0)

    # -- 10. the paper's trace experiment ---------------------------------------
    mark("10")
    report["simulation"] = simulation_phase(pdn, engine_opts, cuda, smi)

    # -- 11. the K-scenario path ------------------------------------------------
    mark("11")
    lane_launches, report["batched"] = batched_phase(pdn, layout, engine_opts, cuda, smi)
    for entry in entries:
        entry["lane_launches"] = lane_launches.get(entry["name"], 0)

    # -- 12. the multi-domain fleet ---------------------------------------------
    mark("12")
    fleet_launches, tenant_fleet_launches, report["fleet"] = fleet_phase(
        pdn, layout, engine_opts, cuda, smi)
    for entry in entries:
        entry["launches_fleet"] = fleet_launches.get(entry["name"], 0)
        entry["launches_tenant_fleet"] = tenant_fleet_launches.get(entry["name"], 0)

    # -- 13. the flight recorder --------------------------------------------------
    mark("13")
    recorder_launches, report["recorder"] = recorder_phase(pdn, layout, engine_opts, cuda, smi,
                                                           out_dir)
    for entry in entries:
        entry["launches_recorder"] = recorder_launches.get(entry["name"], 0)

    # -- 14. the sharded fleet dispatch ---------------------------------------------
    mark("14")
    sharded_launches, sharded_launches_4, report["sharded"] = sharded_phase(
        pdn, layout, engine_opts, cuda, smi, out_dir)
    for entry in entries:
        entry["launches_sharded"] = sharded_launches.get(entry["name"], 0)
        entry["launches_sharded_4_ranks"] = sharded_launches_4.get(entry["name"], 0)

    # -- 15. the MoE, Mamba-2, hybrid and Whisper families ---------------------------
    mark("15")
    family_launches, report["families"] = families_phase(cuda, smi)
    for entry in flash_entries:
        entry["launches_families"] = (family_launches if entry["name"] == "flash_attention_wgmma"
                                      else {arch: {"prefill": 0, "decode": 0}
                                            for arch in family_launches})
    entries.extend(flash_entries)

    serving_run = report["serving_path"].pop("analysis_run")

    # -- 16. the training path ---------------------------------------------------------
    mark("16")
    cli = _start_dryrun_cli(out_dir)  # phase 19c's dry runs, on the host meanwhile
    try:
        lse_entries, report["training"] = training_phase(cuda, smi, args.profile)
        training_run = report["training"]["full_width"].pop("analysis_run")
        entries.extend(lse_entries)

        # -- 17. the training launcher -----------------------------------------------------
        mark("17")
        launcher_launches, pipeline_launches, report["launcher"] = launcher_phase(cuda, smi, out_dir)
        for entry in entries:
            if entry["name"] == "flash_attention_wgmma_lse":
                entry["launches_launcher"] = launcher_launches
            if entry["name"] == "flash_attention_wgmma":
                entry["launches_pipeline"] = pipeline_launches

        # -- 18. the launcher on a mesh ----------------------------------------------------
        mark("18")
        t_phase = time.perf_counter()
        mesh_launches, report["mesh"] = mesh_phase(cuda, smi, report["launcher"]["drill"]["runs"][0],
                                                   out_dir)
        report["mesh"]["seconds"] = time.perf_counter() - t_phase
        log(f"[18] phase 18 in {report['mesh']['seconds']:.1f} s on {smi}")
        for entry in entries:
            if entry["name"] == "flash_attention_wgmma_lse":
                entry["launches_mesh"] = mesh_launches

        # -- 19. the cost analysis on the card's programs ----------------------------------
        mark("19")
        report["analysis"] = analysis_phase(smi, serving_run, training_run, cli)
    finally:
        for *_, proc in cli:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for entry in entries:
        if entry["name"] == "flash_attention_wgmma":
            entry["launches_analysis"] = report["analysis"]["prefill"]["kernel_launches"].get(
                "flash_attention_wgmma", 0)
        if entry["name"] == "flash_attention_wgmma_lse":
            entry["launches_analysis"] = report["analysis"]["train"]["kernel_launches"].get(
                "flash_attention_wgmma_lse", 0)

    if args.profile:
        report["profile"] = profile_step(pdn, kernel_opts)
        report["profile_tenant"] = profile_tenant_step(pdn, layout, engine_opts)

    mark("end")
    report["trace_retries"] = TRACE_RETRIES
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
    check_loop_launches("7", launches, sum(sum(r["phase_iterations"]) for r in rows),
                        stats=kernel_opts.use_pallas_stats)

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


def _kernel_calls(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _check_certify_only(tag, calls: dict, tenants: bool, pdn) -> None:
    """A certified skip launches the certify pass's kernels only: two
    ``tree_matvec`` (the repaired point's residual, Phase I's slack), one
    ``tree_rmatvec`` per tree depth (the repair's factors onto the devices)
    and, with tenants, ``sla_matvec`` (the residual's tenant sums and the
    repair's), and no kernel of a PDHG solve."""
    depths = int(np.max(pdn.node_depth)) + 1
    allowed = {"tree_matvec", "tree_rmatvec"} | ({"sla_matvec"} if tenants else set())
    if (calls.get("tree_matvec") != 2 or calls.get("tree_rmatvec") != depths
            or set(calls) - allowed or (tenants and not calls.get("sla_matvec"))):
        raise AssertionError(f"[{tag}] a skipped step launched {calls}, not the certify pass "
                             f"alone ({sorted(allowed)})")


def incremental_phase(pdn, layout, engine_opts, cuda, tenant_rows):
    """Phase 9: certify-first stepping on the card.  Returns (the certify
    passes' kernel launches over the skipped steps of (a) and (b), report).

    (a) An incremental and an always-full ``AllocEngine`` on the paper
    fleet at KKT tolerance 1e-9 over the quasi-static trace.  The launch
    counts are set to 0 before each step of the incremental engine and read
    after it.  (b) An incremental ``PowerController`` on the Appendix B
    tenant fleet: a cold step, the same step again (a full skip), and after
    ``reset_warm()`` the next sample solved cold (``tenant_rows``: phase 7's
    rows, whose iterations it repeats)."""
    opts = SolverOptions(use_pallas=True, use_pallas_tree=True, eps_abs=INC_EPS,
                         eps_rel=INC_EPS)
    full = AllocEngine(pdn, options=NvpaxOptions(solver=opts), device=cuda)
    inc = AllocEngine(pdn, options=NvpaxOptions(incremental=True, solver=opts), device=cuda)
    sim = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0))
    samples = [sim.power(t) for t in range(INC_STEPS // INC_HOLD)]
    cap0 = float(pdn.node_cap[0])
    caps = np.asarray(pdn.node_cap, np.float64).copy()
    log(f"[9] certify-first stepping: two AllocEngine on n={pdn.n}, eps {INC_EPS:g}, "
        f"{INC_STEPS} steps, telemetry samples 0-{len(samples) - 1} each held {INC_HOLD} steps, "
        f"root cap x {INC_BROWNOUT} at step {INC_BROWNOUT_STEP}")
    inc_calls: dict[str, int] = {}
    certify_calls: dict[str, int] = {}
    rows, anchor, prev_full, drift = [], None, None, 0.0
    for t in range(INC_STEPS):
        tele = samples[t // INC_HOLD]
        if t == INC_BROWNOUT_STEP:
            for e in (full, inc):
                e.set_root_cap(INC_BROWNOUT * cap0)
            caps[0] = INC_BROWNOUT * cap0
        sync(cuda)
        t0 = time.perf_counter()
        rf = full.step(tele)  # ends in a copy to the host
        wall_full = time.perf_counter() - t0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ri = inc.step(tele)
        wall_inc = time.perf_counter() - t0
        calls = _kernel_calls(kernels.launch_counts())
        for key, v in calls.items():
            inc_calls[key] = inc_calls.get(key, 0) + v
        stepped = dataclasses.replace(pdn, node_cap=caps)
        for res in (rf, ri):
            feasibility(stepped, res.allocation)
            if not (res.stats["converged"] and res.stats["kkt_certified"]):
                raise AssertionError(f"[9] step {t} not certified: {dict(res.stats)}")
        skipped = bool(ri.stats["skipped"])
        if skipped:
            _check_certify_only("9", calls, tenants=False, pdn=pdn)
            for key, v in calls.items():
                certify_calls[key] = certify_calls.get(key, 0) + v
            held = float(np.max(np.abs(ri.allocation - anchor)))
            if held > SKIP_TOL:
                raise AssertionError(f"[9] step {t}: a held step moved {held:.3e} W off its anchor")
        else:
            anchor = ri.allocation
        if prev_full is not None and t % INC_HOLD and t != INC_BROWNOUT_STEP:
            drift = max(drift, float(np.max(np.abs(rf.allocation - prev_full))))
        prev_full = rf.allocation
        rows.append({
            "step": t, "skipped": skipped, "certify_pass": bool(ri.stats["certify_pass"]),
            "phase_iterations": list(ri.stats["phase_iterations"]),
            "full_phase_iterations": list(rf.stats["phase_iterations"]),
            "wall_ms": wall_inc * 1e3, "full_wall_ms": wall_full * 1e3,
            "vs_full_w": float(np.max(np.abs(ri.allocation - rf.allocation))),
            "launches": calls,
        })
        log(f"[9] step {t}: " + ("skipped" if skipped else "phase I reused" if
                                 ri.stats["certify_pass"] else "solved")
            + f", iterations {rows[-1]['phase_iterations']} (full "
            f"{rows[-1]['full_phase_iterations']}), {wall_inc * 1e3:.1f} ms (full "
            f"{wall_full * 1e3:.1f} ms), vs full {rows[-1]['vs_full_w']:.2e} W, launches {calls}")
    bar = max(PARITY_TOL, 5 * drift)
    worst = max(r["vs_full_w"] for r in rows)
    n_skip = sum(r["skipped"] for r in rows)
    log(f"[9] the always-full engine's own drift on held steps {drift:.3e} W; bar "
        f"max(1e-6, 5 x drift) = {bar:.3e} W; incremental vs full at most {worst:.3e} W "
        f"(skipped steps {max([r['vs_full_w'] for r in rows if r['skipped']], default=0):.3e}, "
        f"phase I reused {max([r['vs_full_w'] for r in rows if r['certify_pass'] and not r['skipped']], default=0):.3e}, "
        f"solved {max([r['vs_full_w'] for r in rows if not r['certify_pass']], default=0):.3e})")
    if worst > bar:
        raise AssertionError(f"[9] incremental vs always-full {worst:.3e} W > {bar:.3e} W")
    if n_skip < INC_MIN_SKIP_SHARE * INC_STEPS:
        raise AssertionError(f"[9] {n_skip} of {INC_STEPS} steps skipped, under "
                             f"{INC_MIN_SKIP_SHARE:.0%}")
    if full.rebuild_count() != 1 or inc.rebuild_count() != 1:
        raise AssertionError(f"[9] rebuild_count {full.rebuild_count()}, {inc.rebuild_count()}")
    missing = [k for k in ("tree_matvec", "primal_step", "dual_update") if not inc_calls.get(k)]
    if missing:
        raise AssertionError(f"[9] kernels never launched on the incremental path: {missing}")
    walls = {
        "skipped_ms": float(np.median([r["wall_ms"] for r in rows if r["skipped"]])),
        "solved_ms": float(np.median([r["wall_ms"] for r in rows if not r["skipped"]])),
        "full_ms": float(np.median([r["full_wall_ms"] for r in rows])),
    }
    log(f"[9] {n_skip} of {INC_STEPS} steps skipped; median wall: skipped "
        f"{walls['skipped_ms']:.2f} ms, solved {walls['solved_ms']:.1f} ms, always-full "
        f"{walls['full_ms']:.1f} ms; rebuild_count 1, 1; incremental path launches {inc_calls}")
    skip_profile = profiled("one skipped step (9a)", lambda: inc.step(samples[-1]))
    _check_certify_only("9, profiled", skip_profile["kernel_calls"], tenants=False, pdn=pdn)

    # (b) the Appendix B tenant fleet
    ctl = PowerController(
        pdn, sla=layout.sla_topo(device=cuda), priority=layout.priority,
        config=ControllerConfig(options=NvpaxOptions(incremental=True, solver=engine_opts)),
        device=cuda,
    )
    owned = layout.tenant_of >= 0
    s0, s1 = (sim.power(t) for t in (0, 1))
    cold = ctl.step(s0)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    held = ctl.step(s0)
    wall_held = time.perf_counter() - t0
    calls = _kernel_calls(kernels.launch_counts())
    if not held.stats["skipped"]:
        raise AssertionError(f"[9b] the repeated tenant step did not certify: {dict(held.stats)}")
    _check_certify_only("9b", calls, tenants=True, pdn=pdn)
    for key, v in calls.items():
        certify_calls[key] = certify_calls.get(key, 0) + v
    gap = float(np.max(np.abs(held.allocation - cold.allocation)))
    if gap > SKIP_TOL:
        raise AssertionError(f"[9b] the skipped step moved {gap:.3e} W off the cold step")
    over = feasibility(pdn, held.allocation)
    sums = np.bincount(layout.tenant_of[owned], weights=held.allocation[owned],
                       minlength=layout.n_tenants)
    sla_gap = float(max(np.max(layout.b_min - sums), np.max(sums - layout.b_max)))
    if sla_gap > SLA_FEAS_TOL:
        raise AssertionError(f"[9b] a tenant sum leaves its bounds by {sla_gap:.3e} W")
    ctl.reset_warm()
    next_cold = ctl.step(s1)
    want = tenant_rows[1]["phase_iterations"]
    if (next_cold.stats["certify_pass"] or not next_cold.stats["kkt_certified"]
            or list(next_cold.stats["phase_iterations"]) != want):
        raise AssertionError(f"[9b] sample 1 after reset_warm: {dict(next_cold.stats)}, "
                             f"phase 7's iterations {want}")
    if ctl.rebuild_count() != 1:
        raise AssertionError(f"[9b] rebuild_count {ctl.rebuild_count()}")
    log(f"[9b] tenant fleet: sample 0 cold {list(cold.stats['phase_iterations'])}; again: "
        f"skipped in {wall_held * 1e3:.2f} ms, launches {calls}, {gap:.1e} W off the cold step, "
        f"cap excess {over:.2e} W, tenant bound excess {sla_gap:.2e} W; after reset_warm "
        f"sample 1 solved cold, iterations {list(next_cold.stats['phase_iterations'])} "
        f"(phase 7's); rebuild_count 1")
    log(f"[9] the certify passes' launches over the skipped steps: {certify_calls}")
    report = {
        "paper_fleet": {"rows": rows, "self_drift_w": drift, "bar_w": bar, "max_vs_full_w": worst,
                        "skipped": n_skip, "median_walls": walls, "launches": inc_calls,
                        "skip_profile": skip_profile},
        "tenant_fleet": {"cold_iterations": list(cold.stats["phase_iterations"]),
                         "skip_wall_ms": wall_held * 1e3, "skip_launches": calls,
                         "skip_vs_cold_w": gap, "max_cap_excess_w": over,
                         "max_tenant_bound_excess_w": sla_gap,
                         "next_cold_iterations": list(next_cold.stats["phase_iterations"])},
        "certify_launches": certify_calls,
    }
    return certify_calls, report


class RecordingController(PowerController):
    """A ``PowerController`` that keeps every step's allocation, for the
    checks of phase 10 (``DatacenterSim`` returns metrics only)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.allocations: list[np.ndarray] = []

    def step(self, telemetry, *, active=None):
        res = super().step(telemetry, active=active)
        self.allocations.append(res.allocation)
        return res


def simulation_phase(pdn, engine_opts, cuda, smi) -> dict:
    """Phase 10: ``DatacenterSim`` on the paper fleet with the Static and
    Greedy baselines, every kernel flag on, against the port's CPU run of
    its first ``SIM_HELD`` intervals."""
    config = ControllerConfig(options=NvpaxOptions(solver=engine_opts))

    def run(device, steps):
        ctl = RecordingController(pdn, config=config, device=device)
        sim = DatacenterSim.build(pdn, seed=0, controller=ctl)
        sync(device)
        t0 = time.perf_counter()
        out = sim.run(steps)
        return out, ctl, time.perf_counter() - t0

    log(f"[10] DatacenterSim: n={pdn.n}, TelemetrySim seed 0, {SIM_STEPS} intervals with the "
        f"Static and Greedy baselines, every kernel flag on")
    kernels.reset_launch_counts()
    out, ctl, wall = run(cuda, SIM_STEPS)
    launches = _kernel_calls(kernels.launch_counts())
    cpu_out, cpu_ctl, _ = run("cpu", SIM_HELD)
    for t in range(SIM_HELD):
        d = float(np.max(np.abs(ctl.allocations[t] - cpu_ctl.allocations[t])))
        if d > PARITY_TOL:
            raise AssertionError(f"[10] interval {t}: card vs CPU {d:.3e} W")
    for key in ("S_nvpax", "S_static", "S_greedy"):
        d = float(np.max(np.abs(out[key][:SIM_HELD] - cpu_out[key])))
        if d > RATIO_TOL:
            raise AssertionError(f"[10] {key} card vs CPU {d:.3e}")
    for t, a in enumerate(ctl.allocations):
        feasibility(pdn, a)
    if not (out["S_nvpax"] >= out["S_static"]).all():
        bad = int(np.argmin(out["S_nvpax"] - out["S_static"]))
        raise AssertionError(f"[10] interval {bad}: S_nvpax {out['S_nvpax'][bad]:.6f} < S_static "
                             f"{out['S_static'][bad]:.6f}")
    missing = [k for k in ("tree_matvec", "tree_rmatvec", "primal_step", "dual_update",
                           "check_chunk_stats") if not launches.get(k)]
    if missing:
        raise AssertionError(f"[10] kernels never launched: {missing}")
    w = out["wall_ms"]
    gap_cpu = max(float(np.max(np.abs(ctl.allocations[t] - cpu_ctl.allocations[t])))
                  for t in range(SIM_HELD))
    report = {
        "steps": SIM_STEPS,
        "means": {k: float(np.mean(out[k])) for k in ("S_nvpax", "S_static", "S_greedy",
                                                        "straggler_tax")},
        "wall_ms": {"mean": float(np.mean(w)), "median": float(np.median(w)),
                    "p95": float(np.percentile(w, 95)), "first": float(w[0])},
        "run_s": wall,
        "vs_cpu_w": gap_cpu,
        "launches": launches,
        "card": smi,
        "per_step": {k: v.tolist() for k, v in out.items()},
    }
    m, wm = report["means"], report["wall_ms"]
    log(f"[10] means over {SIM_STEPS} intervals: S_nvpax {m['S_nvpax']:.6f}, S_static "
        f"{m['S_static']:.6f}, S_greedy {m['S_greedy']:.6f}, straggler tax "
        f"{m['straggler_tax']:.6f}; S_nvpax >= S_static and every breaker kept on every "
        f"interval; first {SIM_HELD} vs the CPU run {gap_cpu:.2e} W, ratios <= {RATIO_TOL:g}")
    log(f"[10] wall per interval (controller step, host clock): mean {wm['mean']:.1f} ms, "
        f"median {wm['median']:.1f} ms, p95 {wm['p95']:.1f} ms (first {wm['first']:.1f} ms); "
        f"{wall:.1f} s for the run with both baselines; on {smi}; launches {launches}")
    return report


def lane_inputs(cuda, tidx, sidx, dtype, lanes: int, seed: int):
    """Every allocator kernel on ``lanes`` lanes of random inputs over the
    given tree and tenant indexes: {wrapper: (the call on [lanes, size]
    inputs, the call on lane j's inputs alone)}, each returning a tuple of
    outputs.  The primal step and update are called with a per-lane vector
    step and a per-lane scalar step (two launches)."""
    gen = np.random.default_rng(seed)
    n, m, k = tidx.n, tidx.start.shape[0], sidx.k
    inf = float("inf")

    def vec(size, pos=False):
        v = torch.as_tensor(gen.normal(size=(lanes, size)), dtype=dtype, device=cuda)
        return v.abs() + 0.1 if pos else v

    def col(*values):  # one value per lane, [lanes, 1]
        return torch.as_tensor(gen.choice(values, (lanes, 1)), dtype=dtype, device=cuda)

    x, yt, ys, yi = vec(n), vec(m), vec(k), vec(n)
    sm = vec(n, True) * (vec(n) > -0.5).to(dtype)
    d_tree, d_sla, d_imp = vec(m, True), vec(k, True), vec(n, True)
    blocks = []
    for size, a in ((m, vec(m)), (k, vec(k)), (n, sm * vec(n))):
        lo = vec(size)
        hi = lo + vec(size, True)
        blocks.append(pref.DualBlock(vec(size), a, vec(size, True), vec(size, True),
                                     torch.where(vec(size) > 0.5, -inf, lo),
                                     torch.where(vec(size) > 0.5, inf, hi)))
    s_t, t_mov, te = col(1.7, 0.3), col(0.0, 1.0), vec(1)
    w = vec(n).abs() * (vec(n) > -0.5).to(dtype)
    lo = vec(n) - 1.0
    data = tk.PrimalStepData(vec(n), w, vec(n), lo, lo + vec(n, True), d_tree, d_sla, d_imp, sm,
                             tidx, sidx)
    tau, tau_col = vec(n, True), col(0.37, 0.5)
    prox = (x, vec(n), vec(n), w, vec(n), lo, lo + vec(n, True))
    check = ((x, vec(n), vec(n), vec(n)), (yt, vec(m), vec(m)), (yi, vec(n), vec(n)),
             vec(1), vec(1), ys, vec(k))
    cnt = gen.integers(1, 9, lanes).astype(np.float64)
    cnt_dev = torch.as_tensor(cnt, dtype=dtype, device=cuda)  # the lanes' counts, on the card
    adjoint = (yt, ys, yi, d_tree, d_sla, d_imp, sm, tidx, sidx)
    dprox = (blocks[0].y, blocks[0].a, blocks[0].sigma, blocks[0].lo, blocks[0].hi)

    def lane(j, args):
        """Lane j of (nested) arguments; [lanes, 1] columns become 0-d."""
        if isinstance(args, (tk.TreeIndex, tk.SlaIndex)):  # shared by every lane
            return args
        if isinstance(args, tuple):
            items = [lane(j, a) for a in args]
            return type(args)(*items) if hasattr(args, "_fields") else tuple(items)
        if isinstance(args, torch.Tensor):
            return args[j, 0] if args.shape[-1] == 1 else args[j]
        return args

    def step(xs, taus, d):
        return tk.primal_step(*xs, taus, tk.primal_step_plan(d))

    return {
        "tree_matvec": (lambda: (tk.tree_matvec(x, tidx),),
                        lambda j: (tk.tree_matvec(x[j], tidx),)),
        "tree_rmatvec": (lambda: (tk.tree_rmatvec(yt, tidx),),
                         lambda j: (tk.tree_rmatvec(yt[j], tidx),)),
        "sla_matvec": (lambda: (tk.sla_matvec(x, sidx),), lambda j: (tk.sla_matvec(x[j], sidx),)),
        "sla_rmatvec": (lambda: (tk.sla_rmatvec(ys, sidx),),
                        lambda j: (tk.sla_rmatvec(ys[j], sidx),)),
        "scaled_rmatvec": (lambda: tk.scaled_rmatvec(*adjoint),
                           lambda j: tk.scaled_rmatvec(*lane(j, adjoint))),
        "primal_step": (
            lambda: step((x, yt, ys, yi), tau, data) + step((x, yt, ys, yi), tau_col, data),
            lambda j: step(lane(j, (x, yt, ys, yi)), tau[j], lane(j, data))
            + step(lane(j, (x, yt, ys, yi)), tau_col[j, 0], lane(j, data))),
        "primal_update": (lambda: pk.primal_update(*prox, tau) + pk.primal_update(*prox, tau_col),
                          lambda j: pk.primal_update(*lane(j, prox), tau[j])
                          + pk.primal_update(*lane(j, prox), tau_col[j, 0])),
        "dual_prox": (lambda: (pk.dual_prox(*dprox),), lambda j: (pk.dual_prox(*lane(j, dprox)),)),
        "dual_update": (lambda: pk.dual_update(*blocks, s_t, t_mov, te),
                        lambda j: pk.dual_update(*lane(j, (*blocks, s_t, t_mov, te)))),
        "check_chunk_stats": (
            lambda: tuple(flat(pk.check_chunk_stats(*check, cnt_dev))),
            lambda j: tuple(flat(pk.check_chunk_stats(*lane(j, check), float(cnt[j]))))),
    }


def lane_checks(cuda, tidx, sidx) -> dict:
    """Phase 3's lane axis: every allocator kernel at the paper's shapes
    (the fleet's tree, Appendix B's tenants) on K lanes for K in
    ``LANE_COUNTS``, float64 and float32: one wrapper launch per call (two
    for the primal step and update, called with a vector and a per-lane
    scalar step), one kernel on the card per call at K = 8 (torch.profiler),
    each lane's outputs the bits of the call on that lane alone, and the
    chunk statistics' ticket counters back at zero."""
    t0 = time.perf_counter()
    n_checks = 0
    for dtype in (torch.float64, torch.float32):
        for lanes in LANE_COUNTS:
            cases = lane_inputs(cuda, tidx, sidx, dtype, lanes, seed=30_000 + lanes)
            for name, (many, one) in cases.items():
                kernels.reset_launch_counts()
                got = many()
                calls = 2 if name in ("primal_step", "primal_update") else 1
                lane_calls = kernels.lane_launch_counts()[name]
                if kernels.launch_counts()[name] != calls or lane_calls != calls:
                    raise AssertionError(f"[3] {name} at K={lanes}: {kernels.launch_counts()}")
                for j in range(lanes):
                    want = one(j)
                    for g, w in zip(got, want):
                        n_checks += 1
                        if not torch.equal(g[j].reshape(-1).view(BITS[dtype]),
                                           w.reshape(-1).view(BITS[dtype])):
                            raise AssertionError(f"[3] {name} lane {j} of {lanes} ({dtype}) is "
                                                 "not the one-lane launch's bits")
            if bool(pk._tickets(cuda, lanes).any()):
                raise AssertionError(f"[3] the ticket counters are not zero after K={lanes}")
    per_call = {}
    for name, (many, _) in lane_inputs(cuda, tidx, sidx, torch.float64, 8, seed=1).items():
        ran = device_kernels(many, 5)
        calls = 2 if name in ("primal_step", "primal_update") else 1
        if len(ran) != 5 * calls:
            raise AssertionError(f"[3] {name} at K=8: 5 calls ran {len(ran)} kernels: {ran}")
        per_call[name] = sorted(set(ran))
    log(f"[3] lane axis: {n_checks} lane-vs-one-lane comparisons at K in {LANE_COUNTS} "
        f"(n={tidx.n}, m={tidx.start.shape[0]}, k={sidx.k}, float64 and float32), every lane the "
        f"bits of its one-lane launch, one launch per call, tickets back at zero "
        f"({time.perf_counter() - t0:.1f} s); at K=8 one kernel on the card per call: {per_call}")
    return {"comparisons": n_checks, "lane_counts": list(LANE_COUNTS),
            "device_kernels_per_call_k8": per_call}


def _tenant_edges(layout):
    """Appendix B's (device, tenant) incidence."""
    dev = np.nonzero(layout.tenant_of >= 0)[0]
    return dev, layout.tenant_of[dev]


def _lane_row(res, j):
    """Lane j's allocation, Phase I point and iterations."""
    return res.allocation[j], res.phase1[j], [int(v) for v in res.stats["phase_iterations"][j]]


def batched_phase(pdn, layout, engine_opts, cuda, smi):
    """Phase 11: the K-scenario path.  Returns (each allocator kernel's lane
    launches over (a) and (b), report).

    (a) ``PowerController.what_if`` on the paper fleet, ``WHATIF_K``
    ``TelemetrySim`` seed 0 samples, every kernel flag: each lane against
    the card's own cold one-scenario step of that sample (equal iterations
    per phase, ``SKIP_TOL`` W), feasible and certified; lanes 0-1 against
    the port's CPU run (``PARITY_TOL``).  (b) The Appendix B tenant fleet,
    ``TENANT_K`` cold lanes (``what_if``), each held to phase 7's bars
    against its cold one-scenario step: certified, Phase I and the useful
    power min(request, cap) within ``PARITY_TOL``, breakers and contracts
    kept.  (c) The incremental engine's ``step_batched`` on ``WHATIF_K``
    lanes at eps 1e-9: a repeated batch skips every lane with the certify
    pass's launches alone; one dirty lane re-solves, the others hold.  (d)
    The wall of (a) against the one-scenario steps, the launches per batched
    step and per PDHG iteration of the slowest lane against the
    one-scenario step's (torch.profiler), ``calibrate_phase_cost`` and a
    ``deadline_s`` truncation."""
    config = ControllerConfig(options=NvpaxOptions(solver=engine_opts))
    sim = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0))
    samples = np.stack([sim.power(t) for t in range(WHATIF_K)])
    report: dict = {"card": smi}

    # (a) what_if on the paper fleet
    log(f"[11] K-scenario path: PowerController.what_if on n={pdn.n}, K={WHATIF_K} TelemetrySim "
        "seed 0 samples, every kernel flag")
    ctl = PowerController(pdn, config=config, device=cuda)
    ctl.what_if(samples[:2])  # builds the engine
    sync(cuda)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = ctl.what_if(samples)
    wall_batched = time.perf_counter() - t0
    lane_launches = dict(kernels.lane_launch_counts())
    single = PowerController(pdn, config=config, device=cuda)
    ones, walls = [], []
    for t in range(WHATIF_K):
        single.reset_warm()
        sync(cuda)
        t0 = time.perf_counter()
        ones.append(single.step(samples[t]))
        walls.append(time.perf_counter() - t0)
    rows = []
    for j, one in enumerate(ones):
        x, _, its = _lane_row(res, j)
        gap = float(np.max(np.abs(x - one.allocation)))
        over = feasibility(pdn, x)
        if its != list(one.stats["phase_iterations"]) or gap > SKIP_TOL:
            raise AssertionError(f"[11a] lane {j}: iterations {its} vs {one.stats['phase_iterations']}"
                                 f", {gap:.3e} W off its one-scenario step")
        if not (res.stats["converged"][j] and res.stats["kkt_certified"][j]):
            raise AssertionError(f"[11a] lane {j} not certified")
        rows.append({"lane": j, "phase_iterations": its, "vs_single_w": gap,
                     "max_cap_excess_w": over})
    cpu = PowerController(pdn, config=config, device="cpu").what_if(samples[:2])
    cpu_gap = float(np.max(np.abs(res.allocation[:2] - cpu.allocation)))
    if cpu_gap > PARITY_TOL or not np.array_equal(res.stats["phase_iterations"][:2],
                                                  cpu.stats["phase_iterations"]):
        raise AssertionError(f"[11a] lanes 0-1 card vs CPU {cpu_gap:.3e} W")
    worst = max(r["vs_single_w"] for r in rows)
    log(f"[11a] {WHATIF_K} lanes: iterations {[r['phase_iterations'] for r in rows]}, each "
        f"the card's own one-scenario step's, at most {worst:.3e} W off it; lanes 0-1 vs the CPU "
        f"run {cpu_gap:.3e} W; certified, breakers kept; wall {wall_batched * 1e3:.1f} ms against "
        f"{sum(walls) * 1e3:.1f} ms for the {WHATIF_K} one-scenario steps (median "
        f"{np.median(walls) * 1e3:.1f} ms); lane launches {_kernel_calls(lane_launches)}")
    report["paper_what_if"] = {"rows": rows, "max_vs_single_w": worst, "vs_cpu_w": cpu_gap,
                               "wall_ms": wall_batched * 1e3,
                               "single_walls_ms": [w * 1e3 for w in walls]}

    # (b) cold tenant lanes
    owned = layout.tenant_of >= 0
    tconfig = ControllerConfig(options=NvpaxOptions(solver=engine_opts))
    tctl = PowerController(pdn, sla=layout.sla_topo(device=cuda), priority=layout.priority,
                           config=tconfig, device=cuda)
    t0 = time.perf_counter()
    tres = tctl.what_if(samples[:TENANT_K])
    wall_tenant = time.perf_counter() - t0
    for key, v in kernels.lane_launch_counts().items():
        lane_launches[key] = v
    missing = [k for k in ALLOCATOR_KERNELS if not lane_launches.get(k)]
    if missing:
        raise AssertionError(f"[11] kernels never launched over lanes: {missing}")
    tsingle = PowerController(pdn, sla=layout.sla_topo(device=cuda), priority=layout.priority,
                              config=tconfig, device=cuda)
    trows = []
    for j in range(TENANT_K):
        tsingle.reset_warm()
        one = tsingle.step(samples[j])
        x, x1, its = _lane_row(tres, j)
        if not (tres.stats["converged"][j] and tres.stats["kkt_certified"][j]):
            raise AssertionError(f"[11b] lane {j} not certified")
        p1_gap = float(np.max(np.abs(x1 - one.phase1)))
        req = np.asarray(samples[j], np.float64) * tconfig.request_margin
        r_eff = np.where(req >= tconfig.idle_threshold, np.clip(req, pdn.dev_l, pdn.dev_u), 0.0)
        useful = float(np.max(np.abs(np.minimum(r_eff, x) - np.minimum(r_eff, one.allocation))))
        over = feasibility(pdn, x)
        sums = np.bincount(layout.tenant_of[owned], weights=x[owned], minlength=layout.n_tenants)
        sla_gap = float(max(np.max(layout.b_min - sums), np.max(sums - layout.b_max)))
        if p1_gap > PARITY_TOL or useful > PARITY_TOL or sla_gap > SLA_FEAS_TOL:
            raise AssertionError(f"[11b] lane {j}: phase I {p1_gap:.3e} W, useful power "
                                 f"{useful:.3e} W, tenant bounds {sla_gap:.3e} W")
        trows.append({"lane": j, "phase_iterations": its,
                      "single_phase_iterations": list(one.stats["phase_iterations"]),
                      "phase1_vs_single_w": p1_gap, "useful_vs_single_w": useful,
                      "caps_vs_single_w": float(np.max(np.abs(x - one.allocation))),
                      "max_cap_excess_w": over, "max_tenant_bound_excess_w": sla_gap})
    log(f"[11b] Appendix B tenants, {TENANT_K} cold lanes in {wall_tenant * 1e3:.1f} ms: "
        + "; ".join(f"lane {r['lane']} {r['phase_iterations']} (one-scenario "
                    f"{r['single_phase_iterations']}), phase I {r['phase1_vs_single_w']:.1e} W, "
                    f"useful {r['useful_vs_single_w']:.1e} W, caps {r['caps_vs_single_w']:.1e} W"
                    for r in trows))
    report["tenant_what_if"] = {"rows": trows, "wall_ms": wall_tenant * 1e3}

    # (c) the incremental engine on lanes
    inc_opts = engine_opts._replace(eps_abs=INC_EPS, eps_rel=INC_EPS)
    inc = AllocEngine(pdn, options=NvpaxOptions(incremental=True, solver=inc_opts), device=cuda)
    tb = samples * 1.05
    r1 = inc.step_batched(tb)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    r2 = inc.step_batched(tb)
    wall_skip = time.perf_counter() - t0
    skip_calls = _kernel_calls(kernels.launch_counts())
    held = float(np.max(np.abs(r2.allocation - r1.allocation)))
    if not r2.stats["skipped"].all() or r2.stats["iterations"].any() or held > SKIP_TOL:
        raise AssertionError(f"[11c] a repeated batch: skipped {r2.stats['skipped']}, launches "
                             f"{skip_calls}, {held:.3e} W off")
    _check_certify_only("11c", skip_calls, tenants=False, pdn=pdn)
    dirty = WHATIF_K // 2
    tb2 = tb.copy()
    tb2[dirty] *= 1.05
    r3 = inc.step_batched(tb2)
    clean = np.arange(WHATIF_K) != dirty
    # the always-full engine through the same batches, warm-carried: its
    # own drift on the repeated batch sets the dirty lane's bar, as phase 9
    # sets a re-solved step's
    full = AllocEngine(pdn, options=NvpaxOptions(solver=inc_opts), device=cuda)
    f1, f2, f3 = (full.step_batched(b) for b in (tb, tb, tb2))
    drift = float(np.max(np.abs(f2.allocation - f1.allocation)))
    bar = max(PARITY_TOL, 5 * drift)
    dirty_gap = float(np.max(np.abs(r3.allocation[dirty] - f3.allocation[dirty])))
    if (list(r3.stats["skipped"]) != list(clean) or r3.stats["iterations"][clean].any()
            or float(np.max(np.abs(r3.allocation[clean] - r1.allocation[clean]))) > SKIP_TOL
            or dirty_gap > bar or inc.rebuild_count() != 1):
        raise AssertionError(f"[11c] one dirty lane: skipped {r3.stats['skipped']}, the dirty "
                             f"lane {dirty_gap:.3e} W off the always-full engine's (bar "
                             f"{bar:.3e} W)")
    log(f"[11c] incremental engine, {WHATIF_K} lanes: a repeated batch skipped every lane in "
        f"{wall_skip * 1e3:.2f} ms (launches {skip_calls}); lane {dirty} made dirty re-solved "
        f"alone ({list(r3.stats['phase_iterations'][dirty])} iterations, {dirty_gap:.2e} W off "
        f"the always-full engine's lane; its own drift on the repeated batch {drift:.2e} W, bar "
        f"{bar:.2e} W), the others held; rebuild_count 1")
    report["incremental"] = {"skip_wall_ms": wall_skip * 1e3, "skip_launches": skip_calls,
                             "dirty_lane_vs_full_w": dirty_gap, "full_drift_w": drift,
                             "bar_w": bar}

    # (d) launches per PDHG iteration, busy share, calibration, deadline.
    # The K-lane step runs as many water-fill rounds as its slowest lane
    # needs, so it is held to the one-scenario step that launches most
    # (each sample's cold step profiled), and lane 0's is reported beside it
    profs = []
    for t in range(WHATIF_K):
        single.reset_warm()
        profs.append(profiled(f"one cold one-scenario paper step, sample {t} (11d)",
                              lambda: single.step(samples[t]), top=0))
    prof_one = max(profs, key=lambda p: p["launches"])
    iters_lane = int(max(sum(r["phase_iterations"]) for r in rows))
    prof_k = profiled(f"one what_if of K={WHATIF_K} (11d)", lambda: ctl.what_if(samples),
                      iterations=iters_lane)
    per_iter_one = prof_one["launches"] / prof_one["pdhg_iterations"]
    per_iter_0 = profs[0]["launches"] / profs[0]["pdhg_iterations"]
    per_iter_k = prof_k["launches"] / iters_lane
    if per_iter_k > LANE_ITER_RATIO * per_iter_one:
        raise AssertionError(f"[11d] {per_iter_k:.2f} launches per PDHG iteration of the slowest "
                             f"lane against {per_iter_one:.2f} for one scenario")
    stacked = stack_problems([
        AllocProblem.build(pdn, samples[j] * config.request_margin,
                           topology=ctl._get_engine().fleet) for j in range(WHATIF_K)])
    meta = batch_meta(stacked, config.options)
    model = calibrate_phase_cost(stacked, meta, engine_opts)
    cut = optimize_batched(stacked, dataclasses.replace(config.options, deadline_s=1e-7))
    if not cut.stats["truncated"].all() or not np.array_equal(cut.allocation, cut.phase1):
        raise AssertionError("[11d] a 1e-7 s deadline did not truncate every lane to Phase I")
    log(f"[11d] launches per PDHG iteration: one scenario {per_iter_one:.2f} at most "
        f"({prof_one['launches']} over {prof_one['pdhg_iterations']}; sample 0 {per_iter_0:.2f}; "
        f"{[p['launches'] for p in profs]} launches per cold step), K={WHATIF_K} "
        f"{per_iter_k:.2f} ({prof_k['launches']} over the slowest lane's {iters_lane}; "
        f"{per_iter_k / per_iter_one:.2f}x, bar {LANE_ITER_RATIO}x; "
        f"{per_iter_k / per_iter_0:.2f}x sample 0's); busy "
        f"{100 * prof_one['device_us'] / prof_one['wall_us']:.1f}% (the most-launching one "
        f"scenario) vs {100 * prof_k['device_us'] / prof_k['wall_us']:.1f}% (K={WHATIF_K}) "
        f"under the profiler; calibrate_phase_cost at "
        f"K={WHATIF_K}: {model.p1_s * 1e6:.1f} us per Phase I iteration, {model.p23_s * 1e6:.1f} "
        f"us per Phase II/III iteration; deadline 1e-7 s: every lane truncated to Phase I, "
        f"budget {cut.stats['iter_budget']}; on {smi}")
    # each lane kernel's device time at the paper's shapes: K = 8 lanes in
    # one launch, one lane, and 8 one-lane launches
    lane_ms = {}
    for name, (many, one) in lane_inputs(cuda, tk.tree_index(pdn.node_start, pdn.node_end, pdn.n,
                                                             cuda),
                                         tk.sla_index(*_tenant_edges(layout), layout.n_tenants,
                                                      pdn.n, cuda),
                                         torch.float64, WHATIF_K, seed=2).items():
        calls = 2 if name in ("primal_step", "primal_update") else 1
        k8 = time_calls(many)[0] / calls
        k1 = time_calls(lambda: one(0))[0] / calls
        seq = time_calls(lambda: [one(j) for j in range(WHATIF_K)])[0] / calls
        lane_ms[name] = {"k8_ms": k8, "k1_ms": k1, "eight_k1_ms": seq}
    log(f"[11d] lane kernels' device time, float64, paper shapes (Appendix B tenants), per "
        f"launch: K={WHATIF_K} / K=1 / {WHATIF_K} one-lane launches: "
        + ", ".join(f"{k} {v['k8_ms'] * 1e3:.2f} / {v['k1_ms'] * 1e3:.2f} / "
                    f"{v['eight_k1_ms'] * 1e3:.2f} us" for k, v in lane_ms.items()))
    report["timing"] = {"single_profiles": profs, "batched_profile": prof_k,
                        "lane_kernels_ms": lane_ms,
                        "launches_per_iteration": {"single_max": per_iter_one,
                                                   "single_sample0": per_iter_0,
                                                   "batched": per_iter_k},
                        "slowest_lane_iterations": iters_lane,
                        "phase_cost": {"p1_s": model.p1_s, "p23_s": model.p23_s,
                                       "mix": list(model.mix)},
                        "deadline_budget": cut.stats["iter_budget"]}
    report["lane_launches"] = lane_launches
    return lane_launches, report


FLEET_STEPS = 5
FLEET_SIM_STEPS = 4
FLEET_PARITY_TOL = 1e-9  # watts: stacked vs loop and card vs CPU, equal iterations
FLEET_MONO_TOL = 1e-6  # watts: fleet vs the monolithic engine (the reference's bar)
FLEET_RACKS = 20  # phase 12's rebuilt hall, inside the 24-rack padding


def _hall(racks: int):
    """One hall of the paper's geometry with ``racks`` racks, rebased as a
    domain (``split_pdn`` at level 1 of a one-hall datacenter)."""
    return split_pdn(build_datacenter(n_halls=1, racks_per_hall=racks), 1).domains[0].pdn


def _fleet_lanes(pdn, layout):
    """Phase 12a's K = 4 topologies: the paper fleet's 4 hall domains, hall
    3 replaced by a ``FLEET_RACKS``-rack hall, and Appendix B's tenants
    split at the cut (the rebuilt hall keeps its first devices' edges),
    padded as the stacked fleet pads them.  Returns (N, starts, ends, devs,
    tens, rows)."""
    part = split_pdn(pdn, 1, tenants=layout)
    pdns = [d.pdn for d in part.domains]
    pdns[3] = _hall(FLEET_RACKS)
    edges = [part.sla.edges(k) for k in range(part.k)]
    keep = edges[3][0] < pdns[3].n
    edges[3] = (edges[3][0][keep], edges[3][1][keep])
    N, M = max(p.n for p in pdns), max(p.m for p in pdns)
    E = max(d.shape[0] for d, _ in edges)
    rows = part.sla.max_rows + 1  # one inert pad row, as the fleet pads
    starts = np.full((4, M), N, np.int64)
    ends = np.full((4, M), N, np.int64)
    devs = np.zeros((4, E), np.int64)
    tens = np.full((4, E), rows - 1, np.int64)
    for k, (p, (d, t)) in enumerate(zip(pdns, edges)):
        starts[k, : p.m], ends[k, : p.m] = p.node_start, p.node_end
        devs[k, : d.shape[0]], tens[k, : t.shape[0]] = d, t
    return N, starts, ends, devs, tens, rows


def fleet_lane_kernels(pdn, layout, cuda, smi) -> dict:
    """Phase 12a: the tree and tenant kernels over an index of 4 hall
    topologies (``_fleet_lanes``), float64 and float32: one launch per call,
    each lane the bits of a one-lane launch on its own index; each kernel
    against its plain version (``ref.py``) on the same inputs and ``[K, M]``
    / ``[K, E]`` topology: the tree and tenant sums at phase 3's ``LIMITS``
    over each lane's sum of |input| on the card and, for the tenant sums,
    the CPU plain version's bits; the scaled adjoint and the primal step
    bit for bit, as phase 3 holds them; then each kernel's device time at
    K = 4 topologies and at K = 1 (lane 0's index)."""
    N, starts, ends, devs, tens, rows = _fleet_lanes(pdn, layout)
    K, M = starts.shape
    tidx = tk.tree_index(starts, ends, N, cuda)
    sidx = tk.sla_index(devs, tens, rows, N, cuda)
    topo = {a: torch.as_tensor(v) for a, v in (("start", starts), ("end", ends), ("dev", devs),
                                                ("ten", tens))}
    topo_card = {a: v.to(cuda) for a, v in topo.items()}
    plain_err: dict[str, dict[str, float]] = {}
    ones = [(tk.tree_index(starts[j], ends[j], N, cuda),
             tk.sla_index(devs[j], tens[j], rows, N, cuda)) for j in range(K)]
    n_checks = 0
    timing = {}
    for dtype in (torch.float64, torch.float32):
        gen = np.random.default_rng(40_000)

        def vec(size, pos=False):
            v = torch.as_tensor(gen.normal(size=(K, size)), dtype=dtype, device=cuda)
            return v.abs() + 0.1 if pos else v

        x, yt, ys, yi = vec(N), vec(M), vec(rows), vec(N)
        dt, ds, di, sm = vec(M, True), vec(rows, True), vec(N, True), vec(N, True)
        c, w, target, lo = vec(N), vec(N, True), vec(N), vec(N) - 1.0
        hi, tau = lo + vec(N, True), vec(N, True)
        data = tk.PrimalStepData(c, w, target, lo, hi, dt, ds, di, sm, tidx, sidx)
        plan = tk.primal_step_plan(data)
        one_plans = [tk.primal_step_plan(tk.PrimalStepData(
            c[j], w[j], target[j], lo[j], hi[j], dt[j], ds[j], di[j], sm[j], *ones[j]))
            for j in range(K)]
        cases = {
            "tree_matvec": (lambda: (tk.tree_matvec(x, tidx),),
                            lambda j: (tk.tree_matvec(x[j], ones[j][0]),)),
            "tree_rmatvec": (lambda: (tk.tree_rmatvec(yt, tidx),),
                             lambda j: (tk.tree_rmatvec(yt[j], ones[j][0]),)),
            "sla_matvec": (lambda: (tk.sla_matvec(x, sidx),),
                           lambda j: (tk.sla_matvec(x[j], ones[j][1]),)),
            "sla_rmatvec": (lambda: (tk.sla_rmatvec(ys, sidx),),
                            lambda j: (tk.sla_rmatvec(ys[j], ones[j][1]),)),
            "scaled_rmatvec": (
                lambda: tk.scaled_rmatvec(yt, ys, yi, dt, ds, di, sm, tidx, sidx),
                lambda j: tk.scaled_rmatvec(yt[j], ys[j], yi[j], dt[j], ds[j], di[j], sm[j],
                                            *ones[j])),
            "primal_step": (lambda: tk.primal_step(x, yt, ys, yi, tau, plan),
                            lambda j: tk.primal_step(x[j], yt[j], ys[j], yi[j], tau[j],
                                                     one_plans[j])),
        }
        for name, (many, one) in cases.items():
            kernels.reset_launch_counts()
            got = many()
            if kernels.launch_counts()[name] != 1 or kernels.lane_launch_counts()[name] != 1:
                raise AssertionError(f"[12a] {name}: {kernels.launch_counts()}")
            for j in range(K):
                for g, wv in zip(got, one(j)):
                    n_checks += 1
                    if not torch.equal(g[j].reshape(-1).view(BITS[dtype]),
                                       wv.reshape(-1).view(BITS[dtype])):
                        raise AssertionError(f"[12a] {name} lane {j} ({dtype}) is not the bits of "
                                             "its one-lane launch on its own index")
            if dtype == torch.float64:
                timing[name] = {"k4_ms": time_calls(many)[0], "k1_ms": time_calls(lambda: one(0))[0]}
        n_checks += fleet_lane_plain(cases, (x, yt, ys, yi, tau, data), topo, topo_card, N, rows,
                                     plain_err)
    log(f"[12a] per-lane topology: {n_checks} lane-vs-one-lane comparisons over 4 hall domains "
        f"(N={N} padded, devices {[int(e.max()) for e in ends]}, M={M}, {rows} tenant rows, "
        f"E={devs.shape[1]} edges a lane), float64 and float32: every lane the bits of its "
        "one-lane launch on its own index, one launch per call")
    log(f"[12a] against the plain versions on the [K, ...] topology: largest |d| / lane sum of "
        "|input| (limit) " + ", ".join(
            f"{k} {d} {v:.2e} ({LIMITS[k][d]:.1e})" for k, e in plain_err.items()
            for d, v in e.items())
        + "; tenant sums the CPU plain version's bits; scaled_rmatvec and primal_step the bits of "
        "their plain compositions")
    log(f"[12a] device time per launch, float64, K=4 topologies / K=1 (lane 0's), on {smi}: "
        + ", ".join(f"{k} {v['k4_ms'] * 1e3:.2f} / {v['k1_ms'] * 1e3:.2f} us"
                    for k, v in timing.items()))
    return {"comparisons": n_checks, "padded_n": N, "rows": M, "tenant_rows": rows,
            "edges": int(devs.shape[1]), "timing": timing, "plain_rel_err": plain_err}


def fleet_lane_plain(cases, inputs, topo, topo_card, n: int, rows: int, worst: dict) -> int:
    """Phase 12a's kernels over K topologies against their plain versions
    on the same card inputs: the tree and tenant sums within ``LIMITS`` of
    the card's plain version, |d| over the lane's sum of |input| (``worst``
    keeps the largest by kernel and dtype), and the tenant sums the CPU
    plain version's bits; ``scaled_rmatvec`` and ``primal_step`` the bits of
    their plain compositions (the deterministic segment sums, then the
    plain update).  Returns the number of comparisons."""
    x, yt, ys, yi, tau, data = inputs
    key = str(x.dtype).split(".")[-1]
    n_checks = 0
    for name, v, plain, gather in (
        ("tree_matvec", x, lambda v_, t: tref.tree_matvec_ref(v_, t["start"], t["end"]), None),
        ("tree_rmatvec", yt,
         lambda v_, t: tref.tree_rmatvec_ref(v_, t["start"], t["end"], n), None),
        ("sla_matvec", x, lambda v_, t: tref.sla_matvec_ref(v_, t["dev"], t["ten"], rows), "dev"),
        ("sla_rmatvec", ys, lambda v_, t: tref.sla_rmatvec_ref(v_, t["dev"], t["ten"], n), "ten"),
    ):
        got = cases[name][0]()[0]
        want = plain(v, topo_card)
        terms = v if gather is None else tref.take(v, topo_card[gather])
        scale = terms.abs().sum(-1, keepdim=True)
        rel = torch.where(got == want, 0.0, (got - want).abs()) / scale
        n_checks += 1
        if not bool((rel <= LIMITS[name][key]).all()):
            raise AssertionError(f"[12a] {name} ({key}) leaves its plain version on the lanes' "
                                 f"own topology: max |d| / scale {float(rel.max()):.3e} > "
                                 f"{LIMITS[name][key]:.3e}")
        worst.setdefault(name, {})[key] = max(worst.get(name, {}).get(key, 0.0),
                                              float(rel.max()))
        if gather is not None:
            n_checks += 1
            if not torch.equal(got.cpu(), plain(v.cpu(), topo)):
                raise AssertionError(f"[12a] {name} ({key}) is not the bits of its CPU plain "
                                     "version on the lanes' own topology")
    for name, want in (
        ("scaled_rmatvec", tref.scaled_rmatvec_ref(yt, ys, yi, *data[5:])),
        ("primal_step", tref.primal_step_ref(x, yt, ys, yi, tau, data)),
    ):
        for g, w in zip(cases[name][0](), want):
            n_checks += 1
            if not torch.equal(g.view(BITS[x.dtype]), w.view(BITS[x.dtype])):
                raise AssertionError(f"[12a] {name} ({key}) differs from its plain composition "
                                     f"in {int((g != w).sum())} of {g.numel()} values")
    return n_checks


def _fleet_feasible(orch, x, grants):
    """Every domain's own rows under its current boxes and caps, its sum
    under its grant, and every coordinator row above the cut; the largest
    excess in watts."""
    offs = orch._offsets()
    over = -np.inf
    for k, p in enumerate(orch._local_pdn):
        xk = x[offs[k]:offs[k + 1]]
        csum = np.concatenate([[0.0], np.cumsum(xk)])
        over = max(over, float(np.max(csum[p.node_end] - csum[p.node_start] - orch._node_cap[k])),
                   float(xk.sum() - grants[k]))
        if (xk < orch._dev_l[k] - 1e-9).any() or (xk > orch._dev_u[k] + 1e-9).any():
            raise AssertionError(f"domain {k}'s allocation leaves its device boxes")
    if over > FEAS_TOL:
        raise AssertionError(f"a domain row exceeds its cap by {over:.3e} W")
    sums = np.array([x[offs[k]:offs[k + 1]].sum() for k in range(orch.k)])
    orch.coordinator.check(sums, coord_cap=orch.coordinator.cap * orch._feed_scale,
                           tol=FEAS_TOL)
    return over


class RecordingOrchestrator(FleetOrchestrator):
    """A ``FleetOrchestrator`` that keeps every step's allocation, for phase
    12e's checks (``DatacenterSim`` returns metrics only)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.allocations: list[np.ndarray] = []

    def step(self, telemetry, *, active=None):
        res = super().step(telemetry, active=active)
        self.allocations.append(res.allocation)
        return res


def tenant_fleet_quality(tag, pdn_, lay, x, power, active, want=None) -> dict:
    """A tenant fleet's allocation at the quality level: every breaker
    (``FEAS_TOL``) and tenant bound (``SLA_FEAS_TOL``) kept and, against
    ``want`` (the same step on the CPU), the total power within
    ``FLEET_MONO_TOL`` and every device's useful power, min(request, cap),
    within ``PARITY_TOL``, the requests as ``DatacenterSim`` forms them.
    The tenant LPs are eps-degenerate, so the caps themselves are reported,
    not held.  Returns the gaps in watts."""
    feasibility(pdn_, x)
    owned = lay.tenant_of >= 0
    sums = np.bincount(lay.tenant_of[owned], weights=x[owned], minlength=lay.n_tenants)
    excess = float(max(np.max(lay.b_min - sums), np.max(sums - lay.b_max)))
    if excess > SLA_FEAS_TOL:
        raise AssertionError(f"{tag}: a tenant sum leaves its bounds by {excess:.3e} W")
    gaps = {"tenant_bound_excess_w": excess}
    if want is None:
        return gaps
    r = np.where(active, np.clip(power, pdn_.dev_l, pdn_.dev_u), pdn_.dev_l)
    gaps.update(total_w=abs(float(x.sum() - want.sum())),
                useful_w=float(np.max(np.abs(np.minimum(r, x) - np.minimum(r, want)))),
                max_abs_w=float(np.max(np.abs(x - want))))
    if gaps["total_w"] > FLEET_MONO_TOL or gaps["useful_w"] > PARITY_TOL:
        raise AssertionError(f"{tag}: card vs CPU {gaps}")
    return gaps


def unallocated(orch, res) -> list[float]:
    """Each domain's grant less its allocation sum, in watts."""
    offs = np.concatenate([[0], np.cumsum(orch.domain_sizes)])
    return [float(res.grants[k] - res.allocation[offs[k]:offs[k + 1]].sum())
            for k in range(orch.k)]


def hall_unallocated(tag, orch, res) -> list[float]:
    """:func:`unallocated`; past ``UNALLOCATED_TOL`` in any domain the phase
    fails."""
    left = unallocated(orch, res)
    if max(left) > UNALLOCATED_TOL:
        raise AssertionError(f"{tag}: a hall's grant left unallocated past {UNALLOCATED_TOL:g} "
                             f"W: {[round(v, 1) for v in left]} W")
    return left


def stacked_step_kept(orch, tele, act):
    """``orch.step(tele, active=act)`` and the stacked problem its solve was
    given: (result, (ap, meta, options))."""
    import repro_torch.fleet.orchestrator as orch_mod

    kept = {}
    real = orch_mod._solve_batched

    def keep(ap, meta, opts, warm, *a, **kw):
        kept.update(ap=ap, meta=meta, opts=opts)
        return real(ap, meta, opts, warm, *a, **kw)

    orch_mod._solve_batched = keep
    try:
        res = orch.step(tele, active=act)
    finally:
        orch_mod._solve_batched = real
    return res, (kept["ap"], kept["meta"], kept["opts"])


def lanes_alone(tag, orch, res, kept) -> None:
    """Each lane of the stacked problem ``kept`` solved alone (the lane
    sliced out of the ``[K, ...]`` problem, its own topology kept) must give
    the bits and phase iterations the stacked step gave that lane."""
    from repro_torch.core.batched import _solve_batched

    ap, meta, opts = kept
    K = orch.k
    offs = np.concatenate([[0], np.cumsum(orch.domain_sizes)])

    def lane(tree, j):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(lane(v, j) for v in tree))
        if isinstance(tree, torch.Tensor) and tree.ndim >= 1 and tree.shape[0] == K:
            return tree[j:j + 1].contiguous()
        return tree

    for j in range(K):
        _, _, x, _, st, _ = _solve_batched(lane(ap, j), meta, opts, None)
        its = [int(st[f"iterations_p{i}"][0]) for i in (1, 2, 3)]
        xj = x[0, :offs[j + 1] - offs[j]].cpu().numpy()
        want = res.allocation[offs[j]:offs[j + 1]]
        if its != res.stats["phase_iterations"][j].tolist() or not np.array_equal(xj, want):
            raise AssertionError(f"{tag}: hall {j} alone took {its} iterations and lies "
                                 f"{float(np.max(np.abs(xj - want))):.3e} W off its lane of "
                                 f"the stacked step ({res.stats['phase_iterations'][j]})")


def paper_tenant_fleet(pdn, layout, opts, tele, act, cuda, smi) -> tuple[dict, dict]:
    """Phase 12f: the paper's datacenter cut into its 4 halls with Appendix
    B's tenants split at the cut, one cold stacked step with every kernel
    flag (the launch counts set to 0 just before it and read just after):
    every lane converged, every breaker and tenant bound kept, each
    allocator kernel launched over the domains' lanes, no hall's grant left
    unallocated past ``UNALLOCATED_TOL``, and each lane the bits and
    iterations of that lane's problem solved alone.  Then the same cold
    step again under torch.profiler (``reset_warm``): the same bits, and
    the share of the device time in ``primal_step``, whose tenant adjoint
    walks device 0's list of pad edges on one thread.  Last, the same cold
    step with the default options (every kernel flag off), its grants left
    unallocated reported.  Returns (launch counts, report)."""
    orch = FleetOrchestrator(pdn, level=1, tenants=layout, mode="stacked", options=opts,
                             device=cuda)
    sync(cuda)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, kept = stacked_step_kept(orch, tele, act)
    sync(cuda)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts())
    lanes = dict(kernels.lane_launch_counts())
    missing = [k for k in ALLOCATOR_KERNELS if not launches[k] or lanes[k] != launches[k]]
    its = res.stats["phase_iterations"]
    if missing or not res.stats["converged"].all():
        raise AssertionError(f"[12f] converged {res.stats['converged']}; kernels not launched "
                             f"over the domains' lanes: {missing} ({_kernel_calls(launches)})")
    gaps = tenant_fleet_quality("[12f]", pdn, layout, res.allocation, tele, act)
    left = hall_unallocated("[12f]", orch, res)
    lanes_alone("[12f]", orch, res, kept)
    orch.reset_warm()
    again = []
    prof = profiled("one cold stacked tenant fleet step (12f)",
                    lambda: slowest_lane_step(orch, tele, act, again), top=16)
    if not np.array_equal(again[0].allocation, res.allocation):
        raise AssertionError("[12f] a repeated cold step differs by "
                             f"{float(np.max(np.abs(again[0].allocation - res.allocation))):.3e} W")
    primal_us = sum(r["device_us"] for r in prof["top"] if "primal_step" in r["name"])
    slowest = int(np.max(np.sum(its, 1)))
    # a trace that dropped every record of the card's gives no share
    share = primal_us / prof["device_us"] if prof["device_us"] else float("nan")
    pads = [orch._E - orch._sla.edges(k)[0].size for k in range(orch.k)]
    # the default options: every tree and lane sum by torch on the card
    plain = FleetOrchestrator(pdn, level=1, tenants=layout, mode="stacked",
                              options=NvpaxOptions(), device=cuda)
    res_p = plain.step(tele, active=act)
    left_plain = unallocated(plain, res_p)
    its_plain = res_p.stats["phase_iterations"].tolist()
    del plain
    log(f"[12f] tenant fleet, 4 halls x 3,072 devices, Appendix B's {layout.n_tenants} tenants "
        f"split at the cut ({orch._E} edges a lane, of them {pads} pad edges on device 0): one "
        f"cold stacked step, iterations {its.tolist()}, wall "
        f"{wall * 1e3:.1f} ms, launches {_kernel_calls(launches)} "
        f"({prof['launches'] / slowest:.2f} device launches per PDHG iteration of the slowest "
        f"lane's {slowest}, profiled), primal_step {100 * share:.1f}% of "
        f"the device time ({primal_us:.0f} of {prof['device_us']:.0f} us, busy "
        f"{100 * prof['device_us'] / prof['wall_us']:.1f}% of the profiled wall); every breaker "
        f"and tenant bound kept, each hall's grant left unallocated "
        f"{[round(v, 1) for v in left]} W (bar {UNALLOCATED_TOL:g}), each hall's lane the bits "
        f"and iterations of its one-lane solve, a repeated cold step the same bits; the same "
        f"step with the kernel flags off (not gated): iterations {its_plain}, left "
        f"unallocated {[round(v, 1) for v in left_plain]} W; on {smi}")
    return launches, {"phase_iterations": its.tolist(), "wall_ms": wall * 1e3, "pad_edges": pads,
                      "unallocated_w": left, "flags_off_unallocated_w": left_plain,
                      "flags_off_phase_iterations": its_plain,
                      "launches": launches, "quality": gaps, "profile": prof,
                      "primal_step_device_us": primal_us,
                      "primal_step_share": share}


def slowest_lane_step(orch, tele, act, keep=None):
    """A stacked fleet step whose stats count the slowest domain's
    iterations (for launches per PDHG iteration); the result goes into
    ``keep`` where given."""
    r = orch.step(tele, active=act)
    if keep is not None:
        keep.append(r)
    return types.SimpleNamespace(
        stats={"phase_iterations": [int(np.max(np.sum(r.stats["phase_iterations"], 1)))]})


def fleet_phase(pdn, layout, engine_opts, cuda, smi) -> tuple[dict, dict, dict]:
    """Phase 12: the multi-domain fleet.  Returns (each allocator kernel's
    launches over 12b's stacked steps, over 12f's cold tenant fleet step,
    report).

    (a) :func:`fleet_lane_kernels`.  (b) ``FleetOrchestrator(build_datacenter(),
    level=1)`` stacked with every kernel flag, ``FLEET_STEPS`` ``TelemetrySim``
    seed 0 samples: every row of the full PDN feasible and every lane
    converged; against the port's CPU run of the same steps and against the
    loop mode on the card, ``FLEET_PARITY_TOL`` W and equal iterations; the
    walls, launches per PDHG iteration and busy share (torch.profiler)
    beside the monolithic engine's step.  (c) The reference's parity case
    at paper size: ``homogeneous_fleet(4, racks_per_domain=24,
    servers_per_rack=16, gpus_per_server=8)``, subtree grants, against the
    monolithic ``AllocEngine`` on the card to ``FLEET_MONO_TOL``.  (d)
    Churn on (b)'s fleet: a leave and a join, a derated domain feed and a
    rebuild of hall 3 to ``FLEET_RACKS`` racks; ``rebuild_count()`` moves
    only on the rebuild, every step feasible.  (e) ``DatacenterSim`` in
    fleet mode for ``FLEET_SIM_STEPS`` intervals (S values, wall per
    interval), ``prefetch=True`` giving the same S values, and the
    cross-tenant scenario with every tenant minimum margin >= 0, as
    ``cross_tenant()`` builds it and through every kernel flag (each
    allocator kernel launched, every launch over the domains' lanes), the
    latter held to the CPU run of the same intervals by
    :func:`tenant_fleet_quality`.  (f) :func:`paper_tenant_fleet`."""
    report: dict = {"card": smi}
    report["lane_kernels"] = fleet_lane_kernels(pdn, layout, cuda, smi)
    opts = NvpaxOptions(solver=engine_opts)
    sim = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0))
    samples = [sim.power(t) for t in range(FLEET_STEPS)]
    actives = [sim.active_mask(t) for t in range(FLEET_STEPS)]

    def drive(orch):
        out, walls = [], []
        for tele, act in zip(samples, actives):
            sync(cuda)
            t0 = time.perf_counter()
            out.append(orch.step(tele, active=act))
            walls.append(time.perf_counter() - t0)
        return out, walls

    # (b) the stacked fleet on the paper's datacenter; the launch counts are
    # set to 0 just before its steps and read just after
    stacked = FleetOrchestrator(pdn, level=1, mode="stacked", options=opts, device=cuda)
    if stacked.k != 4 or stacked.rebuild_count() != 1:
        raise AssertionError(f"[12b] {stacked.k} domains, {stacked.rebuild_count()} builds")
    sync(cuda)
    kernels.reset_launch_counts()
    res_s, walls_s = drive(stacked)
    sync(cuda)
    fleet_launches = dict(kernels.launch_counts())
    lane_launches = dict(kernels.lane_launch_counts())
    path = ("tree_matvec", "tree_rmatvec", "primal_step", "dual_update", "check_chunk_stats")
    missing = [k for k in path if not fleet_launches[k] or lane_launches[k] != fleet_launches[k]]
    if missing:
        raise AssertionError(f"[12b] kernels not launched over the domains' lanes: {missing} "
                             f"({fleet_launches}, lanes {lane_launches})")
    loop = FleetOrchestrator(pdn, level=1, mode="loop", options=opts, device=cuda)
    res_l, walls_l = drive(loop)
    cpu = FleetOrchestrator(pdn, level=1, mode="stacked", options=opts, device="cpu")
    res_c, _ = drive(cpu)
    mono = AllocEngine(pdn, options=opts, device=cuda)
    mono.step(samples[0], active=actives[0])
    mono.reset_warm()
    walls_m, rows = [], []
    for t, (tele, act) in enumerate(zip(samples, actives)):
        sync(cuda)
        t0 = time.perf_counter()
        rm = mono.step(tele, active=act)
        walls_m.append(time.perf_counter() - t0)
        rs, rl, rc = res_s[t], res_l[t], res_c[t]
        over = feasibility(pdn, rs.allocation)  # every row, the datacenter root included
        its = rs.stats["phase_iterations"]
        gaps = {"loop": float(np.max(np.abs(rs.allocation - rl.allocation))),
                "cpu": float(np.max(np.abs(rs.allocation - rc.allocation)))}
        if (not rs.stats["converged"].all() or gaps["loop"] > FLEET_PARITY_TOL
                or gaps["cpu"] > FLEET_PARITY_TOL
                or not np.array_equal(its, rl.stats["phase_iterations"])
                or not np.array_equal(its, rc.stats["phase_iterations"])):
            raise AssertionError(f"[12b] step {t}: iterations {its.tolist()} (loop "
                                 f"{rl.stats['phase_iterations'].tolist()}, CPU "
                                 f"{rc.stats['phase_iterations'].tolist()}), gaps {gaps}, "
                                 f"converged {rs.stats['converged']}")
        rows.append({"step": t, "phase_iterations": its.tolist(), "vs_loop_w": gaps["loop"],
                     "vs_cpu_w": gaps["cpu"], "max_cap_excess_w": over,
                     "grants_w": rs.grants.tolist(), "mono_phase_iterations":
                     list(rm.stats["phase_iterations"]),
                     "vs_mono_w": float(np.max(np.abs(rs.allocation - rm.allocation)))})
    if stacked.rebuild_count() != 1:
        raise AssertionError("[12b] the stacked fleet rebuilt its tensors while stepping")
    prof_s = profiled("one warm stacked fleet step (12b)",
                      lambda: slowest_lane_step(stacked, samples[0], actives[0]))
    prof_m = profiled("one warm monolithic engine step (12b)",
                      lambda: mono.step(samples[0], active=actives[0]))
    per_s = prof_s["launches"] / prof_s["pdhg_iterations"]
    per_m = prof_m["launches"] / prof_m["pdhg_iterations"]
    med = {k: float(np.median(v) * 1e3) for k, v in
           (("stacked", walls_s), ("loop", walls_l), ("mono", walls_m))}
    log(f"[12b] stacked fleet, 4 halls x 3,072 devices, {FLEET_STEPS} TelemetrySim seed 0 steps: "
        f"iterations {[r['phase_iterations'] for r in rows]}; vs loop on the card "
        f"{max(r['vs_loop_w'] for r in rows):.2e} W, vs the CPU "
        f"{max(r['vs_cpu_w'] for r in rows):.2e} W (equal iterations); every row of the full "
        f"PDN kept; walls stacked {[round(w * 1e3, 1) for w in walls_s]} ms, loop (4 domain "
        f"steps) {[round(w * 1e3, 1) for w in walls_l]} ms, monolithic engine "
        f"{[round(w * 1e3, 1) for w in walls_m]} ms (medians {med}); launches per PDHG "
        f"iteration stacked {per_s:.2f} ({prof_s['launches']} over the slowest lane's "
        f"{prof_s['pdhg_iterations']}), monolithic {per_m:.2f}; busy "
        f"{100 * prof_s['device_us'] / prof_s['wall_us']:.1f}% vs "
        f"{100 * prof_m['device_us'] / prof_m['wall_us']:.1f}%; launches over the 5 stacked "
        f"steps {_kernel_calls(fleet_launches)}; on {smi}")
    report["stacked"] = {"rows": rows, "walls_ms": {"stacked": [w * 1e3 for w in walls_s],
                                                   "loop": [w * 1e3 for w in walls_l],
                                                   "mono": [w * 1e3 for w in walls_m]},
                         "median_ms": med, "launches_per_iteration": {"stacked": per_s,
                                                                      "mono": per_m},
                         "profile_stacked": prof_s, "profile_mono": prof_m,
                         "launches": fleet_launches}

    # (c) the reference's parity case at paper size
    hpdn = homogeneous_fleet(4, racks_per_domain=24, servers_per_rack=16, gpus_per_server=8,
                             root_oversub=1.0)
    sub = FleetOrchestrator(hpdn, level=1, coordinator_mode="subtree", options=opts, device=cuda)
    hmono = AllocEngine(hpdn, options=opts, device=cuda)
    rng = np.random.default_rng(0)
    gaps_c = []
    for t in range(3):
        tele = rng.uniform(80, 680, hpdn.n)
        rf, rm = sub.step(tele), hmono.step(tele)
        gap = float(np.max(np.abs(rf.allocation - rm.allocation)))
        tot = abs(float(rf.allocation.sum() - rm.allocation.sum()))
        feasibility(hpdn, rf.allocation)
        if gap > FLEET_MONO_TOL or tot > FLEET_MONO_TOL or not rf.stats["converged"].all():
            raise AssertionError(f"[12c] step {t}: {gap:.3e} W per device, {tot:.3e} W total "
                                 "off the monolithic engine")
        gaps_c.append({"per_device_w": gap, "total_w": tot,
                       "phase_iterations": rf.stats["phase_iterations"].tolist()})
    log(f"[12c] homogeneous_fleet(4) at paper size (n={hpdn.n}), subtree grants, {sub.mode}, "
        f"cold + 2 warm steps vs the monolithic engine: per device "
        f"{max(g['per_device_w'] for g in gaps_c):.2e} W, total "
        f"{max(g['total_w'] for g in gaps_c):.2e} W (bar {FLEET_MONO_TOL:g})")
    report["parity_subtree"] = gaps_c

    # (d) churn on (b)'s fleet
    life = FleetLifecycle(stacked)
    tele, act = samples[1], actives[1]
    churn = []

    def churn_step(tag):
        res = stacked.step(tele_now[0], active=act_now[0])
        over = _fleet_feasible(stacked, res.allocation, res.grants)
        if not res.stats["converged"].all():
            raise AssertionError(f"[12d] {tag}: not converged")
        churn.append({"event": tag, "rebuilds": stacked.rebuild_count(), "max_excess_w": over,
                      "phase_iterations": res.stats["phase_iterations"].tolist()})
        return res

    tele_now, act_now = [tele], [act]
    left = np.array([5, 3_100, 9_000])
    life.device_leave(left)
    res = churn_step("leave 3 devices")
    if np.abs(res.allocation[left]).max() > 0.0:
        raise AssertionError("[12d] a left device got power")
    stacked.set_domain_supply(2, 0.9)
    churn_step("hall 2 feed x 0.9")
    life.device_join(left)
    churn_step("rejoin")
    before = stacked.rebuild_count()
    stacked.rebuild_domain(3, _hall(FLEET_RACKS))
    keep = np.r_[0:3 * 3_072, 3 * 3_072:3 * 3_072 + _hall(FLEET_RACKS).n]
    tele_now[0], act_now[0] = tele[keep], act[keep]
    churn_step(f"hall 3 rebuilt to {FLEET_RACKS} racks")
    counts = [c["rebuilds"] for c in churn]
    if counts[:3] != [before] * 3 or counts[3] != before + 1 or life.n_left:
        raise AssertionError(f"[12d] rebuild counts {counts} (before the rebuild {before})")
    log(f"[12d] churn on the stacked fleet: " + "; ".join(
        f"{c['event']}: rebuilds {c['rebuilds']}, iterations {c['phase_iterations']}, max excess "
        f"{c['max_excess_w']:.2e} W" for c in churn))
    report["churn"] = churn

    # (e) the simulator in fleet mode, and the cross-tenant scenario
    def fleet_sim():
        orch = FleetOrchestrator(pdn, level=1, options=opts, device=cuda)
        return DatacenterSim.build(pdn, seed=0, orchestrator=orch)

    out = fleet_sim().run(FLEET_SIM_STEPS)
    pre = fleet_sim().run(FLEET_SIM_STEPS, prefetch=True)
    for key in ("S_nvpax", "S_static", "S_greedy"):
        if not np.array_equal(out[key], pre[key]):
            raise AssertionError(f"[12e] prefetch changed {key}")
    if (out["S_nvpax"] < out["S_static"] - 1e-9).any():
        raise AssertionError("[12e] S_nvpax below S_static")
    cross = DatacenterSim.cross_tenant(device=cuda).run(FLEET_SIM_STEPS // 4)
    # the same scenario through every kernel flag, on the card and on the CPU
    hpdn = homogeneous_fleet(4)
    lay = assign_cross_domain_tenants(hpdn, 1, lo_frac=0.5, hi_frac=0.8, seed=0)

    def flagged_cross(device):
        orch = RecordingOrchestrator(hpdn, level=1, tenants=lay, options=opts, device=device)
        sim_ = DatacenterSim.build(hpdn, seed=0, orchestrator=orch, tenants=lay)
        kernels.reset_launch_counts()
        out_ = sim_.run(FLEET_SIM_STEPS // 4)
        sync(device)
        return out_, orch.allocations, sim_.trace

    cross_flags, cross_x, trace = flagged_cross(cuda)
    cross_lanes = dict(kernels.lane_launch_counts())
    cross_launches = dict(kernels.launch_counts())
    missing = [k for k in ALLOCATOR_KERNELS
               if not cross_launches[k] or cross_lanes[k] != cross_launches[k]]
    if missing or min(cross["sla_min_margin"].min(),
                      cross_flags["sla_min_margin"].min()) < -SLA_FEAS_TOL:
        raise AssertionError(f"[12e] cross-tenant margins {cross['sla_min_margin']} / "
                             f"{cross_flags['sla_min_margin']}; kernels not launched over the "
                             f"domains' lanes: {missing} ({_kernel_calls(cross_launches)})")
    cross_cpu, cross_cpu_x, _ = flagged_cross("cpu")
    cross_gaps = [tenant_fleet_quality(f"[12e] interval {t}", hpdn, lay, x, trace.power(t),
                                       trace.active_mask(t), want=cross_cpu_x[t])
                  for t, x in enumerate(cross_x)]
    w = out["wall_ms"]
    log(f"[12e] DatacenterSim in fleet mode, {FLEET_SIM_STEPS} intervals: S_nvpax "
        f"{out['S_nvpax'].mean():.6f}, S_static {out['S_static'].mean():.6f}, S_greedy "
        f"{out['S_greedy'].mean():.6f}; wall per interval mean {w.mean():.1f} ms, median "
        f"{np.median(w):.1f}, p95 {np.percentile(w, 95):.1f} (prefetch: mean "
        f"{pre['wall_ms'].mean():.1f} ms, same S values); cross-tenant scenario "
        f"({FLEET_SIM_STEPS // 4} intervals): S_nvpax {cross['S_nvpax'].mean():.6f}, worst tenant "
        f"minimum margin {cross['sla_min_margin'].min():.3f} W; with every kernel flag S_nvpax "
        f"{cross_flags['S_nvpax'].mean():.6f}, worst margin "
        f"{cross_flags['sla_min_margin'].min():.3f} W, launches "
        f"{_kernel_calls(cross_launches)}, each over the 4 domains' lanes; against the CPU run "
        f"of the same intervals: total power {max(g['total_w'] for g in cross_gaps):.2e} W (bar "
        f"{FLEET_MONO_TOL:g}), useful power {max(g['useful_w'] for g in cross_gaps):.2e} W (bar "
        f"{PARITY_TOL:g}), per device {max(g['max_abs_w'] for g in cross_gaps):.2e} W, S_nvpax "
        f"{float(np.max(np.abs(cross_flags['S_nvpax'] - cross_cpu['S_nvpax']))):.2e}; every "
        f"breaker and tenant bound kept")
    report["simulation"] = {
        "S_nvpax": out["S_nvpax"].tolist(), "S_static": out["S_static"].tolist(),
        "S_greedy": out["S_greedy"].tolist(), "wall_ms": w.tolist(),
        "prefetch_wall_ms": pre["wall_ms"].tolist(),
        "cross_tenant": {"S_nvpax": cross["S_nvpax"].tolist(),
                         "sla_min_margin": cross["sla_min_margin"].tolist(),
                         "flags_S_nvpax": cross_flags["S_nvpax"].tolist(),
                         "flags_sla_min_margin": cross_flags["sla_min_margin"].tolist(),
                         "flags_vs_cpu": cross_gaps,
                         "flags_cpu_S_nvpax": cross_cpu["S_nvpax"].tolist(),
                         "launches": cross_launches}}

    tenant_launches, report["tenant_fleet"] = paper_tenant_fleet(pdn, layout, opts, samples[0],
                                                                  actives[0], cuda, smi)
    return fleet_launches, tenant_launches, report


# -- phase 13: the flight recorder ---------------------------------------------

REC_SAMPLES = 5  # 13a: TelemetrySim seed 0 samples 0-4, each held REC_HOLD steps
REC_HOLD = 2
REC_CPU_ROWS = 3  # 13a: rows held against the port's CPU run of the same steps
REC_KKT_TOL = 1e-3 * INC_EPS  # 13a: kkt_res card vs CPU, three orders under the solve's eps
REC_WARMUP_REPS = 2  # 13b: untimed repeats before the timed ones
REC_WARM_REPS = 6  # 13b: interleaved repeats of the 5 warm steps
REC_HELD_STEPS = 10  # 13b: held steps per repeat
REC_HELD_REPS = 4
REC_COST_CALLS = 50  # 13b: timed appends per estimate of the recorder's own cost
OVERHEAD_BAR = 1.05  # 13b: a recorded warm step over an unrecorded one
REC_H2D = 1  # 13c: host-to-device copies a recorded step adds (the staged gauges)
REC_FLEET_STEPS = 3  # 13d
REC_SIM_STEPS = 20  # 13d
REC_REPLAYS = 5  # 13e
REC_INT_FIELDS = ("step", "restarts", "iterations", "iter_p1", "iter_p2", "iter_p3", "tier",
                  "skipped", "converged", "certified", "truncated")


def _int_rows_equal(tag, g, w, fields=REC_INT_FIELDS) -> None:
    """The integer ``fields`` of two flushes' rows equal."""
    if g.shape != w.shape:
        raise AssertionError(f"{tag}: {g.shape[0]} rows against {w.shape[0]}")
    for name in fields:
        j = obs_recorder.FIELDS.index(name)
        if not np.array_equal(g[:, j], w[:, j]):
            raise AssertionError(f"{tag}: {name} {g[:, j].tolist()} != {w[:, j].tolist()}")


# 13c: CUDA runtime calls that put work on the card's queue
_ENQUEUE_CALL = re.compile(r"^cu(da)?(Launch|Memcpy|Memset|GraphLaunch)")


def _copies_by_direction():
    """A dispatch mode that counts the copies ATen makes between the host
    and the card: ``h2d`` (a host tensor into a card result) and ``d2h`` (a
    card tensor into a host result, or read as a Python number)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    copies = (torch.ops.aten.copy_.default, torch.ops.aten._to_copy.default)
    reads = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.equal.default)

    class CopyCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.h2d = self.d2h = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            on_card = any(t.is_cuda for t in ins)
            if on_card and (func in reads or any(not t.is_cuda for t in outs)):
                self.d2h += 1
            elif any(t.is_cuda for t in outs) and any(
                    not t.is_cuda and (func in copies or t.dim() > 0) for t in ins):
                self.h2d += 1  # a 0-dim host operand of a card op is passed by value
            return out

    return CopyCount()


def _host_reads(step) -> dict:
    """Device-to-host and host-to-device copies of ``step()`` as ATen makes
    them (:func:`_copies_by_direction`), and its synchronizations and device
    launches as the CUDA runtime calls that torch.profiler records on the
    host (one device synchronize after it, the same for every step
    profiled).  The card's own activity records are not read: on the H100
    a trace drops some of them, from none to all, between one step and the
    next."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with _copies_by_direction() as copies:
            step()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    return {
        "d2h": copies.d2h,
        "syncs": sum("Synchronize" in n for n in names),
        "h2d": copies.h2d,
        "launches": sum(bool(_ENQUEUE_CALL.match(n)) for n in names),
    }


def _best_walls(engines, powers, reps: int) -> list[float]:
    """Per-step minimum walls (s) of each engine over ``reps`` repeats of
    ``powers``, summed (``benchmarks/obs_bench.py``'s estimator), after
    ``REC_WARMUP_REPS`` untimed repeats.  The engines take turns at every step, in an
    order that flips each repeat, so that a drift of the host's speed during
    the run falls on all of them; Python's garbage collector runs between
    repeats, not inside a timed step (as ``timeit`` keeps it out); every
    step ends in a copy to the host."""
    best = [np.full(len(powers), np.inf) for _ in engines]
    try:
        for rep in range(REC_WARMUP_REPS + reps):
            gc.collect()
            gc.disable()
            order = list(range(len(engines)))
            if rep % 2:
                order.reverse()
            for i, p in enumerate(powers):
                for e in order:
                    t0 = time.perf_counter()
                    engines[e].step(p)
                    if rep >= REC_WARMUP_REPS:
                        best[e][i] = min(best[e][i], time.perf_counter() - t0)
            gc.enable()
    finally:
        gc.enable()
    return [float(b.sum()) for b in best]


def _draw_step(rng, n: int, cuda):
    """One step's solver stats (counts and flags host values, the residual
    and the in-loop histogram on the card), allocation and request, drawn
    so that every tier and flag comes up."""
    stats = {k: int(rng.integers(0, 500)) for k in
             ("restarts", "iterations", "iterations_p1", "iterations_p2", "iterations_p3")}
    stats.update({k: bool(rng.random() < 0.5) for k in
                  ("skipped", "certify_pass", "converged", "kkt_certified", "truncated")})
    stats["kkt_res"] = torch.tensor(10.0 ** rng.uniform(-14, 2), device=cuda)
    stats["kkt_hist"] = torch.as_tensor(rng.integers(0, 9, KKT_HIST_BUCKETS).astype(np.int32),
                                        device=cuda)
    alloc = torch.as_tensor(rng.uniform(100.0, 700.0, n), device=cuda)
    r = torch.as_tensor(rng.uniform(0.0, 800.0, n), device=cuda)
    return stats, alloc, r


def _record_cost(eng, cuda) -> float:
    """The least wall (s) over ``REC_COST_CALLS`` calls of the append that
    ``eng``'s step makes (``_engine_solve``'s ``torch.where`` and
    ``obs.recorder.record`` on its fleet), each from an idle card to the
    end of its launches on the card: the recorder's own cost per step,
    host and device, apart from the step it rides on."""
    cfg = eng.recorder_config
    st = obs_recorder.init_state(cfg, eng.n, device=cuda)
    stats, x, r = _draw_step(np.random.default_rng(0), eng.n, cuda)
    active = r > 50.0
    best = np.inf
    for _ in range(REC_COST_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs_recorder.record(cfg, st, stats, x, torch.where(active, r, 0.0), eng.fleet.sla)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def recorder_graph_replay(n: int, cuda) -> dict:
    """13e: one ``record_step`` captured in a CUDA graph, its gauges staged
    in static buffers, replayed ``REC_REPLAYS`` times with new values copied
    in before each replay, against as many eager calls on the same values:
    the ring, the counters, the histograms, the step and the last
    allocation must be the same bits."""
    cfg = obs_recorder.RecorderConfig(capacity=4)  # the replays wrap the ring
    m = obs_recorder.static_metrics(cfg, device=cuda)
    alloc = torch.zeros(n, dtype=torch.float64, device=cuda)
    eager = obs_recorder.init_state(cfg, n, device=cuda)
    graphed = obs_recorder.init_state(cfg, n, device=cuda)
    scratch = obs_recorder.init_state(cfg, n, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            obs_recorder.record_step(cfg, scratch, m, alloc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        obs_recorder.record_step(cfg, graphed, m, alloc)
    rng = np.random.default_rng(13)
    for _ in range(REC_REPLAYS):
        stats, a, r = _draw_step(rng, n, cuda)
        margin = torch.tensor(rng.normal(0.0, 50.0), dtype=torch.float64, device=cuda)
        step = obs_recorder.step_metrics(stats, a, r, margin)
        obs_recorder.copy_metrics(m, step)
        alloc.copy_(a)
        graph.replay()
        obs_recorder.record_step(cfg, eager, step, a)
    torch.cuda.synchronize()
    leaves = ("step", "ring", "hists", "solver_hist", "counters", "last_alloc")
    differ = [k for k in leaves if not torch.equal(getattr(graphed, k), getattr(eager, k))]
    if differ:
        raise AssertionError(f"[13e] graph replays differ from eager calls in {differ}")
    if int(graphed.step) != REC_REPLAYS:
        raise AssertionError(f"[13e] {int(graphed.step)} rows after {REC_REPLAYS} replays")
    return {"replays": REC_REPLAYS, "capacity": cfg.capacity, "same_bits": leaves}


def recorder_phase(pdn, layout, engine_opts, cuda, smi, out_dir=None) -> tuple[dict, dict]:
    """Phase 13: the flight recorder on the card.  Returns (each allocator
    kernel's launches over 13a's recorded steps, report).

    (a) An incremental ``AllocEngine(build_datacenter(), recorder=True)`` at
    eps 1e-9 with every kernel flag over ``REC_SAMPLES`` ``TelemetrySim``
    seed 0 samples, each held ``REC_HOLD`` steps: every row against the host
    oracle from the returned results, a held step's launches the certify
    pass's alone, the first ``REC_CPU_ROWS`` rows against the port's CPU run
    (integer fields and the three histograms equal, float fields within
    phase 4's per-device bar, times n where the field sums over devices);
    then a cold Appendix B step through ``PowerController(recorder=True)``,
    whose SLA margin is finite, >= -1e-6 W and the host's recomputation
    from the allocation, and the margin alone one ``sla_matvec`` launch.
    (b) The overhead: the recorder's own cost per step
    (:func:`_record_cost`, measured twice) over an unrecorded warm step's
    wall, bar ``OVERHEAD_BAR``, and over a held step's (reported); beside
    it, reported, the whole-step ratio of recording and unrecorded engines
    on the same telemetry, per-step minimum over interleaved repeats, with
    a second unrecorded engine's (A/A).  (c) A recorded and an
    unrecorded step of each kind (solved, held), counted by
    :func:`_host_reads`: the same
    device-to-host copies and synchronizations, ``REC_H2D`` more
    host-to-device copies, and the same added launches on both kinds.
    (d) ``what_if`` of ``WHATIF_K`` samples, recorded, each lane against
    its one-lane flight; a stacked fleet against the loop mode's
    per-domain flights; ``DatacenterSim`` recording ``REC_SIM_STEPS``
    intervals, its flight through ``write_jsonl`` and the report CLI.  (e)
    :func:`recorder_graph_replay`."""
    out_dir = Path(out_dir or ROOT / "artifacts" / "chip_smoke")
    out_dir.mkdir(parents=True, exist_ok=True)
    report: dict = {"card": smi}
    opts = engine_opts._replace(eps_abs=INC_EPS, eps_rel=INC_EPS)
    inc_opts = NvpaxOptions(incremental=True, solver=opts)
    sim = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0))
    samples = [sim.power(t) for t in range(max(REC_SAMPLES + 1, WHATIF_K))]
    tele = [samples[t // REC_HOLD] for t in range(REC_SAMPLES * REC_HOLD)]
    n = pdn.n

    # (a) the engine on the paper fleet
    log(f"[13a] AllocEngine(recorder=True) on n={n}, incremental at eps {INC_EPS:g}, every "
        f"kernel flag; {len(tele)} steps of TelemetrySim seed 0 samples 0-{REC_SAMPLES - 1}, "
        f"each held {REC_HOLD} steps")
    eng = AllocEngine(pdn, options=inc_opts, recorder=True, device=cuda)
    rec_launches: dict[str, int] = {}
    results, early = [], None
    for t, p in enumerate(tele):
        kernels.reset_launch_counts()
        res = eng.step(p)
        calls = _kernel_calls(kernels.launch_counts())
        for key, v in calls.items():
            rec_launches[key] = rec_launches.get(key, 0) + v
        if res.stats["skipped"]:
            _check_certify_only("13a", calls, tenants=False, pdn=pdn)
        results.append(res)
        if t == REC_CPU_ROWS - 1:
            early = eng.flush_recorder()["step"]  # not reset: the steps go on
    flight = eng.flush_recorder()["step"]
    rows = obs_recorder.rows_as_dicts(flight)
    if len(rows) != len(tele) or flight["counters"]["n_steps"] != len(tele):
        raise AssertionError(f"[13a] {len(rows)} rows for {len(tele)} steps")
    for t, (row, res) in enumerate(zip(rows, results)):
        x = res.allocation
        move = 0.0 if t == 0 else float(np.max(np.abs(x - results[t - 1].allocation)))
        want = {"step": t, "iterations": res.stats["total_iterations"],
                "skipped": int(res.stats["skipped"]), "converged": int(res.stats["converged"])}
        bad = {k: (row[k], v) for k, v in want.items() if row[k] != v}
        if abs(row["alloc_W"] - float(x.sum())) > 1e-9 * abs(float(x.sum())):
            bad["alloc_W"] = (row["alloc_W"], float(x.sum()))
        if abs(row["grant_move"] - move) > 1e-9 * max(move, 1e-3):
            bad["grant_move"] = (row["grant_move"], move)
        if bad:
            raise AssertionError(f"[13a] row {t} against the host oracle: {bad}")
    tiers = [r["tier"] for r in rows]
    if 0 not in tiers or 2 not in tiers:
        raise AssertionError(f"[13a] tiers {tiers}: want both solved (0) and held (2) rows")
    cpu = AllocEngine(pdn, options=inc_opts, recorder=True, device="cpu")
    for p in tele[:REC_CPU_ROWS]:
        cpu.step(p)
    cpu_flight = cpu.flush_recorder()["step"]
    _int_rows_equal("[13a] card vs CPU", early["rows"], cpu_flight["rows"])
    # a held step is its anchor through the exact repair: 0 W from it on the
    # card, ~1e-10 W on the CPU, whose tree sums add in another order; so
    # grant movements under phase 4's per-device bar count as one bucket
    sub_bar = int(np.log10(PARITY_TOL)) - early["hist_lo_exp"]
    for key in ("hist_kkt", "hist_move", "solver_hist"):
        g, w = early[key], cpu_flight[key]
        if key == "hist_move":
            g = np.concatenate([[g[:sub_bar].sum()], g[sub_bar:]])
            w = np.concatenate([[w[:sub_bar].sum()], w[sub_bar:]])
        if not np.array_equal(g, w):
            raise AssertionError(f"[13a] card vs CPU {key}: {early[key].tolist()} != "
                                 f"{cpu_flight[key].tolist()}")
    r_eff = [np.where(p >= eng.idle_threshold, np.clip(p, pdn.dev_l, pdn.dev_u), 0.0)
             for p in tele[:REC_CPU_ROWS]]
    bars = {"kkt_res": REC_KKT_TOL, "grant_move": 2 * PARITY_TOL, "alloc_W": n * PARITY_TOL}
    gaps = {}
    for name in ("kkt_res", "sla_min_margin", "satisfaction", "grant_move", "alloc_W"):
        j = obs_recorder.FIELDS.index(name)
        g, w = early["rows"][:, j], cpu_flight["rows"][:, j]
        with np.errstate(invalid="ignore"):  # equal infinities: no tenant rows
            d = np.where(g == w, 0.0, np.abs(g - w))
        gaps[name] = float(d.max())
        bar = (np.array([n * PARITY_TOL / r.sum() for r in r_eff]) if name == "satisfaction"
               else bars.get(name, 0.0))
        if not (d <= bar).all():
            raise AssertionError(f"[13a] card vs CPU {name}: |d| {d.tolist()} > {bar}")
    log(f"[13a] {len(rows)} rows, tiers {tiers}, iterations "
        f"{[r['iterations'] for r in rows]}; every row the host oracle's (step, iterations, "
        f"skipped, converged, alloc_W, grant_move); held steps launched the certify pass "
        f"alone; rows 0-{REC_CPU_ROWS - 1} against the CPU: integer fields, hist_kkt and "
        f"solver_hist equal, hist_move {early['hist_move'].tolist()} (CPU "
        f"{cpu_flight['hist_move'].tolist()}, equal from 1e-6 W up), float fields |d| {gaps}")
    # a cold tenant step through the controller: the SLA margin
    ctl = PowerController(pdn, sla=layout.sla_topo(device=cuda), priority=layout.priority,
                          config=ControllerConfig(options=NvpaxOptions(solver=engine_opts)),
                          recorder=True, device=cuda)
    kernels.reset_launch_counts()
    tres = ctl.step(samples[0])
    for key, v in _kernel_calls(kernels.launch_counts()).items():
        rec_launches[key] = rec_launches.get(key, 0) + v
    (trow,) = obs_recorder.rows_as_dicts(ctl.flush_recorder()["step"])
    dev = np.nonzero(layout.tenant_of >= 0)[0]
    sums = np.bincount(layout.tenant_of[dev], weights=tres.allocation[dev],
                       minlength=layout.n_tenants)
    host_margin = float(np.min(sums - layout.b_min))
    margin_gap = abs(trow["sla_min_margin"] - host_margin)
    if not (np.isfinite(trow["sla_min_margin"]) and trow["sla_min_margin"] >= -SLA_FEAS_TOL
            and margin_gap <= SLA_FEAS_TOL):
        raise AssertionError(f"[13a] tenant step margin {trow['sla_min_margin']} W, host "
                             f"{host_margin} W")
    x_dev = torch.as_tensor(tres.allocation, device=cuda)
    kernels.reset_launch_counts()
    obs_recorder.sla_min_margin(x_dev, ctl._engine.fleet.sla)
    margin_calls = _kernel_calls(kernels.launch_counts())
    if margin_calls != {"sla_matvec": 1}:
        raise AssertionError(f"[13a] the SLA margin launched {margin_calls}, not one sla_matvec")
    missing = [k for k in ALLOCATOR_KERNELS if not rec_launches.get(k)]
    if missing:
        raise AssertionError(f"[13a] kernels never launched while recording: {missing}")
    log(f"[13a] cold Appendix B step through PowerController(recorder=True): SLA margin "
        f"{trow['sla_min_margin']:.6f} W (host {host_margin:.6f} W, |d| {margin_gap:.2e}), tier "
        f"{trow['tier']}, iterations {trow['iterations']}; the margin alone {margin_calls}; "
        f"launches over 13a {rec_launches}")
    report["engine"] = {"rows": rows, "cpu_gaps": gaps, "tenant_row": trow,
                        "tenant_host_margin": host_margin, "launches": rec_launches}

    # (b) the overhead: gated on the recorder's own cost over an unrecorded
    # step; the whole-step ratio is reported beside two unrecorded engines'
    plain = NvpaxOptions(solver=engine_opts)
    base = AllocEngine(pdn, options=plain, device=cuda)
    base2 = AllocEngine(pdn, options=plain, device=cuda)
    rec = AllocEngine(pdn, options=plain, recorder=True, device=cuda)
    warm = samples[:REC_SAMPLES]
    for e in (base, base2, rec):
        e.step(samples[REC_SAMPLES])
        e.step(warm[0])
    cost_a = _record_cost(rec, cuda)
    base_s, base2_s, rec_s = _best_walls([base, base2, rec], warm, REC_WARM_REPS)
    cost_b = _record_cost(rec, cuda)
    inc_base = AllocEngine(pdn, options=inc_opts, device=cuda)
    inc_rec = AllocEngine(pdn, options=inc_opts, recorder=True, device=cuda)
    held = [samples[0]] * REC_HELD_STEPS
    for e in (inc_base, inc_rec):
        e.step(samples[0])
        if not e.step(samples[0]).stats["skipped"]:
            raise AssertionError("[13b] a repeated step did not skip")
    hbase_s, hrec_s = _best_walls([inc_base, inc_rec], held, REC_HELD_REPS)
    step_s, hstep_s = base_s / len(warm), hbase_s / REC_HELD_STEPS
    cost_ratios = [1.0 + c / step_s for c in (cost_a, cost_b)]
    warm_ratio, aa_ratio, held_ratio = rec_s / base_s, base2_s / base_s, hrec_s / hbase_s
    held_cost_ratio = 1.0 + max(cost_a, cost_b) / hstep_s
    log(f"[13b] the recorder's own cost per step {cost_a * 1e3:.3f} / {cost_b * 1e3:.3f} ms "
        f"(before / after the walls; least of {REC_COST_CALLS} appends, each to the card's "
        f"end) on an unrecorded warm step of {step_s * 1e3:.1f} ms: "
        f"{cost_ratios[0]:.4f}x / {cost_ratios[1]:.4f}x (bar {OVERHEAD_BAR}x); a held step of "
        f"{hstep_s * 1e3:.2f} ms: {held_cost_ratio:.4f}x (reported); on {smi}")
    log(f"[13b] whole steps, per-step minimum over {REC_WARM_REPS} interleaved repeats "
        f"(reported): {len(warm)} warm steps {rec_s * 1e3:.1f} ms recorded / "
        f"{base_s * 1e3:.1f} ms unrecorded = {warm_ratio:.4f}x, a second unrecorded engine "
        f"{base2_s * 1e3:.1f} ms = {aa_ratio:.4f}x (A/A); {REC_HELD_STEPS} held steps "
        f"{hrec_s * 1e3:.2f} / {hbase_s * 1e3:.2f} ms = {held_ratio:.4f}x "
        f"({REC_HELD_REPS} repeats)")
    if max(cost_ratios) > OVERHEAD_BAR:
        raise AssertionError(f"[13b] recording costs {max(cost_ratios):.4f}x a warm step, "
                             f"over {OVERHEAD_BAR}x")
    report["overhead"] = {"record_cost_ms": [cost_a * 1e3, cost_b * 1e3],
                          "warm_step_ms": step_s * 1e3, "warm_cost_ratio": cost_ratios,
                          "held_step_ms": hstep_s * 1e3, "held_cost_ratio": held_cost_ratio,
                          "warm_steps": len(warm), "warm_recorded_ms": rec_s * 1e3,
                          "warm_unrecorded_ms": base_s * 1e3,
                          "warm_unrecorded2_ms": base2_s * 1e3, "warm_ratio": warm_ratio,
                          "warm_aa_ratio": aa_ratio, "held_steps": REC_HELD_STEPS,
                          "held_recorded_ms": hrec_s * 1e3, "held_unrecorded_ms": hbase_s * 1e3,
                          "held_ratio": held_ratio, "warm_reps": REC_WARM_REPS,
                          "held_reps": REC_HELD_REPS, "cost_calls": REC_COST_CALLS}

    # (c) no host read
    reads = {
        "solved": (_host_reads(lambda: base.step(samples[REC_SAMPLES])),
                   _host_reads(lambda: rec.step(samples[REC_SAMPLES]))),
        "held": (_host_reads(lambda: inc_base.step(samples[0])),
                 _host_reads(lambda: inc_rec.step(samples[0]))),
    }
    added = {kind: on["launches"] - off["launches"] for kind, (off, on) in reads.items()}
    for kind, (off, on) in reads.items():
        if off["syncs"] == 0 or off["d2h"] == 0:
            raise AssertionError(f"[13c] no synchronization or no device-to-host copy seen in "
                                 f"an unrecorded {kind} step: {off}")
        if (on["d2h"], on["syncs"]) != (off["d2h"], off["syncs"]):
            raise AssertionError(f"[13c] a recorded {kind} step reads the device back: {on} "
                                 f"against {off} unrecorded")
        if on["h2d"] - off["h2d"] != REC_H2D:
            raise AssertionError(f"[13c] a recorded {kind} step adds {on['h2d'] - off['h2d']} "
                                 f"host-to-device copies, not {REC_H2D}")
        log(f"[13c] {kind} step: device-to-host copies {on['d2h']} recorded / {off['d2h']} "
            f"unrecorded, synchronizations {on['syncs']} / {off['syncs']}; recording adds "
            f"{on['launches'] - off['launches']} launch calls ({on['launches']} / "
            f"{off['launches']}) and {on['h2d'] - off['h2d']} host-to-device copies")
    if len(set(added.values())) != 1:
        raise AssertionError(f"[13c] the launches recording adds differ by step kind: {added}")
    report["host_reads"] = {k: {"recorded": on, "unrecorded": off, "added_launches": added[k]}
                            for k, (off, on) in reads.items()}

    # (d) lanes, the fleet and the report CLI
    config = ControllerConfig(options=NvpaxOptions(solver=engine_opts))
    wctl = PowerController(pdn, config=config, recorder=True, device=cuda)
    wctl.what_if(np.stack(samples[:WHATIF_K]))
    for j in range(WHATIF_K):
        wctl.what_if(np.stack(samples[j:j + 1]))
    batched = wctl.flush_recorder()["batched"]
    ones = batched[1][0]["rows"]  # one row per one-lane call, its step counts the calls
    ia = obs_recorder.FIELDS.index("alloc_W")
    lane_gap = 0.0
    for j, lane in enumerate(batched[WHATIF_K]):
        _int_rows_equal(f"[13d] what_if lane {j}", lane["rows"], ones[j:j + 1],
                        REC_INT_FIELDS[1:])
        gap = abs(float(lane["rows"][0, ia] - ones[j, ia]))
        lane_gap = max(lane_gap, gap)
        if gap > SKIP_TOL * n:
            raise AssertionError(f"[13d] what_if lane {j}: alloc_W {gap:.3e} W off its "
                                 f"one-lane flight")
    fleet_opts = NvpaxOptions(solver=engine_opts)
    fl = {}
    for mode in ("stacked", "loop"):
        orch = FleetOrchestrator(pdn, level=1, mode=mode, options=fleet_opts, recorder=True,
                                 device=cuda)
        for t in range(REC_FLEET_STEPS):
            orch.step(samples[t], active=sim.active_mask(t))
        fl[mode] = orch.flush_recorder()
    if len(fl["stacked"]["lanes"]) != 4:
        raise AssertionError(f"[13d] {len(fl['stacked']['lanes'])} stacked lanes, not 4")
    for k, (a, b) in enumerate(zip(fl["stacked"]["lanes"], fl["loop"]["lanes"])):
        _int_rows_equal(f"[13d] fleet domain {k}, stacked vs loop", a["rows"], b["rows"])
    dsim = DatacenterSim.build(pdn, seed=0, recorder=True, device=cuda)
    out = dsim.run(REC_SIM_STEPS, baselines=False)
    rows_sim = flight_rows(dsim.flush_flight()["step"], walls_ms=out["wall_ms"])
    path = out_dir / "flight.jsonl"
    write_jsonl(str(path), rows_sim)
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(path), "--prom",
         str(out_dir / "flight.prom")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    prom = (out_dir / "flight.prom").read_text() if cli.returncode == 0 else ""
    if (cli.returncode != 0 or f"flight record: {REC_SIM_STEPS} steps" not in cli.stdout
            or f"repro_steps_total {REC_SIM_STEPS}\n" not in prom):
        raise AssertionError(f"[13d] report CLI rc {cli.returncode}: {cli.stdout[-500:]} "
                             f"{cli.stderr[-500:]}")
    log(f"[13d] what_if of {WHATIF_K} samples recorded: each lane's row the integer fields of "
        f"its one-lane flight, alloc_W within {lane_gap:.2e} W; stacked fleet of 4 halls, "
        f"{REC_FLEET_STEPS} steps: each domain's integer fields those of loop mode's flight; "
        f"DatacenterSim {REC_SIM_STEPS} intervals recorded through write_jsonl and "
        f"python -m repro_torch.obs.report:")
    for line in cli.stdout.splitlines():
        log(f"[13d]   {line}")
    report["lanes_fleet_cli"] = {"what_if_alloc_gap_w": lane_gap, "report": cli.stdout,
                                 "prom": prom}

    # (e) ready for a CUDA graph
    report["graph"] = recorder_graph_replay(n, cuda)
    log(f"[13e] record_step captured in a CUDA graph (gauges in static buffers), replayed "
        f"{REC_REPLAYS} times: the bits of {REC_REPLAYS} eager calls in "
        f"{report['graph']['same_bits']}")
    return rec_launches, report


# -- phase 14: the sharded fleet dispatch ---------------------------------------

SHARD_RANKS = 4  # 14b: gloo ranks on the one card, one hall each
SHARD_JOIN_S = 300  # 14b: seconds before a rank that has not finished fails the phase
SHARD_REC_STEPS = 3  # 14d: recorded steps
EXAMPLE_TIMEOUT_S = 300  # 14e: each example script
# 14b: watts per device of useful power, min(request, cap), between a one-lane
# and a four-lane cold step of the ε-degenerate tenant fleet on the card: 5x
# the reference's own wander between identical tenant re-solves (2e-4 W,
# ROADMAP Queue 3); the four-lane step on the card is 1.2e-4 W off the CPU's
USEFUL_DEGENERATE_TOL = 1e-3
# 12f, 14b: watts of a hall's grant a cold tenant fleet step may leave
# unallocated (grant - the hall's allocation sum).  The eps-degenerate max-min
# rounds stop when a constant row's dual, grown from the rounding of its
# folded bound, inflates the KKT scales: on the H100 the one-lane order of
# the plain tree and lane sums leaves at most 237 W and the CPU's stacked
# step 177 W, other summation orders 42-44 kW of hall 2's.  The bar holds
# that order (each lane's bits whatever K), not convergence.
UNALLOCATED_TOL = 250.0


def _fleet_samples(pdn, steps: int = FLEET_STEPS):
    """Phase 12b's telemetry: ``TelemetrySim`` seed 0 and the scheduler's masks."""
    sim = TelemetrySim(TraceConfig(n_devices=pdn.n, seed=0))
    return [sim.power(t) for t in range(steps)], [sim.active_mask(t) for t in range(steps)]


def _wall_spread(walls) -> dict:
    ms = np.asarray(walls) * 1e3
    return {"median_ms": float(np.median(ms)), "min_ms": float(ms.min()),
            "max_ms": float(ms.max()), "walls_ms": ms.tolist()}


def _fmt_walls(w: dict) -> str:
    return f"median {w['median_ms']:.1f} ms (min {w['min_ms']:.1f}, max {w['max_ms']:.1f})"


def shard_rank_main(rank: int, out_dir: Path) -> int:
    """One rank of phase 14b (``--shard-rank``): a gloo group of
    ``SHARD_RANKS`` over a ``FileStore`` in ``out_dir``, holding one hall of
    the paper's datacenter on the card.  Runs 14a's steps with the flight
    recorder on and flushes it, then one cold step of phase 12f's tenant
    fleet, and writes what it saw to ``out_dir/rank<rank>.npz`` and
    ``.json``.  The parent has built the kernels."""
    import datetime

    import torch.distributed as dist

    from repro_torch.fleet import sharded as shd

    dist.init_process_group("gloo", store=dist.FileStore(str(out_dir / "store"), SHARD_RANKS),
                            rank=rank, world_size=SHARD_RANKS,
                            timeout=datetime.timedelta(seconds=60))
    try:
        cuda = torch.device("cuda")
        _build.library()
        pdn = build_datacenter()
        opts = NvpaxOptions(solver=SolverOptions(use_pallas=True, use_pallas_tree=True,
                                                 use_pallas_stats=True))
        samples, actives = _fleet_samples(pdn)
        orch = FleetOrchestrator(pdn, level=1, mode="sharded", options=opts, recorder=True,
                                 device=cuda)
        lay = orch._shard
        arrays: dict = {}
        info: dict = {"layout": [lay.backend, lay.world, lay.shards, lay.lo, lay.hi],
                      "collectives": [], "walls_s": []}
        sync(cuda)
        kernels.reset_launch_counts()
        for t, (tele, act) in enumerate(zip(samples, actives)):
            shd.COLLECTIVES.clear()
            t0 = time.perf_counter()
            res = orch.step(tele, active=act)
            info["walls_s"].append(time.perf_counter() - t0)
            info["collectives"].append(dict(shd.COLLECTIVES))
            arrays[f"alloc{t}"] = res.allocation
            arrays[f"grants{t}"] = res.grants
            arrays[f"iters{t}"] = res.stats["phase_iterations"]
        info["launches"] = dict(kernels.launch_counts())
        shd.COLLECTIVES.clear()
        arrays["flight"] = np.stack([lane["rows"] for lane in orch.flush_recorder()["lanes"]])
        info["flush_collectives"] = dict(shd.COLLECTIVES)
        del orch
        layout = appendix_b_layout(pdn, seed=0)
        torch_orch = FleetOrchestrator(pdn, level=1, tenants=layout, mode="sharded",
                                       options=opts, device=cuda)
        sync(cuda)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = torch_orch.step(samples[0], active=actives[0])
        info["tenant_wall_s"] = time.perf_counter() - t0
        info["tenant_launches"] = dict(kernels.launch_counts())
        info["tenant_iterations"] = res.stats["phase_iterations"].tolist()
        arrays["tenant_alloc"] = res.allocation
        arrays["tenant_grants"] = res.grants
        arrays["tenant_slice_hi"] = res.stats["slice_hi"]
        np.savez(out_dir / f"rank{rank}.npz", **arrays)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()
    return 0


def _spawn_ranks(flag: str, n: int, rank_dir: Path, join_s: float, tag: str) -> None:
    """``n`` ranks of this script (``flag r --out rank_dir``), spawned at
    once into a fresh ``rank_dir``; each must exit 0 within ``join_s`` (all
    are killed otherwise)."""
    if rank_dir.exists():
        shutil.rmtree(rank_dir)
    rank_dir.mkdir(parents=True)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(r), "--out", str(rank_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]
    deadline = time.monotonic() + join_s
    failed = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}: {out[-3000:]}")
    except subprocess.TimeoutExpired:
        failed.append(f"a rank did not finish in {join_s} s (a hung collective?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError(f"[{tag}] " + "\n".join(failed))


def _flights_match(tag, got: list, want: list, rows: int) -> float:
    """Lane by lane, the first ``rows`` flight rows: integer fields equal,
    ``alloc_W`` within ``FLEET_MONO_TOL``; the largest ``alloc_W`` gap."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} lanes against {len(want)}")
    i_alloc = obs_recorder.FIELDS.index("alloc_W")
    ints = [obs_recorder.FIELDS.index(f) for f in REC_INT_FIELDS]
    gap = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g)[:rows], np.asarray(w)[:rows]
        if g.shape != w.shape or not np.array_equal(g[:, ints], w[:, ints]):
            raise AssertionError(f"{tag}: lane {k}'s integer fields differ")
        gap = max(gap, float(np.max(np.abs(g[:, i_alloc] - w[:, i_alloc]))))
    if gap > FLEET_MONO_TOL:
        raise AssertionError(f"{tag}: alloc_W {gap:.3e} W apart")
    return gap


def sharded_phase(pdn, layout, engine_opts, cuda, smi, out_dir) -> tuple[dict, dict, dict]:
    """Phase 14: the sharded fleet dispatch.  Returns (each allocator
    kernel's launches over 14a's sharded steps, the four ranks' launches
    over 14b's steps, report).

    (a) ``FleetOrchestrator(build_datacenter(), level=1, mode="sharded")``
    at one NCCL rank with every kernel flag, 12b's ``FLEET_STEPS`` steps,
    against stacked mode on the card (``FLEET_MONO_TOL`` W, equal
    iterations, every row kept), one all-reduce and one all-gather a step,
    the walls of both and the device launches of a cold step of each
    (torch.profiler); the coordinator tree's ``tree_matvec`` at K = 4
    against its plain version.  (d) 14a's fleet with the flight recorder
    for ``SHARD_REC_STEPS`` steps, sharded and stacked: equal integer fields,
    ``alloc_W`` within ``FLEET_MONO_TOL``.  (b) ``SHARD_RANKS`` gloo ranks
    on the one card (:func:`shard_rank_main`), one hall each: every rank's
    allocations within ``FLEET_MONO_TOL`` of 14a's and its grants the
    others' bits, the lanes gathered only at the flush and equal to (d)'s,
    then one cold step of 12f's tenant fleet held to the stacked step on
    the card by :func:`tenant_fleet_quality` and to the same step at one
    NCCL rank bit for bit (one lane a rank, four at one rank); that stacked
    step and the one NCCL rank's leave at most ``UNALLOCATED_TOL`` of any
    hall's grant unallocated.  (c) churn on 14a's two
    orchestrators: a derated domain, a feed scale, a leave and a join; no
    rebuild, every step feasible and the two modes within
    ``FLEET_MONO_TOL``.  (e) the example twins on the card."""
    from repro_torch.fleet import sharded as shd

    report: dict = {"card": smi}
    opts = NvpaxOptions(solver=engine_opts)
    samples, actives = _fleet_samples(pdn)
    path = ("tree_matvec", "tree_rmatvec", "primal_step", "dual_update", "check_chunk_stats")

    def drive(orch):
        out, walls = [], []
        for tele, act in zip(samples, actives):
            sync(cuda)
            t0 = time.perf_counter()
            out.append(orch.step(tele, active=act))
            walls.append(time.perf_counter() - t0)
        return out, walls

    def against(tag, got, want, iterations=True):
        gap = max(float(np.max(np.abs(got.allocation - want.allocation))),
                  float(np.max(np.abs(got.grants - want.grants))))
        same = np.array_equal(got.stats["phase_iterations"], want.stats["phase_iterations"])
        if gap > FLEET_MONO_TOL or (iterations and not same):
            raise AssertionError(f"{tag}: {gap:.3e} W apart, iterations "
                                 f"{got.stats['phase_iterations'].tolist()} against "
                                 f"{want.stats['phase_iterations'].tolist()}")
        return gap

    # (a) one NCCL rank against stacked mode; the launch counts are set to 0
    # just before the sharded steps and read just after
    stacked = FleetOrchestrator(pdn, level=1, mode="stacked", options=opts, device=cuda)
    res_s, walls_s = drive(stacked)
    sharded = FleetOrchestrator(pdn, level=1, mode="sharded", options=opts, device=cuda)
    lay = sharded._shard
    if (lay.backend, lay.world, lay.shards) != ("nccl", 1, 1) or sharded.rebuild_count() != 1:
        raise AssertionError(f"[14a] group {lay.backend} of {lay.world}, {lay.shards} shards, "
                             f"{sharded.rebuild_count()} builds")
    sync(cuda)
    kernels.reset_launch_counts()
    shd.COLLECTIVES.clear()
    res_h, walls_h = drive(sharded)
    sync(cuda)
    launches = dict(kernels.launch_counts())
    lanes = dict(kernels.lane_launch_counts())
    coll = dict(shd.COLLECTIVES)
    # every kernel of the path over the lanes; the tree kernels also on the
    # coordinator tree (the replicated water-fills, one vector)
    missing = [k for k in path if not lanes[k]]
    if missing or coll != {"all_reduce": FLEET_STEPS, "all_gather": FLEET_STEPS}:
        raise AssertionError(f"[14a] collectives {coll} in {FLEET_STEPS} steps; kernels not "
                             f"launched over the lanes: {missing} ({_kernel_calls(launches)})")
    plan_launches = {k: launches[k] - lanes[k] for k in path if launches[k] != lanes[k]}
    gaps = []
    for t, (h, s) in enumerate(zip(res_h, res_s)):
        gaps.append(against(f"[14a] step {t}", h, s))
        _fleet_feasible(sharded, h.allocation, h.grants)
        if not h.stats["converged"].all():
            raise AssertionError(f"[14a] step {t}: not converged")
    sharded.reset_warm()
    stacked.reset_warm()
    prof_h = profiled("one cold sharded step, one NCCL rank (14a)",
                      lambda: slowest_lane_step(sharded, samples[0], actives[0]))
    prof_s = profiled("the same step stacked (14a)",
                      lambda: slowest_lane_step(stacked, samples[0], actives[0]))
    gen = torch.Generator(device=cuda).manual_seed(14)
    ctree = sharded._ctree
    x = torch.rand(sharded.k, generator=gen, dtype=torch.float64, device=cuda) * 1e6
    got = tk.tree_matvec(x, ctree.index)
    want = tref.tree_matvec_ref(x, ctree.start, ctree.end)
    ctree_err = float((got - want).abs().max())
    if ctree_err > TREE_TOL["float64"] * float(x.abs().sum()):
        raise AssertionError(f"[14a] tree_matvec at K = {sharded.k}: {ctree_err:.3e} off plain")
    w_h, w_s = _wall_spread(walls_h), _wall_spread(walls_s)
    iters = [r.stats["phase_iterations"].tolist() for r in res_h]
    log(f"[14a] sharded fleet at one NCCL rank (K = {sharded.k} halls as the lanes of one "
        f"shard), {FLEET_STEPS} TelemetrySim steps: against stacked mode on the card "
        f"{max(gaps):.2e} W (bar {FLEET_MONO_TOL:g}), equal iterations {iters}, every row "
        f"kept; collectives per step: {coll['all_reduce'] // FLEET_STEPS} all-reduce, "
        f"{coll['all_gather'] // FLEET_STEPS} all-gather; step wall sharded {_fmt_walls(w_h)}, "
        f"stacked {_fmt_walls(w_s)}; a cold step's device launches sharded "
        f"{prof_h['launches']}, stacked {prof_s['launches']}; launches "
        f"{_kernel_calls(launches)}, of them on the coordinator tree {plan_launches}; the "
        f"coordinator tree's tree_matvec at K = {sharded.k} "
        f"{ctree_err:.2e} off its plain version; on {smi}")
    report["one_rank"] = {"gap_w": gaps, "phase_iterations": iters, "collectives": coll,
                          "plan_launches": plan_launches,
                          "walls_sharded": w_h, "walls_stacked": w_s, "launches": launches,
                          "profile_sharded": prof_h, "profile_stacked": prof_s,
                          "ctree_tree_matvec_err": ctree_err}

    # (d) the flight recorder, sharded and stacked
    flights = {}
    for mode in ("sharded", "stacked"):
        orch = FleetOrchestrator(pdn, level=1, mode=mode, options=opts, recorder=True,
                                 device=cuda)
        for tele, act in zip(samples[:SHARD_REC_STEPS], actives[:SHARD_REC_STEPS]):
            orch.step(tele, active=act)
        shd.COLLECTIVES.clear()
        flights[mode] = [lane["rows"] for lane in orch.flush_recorder()["lanes"]]
        if mode == "sharded" and dict(shd.COLLECTIVES) != {"flush_gather": 1}:
            raise AssertionError(f"[14d] the flush made {dict(shd.COLLECTIVES)}")
        del orch
    rec_gap = _flights_match("[14d]", flights["sharded"], flights["stacked"], SHARD_REC_STEPS)
    log(f"[14d] flight recorder, {SHARD_REC_STEPS} steps: sharded and stacked lanes have equal "
        f"integer fields, alloc_W {rec_gap:.2e} W apart; the flush is one gather")
    report["recorder"] = {"alloc_w_gap": rec_gap}

    # (b) four gloo ranks on the card; the stacked tenant fleet's step first
    tstacked = FleetOrchestrator(pdn, level=1, tenants=layout, mode="stacked", options=opts,
                                 device=cuda)
    sync(cuda)
    t0 = time.perf_counter()
    res_ts = tstacked.step(samples[0], active=actives[0])
    wall_ts = time.perf_counter() - t0
    left_stacked = hall_unallocated("[14b] the stacked tenant step", tstacked, res_ts)
    # the same cold step at one NCCL rank (14a's dispatch): the stacked
    # step's lanes, under grants of the coordinator's water-fill on the card
    # (1e-10 W from the host's), which the eps-degenerate tenant LPs carry
    # to other vertices: held to breakers, tenant bounds and the grant bar,
    # its gaps to the stacked step reported
    tsharded = FleetOrchestrator(pdn, level=1, tenants=layout, mode="sharded", options=opts,
                                 device=cuda)
    res_tn = tsharded.step(samples[0], active=actives[0])
    tenant_fleet_quality("[14b] the tenant step at one NCCL rank", pdn, layout,
                         res_tn.allocation, samples[0], actives[0])
    left_nccl = hall_unallocated("[14b] the tenant step at one NCCL rank", tsharded, res_tn)
    nccl_gap = float(np.max(np.abs(res_tn.allocation - res_ts.allocation)))
    del tstacked, tsharded
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rank_dir = Path(out_dir) / "shard_ranks"
    _spawn_ranks("--shard-rank", SHARD_RANKS, rank_dir, SHARD_JOIN_S, "14b")
    ranks = [(dict(np.load(rank_dir / f"rank{r}.npz")),
              json.loads((rank_dir / f"rank{r}.json").read_text())) for r in range(SHARD_RANKS)]
    ranks_wall = time.perf_counter() - t0
    rank_gaps, walls_r, launches_4, tenant_launches_4 = [], [], {}, {}
    for r, (arr, info) in enumerate(ranks):
        if info["layout"] != ["gloo", SHARD_RANKS, SHARD_RANKS, r, r + 1]:
            raise AssertionError(f"[14b] rank {r}'s layout {info['layout']}")
        if any(c != {"all_reduce": 1, "all_gather": 1} for c in info["collectives"]) or \
                info["flush_collectives"] != {"flush_gather": 1}:
            raise AssertionError(f"[14b] rank {r}: collectives {info['collectives']}, flush "
                                 f"{info['flush_collectives']}")
        rmiss = [k for k in path if not info["launches"].get(k)]
        tmiss = [k for k in ALLOCATOR_KERNELS if not info["tenant_launches"].get(k)]
        if rmiss or tmiss:
            raise AssertionError(f"[14b] rank {r}: kernels not launched {rmiss} / {tmiss}")
        for t, h in enumerate(res_h):
            gap = max(float(np.max(np.abs(arr[f"alloc{t}"] - h.allocation))),
                      float(np.max(np.abs(arr[f"grants{t}"] - h.grants))))
            if gap > FLEET_MONO_TOL:
                raise AssertionError(f"[14b] rank {r} step {t}: {gap:.3e} W off 14a's")
            rank_gaps.append(gap)
            for key in (f"grants{t}", f"alloc{t}"):
                if not np.array_equal(arr[key], ranks[0][0][key]):
                    raise AssertionError(f"[14b] rank {r}'s {key} differs from rank 0's bits")
        for key in ("tenant_alloc", "tenant_grants", "tenant_slice_hi", "flight"):
            if not np.array_equal(arr[key], ranks[0][0][key]):
                raise AssertionError(f"[14b] rank {r}'s {key} differs from rank 0's bits")
        walls_r.append(info["walls_s"])
        for k, v in info["launches"].items():
            launches_4[k] = launches_4.get(k, 0) + v
        for k, v in info["tenant_launches"].items():
            tenant_launches_4[k] = tenant_launches_4.get(k, 0) + v
    rec4_gap = _flights_match("[14b] flight", list(ranks[0][0]["flight"]), flights["sharded"],
                              SHARD_REC_STEPS)
    # the tenant fleet at the quality level: breakers and tenant bounds kept,
    # useful power against the stacked step; the total is reported with each
    # hall's grant left unallocated (gated above for the stacked step and the
    # one NCCL rank)
    x_t = ranks[0][0]["tenant_alloc"]
    # one lane a rank and four lanes at one rank: each lane the same bits
    ranks_vs_nccl = float(np.max(np.abs(x_t - res_tn.allocation)))
    if not np.array_equal(x_t, res_tn.allocation):
        raise AssertionError(f"[14b] the tenant step of {SHARD_RANKS} gloo ranks lies "
                             f"{ranks_vs_nccl:.3e} W off the one NCCL rank's lanes")
    tgaps = tenant_fleet_quality("[14b]", pdn, layout, x_t, samples[0], actives[0])
    r_t = np.where(actives[0], np.clip(samples[0], pdn.dev_l, pdn.dev_u), pdn.dev_l)
    tgaps.update(useful_w=float(np.max(np.abs(np.minimum(r_t, x_t)
                                              - np.minimum(r_t, res_ts.allocation)))),
                 total_w=float(x_t.sum() - res_ts.allocation.sum()),
                 max_abs_w=float(np.max(np.abs(x_t - res_ts.allocation))))
    if tgaps["useful_w"] > USEFUL_DEGENERATE_TOL:
        raise AssertionError(f"[14b] tenant fleet: useful power {tgaps['useful_w']:.3e} W off "
                             "the stacked step")
    offs = np.concatenate([[0], np.cumsum([3_072] * 4)])

    def left_of(x, grants):
        return [round(float(grants[k] - x[offs[k]:offs[k + 1]].sum()), 3) for k in range(4)]

    tgaps["unallocated_w"] = left_of(x_t, ranks[0][0]["tenant_grants"])
    tgaps["ranks_vs_nccl_w"] = ranks_vs_nccl
    tgaps["stacked_unallocated_w"] = [round(v, 3) for v in left_stacked]
    tgaps["nccl_unallocated_w"] = [round(v, 3) for v in left_nccl]
    tgaps["nccl_vs_stacked_w"] = nccl_gap
    w_r = _wall_spread(np.max(np.asarray(walls_r), axis=0))
    t_walls = [info["tenant_wall_s"] * 1e3 for _, info in ranks]
    log(f"[14b] {SHARD_RANKS} gloo ranks on the one card (collectives staged through host "
        f"memory), one hall each: {FLEET_STEPS} steps within {max(rank_gaps):.2e} W of 14a's "
        f"(bar {FLEET_MONO_TOL:g}), every rank's grants and allocations the same bits, one "
        f"all-reduce and one all-gather a step, the recorder's lanes gathered once at the "
        f"flush ({rec4_gap:.2e} W off 14d's); step wall (slowest rank) {_fmt_walls(w_r)}; "
        f"launches over the ranks {_kernel_calls(launches_4)}; the tenant fleet's cold step "
        f"(Appendix B split at the cut): iterations {ranks[0][1]['tenant_iterations']}, against "
        f"the stacked step on the card useful power {tgaps['useful_w']:.2e} W (bar "
        f"{USEFUL_DEGENERATE_TOL:g}), per device {tgaps['max_abs_w']:.2e} W, total "
        f"{tgaps['total_w']:+.1f} W, the one NCCL rank's four lanes bit for bit (grant left "
        f"unallocated per hall {tgaps['unallocated_w']} W, "
        f"stacked {tgaps['stacked_unallocated_w']} W, one NCCL rank "
        f"{tgaps['nccl_unallocated_w']} W, per device {nccl_gap:.2e} W off stacked; bar "
        f"{UNALLOCATED_TOL:g} W on the last two), tenant bounds "
        f"{tgaps['tenant_bound_excess_w']:.2e} W; wall per rank "
        f"{', '.join(f'{w:.0f}' for w in t_walls)} ms against the stacked step's "
        f"{wall_ts * 1e3:.0f} ms (iterations {res_ts.stats['phase_iterations'].tolist()}); "
        f"the ranks' processes {ranks_wall:.1f} s in all; on {smi}")
    report["four_ranks"] = {"gap_w": rank_gaps, "walls": w_r, "launches": launches_4,
                            "tenant_launches": tenant_launches_4, "tenant_quality": tgaps,
                            "tenant_walls_ms": t_walls, "stacked_tenant_wall_ms": wall_ts * 1e3,
                            "tenant_iterations": ranks[0][1]["tenant_iterations"],
                            "stacked_tenant_iterations":
                                res_ts.stats["phase_iterations"].tolist(),
                            "flight_gap_w": rec4_gap, "processes_s": ranks_wall}

    # (c) churn on 14a's two orchestrators
    lives = [FleetLifecycle(sharded), FleetLifecycle(stacked)]
    before = [sharded.rebuild_count(), stacked.rebuild_count()]
    left = np.array([5, 3_100, 9_000])
    churn = []

    def churn_step(tag, t):
        h = sharded.step(samples[t], active=actives[t])
        s = stacked.step(samples[t], active=actives[t])
        over = _fleet_feasible(sharded, h.allocation, h.grants)
        gap = against(f"[14c] {tag}", h, s, iterations=False)
        counts = [sharded.rebuild_count(), stacked.rebuild_count()]
        if counts != before:
            raise AssertionError(f"[14c] {tag}: rebuild counts {counts}, {before} before")
        churn.append({"event": tag, "gap_w": gap, "max_excess_w": over})
        return h

    for orch in (sharded, stacked):
        orch.set_domain_supply(0, 0.8)
    churn_step("hall 0 feed x 0.8", 1)
    for orch in (sharded, stacked):
        orch.set_feed_scale(0.95)
    churn_step("feed x 0.95", 2)
    for life in lives:
        life.device_leave(left)
    h = churn_step("leave 3 devices", 3)
    if np.abs(h.allocation[left]).max() > 0.0:
        raise AssertionError("[14c] a left device got power")
    for life in lives:
        life.device_join(left)
    churn_step("rejoin", 4)
    log(f"[14c] churn on 14a's sharded and stacked fleets: " + "; ".join(
        f"{c['event']}: {c['gap_w']:.2e} W apart, max excess {c['max_excess_w']:.2e} W"
        for c in churn) + f"; rebuild counts stay {before}")
    report["churn"] = churn

    # (e) the example twins on the card
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    examples = {}
    for script, argv in (("torch_quickstart.py", []),
                         ("torch_datacenter_simulation.py", ["--steps", "5"])):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, str(ROOT / "examples" / script), *argv],
                             capture_output=True, text=True, env=env, cwd=ROOT,
                             timeout=EXAMPLE_TIMEOUT_S)
        lines = [ln for ln in run.stdout.splitlines() if ln.strip()]
        if run.returncode != 0 or not any(ln.startswith("nvPAX") for ln in lines):
            raise AssertionError(f"[14e] {script} exited {run.returncode}: "
                                 f"{(run.stdout + run.stderr)[-3000:]}")
        examples[script] = {"lines": lines, "seconds": time.perf_counter() - t0}
        for ln in lines:
            log(f"[14e] {script}: {ln}")
    report["examples"] = examples
    return launches, launches_4, report


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
    report["analysis_run"] = _count_prefill(cfg, params, tokens)  # phase 19a, reported there
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


# -- phase 15: the MoE, Mamba-2, hybrid and Whisper families ---------------------

# the families' serving paths at full width: olmoe-1b-7b (MoE), mamba2-1.3b
# (SSD), jamba-v0.1-52b (hybrid attention + SSD + MoE) and whisper-tiny
# (encoder-decoder)
FAMILY_ARCHS = ("olmoe-1b-7b", "mamba2-1.3b", "jamba-v0.1-52b", "whisper-tiny")
# jamba at full width, cut to one 8-layer unit of its pattern (attention at
# position 3, SSD elsewhere, MoE on odd positions): about 12.7 B parameters,
# 51 GB in float32, beside the bf16 cast of one MoE layer's experts
JAMBA_LAYERS = 8
FAMILY_GEN = 16  # decoded tokens after the prefill
# whisper's decoder prompt: its text context (448), under attn_chunk, so the
# decoder's self-attention takes the plain branch and the kernel runs the
# encoder's and the cross-attention
WHISPER_PROMPT = 448
# decode vs prefill (as 8e): float32 compute at full width and a few layers,
# one request of FAMILY_DECODE_S tokens (a multiple of moe_chunk and
# ssd_chunk) with attn_chunk FAMILY_DECODE_CHUNK below it, so the prefill
# runs the kernel in 512 decode steps rather than 1,536
FAMILY_DECODE_LAYERS = {"olmoe-1b-7b": 2, "mamba2-1.3b": 4, "jamba-v0.1-52b": 4}
FAMILY_DECODE_S, FAMILY_DECODE_CHUNK = 512, 256
# the reduced configs on the card against the CPU (as 8d): a prompt past the
# reduced attn_chunk (64), a multiple of moe_chunk (32) and ssd_chunk (16);
# whisper's frames raised past attn_chunk to a length that is not a multiple
# of it
REDUCED_S, REDUCED_FRAMES = 192, 100
SERVE_EXAMPLE = "torch_serve_capped.py"


def _grown(caches, total: int) -> list:
    """A prefill's caches as a decode's of ``total`` positions: each KV
    cache copied into zeros of that length, each SSM cache as it is."""
    out = []
    for c in caches:
        if isinstance(c, attention.KVCache):
            k = c.k.new_zeros((c.k.shape[0], total) + c.k.shape[2:])
            v = torch.zeros_like(k)
            k[:, : c.k.shape[1]] = c.k
            v[:, : c.v.shape[1]] = c.v
            c = attention.KVCache(k, v)
        out.append(c)
    return out


def _flash_counts() -> dict:
    counts = kernels.launch_counts()
    return {k: counts[k] for k in FLASH_KERNELS}


def _family_flash_shapes(cfg, params, tokens, enc, cuda) -> list[dict]:
    """15b: each new shape of the family's attention held to its plain
    version (``check_flash``): the first attention layer's causal q/k/v of
    the prompt; for whisper the encoder's non-causal self-attention over the
    1,500 frames, the decoder's cross-attention over them (Sq != Sk), and a
    decode step's (Sq = 1)."""
    B, S = tokens.shape
    U = cfg.unit_size
    if cfg.is_encdec:
        cd = cfg.compute_dtype
        F = enc.shape[1]
        x = enc.to(cd) + sinusoidal_positions(F, cfg.d_model, cd, cuda)[None]
        layer = params["enc"][0]
        pos = torch.arange(F, device=cuda).expand(B, F)
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        q, k, v = attention._project_qkv(layer["attn"], cfg, h, pos, rope=False)
        rows = check_flash(f"{cfg.name} encoder", q, k, v, False)
        memory = encdec.encode(params, cfg, enc)
        dec = params["dec"][0]
        xd = params["tok_embed"][tokens].to(cd) + sinusoidal_positions(S, cfg.d_model, cd,
                                                                       cuda)[None]
        hx = rms_norm(xd, dec["ln_x"], cfg.norm_eps)
        q, _, _ = attention._project_qkv(dec["xattn"], cfg, hx, pos[:, :S], rope=False)
        mpos = torch.zeros(memory.shape[:2], dtype=torch.int64, device=cuda)
        _, k, v = attention._project_qkv(dec["xattn"], cfg, memory, mpos, rope=False)
        rows += check_flash(f"{cfg.name} cross-attention", q, k, v, False)
        rows += check_flash(f"{cfg.name} decode cross-attention", q[:, -1:].contiguous(), k, v,
                            False)
        return rows
    attn = [j for j in range(cfg.n_layers) if cfg.layer_kind(j % U) == "attn"]
    if not attn:
        return []
    layer = params["layers"][attn[0]]
    h = rms_norm(params["tok_embed"][tokens].to(cfg.compute_dtype), layer["ln1"], cfg.norm_eps)
    pos = torch.arange(S, device=cuda).expand(B, S)
    q, k, v = attention._project_qkv(layer["attn"], cfg, h, pos)
    if fk.variant(q, k, v) != "wgmma":
        raise AssertionError(f"[15b] {cfg.name}'s q/k/v do not go to the Hopper kernel")
    return check_flash(f"{cfg.name} prefill", q, k, v, True)


def _family_card_vs_cpu(arch: str, cuda) -> dict:
    """15e: the reduced config in float32, prefill on the card (the float32
    flash kernel in the blocked branch) against the CPU (its plain
    version): logits, every cache and whisper's memory within
    ``CARD_CPU_TOL``."""
    small = get_arch(arch).reduced()
    if small.is_encdec:
        small = dataclasses.replace(small, enc_frames=REDUCED_FRAMES)
    api = build(small)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    S = 96 if small.is_encdec else REDUCED_S
    toks = torch.as_tensor(rng.integers(0, small.vocab, (2, S)))
    args = [toks]
    if small.is_encdec:
        args.append(torch.as_tensor(rng.normal(size=(2, REDUCED_FRAMES, small.d_model)),
                                    dtype=torch.float32))
    cpu_out = api.prefill(params, *args)
    params.to(cuda)
    kernels.reset_launch_counts()
    card_out = api.prefill(params, *(a.to(cuda) for a in args))
    f32 = kernels.launch_counts()["flash_attention_f32"]

    def flat(out):
        logits, caches = out[0], out[1]
        tensors = [logits] + [t for c in caches for t in c]
        return tensors + list(out[2:])

    gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(flat(card_out), flat(cpu_out)))
    if not gap <= CARD_CPU_TOL:
        raise AssertionError(f"[15e] {small.name}: card vs CPU {gap:.3e} (limit {CARD_CPU_TOL})")
    log(f"[15e] {small.name} float32, prompt {S}"
        + (f", {REDUCED_FRAMES} frames" if small.is_encdec else "")
        + f": card ({f32} flash_attention_f32 launches) vs CPU (plain) logits, caches"
        + (" and memory" if small.is_encdec else "") + f" max |d| {gap:.3e} (limit {CARD_CPU_TOL})")
    return {"arch": small.name, "seq": S, "max_abs": gap, "launches_f32": f32}


def _family_decode_vs_prefill(arch: str, cuda) -> dict | None:
    """15d: as 8e, at full width and ``FAMILY_DECODE_LAYERS`` layers in
    float32 compute: one request decoded token by token against the prefill's
    last-position logits, rtol = atol = ``SERVE_TOL``.  A prefill drops the
    (token, choice) pairs past an expert's capacity in its chunk, a decode
    step routes one token and drops none, so the MoE models run at capacity
    factor E / top_k (every pair keeps a slot), where the two agree."""
    if arch not in FAMILY_DECODE_LAYERS:
        return None
    cfg = dataclasses.replace(get_arch(arch), n_layers=FAMILY_DECODE_LAYERS[arch],
                              compute_dtype=torch.float32, attn_chunk=FAMILY_DECODE_CHUNK)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    api = build(cfg)
    params = api.init(torch.Generator(device=cuda).manual_seed(2), cuda)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (1, FAMILY_DECODE_S)),
                           device=cuda)
    kernels.reset_launch_counts()
    full, _ = api.prefill(params, toks)
    f32 = kernels.launch_counts()["flash_attention_f32"]
    attn = sum(cfg.layer_kind(j % cfg.unit_size) == "attn" for j in range(cfg.n_layers))
    if f32 != attn or sum(_flash_counts().values()) != attn:
        raise AssertionError(f"[15d] {arch}: the prefill launched {_flash_counts()}, not {attn} "
                             "flash_attention_f32")
    caches = api.init_decode_cache(1, FAMILY_DECODE_S, cuda)

    def decode_all():
        nonlocal caches
        out = None
        for i in range(FAMILY_DECODE_S):
            out, caches = api.decode_step(params, caches, toks[:, i : i + 1], i)
        return out

    last, wall = _timed(decode_all)
    d = (last - full).abs()
    row = {"arch": arch, "n_layers": cfg.n_layers, "seq": FAMILY_DECODE_S,
           "capacity_factor": cfg.capacity_factor if cfg.n_experts else None,
           "max_abs": float(d.max()), "rel": float((last - full).norm() / full.norm()),
           "logit_scale": float(full.abs().max()),
           "decode_ms_per_token": wall * 1e3 / FAMILY_DECODE_S,
           "prefill_launches_f32": f32}
    log(f"[15d] {arch}, {cfg.n_layers} layers at full width, float32, attn_chunk "
        f"{cfg.attn_chunk}"
        + (f", capacity factor {cfg.capacity_factor:g}" if cfg.n_experts else "")
        + f": decode of {FAMILY_DECODE_S} "
        f"tokens one by one ({row['decode_ms_per_token']:.2f} ms/token) vs the prefill "
        f"({f32} flash_attention_f32 launches): last-position logits max |d| "
        f"{row['max_abs']:.3e} (scale {row['logit_scale']:.2f}), relative {row['rel']:.3e}")
    torch.testing.assert_close(last, full, rtol=SERVE_TOL, atol=SERVE_TOL,
                               msg=lambda m: f"[15d] {arch} decode vs prefill: {m}")
    return row


def _family(arch: str, cuda, smi) -> tuple[dict, dict]:
    """Phase 15 for one model: (a) its weights at full width from a seeded
    generator on the card; (b) its new attention shapes against the plain
    version; (c) the prefill of 4 requests (2,048 random tokens, numpy
    seed 0; whisper: a 448-token prompt over [4, 1,500, 384] frames from the
    same generator), its flash launches (the counts set to 0 just before
    it, read just after) and, for MoE layers, the share of (token, choice)
    pairs dropped at capacity; then 16 greedy decode steps from its caches
    (whisper's with the encoder's memory: 4 cross-attention launches a
    step); (d) decode vs prefill; (e) the reduced config, card vs CPU.
    Returns (report, the flash launches of its prefill and decode)."""
    cfg = get_arch(arch)
    if arch == "jamba-v0.1-52b":
        cfg = dataclasses.replace(cfg, n_layers=JAMBA_LAYERS)
    api = build(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_s = _timed(lambda: api.init(torch.Generator(device=cuda).manual_seed(0), cuda))
    n_params = sum(p.numel() for p in params.parameters())
    report = {"arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "params": n_params,
              "float32_gb": 4 * n_params / 1e9, "init_s": init_s}
    log(f"[15a] {arch} at full width, {cfg.n_layers} layers"
        + (f" (one unit of {get_arch(arch).n_layers})" if arch == "jamba-v0.1-52b" else "")
        + (f" + {cfg.enc_layers} encoder layers" if cfg.is_encdec else "")
        + f", d_model {cfg.d_model}: {n_params:,} parameters ({4 * n_params / 1e9:.2f} GB "
        f"float32), built in {init_s:.2f} s on {smi}")

    rng = np.random.default_rng(0)
    S = WHISPER_PROMPT if cfg.is_encdec else SERVE_S
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (SERVE_B, S)), device=cuda)
    batch = {"tokens": tokens}
    enc = None
    if cfg.is_encdec:
        enc = torch.as_tensor(rng.normal(size=(SERVE_B, cfg.enc_frames, cfg.d_model)),
                              dtype=torch.float32, device=cuda)
        batch["enc_input"] = enc
    report["flash_checks"] = _family_flash_shapes(cfg, params, tokens, enc, cuda)

    # (c) the prefill: a first run counts the MoE chunks and their dropped
    # pairs (moe._route wrapped), the second is timed and counted
    prefill, _ = make_serve_steps(cfg, api)
    chunks = []
    route = moe._route

    def counted_route(p, cfg_, xc):
        combine, disp, aux = route(p, cfg_, xc)
        chunks.append((xc.shape[0] * xc.shape[1] * cfg_.top_k, disp.sum()))
        return combine, disp, aux

    moe._route = counted_route
    try:
        prefill(params, batch)
    finally:
        moe._route = route
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out, wall = _timed(lambda: prefill(params, batch))
    counts = kernels.launch_counts()
    logits, caches = out[0], out[1]
    memory = out[2] if cfg.is_encdec else None
    flash = {k: counts[k] for k in FLASH_KERNELS}
    U = cfg.unit_size
    attn_layers = sum(cfg.layer_kind(j % U) == "attn" for j in range(cfg.n_layers))
    # whisper: the encoder's self-attention and the decoder's cross-attention
    want = cfg.enc_layers + cfg.n_layers if cfg.is_encdec else attn_layers
    if (flash["flash_attention_wgmma"] != want or sum(flash.values()) != want
            or any(counts[k] for k in ALLOCATOR_KERNELS)):
        raise AssertionError(f"[15c] {arch}: the prefill launched {_kernel_calls(counts)}, not "
                             f"{want} flash_attention_wgmma")
    if logits.shape != (SERVE_B, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[15c] {arch}: prefill logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    moe_layers = sum(cfg.layer_moe(j % U) for j in range(cfg.n_layers))
    pairs = sum(n for n, _ in chunks)
    kept = float(sum(k for _, k in chunks)) if chunks else 0.0
    if len(chunks) != moe_layers * (S // min(cfg.moe_chunk, S)):
        raise AssertionError(f"[15c] {arch}: {len(chunks)} MoE chunks routed, not "
                             f"{S // min(cfg.moe_chunk, S)} in each of {moe_layers} MoE layers")
    report["prefill"] = {
        "batch": SERVE_B, "seq": S, "wall_ms": wall * 1e3, "tokens_per_s": SERVE_B * S / wall,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "flash_launches": flash,
        "moe_chunks": len(chunks), "dropped_share": (1 - kept / pairs) if pairs else None,
    }
    log(f"[15c] {arch} prefill B={SERVE_B} S={S}"
        + (f" over {cfg.enc_frames} frames" if cfg.is_encdec else "")
        + f": {wall * 1e3:.1f} ms ({SERVE_B * S / wall:,.0f} tokens/s), peak device memory "
        f"{report['prefill']['peak_gb']:.2f} GB, {flash['flash_attention_wgmma']} "
        f"flash_attention_wgmma launches"
        + (" (none: no attention layer)" if not want else "")
        + (f", {len(chunks)} MoE chunks, {100 * (1 - kept / pairs):.3f}% of the "
           f"{pairs:,} (token, choice) pairs dropped at capacity" if pairs else "")
        + f"; on {smi}")

    # then 16 greedy tokens from the prefill's caches
    dcaches = _grown(caches, S + FAMILY_GEN)
    kernels.reset_launch_counts()

    def decode():
        nonlocal dcaches
        cur, toks = torch.argmax(logits, -1), []
        for i in range(S, S + FAMILY_GEN):
            if cfg.is_encdec:
                lg, dcaches = api.decode_step(params, dcaches, cur, i, memory=memory)
            else:
                lg, dcaches = api.decode_step(params, dcaches, cur, i)
            cur = torch.argmax(lg, -1)
            toks.append(cur[:, 0])
        return torch.stack(toks, 1)

    gen_toks, dwall = _timed(decode)
    dflash = _flash_counts()
    dwant = FAMILY_GEN * cfg.n_layers if cfg.is_encdec else 0
    if (dflash["flash_attention_wgmma"] != dwant or sum(dflash.values()) != dwant
            or not bool(((gen_toks >= 0) & (gen_toks < cfg.vocab)).all())):
        raise AssertionError(f"[15c] {arch}: decode launched {dflash}, not {dwant}")
    report["decode"] = {"tokens": FAMILY_GEN, "ms_per_token": dwall * 1e3 / FAMILY_GEN,
                        "flash_launches": dflash, "greedy": gen_toks.tolist()}
    log(f"[15c] {arch} decode of {FAMILY_GEN} greedy tokens (B={SERVE_B}): "
        f"{dwall * 1e3 / FAMILY_GEN:.2f} ms/token, {dflash['flash_attention_wgmma']} "
        f"flash_attention_wgmma launches"
        + (f" ({cfg.n_layers} cross-attention launches a step over the memory)"
           if cfg.is_encdec else " (a decode step's attention is grouped einsums)"
           if attn_layers else " (no attention layer)"))
    del params, caches, dcaches, logits, out, memory, enc, batch, tokens
    gc.collect()
    torch.cuda.empty_cache()

    report["decode_vs_prefill"] = _family_decode_vs_prefill(arch, cuda)
    if report["decode_vs_prefill"] is None:
        log(f"[15d] {arch}: not held, by the reference's design: its decode step adds "
            "position 0's sinusoidal row at every step, where its prefill adds each position's")
    gc.collect()
    torch.cuda.empty_cache()
    report["card_vs_cpu"] = _family_card_vs_cpu(arch, cuda)
    launches = {"prefill": flash["flash_attention_wgmma"],
                "decode": dflash["flash_attention_wgmma"]}
    return report, launches


def families_phase(cuda, smi) -> tuple[dict, dict]:
    """Phase 15: the MoE, Mamba-2, hybrid and Whisper families' serving
    paths (see :func:`_family`), then the launcher twice on olmoe-1b-7b and
    twice on whisper-tiny at full width (the same greedy tokens each time)
    and ``examples/torch_serve_capped.py`` to its end.  Returns (each
    model's flash launches in its prefill and decode, report)."""
    report: dict = {"card": smi}
    launches = {}
    t_phase = time.perf_counter()
    for arch in FAMILY_ARCHS:
        report[arch], launches[arch] = _family(arch, cuda, smi)
        gc.collect()
        torch.cuda.empty_cache()

    runs = {}
    for arch in ("olmoe-1b-7b", "whisper-tiny"):
        argv = ["--arch", arch]
        got = []
        for _ in range(2):
            torch.cuda.empty_cache()
            r = serve.run(serve.parse_args(argv))
            got.append(r)
            log(f"[15f] python -m repro_torch.launch.serve --arch {arch}: prefill "
                f"{r.prefill_ms:.1f} ms, decode {r.decode_ms_per_token:.2f} ms/token, "
                f"{r.tok_s:.1f} tok/s on {r.device}")
        if not np.array_equal(got[0].tokens, got[1].tokens):
            raise AssertionError(f"[15f] two launcher runs of {arch} gave other greedy tokens")
        runs[arch] = [{"tokens": r.tokens.tolist(), "prefill_ms": r.prefill_ms,
                       "decode_ms_per_token": r.decode_ms_per_token, "tok_s": r.tok_s}
                      for r in got]
        del got
    report["launcher"] = runs
    log("[15f] each launcher's two runs: the same greedy tokens")

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, str(ROOT / "examples" / SERVE_EXAMPLE)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=EXAMPLE_TIMEOUT_S)
    lines = [ln for ln in run.stdout.splitlines() if ln.strip()]
    if run.returncode != 0 or not any(ln.startswith("replica uncapped") for ln in lines):
        raise AssertionError(f"[15g] {SERVE_EXAMPLE} exited {run.returncode}: "
                             f"{(run.stdout + run.stderr)[-3000:]}")
    for ln in lines:
        log(f"[15g] {SERVE_EXAMPLE}: {ln}")
    report["example"] = {"lines": lines, "seconds": time.perf_counter() - t0}
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[15] phase 15 in {report['seconds']:.1f} s on {smi}")
    return launches, report


# ---------------------------------------------------------------------------
# Phase 16: the training path.

TRAIN_ARCH = "qwen3-4b"
TRAIN_BATCH, TRAIN_SEQ = 4, 2_048  # 16d: tokens per step, microbatches of the config's
TRAIN_STEPS = 5
# 16d's depth: None runs the config's every layer, an int cuts it by whole
# layers (the widths never change) where the state and the activations do
# not fit beside each other (PERF.md §4)
TRAIN_LAYERS = None
TRAIN_SCHEDULE = {"lr": 3e-4, "warmup": 100, "total_steps": 10_000}
# 16a: the rows' log-sum-exp against the plain version run in float32 on the
# same values, |d| <= LSE_TOL * max(1, |lse|); a row that sees no key holds
# the masked -1e30 itself.  (tag, B, Sq, Sk, H, KV, dh, causal, dtype); the
# first is qwen3-4b's training shape, timed with and without lse
LSE_TOL = 1e-5
LSE_SHAPES = [
    ("qwen3-4b", 4, 2_048, 2_048, 32, 8, 128, True, torch.bfloat16),
    ("dh 160", 2, 2_048, 2_048, 32, 8, 160, True, torch.bfloat16),
    ("dh 32", 2, 2_048, 2_048, 8, 2, 32, True, torch.bfloat16),
    ("float32", 1, 2_048, 2_048, 32, 8, 128, True, torch.float32),
    ("whisper encoder", 4, 1_500, 1_500, 6, 6, 64, False, torch.bfloat16),
    ("cross", 4, 448, 1_500, 6, 6, 64, False, torch.bfloat16),
    ("rows that see no key", 2, 1_000, 300, 8, 2, 128, True, torch.bfloat16),
]
# 16b: flash_vjp's gradients against autograd through the plain blocked scan
# (float32: 2e-5 of each tensor's largest magnitude; bfloat16: PATH_TOL in
# relative Frobenius norm, 8e's bar), at one microbatch of 16d's attention
VJP_SHAPE = (1, 2_048, 32, 8, 128, 1_024)  # B, S, H, KV, dh, attn_chunk
VJP_TOL = 2e-5
# 16c: every family's reduced config, card vs the port's CPU run (as
# tests/test_torch_train.py holds the CPU run to the reference)
TRAIN_FAMILIES = ("qwen3-4b", "olmoe-1b-7b", "mamba2-1.3b", "jamba-v0.1-52b", "whisper-tiny")
REDUCED_TRAIN_B, REDUCED_TRAIN_S, REDUCED_TRAIN_FRAMES = 4, 128, 96
REDUCED_TRAIN_STEPS = 3
TRAIN_CARD_CPU_TOL = 2e-5
# 16e: the example twin at 60 steps, its loss falling by more than half of
# what the reference's example falls in the same run (12.443 -> 12.241 for
# `examples/train_power_managed.py --steps 60` on the CPU: its 151,936-token
# embedding learns slowly); then the reference's own bar on learning
# (tests/test_training.py::test_loss_decreases: reduced qwen3-4b, lr 5e-3, 3
# warmup steps of 80, 30 steps of 8 x 64 tokens, the loss down by more than
# 0.5) through the port's train step on the card
TRAIN_EXAMPLE = "torch_train_power_managed.py"
TRAIN_EXAMPLE_STEPS = 60
EXAMPLE_REF_DROP = 12.443 - 12.241
LOSS_DROP = 0.5


def _lse_err(got, want) -> float:
    """max |got - want| / max(1, |want|), equal values (the -1e30 of a row
    that sees no key) counting 0."""
    d = torch.where(got == want, 0.0, (got - want).abs() / want.abs().clamp_min(1.0))
    return float(d.max())


def _lse_shape(cuda, tag, B, Sq, Sk, H, KV, dh, causal, dtype) -> list[dict]:
    """16a at one shape: every kernel that takes these inputs asked for the
    lse (the one the wrapper picks, and the mma.sync kernel where that is
    the Hopper kernel): lse against the plain version in float32, out the
    bits of the same kernel without lse and within FLASH_TOL of the plain
    version, one launch counted under the ``_lse`` name."""
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk + dh)
    q, k, v = (torch.randn(B, s, n, dh, generator=gen, device=cuda).to(dtype)
               for s, n in ((Sq, H), (Sk, KV), (Sk, KV)))
    plain = attention_ref(q, k, v, causal=causal)
    _, want = attention_ref(q.float(), k.float(), v.float(), causal=causal, return_lse=True)
    name = str(dtype).split(".")[-1]
    picked = fk.variant(q, k, v)
    runs = [(picked, fk.flash_attention)]
    if picked == "wgmma":
        runs.append(("mma", fk._flash_attention_mma))
    rows = []
    for kind, fn in runs:
        bare = fn(q, k, v, causal=causal)
        kernels.reset_launch_counts()
        out, lse = fn(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        row = {"tag": tag, "kernel": f"flash_attention_{kind}_lse",
               "shape": [B, Sq, Sk, H, KV, dh], "causal": causal, "dtype": name,
               "lse_err": _lse_err(lse, want), "lse_max_abs": float(
                   torch.where(lse == want, 0.0, (lse - want).abs()).max()),
               "out_same_bits": bool(torch.equal(out, bare)), "out_rel": _row_err(out, plain)}
        if causal and Sq > Sk:
            row["blind_rows_masked"] = bool((lse[..., : Sq - Sk] == -1e30).all())
        log(f"[16a] {tag}: B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} dh={dh} "
            f"{'causal' if causal else 'non-causal'} {name}, {kind}: lse |d| / max(1, |lse|) "
            f"{row['lse_err']:.3e} (limit {LSE_TOL:.0e}), out the same bits as without lse: "
            f"{row['out_same_bits']}, out vs plain {row['out_rel']:.3e} (limit "
            f"{FLASH_TOL[name]:.3e})"
            + (f", rows that see no key at -1e30: {row['blind_rows_masked']}"
               if "blind_rows_masked" in row else ""))
        if (counts[f"flash_attention_{kind}_lse"] != 1 or counts[f"flash_attention_{kind}"]
                or not row["out_same_bits"] or not row["lse_err"] <= LSE_TOL
                or not row["out_rel"] <= FLASH_TOL[name] or not row.get("blind_rows_masked", True)):
            raise AssertionError(f"[16a] the kernel's lse or out disagrees: {row}, launches {counts}")
        rows.append(row)
    return rows


def _lse_timing(cuda, smi, tag, B, Sq, Sk, H, KV, dh, causal, dtype) -> dict:
    """The kernel at one shape with and without lse, the plain version with
    lse, and the efficient-attention operator that also returns the rows'
    log-sum-exp (k and v repeated to the query heads beforehand: it takes
    no GQA), each the later of two timings; the bound adds lse's bytes."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(B, s, n, dh, generator=gen, device=cuda).to(dtype)
               for s, n in ((Sq, H), (Sk, KV), (Sk, KV)))
    name = str(dtype).split(".")[-1]
    flops = 4 * B * H * dh * Sq * (Sq + 1) / 2 if causal else 4 * B * H * dh * Sq * Sk
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel()) + 4 * B * H * Sq
    t_ops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES_S
    bound_ms, bound_by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    rep = H // KV
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(rep, 2),
                                              v.repeat_interleave(rep, 2)))
    calls = {
        "plain": lambda: attention_ref(q, k, v, causal=causal, return_lse=True),
        "kernel": lambda: fk.flash_attention(q, k, v, causal=causal),
        "kernel_lse": lambda: fk.flash_attention(q, k, v, causal=causal, return_lse=True),
        "library": lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, None, True, 0.0, causal, scale=dh**-0.5),
    }
    _, lse = calls["kernel_lse"]()
    lib_lse = calls["library"]()[1][..., :Sq]
    lib_err = _lse_err(lib_lse.float(), lse)
    times = {}
    for key in ("plain", "kernel", "kernel_lse", "library", "kernel_lse", "kernel", "plain"):
        times[key] = time_calls(calls[key])
    out = {"tag": tag, "shape": [B, Sq, Sk, H, KV, dh], "dtype": name, "causal": causal,
           "flops": flops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
           "ms": {key: t[0] for key, t in times.items()},
           "paced_ms": {key: t[1] for key, t in times.items()},
           "library_lse_vs_kernel": lib_err, "card": smi}
    ms = out["ms"]
    log(f"[16a] times at {tag} (B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} dh={dh} {name}) on {smi}: "
        f"kernel {ms['kernel']:.4f} ms, with lse {ms['kernel_lse']:.4f} ms "
        f"(x{ms['kernel_lse'] / ms['kernel']:.4f}), plain with lse {ms['plain']:.4f} ms, "
        f"efficient attention with lse {ms['library']:.4f} ms (its lse vs the kernel's "
        f"{lib_err:.2e}), bound {bound_ms:.4f} ms ({bound_by})")
    return out


def _vjp_check(cuda, dtype) -> dict:
    """16b: flash_vjp on the card (the kernel with lse, the hand-written
    backward) against autograd through the port's plain blocked scan on the
    card, at one microbatch of qwen3-4b's attention; both timed forward and
    backward, the host clock ending in a sync."""
    B, S, H, KV, dh, chunk = VJP_SHAPE
    gen = torch.Generator(device=cuda).manual_seed(16)
    q, k, v = (torch.randn(B, S, n, dh, generator=gen, device=cuda).to(dtype).requires_grad_(True)
               for n in (H, KV, KV))
    g = torch.randn(B, S, H, dh, generator=gen, device=cuda).to(dtype)
    kind = "f32" if dtype == torch.float32 else "wgmma"

    def grads(fn):
        for t in (q, k, v):
            t.grad = None
        out = fn()
        out.backward(g)
        return [out.detach()] + [t.grad for t in (q, k, v)]

    def mo():
        return flash_vjp.blocked_attention_mo(q, k, v, True, dh**-0.5, chunk, chunk)

    def plain():
        return attention._blocked_attention(q, k, v, True, chunk)

    kernels.reset_launch_counts()
    got = grads(mo)
    launches = kernels.launch_counts()[f"flash_attention_{kind}_lse"]
    want = grads(plain)
    name = str(dtype).split(".")[-1]
    errs = {}
    for tag, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        errs[tag] = (float((a - b).abs().max() / b.abs().max()) if dtype == torch.float32
                     else float((a - b).norm() / b.norm()))
    tol = VJP_TOL if dtype == torch.float32 else PATH_TOL
    walls = {}
    for key, fn in (("flash_vjp", mo), ("plain_autograd", plain), ("flash_vjp", mo),
                    ("plain_autograd", plain)):
        walls[key] = _timed(lambda: grads(fn))[1] * 1e3
    log(f"[16b] flash_vjp backward vs autograd through the plain blocked scan, B={B} S={S} "
        f"H={H} KV={KV} dh={dh} chunk={chunk} causal {name}: "
        + ", ".join(f"{t} {e:.3e}" for t, e in errs.items())
        + f" ({'max |d| / max |ref|' if dtype == torch.float32 else 'relative Frobenius'}, "
        f"limit {tol:.1e}); {launches} flash_attention_{kind}_lse launch; forward + backward "
        f"{walls['flash_vjp']:.1f} ms against {walls['plain_autograd']:.1f} ms")
    if launches != 1 or not all(e <= tol for e in errs.values()):
        raise AssertionError(f"[16b] flash_vjp's gradients disagree: {errs}, launches {launches}")
    return {"dtype": name, "errors": errs, "tol": tol, "launches": launches, "walls_ms": walls}


def _tree_err(a: dict, b: dict) -> tuple[float, str]:
    """The largest max |d| / max |b| over the leaves of two nested dicts of
    numpy arrays, and its leaf's name."""
    worst = (0.0, "")
    if isinstance(b, dict):
        for key in b:
            e, where = _tree_err(a[key], b[key])
            worst = max(worst, (e, f"{key}/{where}" if where else str(key)))
        return worst
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)), ""


def _reduced_train(arch: str, cuda) -> tuple[dict, int]:
    """16c: one family's reduced config on the card against the port's CPU
    run of the same weights (``torch.Generator`` seed 0 on the CPU, copied to
    the card) and batches: the loss and every gradient, then
    REDUCED_TRAIN_STEPS steps of ``make_train_step`` (each step's loss and
    grad norm, then every parameter).  Returns (report, the card's
    ``flash_attention_f32_lse`` launches)."""
    cfg = get_arch(arch).reduced()
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, enc_frames=REDUCED_TRAIN_FRAMES)
    api = build(cfg)
    to_numpy = encdec_params_to_numpy if cfg.is_encdec else lm_params_to_numpy
    data = SyntheticLMData(cfg.vocab, seed=0)
    enc = (cfg.enc_frames, cfg.d_model) if cfg.is_encdec else None
    batches = [data.batch(i, REDUCED_TRAIN_B, REDUCED_TRAIN_S, enc=enc)
               for i in range(REDUCED_TRAIN_STEPS)]
    runs = {}
    kernels.reset_launch_counts()
    for dev in ("cpu", cuda):
        state = init_train_state(cfg, api, torch.Generator().manual_seed(0), "cpu")
        if dev != "cpu":
            state.params.to(dev)
            state = state._replace(opt=type(state.opt)(*(t.to(dev) for t in state.opt)))
        b0 = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}
        loss, metrics = api.loss(state.params, **b0)
        loss.backward()
        grads = to_numpy(state.params, cfg, grad=True)
        state.params.zero_grad(set_to_none=True)
        step = make_train_step(cfg, api, **TRAIN_SCHEDULE)
        history = []
        for batch in batches:
            state, m = step(state, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
            history.append({k: float(v) for k, v in m.items()})
        runs["card" if dev != "cpu" else "cpu"] = {
            "loss": loss.item(), "grads": grads, "history": history,
            "params": to_numpy(state.params, cfg)}
    launches = kernels.launch_counts()["flash_attention_f32_lse"]
    card, cpu = runs["card"], runs["cpu"]
    loss_gap = abs(card["loss"] - cpu["loss"])
    grad_err, grad_leaf = _tree_err(card["grads"], cpu["grads"])
    param_err, param_leaf = _tree_err(card["params"], cpu["params"])
    step_gap = max(abs(c[key] - w[key]) / max(1.0, abs(w[key]))
                   for c, w in zip(card["history"], cpu["history"]) for key in w)
    n_attn = sum(cfg.layer_kind(layer % cfg.unit_size) == "attn" for layer in range(cfg.n_layers))
    log(f"[16c] {cfg.name} train, card vs CPU: loss {card['loss']:.6f} (|d| {loss_gap:.2e}), "
        f"gradients {grad_err:.2e} ({grad_leaf}), {REDUCED_TRAIN_STEPS} steps' loss and grad "
        f"norm {step_gap:.2e}, parameters after them {param_err:.2e} ({param_leaf}); limit "
        f"{TRAIN_CARD_CPU_TOL:.0e}; {launches} flash_attention_f32_lse launches "
        f"({n_attn} attention layers)")
    if not max(loss_gap, grad_err, param_err, step_gap) <= TRAIN_CARD_CPU_TOL:
        raise AssertionError(f"[16c] {cfg.name}: the card's training disagrees with the CPU's")
    if n_attn and launches == 0:
        raise AssertionError(f"[16c] {cfg.name}: the card's training launched no flash kernel")
    return ({"loss": card["loss"], "loss_gap": loss_gap, "grad_err": grad_err,
             "grad_leaf": grad_leaf, "param_err": param_err, "param_leaf": param_leaf,
             "step_gap": step_gap, "history": card["history"], "launches": launches}, launches)


def _full_width_train(cuda, smi, profile: bool) -> dict:
    """16d: qwen3-4b at its published widths, float32 parameters and
    moments, bf16 compute, remat, the config's microbatches: TRAIN_STEPS
    steps of ``make_train_step`` on ``SyntheticLMData`` batches of
    TRAIN_BATCH x TRAIN_SEQ tokens, each finite, each launching the Hopper
    kernel with lse once per layer, microbatch and pass (the forward and its
    recompute) and no other flash kernel."""
    cfg = get_arch(TRAIN_ARCH)
    if TRAIN_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    api = build(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free0, total = torch.cuda.mem_get_info()
    before = _card_bytes()
    state, init_s = _timed(lambda: init_train_state(
        cfg, api, torch.Generator(device=cuda).manual_seed(0), cuda))
    init_bytes = [a - b for a, b in zip(_card_bytes(), before)]
    n_params = sum(p.numel() for p in state.params.parameters())
    state_gb = torch.cuda.memory_allocated() / 1e9
    log(f"[16d] {cfg.name} train state, {cfg.n_layers} layers of {get_arch(TRAIN_ARCH).n_layers}, "
        f"d_model {cfg.d_model}: {n_params:,} parameters, {state_gb:.2f} GB of float32 "
        f"parameters and moments, built in {init_s:.2f} s; the card had {free0 / 1e9:.2f} of "
        f"{total / 1e9:.2f} GB free on {smi}")
    data = SyntheticLMData(cfg.vocab, seed=0)
    step = make_train_step(cfg, api, **TRAIN_SCHEDULE)
    expected = cfg.n_layers * max(cfg.microbatch, 1) * (2 if cfg.remat else 1)
    rows = []
    kernels.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        batch = {k: torch.as_tensor(v, device=cuda)
                 for k, v in data.batch(i, TRAIN_BATCH, TRAIN_SEQ).items()}
        before = kernels.launch_counts()
        (state, m), wall = _timed(lambda: step(state, batch))
        after = kernels.launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        row = {"step": i, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "wall_ms": wall * 1e3, "flash_launches": launched}
        log(f"[16d] step {i}: loss {row['loss']:.4f}, grad norm {row['grad_norm']:.4f}, "
            f"{row['wall_ms']:.1f} ms, flash launches {launched} (expected "
            f"{expected} flash_attention_wgmma_lse: {cfg.n_layers} layers x {cfg.microbatch} "
            "microbatches x forward and recompute)")
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
            raise AssertionError(f"[16d] step {i} is not finite: {row}")
        if launched != {"flash_attention_wgmma_lse": expected}:
            raise AssertionError(f"[16d] step {i} launched {launched}, not {expected} "
                                 "flash_attention_wgmma_lse")
        rows.append(row)
    launches = kernels.launch_counts()["flash_attention_wgmma_lse"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    median = float(np.median([r["wall_ms"] for r in rows[1:]]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    report = {"arch": cfg.name, "n_layers": cfg.n_layers, "published_layers":
              get_arch(TRAIN_ARCH).n_layers, "params": n_params, "state_gb": state_gb,
              "peak_gb": peak, "card_total_gb": total / 1e9, "steps": rows,
              "median_step_ms": median, "tokens_per_s": tokens / median * 1e3,
              "launches_per_step": expected, "launches": launches, "card": smi}
    log(f"[16d] {cfg.name} training at full width on {smi}: median step (steps 2-{TRAIN_STEPS}) "
        f"{median:.1f} ms, {tokens / median * 1e3:,.0f} tokens/s, peak device memory "
        f"{peak:.2f} GB of {total / 1e9:.2f}, {expected} flash_attention_wgmma_lse launches a step "
        f"({launches} in {TRAIN_STEPS} steps)")
    # phase 19a/b (reported there): one more step under the op counter, on a
    # batch whose bytes are measured alone (the last step's freed first)
    batch = None
    before = _card_bytes()
    batch = {k: torch.as_tensor(v, device=cuda)
             for k, v in data.batch(TRAIN_STEPS + 1, TRAIN_BATCH, TRAIN_SEQ).items()}
    batch_bytes = [a - b for a, b in zip(_card_bytes(), before)]
    report["analysis_run"] = _count_train_step(
        cfg, state, step, batch, tuple(a + b for a, b in zip(init_bytes, batch_bytes)),
        median / 1e3)
    del batch
    if profile:
        batch = {k: torch.as_tensor(v, device=cuda)
                 for k, v in data.batch(TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ).items()}
        report["profile"] = profiled("16d one training step", lambda: step(state, batch), top=15)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return report


def training_phase(cuda, smi, profile: bool = False) -> tuple[list, dict]:
    """Phase 16: the training path (see the module's doc).  Returns (the
    kernels line's entries of the lse launches, report)."""
    report: dict = {"card": smi}
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    report["lse"] = [row for shape in LSE_SHAPES for row in _lse_shape(cuda, *shape)]
    timing = {"bfloat16": _lse_timing(cuda, smi, *LSE_SHAPES[0]),
              "float32": _lse_timing(cuda, smi, *LSE_SHAPES[3])}
    report["lse_timing"] = timing
    report["vjp"] = [_vjp_check(cuda, dtype) for dtype in (torch.float32, torch.bfloat16)]
    report["reduced"], f32_launches = {}, 0
    for arch in TRAIN_FAMILIES:
        report["reduced"][arch], n = _reduced_train(arch, cuda)
        f32_launches += n
    report["full_width"] = _full_width_train(cuda, smi, profile)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, str(ROOT / "examples" / TRAIN_EXAMPLE), "--steps",
                          str(TRAIN_EXAMPLE_STEPS)], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=EXAMPLE_TIMEOUT_S)
    lines = [ln for ln in run.stdout.splitlines() if ln.strip()]
    found = re.search(r"loss ([0-9.]+) -> ([0-9.]+)", run.stdout)
    if run.returncode != 0 or found is None:
        raise AssertionError(f"[16e] {TRAIN_EXAMPLE} exited {run.returncode}: "
                             f"{(run.stdout + run.stderr)[-3000:]}")
    for ln in lines:
        log(f"[16e] {TRAIN_EXAMPLE}: {ln}")
    first, last = float(found.group(1)), float(found.group(2))
    report["example"] = {"lines": lines, "loss_first": first, "loss_last": last}
    log(f"[16e] the example's loss fell by {first - last:.3f} in {TRAIN_EXAMPLE_STEPS} steps "
        f"(the reference's example: {EXAMPLE_REF_DROP:.3f}; bar {EXAMPLE_REF_DROP / 2:.3f})")
    if not first - last > EXAMPLE_REF_DROP / 2:
        raise AssertionError(f"[16e] the example's loss fell by {first - last:.3f}")
    cfg = get_arch(TRAIN_ARCH).reduced()
    api = build(cfg)
    state = init_train_state(cfg, api, torch.Generator(device=cuda).manual_seed(0), cuda)
    data = SyntheticLMData(cfg.vocab, seed=0)
    step = make_train_step(cfg, api, lr=5e-3, warmup=3, total_steps=80)
    losses = []
    for i in range(30):
        state, m = step(state, {k: torch.as_tensor(v, device=cuda)
                                for k, v in data.batch(i, 8, 64).items()})
        losses.append(float(m["loss"]))
    report["loss_decreases"] = losses
    log(f"[16e] {cfg.name}, the reference's test_loss_decreases on the card: loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f} in 30 steps (bar: down by more than {LOSS_DROP})")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] - LOSS_DROP):
        raise AssertionError(f"[16e] no learning: {losses[0]} -> {losses[-1]}")

    max_err = {}
    for row in report["lse"]:
        max_err[row["kernel"]] = max(max_err.get(row["kernel"], 0.0), row["lse_max_abs"])
    entries = []
    for kind, t, launches, where in (
            ("wgmma", timing["bfloat16"], report["full_width"]["launches"],
             f"16d: {TRAIN_STEPS} full-width {TRAIN_ARCH} training steps"),
            ("f32", timing["float32"], f32_launches,
             f"16c: the reduced families' float32 training on the card")):
        src = "flash_attention_hopper.cu" if kind == "wgmma" else "flash_attention.cu"
        entries.append({
            "name": f"flash_attention_{kind}_lse", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
            "launches": launches, "launches_path": where,
            "max_abs_err": max_err[f"flash_attention_{kind}_lse"],
            "ms": t["ms"]["kernel_lse"], "plain_ms": t["ms"]["plain"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["ms"]["library"], "ms_without_lse": t["ms"]["kernel"],
            "paced_ms": t["paced_ms"]["kernel_lse"], "plain_paced_ms": t["paced_ms"]["plain"],
        })
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[16] phase 16 in {report['seconds']:.1f} s on {smi}")
    return entries, report

# ---------------------------------------------------------------------------
# Phase 17: the training launcher.

# 17a: whisper-tiny's full-width train state after one step (moments non-zero)
CKPT_ARCH = "whisper-tiny"
# 17b: the restart drill as users run it, each run a fresh process through
# the launcher's main path (DRILL_SCRIPT prints the losses unrounded)
DRILL_SEQ = 448  # whisper's text context
DRILL_ARGV = ["--arch", "whisper-tiny", "--batch", "4", "--seq", str(DRILL_SEQ), "--log-every",
              "1"]
DRILL_STEPS, DRILL_CKPT_EVERY, DRILL_FAIL_AT = 6, 2, 4
DRILL_COMPRESS_STEPS = 4
DRILL_TOL = 1e-5  # relative: the resumed steps against the uninterrupted run
DRILL_TIMEOUT_S = 300
DRILL_SCRIPT = """
import json, sys
from repro_torch import kernels
from repro_torch.launch import train
run = None
try:
    run = train.run(train.parse_args(sys.argv[1:]))
finally:
    print("DRILL " + json.dumps({
        "losses": None if run is None else run.losses,
        "step_ms": None if run is None else run.step_ms,
        "launches": {k: v for k, v in kernels.launch_counts().items() if v}}), flush=True)
"""
# 17c: the launcher at full width, in process
LAUNCH_ARGV = ["--arch", "qwen3-4b", "--batch", "4", "--seq", "2048", "--steps", "3", "--lr",
               "3e-4", "--power-managed", "--log-every", "1"]
# 17d: compressed_psum of qwen3-4b's embedding gradient; 17e: the GPipe
# forward, 9 of qwen3-4b's 36 layers a rank, M microbatches of 1 x 2,048
LAUNCH_RANKS = 4
LAUNCH_GROUP_S = 300  # the gloo group's timeout
LAUNCH_JOIN_S = 600  # seconds before a rank that has not finished fails the phase
PSUM_SHAPE = (151_936, 2_560)
PSUM_SEED = 1_700
PSUM_REPS = 1  # 17d's timed all-reduces of each kind on the four ranks (the first)
PIPE_M, PIPE_SEQ, PIPE_SEED = 4, 2_048, 1_710


def _digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (on the host)."""
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8).numpy().data).hexdigest()


def _lse_per_step(cfg, seq: int) -> int:
    """``flash_attention_wgmma_lse`` launches of one train step on ``seq``
    tokens: every attention whose query or key length passes ``attn_chunk``
    (whisper's encoder over its frames and its cross-attention; a decoder
    over the sequence), per microbatch, twice under remat (forward and
    recompute)."""
    def blocked(sq, sk):
        return max(sq, sk) > cfg.attn_chunk

    if cfg.is_encdec:
        n = cfg.enc_layers * blocked(cfg.enc_frames, cfg.enc_frames) + cfg.n_layers * (
            blocked(seq, seq) + blocked(seq, cfg.enc_frames))
    else:
        n = cfg.n_layers * blocked(seq, seq)
    return n * max(cfg.microbatch, 1) * (2 if cfg.remat else 1)


def _other_flash(flash: dict, name: str, expected: int) -> bool:
    """Whether ``flash`` (launches by kernel) is anything but ``expected``
    launches of ``name``."""
    return flash.get(name, 0) != expected or any(v for k, v in flash.items() if k != name)


def _pipe_blocked(cfg) -> int:
    """1 where 17e's attention takes the blocked branch (the kernel)."""
    return int(PIPE_SEQ > cfg.attn_chunk)


def _psum_grad(rank: int, cuda) -> torch.Tensor:
    """Rank ``rank``'s gradient of 17d: N(0, 1) x (rank + 1), so that the
    shared scale is the last rank's."""
    gen = torch.Generator(device=cuda).manual_seed(PSUM_SEED + rank)
    return torch.randn(PSUM_SHAPE, generator=gen, device=cuda).mul_(rank + 1)


def _pipe_inputs(cfg, layers, cuda):
    """17e's layers (each from a generator seeded with its index, on the
    card) and microbatches of hidden states ``[M, 1, S, d_model]``."""
    params = [blocks.init_block(torch.Generator(device=cuda).manual_seed(PIPE_SEED + i), cfg, 0,
                                device=cuda) for i in layers]
    gen = torch.Generator(device=cuda).manual_seed(PIPE_SEED)
    batch = torch.randn(PIPE_M, 1, PIPE_SEQ, cfg.d_model, generator=gen, device=cuda)
    return params, batch.to(cfg.compute_dtype)


def _pipe_stage(cfg, layers, x):
    """``pipeline_forward``'s stage_fn: the given layers over ``x``."""
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[0], -1)
    for p in layers:
        x = blocks.block_train(p, cfg, 0, x, positions)[0]
    return x


def _staged_all_reduce(t: torch.Tensor) -> None:
    """A float32 all-reduce of ``t`` through host memory, as gloo takes it."""
    host = t.cpu()
    dist.all_reduce(host)
    t.copy_(host)


def launch_rank_main(rank: int, out_dir: Path) -> int:
    """One of 17d/17e's gloo ranks on the card (spawned by
    :func:`launcher_phase` as ``chip_smoke.py --launch-rank r --out DIR``):
    ``compressed_psum`` of its gradient and a plain float32 all-reduce,
    timed; then its stage of the GPipe forward.  Writes ``rank{r}.json``."""
    cuda = torch.device("cuda")
    _build.library()
    dist.init_process_group("gloo", store=dist.FileStore(str(out_dir / "store"), LAUNCH_RANKS),
                            rank=rank, world_size=LAUNCH_RANKS,
                            timeout=datetime.timedelta(seconds=LAUNCH_GROUP_S))
    rep: dict = {"rank": rank}
    g = _psum_grad(rank, cuda)
    walls = {"compressed": [], "plain": []}
    out = None
    for _ in range(PSUM_REPS):
        dist.barrier()
        out, wall = _timed(lambda: compressed_psum(g))
        walls["compressed"].append(wall * 1e3)
    rep["psum_digest"] = _digest(out)
    del out
    buf = g.clone()
    for _ in range(PSUM_REPS):
        buf.copy_(g)
        dist.barrier()
        _, wall = _timed(lambda: _staged_all_reduce(buf))
        walls["plain"].append(wall * 1e3)
    rep["psum_ms"] = walls
    del g, buf
    torch.cuda.empty_cache()

    cfg = get_arch(TRAIN_ARCH)
    per = cfg.n_layers // LAUNCH_RANKS
    layers, batch = _pipe_inputs(cfg, range(rank * per, (rank + 1) * per), cuda)
    forward = pipeline_forward(None, lambda sp, x: _pipe_stage(cfg, sp, x), PIPE_M)
    kernels.reset_launch_counts()
    with torch.no_grad():
        dist.barrier()
        outs, wall = _timed(lambda: forward(layers, batch))
    rep["pipe_ms"] = wall * 1e3
    rep["pipe_digest"] = _digest(outs)
    rep["pipe_finite"] = bool(torch.isfinite(outs).all())
    rep["launches"] = {k: v for k, v in kernels.launch_counts().items() if v}
    (out_dir / f"rank{rank}.json").write_text(json.dumps(rep))
    dist.destroy_process_group()
    return 0


def _ckpt_on_card(cuda, ckpt_dir: Path) -> dict:
    """17a: whisper-tiny's full-width train state after one step on the
    card, saved and restored onto the card (every leaf the same bits),
    under the keys, shapes and dtypes of the port's CPU save of the same
    config."""
    cfg = get_arch(CKPT_ARCH)
    api = build(cfg)
    state = init_train_state(cfg, api, torch.Generator(device=cuda).manual_seed(0), cuda)
    batch = SyntheticLMData(cfg.vocab, seed=0).batch(0, 4, DRILL_SEQ,
                                                     enc=(cfg.enc_frames, cfg.d_model))
    state, _ = make_train_step(cfg, api)(state, {k: torch.as_tensor(v, device=cuda)
                                                 for k, v in batch.items()})
    _, save_s = _timed(lambda: checkpoint.save(str(ckpt_dir / "card"), 1, state, cfg=cfg))
    like = init_train_state(cfg, api, torch.Generator(device=cuda).manual_seed(1), cuda)
    got, restore_s = _timed(lambda: checkpoint.restore(str(ckpt_dir / "card"), 1, like, cfg=cfg))
    pairs = [(a, b) for x, y in ((got.params, state.params), (got.opt.m, state.opt.m),
                                 (got.opt.v, state.opt.v))
             for a, b in zip(x.parameters(), y.parameters(), strict=True)]
    same = got.step == state.step and all(
        a.device == b.device and a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    nbytes = (ckpt_dir / "card" / "step_00000001" / "leaves.npz").stat().st_size
    cpu_state = init_train_state(cfg, api, torch.Generator().manual_seed(0), "cpu")
    checkpoint.save(str(ckpt_dir / "cpu"), 1, cpu_state, cfg=cfg)
    card_m, cpu_m = (json.loads((ckpt_dir / d / "step_00000001" / "manifest.json").read_text())
                     for d in ("card", "cpu"))
    same_keys = card_m["leaves"] == cpu_m["leaves"]
    n_params = sum(p.numel() for p in state.params.parameters())
    rep = {"arch": cfg.name, "params": n_params, "leaves": len(card_m["leaves"]), "bytes": nbytes,
           "save_s": save_s, "restore_s": restore_s, "same_bits": same,
           "same_keys_as_cpu_save": same_keys}
    log(f"[17a] {cfg.name} train state ({n_params:,} parameters, {len(card_m['leaves'])} leaves, "
        f"{nbytes / 1e6:.1f} MB on disk): save from the card {save_s:.3f} s, restore onto the "
        f"card {restore_s:.3f} s; every leaf the same bits: {same}; keys, shapes and dtypes "
        f"those of the CPU save: {same_keys}")
    if not (same and same_keys):
        raise AssertionError(f"[17a] the checkpoint round trip on the card failed: {rep}")
    return rep


def _drill_run(tag: str, argv: list[str]) -> dict:
    """One launcher run in a fresh process: exit code, stdout, the losses
    (None for a run that exited early), step walls, its kernel launches."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", DRILL_SCRIPT, *argv], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=DRILL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    found = [ln for ln in p.stdout.splitlines() if ln.startswith("DRILL ")]
    if not found:
        raise AssertionError(f"[17b] {tag} exited {p.returncode} without its record: "
                             f"{(p.stdout + p.stderr)[-3000:]}")
    rec = json.loads(found[-1][len("DRILL "):])
    lines = [ln for ln in p.stdout.splitlines() if ln.strip() and not ln.startswith("DRILL ")]
    for ln in lines:
        log(f"[17b] {tag}: {ln}")
    return {"tag": tag, "argv": argv, "rc": p.returncode, "wall_s": wall, "lines": lines,
            "stderr_tail": p.stderr[-2000:], **rec}


def _restart_drill(cuda, ckpt_dir: Path) -> tuple[dict, int]:
    """17b: the drill's three runs, then a ``--compress-grads`` run at full
    width in this process (finite) and one of the reduced config card vs
    CPU.  Returns (report, the runs' ``flash_attention_wgmma_lse``
    launches)."""
    cfg = get_arch(CKPT_ARCH)
    base = DRILL_ARGV + ["--steps", str(DRILL_STEPS), "--ckpt-every", str(DRILL_CKPT_EVERY)]
    runs = [
        _drill_run("uninterrupted", base + ["--ckpt-dir", str(ckpt_dir / "whole")]),
        _drill_run("crash", base + ["--ckpt-dir", str(ckpt_dir / "drill"), "--fail-at",
                                    str(DRILL_FAIL_AT)]),
        _drill_run("resumed", base + ["--ckpt-dir", str(ckpt_dir / "drill"), "--resume"]),
    ]
    whole, crash, resumed = runs
    per_step = _lse_per_step(cfg, DRILL_SEQ)
    problems = []
    if whole["rc"] != 0 or not np.isfinite(whole["losses"]).all():
        problems.append(f"the uninterrupted run exited {whole['rc']}: {whole['stderr_tail']}")
    if crash["rc"] != 42 or f"simulating crash at step {DRILL_FAIL_AT}" not in crash["lines"]:
        problems.append(f"the crash run exited {crash['rc']}, not 42: {crash['stderr_tail']}")
    if resumed["rc"] != 0 or resumed["lines"][:1] != [f"resumed from step {DRILL_FAIL_AT}"]:
        problems.append(f"the resumed run exited {resumed['rc']}: {resumed['stderr_tail']}")
    if problems:
        raise AssertionError("[17b] " + "\n".join(problems))
    want = np.asarray(whole["losses"][DRILL_FAIL_AT:])
    got = np.asarray(resumed["losses"])
    gap = float((np.abs(got - want) / np.abs(want)).max())
    same_bits = resumed["losses"] == whole["losses"][DRILL_FAIL_AT:]
    steps = {"uninterrupted": DRILL_STEPS, "crash": DRILL_FAIL_AT,
             "resumed": DRILL_STEPS - DRILL_FAIL_AT}
    launches = 0
    for run in runs:
        expected = per_step * steps[run["tag"]]
        flash = {k: v for k, v in run["launches"].items() if k.startswith("flash_attention")}
        log(f"[17b] {run['tag']}: {run['wall_s']:.1f} s in all, steps "
            + ", ".join(f"{ms:.1f}" for ms in run["step_ms"] or []) + f" ms; flash launches "
            f"{flash} (expected {expected} flash_attention_wgmma_lse)")
        if _other_flash(flash, "flash_attention_wgmma_lse", expected):
            raise AssertionError(f"[17b] {run['tag']} launched {flash}, not {expected} "
                                 "flash_attention_wgmma_lse")
        launches += flash["flash_attention_wgmma_lse"]
    log(f"[17b] {cfg.name} restart drill: the resumed steps {DRILL_FAIL_AT}-{DRILL_STEPS - 1} "
        f"{resumed['losses']} against the uninterrupted run's "
        f"{whole['losses'][DRILL_FAIL_AT:]}: gap {gap:.3e} relative "
        f"(limit {DRILL_TOL:.0e}); the same bits: {same_bits}")
    if not gap <= DRILL_TOL:
        raise AssertionError(f"[17b] the resumed run parts from the uninterrupted one: {gap:.3e}")
    # the compressed run in this process (its start-up is the drill's)
    kernels.reset_launch_counts()
    comp = train_launcher.run(train_launcher.parse_args(
        DRILL_ARGV + ["--steps", str(DRILL_COMPRESS_STEPS), "--compress-grads"])).losses
    flash = {k: v for k, v in kernels.launch_counts().items()
             if k.startswith("flash_attention") and v}
    launches += flash.get("flash_attention_wgmma_lse", 0)
    log(f"[17b] --compress-grads at full width: losses {comp} (uncompressed "
        f"{whole['losses'][:DRILL_COMPRESS_STEPS]}; step 0 the same bits: "
        f"{comp[0] == whole['losses'][0]}); flash launches {flash}")
    if not np.isfinite(comp).all() or _other_flash(flash, "flash_attention_wgmma_lse",
                                                    per_step * DRILL_COMPRESS_STEPS):
        raise AssertionError(f"[17b] the compressed run: losses {comp}, launches {flash}")
    # whisper-tiny computes in bf16: card and CPU are held at float32 compute
    # (the reduced config), as 16c holds the train step, on the same weights
    # (a CPU generator's draws copied to the device: a card's generator
    # draws others)
    small = DRILL_ARGV + ["--reduced", "--steps", str(DRILL_COMPRESS_STEPS), "--compress-grads"]
    real_build = train_launcher.build

    def cpu_weights(c):
        api = real_build(c)
        return api._replace(init=lambda generator, device=None: api.init(
            torch.Generator().manual_seed(0), "cpu").to(device))

    train_launcher.build = cpu_weights
    try:
        reduced = {dev: train_launcher.run(train_launcher.parse_args(
            small + ["--device", dev])).losses for dev in ("cpu", str(cuda))}
    finally:
        train_launcher.build = real_build
    red_gap = float((np.abs(np.subtract(reduced[str(cuda)], reduced["cpu"]))
                     / np.abs(reduced["cpu"])).max())
    log(f"[17b] --compress-grads --reduced, card vs CPU over {DRILL_COMPRESS_STEPS} steps: "
        f"{red_gap:.3e} relative (limit {TRAIN_CARD_CPU_TOL:.0e})")
    if not red_gap <= TRAIN_CARD_CPU_TOL:
        raise AssertionError(f"[17b] the compressed run on the card parts from the CPU's: {red_gap}")
    return ({"runs": runs, "resume_gap": gap, "resume_same_bits": same_bits,
             "lse_per_step": per_step, "compressed": comp, "reduced_compressed": reduced,
             "reduced_compressed_gap": red_gap}, launches)


def _launch_full_width(cuda, smi) -> tuple[dict, int]:
    """17c: ``launch.train`` at qwen3-4b's full width in process, with the
    nvPAX controller beside it: each loss finite, 288
    ``flash_attention_wgmma_lse`` launches a step and no other flash kernel,
    the median step, tokens/s, peak memory and the controller's wall."""
    cfg = get_arch(TRAIN_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run = train_launcher.run(train_launcher.parse_args(LAUNCH_ARGV))
    flash = {k: v for k, v in kernels.launch_counts().items()
             if k.startswith("flash_attention") and v}
    steps = len(run.losses)
    per_step = _lse_per_step(cfg, TRAIN_SEQ)
    peak = torch.cuda.max_memory_allocated() / 1e9
    median = float(np.median(run.step_ms[1:]))
    tokens = 4 * TRAIN_SEQ
    rep = {"argv": LAUNCH_ARGV, "losses": run.losses, "grad_norms": run.grad_norms,
           "step_ms": run.step_ms, "median_step_ms": median, "tokens_per_s": tokens / median * 1e3,
           "peak_gb": peak, "control_ms": run.control_ms, "slowdowns": run.slowdowns,
           "flash_launches": flash, "lse_per_step": per_step, "card": smi}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[17c] launch.train {' '.join(LAUNCH_ARGV)} on {smi}: losses {rep['losses']}, steps "
        + ", ".join(f"{ms:.1f}" for ms in rep["step_ms"]) + f" ms (median of steps 2-{steps} "
        f"{median:.1f} ms, {tokens / median * 1e3:,.0f} tokens/s), peak {peak:.2f} GB; controller "
        + ", ".join(f"{ms:.1f}" for ms in rep["control_ms"]) + " ms a step, slowdowns "
        + ", ".join(f"x{s:.4f}" for s in rep["slowdowns"])
        + f"; flash launches {flash} (expected {per_step} flash_attention_wgmma_lse a step)")
    if not np.isfinite(rep["losses"]).all() or \
            len(rep["losses"]) != int(LAUNCH_ARGV[LAUNCH_ARGV.index("--steps") + 1]):
        raise AssertionError(f"[17c] the launcher's losses: {rep['losses']}")
    if _other_flash(flash, "flash_attention_wgmma_lse", per_step * steps):
        raise AssertionError(f"[17c] launched {flash}, not {per_step} "
                             "flash_attention_wgmma_lse a step")
    return rep, flash["flash_attention_wgmma_lse"]


def _psum_one_rank(cuda, smi) -> dict:
    """17d at one NCCL rank: ``compressed_psum`` is the int8 round trip of a
    zero error bit for bit; its wall beside a plain float32 all-reduce."""
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=LAUNCH_GROUP_S))
    try:
        g = _psum_grad(0, cuda)
        want, _ = quantize_dequantize(g, torch.zeros_like(g))
        got = compressed_psum(g)
        same = bool(torch.equal(got, want))
        del want, got
        walls = {"compressed": [], "plain": []}
        buf = g.clone()
        for i in range(PSUM_REPS + 1):
            _, wall = _timed(lambda: compressed_psum(g))
            buf.copy_(g)
            _, plain = _timed(lambda: dist.all_reduce(buf))
            if i:
                walls["compressed"].append(wall * 1e3)
                walls["plain"].append(plain * 1e3)
        del g, buf
    finally:
        dist.destroy_process_group()
    log(f"[17d] compressed_psum of a {PSUM_SHAPE} float32 gradient at one NCCL rank on {smi}: "
        f"the bits of quantize_dequantize with a zero error: {same}; "
        f"{', '.join(f'{w:.2f}' for w in walls['compressed'])} ms against a float32 all_reduce's "
        f"{', '.join(f'{w:.2f}' for w in walls['plain'])} ms (int32 payload: as many bytes)")
    if not same:
        raise AssertionError("[17d] compressed_psum at one rank is not the int8 round trip")
    return {"same_bits": same, "ms": walls}


def _psum_oracle(cuda) -> str:
    """The four ranks' ``compressed_psum`` computed on the CPU from the same
    gradients: the largest rank's scale, an int32 sum, then scale / 4."""
    grads = [_psum_grad(r, cuda).cpu() for r in range(LAUNCH_RANKS)]
    scale = max((torch.clamp_min(g.abs().max(), 1e-12) / 127.0 for g in grads),
                key=lambda s: float(s))
    total = torch.zeros(PSUM_SHAPE, dtype=torch.int32)
    for g in grads:
        total += torch.clamp(torch.round(g / scale), -127, 127).to(torch.int32)
    del grads
    n = torch.tensor(float(LAUNCH_RANKS), dtype=torch.float32)
    return _digest(total.float() * scale / n)


def launcher_phase(cuda, smi, out_dir: Path) -> tuple[dict, dict, dict]:
    """Phase 17: the training launcher (see the module's doc).  Returns (the
    ``flash_attention_wgmma_lse`` launches of 17b and 17c, the
    ``flash_attention_wgmma`` launches of 17e, report)."""
    report: dict = {"card": smi}
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_dir = out_dir / "phase17_ckpt"
    if ckpt_dir.exists():
        shutil.rmtree(ckpt_dir)
    try:
        report["checkpoint"] = _ckpt_on_card(cuda, ckpt_dir / "17a")
        gc.collect()
        torch.cuda.empty_cache()
        report["drill"], drill_launches = _restart_drill(cuda, ckpt_dir / "17b")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    report["launch"], launch_launches = _launch_full_width(cuda, smi)

    report["psum_one_rank"] = _psum_one_rank(cuda, smi)
    gc.collect()
    torch.cuda.empty_cache()
    rank_dir = out_dir / "phase17_ranks"
    _spawn_ranks("--launch-rank", LAUNCH_RANKS, rank_dir, LAUNCH_JOIN_S, "17d/e")
    ranks = [json.loads((rank_dir / f"rank{r}.json").read_text()) for r in range(LAUNCH_RANKS)]
    oracle = _psum_oracle(cuda)
    psum_same = all(r["psum_digest"] == oracle for r in ranks)
    report["psum_four_ranks"] = {"same_bits_as_cpu": psum_same, "oracle_digest": oracle,
                                 "ranks": [{k: r[k] for k in ("psum_digest", "psum_ms")}
                                           for r in ranks]}
    log(f"[17d] compressed_psum on four gloo ranks of the one card: every rank the bits of the "
        f"CPU oracle: {psum_same}; rank 0 {', '.join(f'{w:.1f}' for w in ranks[0]['psum_ms']['compressed'])} "
        f"ms against a float32 all_reduce's {', '.join(f'{w:.1f}' for w in ranks[0]['psum_ms']['plain'])} "
        f"ms (both staged through host memory)")
    if not psum_same:
        raise AssertionError(f"[17d] a rank's compressed_psum is not the CPU oracle's bits: "
                             f"{[r['psum_digest'] for r in ranks]} vs {oracle}")

    cfg = get_arch(TRAIN_ARCH)
    layers, batch = _pipe_inputs(cfg, range(cfg.n_layers), cuda)
    kernels.reset_launch_counts()
    with torch.no_grad():
        seq, seq_s = _timed(lambda: torch.stack([_pipe_stage(cfg, layers, batch[m])
                                                  for m in range(PIPE_M)]))
    seq_launches = kernels.launch_counts()
    seq_digest = _digest(seq)
    del layers, batch, seq
    gc.collect()
    torch.cuda.empty_cache()
    rank_launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            if k.startswith("flash_attention"):
                rank_launches[k] = rank_launches.get(k, 0) + v
    pipe_same = all(r["pipe_digest"] == seq_digest and r["pipe_finite"] for r in ranks)
    report["pipeline"] = {"same_bits_as_sequential": pipe_same, "sequential_ms": seq_s * 1e3,
                          "pipeline_ms": [r["pipe_ms"] for r in ranks],
                          "rank_launches": rank_launches,
                          "sequential_launches": seq_launches["flash_attention_wgmma"]}
    log(f"[17e] GPipe forward of {cfg.name}'s {cfg.n_layers} layers on {LAUNCH_RANKS} gloo ranks "
        f"of the one card ({cfg.n_layers // LAUNCH_RANKS} a rank, {PIPE_M} microbatches of 1 x "
        f"{PIPE_SEQ}): every rank the bits of the sequential stack: {pipe_same}; "
        f"{ranks[0]['pipe_ms']:.1f} ms (rank 0) against {seq_s * 1e3:.1f} ms sequential in one "
        f"process; launches {rank_launches} over the ranks, "
        f"{seq_launches['flash_attention_wgmma']} flash_attention_wgmma sequential")
    expected = cfg.n_layers * PIPE_M * _pipe_blocked(cfg)
    if not pipe_same:
        raise AssertionError("[17e] the pipeline's output is not the sequential stack's bits")
    seq_flash = {k: v for k, v in seq_launches.items() if k.startswith("flash_attention") and v}
    if (_other_flash(rank_launches, "flash_attention_wgmma", expected)
            or _other_flash(seq_flash, "flash_attention_wgmma", expected)):
        raise AssertionError(f"[17e] launched {rank_launches} over the ranks and {seq_flash} "
                             f"sequential, not {expected} flash_attention_wgmma each")
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[17] phase 17 in {report['seconds']:.1f} s on {smi}")
    return ({"17b": drill_launches, "17c": launch_launches},
            {"17e_ranks": rank_launches["flash_attention_wgmma"],
             "17e_sequential": seq_flash["flash_attention_wgmma"]}, report)


# 18: the launcher at --mesh 2x2 on four gloo ranks of the card (the launcher
# spawns three ranks beside this process), whisper-tiny as in 17b
MESH = "2x2"
MESH_STEPS = 4
MESH_FAIL_AT = 2  # 18b: the 2x2 run crashes here, a 1x1 run resumes
# The bar on each loss against 17b's uninterrupted 1x1 run, relative: ten
# times the 1x1 run's spread under a 1-ulp change of the embedding (1.68e-5,
# tools/launch_ulp_spread.py on the H100), stated before the first 2x2 run.
MESH_TOL = 1.7e-4


def _mesh_run(argv: list[str]):
    """``launch.train.run`` of ``argv`` in this process (with no process
    group, so that a mesh run spawns its other ranks itself): (its TrainRun
    or None, the exit code of a crash drill, host seconds)."""
    t0 = time.perf_counter()
    try:
        return train_launcher.run(train_launcher.parse_args(argv)), None, \
            time.perf_counter() - t0
    except SystemExit as e:
        return None, e.code, time.perf_counter() - t0


def _rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.abs(want)).max())


def mesh_phase(cuda, smi, whole: dict, out_dir: Path) -> tuple[dict, dict]:
    """Phase 18: (a) ``launch.train`` of 17b's whisper-tiny run at ``--mesh
    2x2`` from this process, the launcher spawning the other three ranks on
    the one card (every DTensor collective staged through the host): each
    loss within ``MESH_TOL`` of 17b's uninterrupted 1x1 run ``whole``, every
    rank launching ``flash_attention_wgmma_lse`` on its own shard as often
    as the 1x1 run and no other flash kernel; every rank's shard bytes, the
    collectives a step by kind and bytes, the step walls against 1x1's; (b)
    the elastic drill: the launcher's 2x2 run crashing at step
    ``MESH_FAIL_AT`` after its checkpoint (its ranks spawned anew), then
    ``--mesh 1x1 --resume`` here, its steps within ``MESH_TOL`` of
    ``whole``.  Returns (18a's launches: in all and per rank, report)."""
    cfg = get_arch(CKPT_ARCH)
    per_step = _lse_per_step(cfg, DRILL_SEQ)
    want = np.asarray(whole["losses"][:MESH_STEPS])
    base = DRILL_ARGV + ["--steps", str(MESH_STEPS)]
    ckpt = out_dir / "phase18_ckpt"
    gc.collect()
    torch.cuda.empty_cache()
    try:
        kernels.reset_launch_counts()
        run, _, wall = _mesh_run(base + ["--mesh", MESH])
        rep = run.mesh_report
        full_bytes = sum(p.numel() * p.element_size()
                         for tree in (run.state.params, run.state.opt.m, run.state.opt.v)
                         for p in tree.parameters())
        losses, step_ms = run.losses, run.step_ms
        del run
        gc.collect()
        torch.cuda.empty_cache()
        _, code, crash_s = _mesh_run(base + ["--mesh", MESH, "--ckpt-dir", str(ckpt),
                                            "--ckpt-every", "2", "--fail-at", str(MESH_FAIL_AT)])
        kernels.reset_launch_counts()
        resumed, _, resume_s = _mesh_run(base + ["--ckpt-dir", str(ckpt), "--resume"])
        resume_flash = {k: v for k, v in kernels.launch_counts().items()
                        if k.startswith("flash_attention") and v}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    rank_flash = [{k: v for k, v in r["launches"].items() if k.startswith("flash_attention")}
                  for r in rep["ranks"]]
    gap = _rel_gap(losses, want)
    shard_bytes = [r["shard_bytes"] for r in rep["ranks"]]
    steps = rep["collectives"]
    sent = [sum(c["bytes"] for c in step.values()) for step in steps]
    median = float(np.median(step_ms[1:]))
    median_1x1 = float(np.median(whole["step_ms"][1:]))
    out = {"argv": base + ["--mesh", MESH], "card": smi, "losses": losses,
           "losses_1x1": want.tolist(), "gap": gap, "tol": MESH_TOL, "step_ms": step_ms,
           "step_ms_1x1": whole["step_ms"], "median_step_ms": median,
           "median_step_ms_1x1": median_1x1, "wall_s": wall, "rank_flash": rank_flash,
           "lse_per_step": per_step, "shard_bytes": shard_bytes, "full_bytes": full_bytes,
           "collectives": steps, "bytes_sent_per_step": sent, "mesh": rep["mesh"]}
    log(f"[18a] launch.train {' '.join(out['argv'])} on {smi}, this process and three ranks "
        f"the launcher spawned on the one card: losses {losses} against 17b's 1x1 "
        f"{want.tolist()}: gap {gap:.3e} relative (limit {MESH_TOL:.1e}); steps "
        + ", ".join(f"{ms:.1f}" for ms in step_ms)
        + f" ms (median of steps 2-{MESH_STEPS} {median:.1f} ms against 1x1's {median_1x1:.1f}); "
        f"the run {wall:.1f} s with its ranks' start")
    log(f"[18a] each rank's parameters and moments: "
        + ", ".join(f"{b / 1e6:.1f}" for b in shard_bytes)
        + f" MB of the whole state's {full_bytes / 1e6:.1f} MB; flash launches by rank "
        f"{rank_flash} (expected {per_step * MESH_STEPS} flash_attention_wgmma_lse each)")
    for i, step in enumerate(steps):
        log(f"[18a] step {i} collectives (rank 0, staged through the host): "
            + ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 1e6:.1f} MB"
                        for k, v in step.items()) + f"; {sent[i] / 1e6:.1f} MB sent in")
    if not gap <= MESH_TOL or not np.isfinite(losses).all():
        raise AssertionError(f"[18a] the 2x2 losses part from 1x1's: {gap:.3e} > {MESH_TOL:.1e}")
    for r, flash in enumerate(rank_flash):
        if _other_flash(flash, "flash_attention_wgmma_lse", per_step * MESH_STEPS):
            raise AssertionError(f"[18a] rank {r} launched {flash}, not "
                                 f"{per_step * MESH_STEPS} flash_attention_wgmma_lse")
    if not all(b < full_bytes for b in shard_bytes) or not all(sent):
        raise AssertionError(f"[18a] ranks hold {shard_bytes} of {full_bytes} bytes; sent {sent}")

    rgap = _rel_gap(resumed.losses, want[MESH_FAIL_AT:])
    out["drill"] = {"exit": code, "crash_s": crash_s, "resume_s": resume_s,
                    "start_step": resumed.start_step, "losses": resumed.losses, "gap": rgap,
                    "resume_flash": resume_flash}
    log(f"[18b] the launcher's 2x2 run crashing at step {MESH_FAIL_AT} exited {code} "
        f"({crash_s:.1f} s with its ranks' start); --mesh 1x1 --resume from step "
        f"{resumed.start_step}: losses {resumed.losses} against the uninterrupted run's "
        f"{want[MESH_FAIL_AT:].tolist()}: gap {rgap:.3e} (limit {MESH_TOL:.1e}), "
        f"{resume_s:.1f} s, flash launches {resume_flash}")
    if code != 42 or resumed.start_step != MESH_FAIL_AT or not rgap <= MESH_TOL:
        raise AssertionError(f"[18b] the elastic drill: {out['drill']}")
    launches = {"18a": sum(f["flash_attention_wgmma_lse"] for f in rank_flash),
                "18a_per_rank": [f["flash_attention_wgmma_lse"] for f in rank_flash]}
    return launches, out


# ---------------------------------------------------------------------------
# Phase 19: the cost analysis (repro_torch.analysis, launch.dryrun) held to
# the card's own programs, bytes and memory.

# 19b: the bytes the state's and batch's tensors asked the caching
# allocator for (its requested_bytes) are the dry run's argument bytes
# exactly; the bytes it allocated lie above them by each block's rounding,
# at most 1 MiB a tensor (a block of the large pool is not split when the
# rest would be under 1 MiB: a bar of 512 bytes a tensor missed by 341 MB on
# qwen3-4b's state); a step's measured peak of intermediates over the counted one,
# from the allocator's max_memory_allocated(): the counter sees every op's
# results but not the scratch an op allocates inside itself (cuBLAS's, the
# loss's), so the bar is loose above
ARG_ROUND = 1 << 20
TEMP_RATIO = (0.9, 1.5)
# 19c: the dry run's CLI in a subprocess that sees no card and cannot import
# jax or the JAX package (the reference test's cell, and a train cell at
# full width)
ANALYSIS_CLI = (("whisper-tiny", "decode_32k"), ("qwen3-4b", "train_4k"))
ANALYSIS_CLI_TIMEOUT_S = 300
NO_JAX_MAIN = """
import importlib.abc, runpy, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} is not importable here")
        return None

sys.meta_path.insert(0, NoJax())
sys.argv = ["dryrun"] + sys.argv[1:]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
finally:
    print("JAX_LOADED", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")))
"""


def _counted(fn):
    """(fn()'s result, the op counter's OpCost of the card's program, the
    flash kernels launched), ending in a device sync."""
    before = kernels.launch_counts()
    with CostCounter("cuda") as counter:
        out = fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    return out, counter.cost(), {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}


def _count_prefill(cfg, params, tokens) -> dict:
    """19a's prefill: 8c's prefill of ``tokens`` timed once more, then once
    under the op counter (phase 8's weights, already warm)."""
    batch = {"tokens": tokens}
    prefill, _ = make_serve_steps(cfg, build(cfg))
    _, wall = _timed(lambda: prefill(params, batch))
    _, cost, launched = _counted(lambda: prefill(params, batch))
    B, S = tokens.shape
    return {"cost": cost, "launched": launched, "wall_s": wall,
            "shape": ShapeSpec("serve", S, B, "prefill"),
            "flash_shape": ((B, S, cfg.n_heads, cfg.head_dim), (B, S, cfg.n_kv, cfg.head_dim))}


def _card_bytes() -> tuple[int, int]:
    """(allocated, requested) bytes of the caching allocator now."""
    return (torch.cuda.memory_allocated(),
            torch.cuda.memory_stats().get("requested_bytes.all.current", -1))


def _count_train_step(cfg, state, step, batch, init_bytes: tuple, wall_s: float) -> dict:
    """19a/b's train step: one more step of 16d's state under the op counter,
    the card's peak of allocated bytes over the step beside the counted peak
    of live intermediates; the state's argument bytes by the dry run's
    accounting beside the (allocated, requested) bytes ``init_train_state``
    and the batch took (``init_bytes``)."""
    n_tensors = sum(1 for tree in (state.params, state.opt.m, state.opt.v)
                    for _ in tree.parameters()) + len(batch)
    args = dryrun.argument_bytes(state.params, state.opt.m, state.opt.v, batch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (_, m), cost, launched = _counted(lambda: step(state, batch))
    peak = torch.cuda.max_memory_allocated() - base
    micro = TRAIN_BATCH // max(cfg.microbatch, 1)
    return {"cost": cost, "launched": launched, "wall_s": wall_s, "loss": float(m["loss"]),
            "shape": ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
            "flash_shape": ((micro, TRAIN_SEQ, cfg.n_heads, cfg.head_dim),
                            (micro, TRAIN_SEQ, cfg.n_kv, cfg.head_dim)),
            "argument_bytes": args, "init_alloc": init_bytes[0], "init_requested": init_bytes[1],
            "n_tensors": n_tensors, "peak_temp": peak}


def _start_dryrun_cli(out_dir: Path) -> list:
    """19c's CLI runs, started at once (they need the host only, and a card
    they cannot see): one process a cell."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    dest = out_dir / "dryrun"
    procs = []
    for arch, shape in ANALYSIS_CLI:
        cmd = [sys.executable, "-c", NO_JAX_MAIN, "--arch", arch, "--shape", shape, "--mesh",
               "pod", "--out", str(dest)]
        procs.append(((arch, shape), cmd, time.perf_counter(), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def _program_line(tag: str, cfg, counted: dict, smi: str) -> dict:
    """Print and return one card program's counts, roofline and compute
    share; hold each flash launch's counted FLOPs to row 10's count."""
    cost, launched = counted["cost"], counted["launched"]
    calls = sum(v for k, v in cost.calls.items() if k.startswith("flash_attention"))
    kernel_launches = sum(v for k, v in launched.items() if k.startswith("flash_attention"))
    (B, S, H, dh), k_shape = counted["flash_shape"]
    row10 = 4 * B * H * dh * S * (S + 1) / 2  # phase 8g / 16a's bound count
    per_launch = cost.by_op.get("flash_attention", 0.0) / max(calls, 1)
    rt = roofline_terms(cfg, counted["shape"], n_devices=1, hlo_flops=cost.flops,
                        hlo_bytes=cost.hbm_bytes, collective_bytes=0)
    share = model_flops_utilization(cfg, counted["shape"], counted["wall_s"])
    top = dict(sorted(cost.by_op.items(), key=lambda kv: -kv[1])[:6])
    out = {"flops": cost.flops, "bytes": cost.hbm_bytes, "by_op": cost.by_op,
           "calls": cost.calls, "kernel_launches": launched, "flash_calls": calls,
           "flash_flops_per_launch": per_launch, "row10_count": row10,
           "peak_bytes": cost.peak_bytes, "wall_ms": counted["wall_s"] * 1e3,
           "roofline": dataclasses.asdict(rt), "model_flops_utilization": share, "card": smi}
    log(f"[19a] {tag} on {smi}: {cost.flops:.4e} FLOPs, {cost.hbm_bytes:.4e} bytes, by op "
        + ", ".join(f"{k} {v:.3e}" for k, v in top.items())
        + f"; flash calls counted {calls}, kernel launches {launched}; "
        f"{per_launch:.6e} FLOPs a flash launch (row 10's count at this shape {row10:.6e})")
    log(f"[19a] {tag}: model FLOPs {rt.model_flops:.4e}, useful ratio {rt.useful_ratio:.4f}; "
        f"roofline on one H100: compute {rt.compute_s * 1e3:.2f} ms, memory "
        f"{rt.memory_s * 1e3:.2f} ms, collective {rt.collective_s * 1e3:.2f} ms, bound by "
        f"{rt.bottleneck}; measured wall {counted['wall_s'] * 1e3:.1f} ms: model FLOPs over the "
        f"wall over the peak {share:.4f} ({share * 100:.2f}% of 989.4 TFLOP/s)")
    if calls != kernel_launches or per_launch != row10:
        raise AssertionError(f"[19a] {tag}: {calls} counted flash calls against "
                             f"{kernel_launches} launches, {per_launch} FLOPs a launch against "
                             f"row 10's {row10}")
    return out


def analysis_phase(smi, serving: dict, training: dict, cli: list) -> dict:
    """Phase 19: (a) the op counter on phase 8's prefill and 16d's train step
    on the card (FLOPs, bytes, flash launches, roofline, the compute share of
    the measured wall); (b) the dry run's argument bytes of 16d's state and
    batch against what the card allocated, the counted peak of a step's
    intermediates against the card's; (c) the dry run's CLI (started with
    phase 16) on the reference test's cell and a train cell."""
    t_phase = time.perf_counter()
    report: dict = {"card": smi}
    cfg = get_arch(SERVE_ARCH)
    report["prefill"] = _program_line(f"{cfg.name} prefill {SERVE_B} x {SERVE_S}", cfg, serving,
                                      smi)
    tcfg = get_arch(TRAIN_ARCH)
    report["train"] = _program_line(f"{tcfg.name} train step {TRAIN_BATCH} x {TRAIN_SEQ} "
                                    f"(microbatch {tcfg.microbatch})", tcfg, training, smi)
    if report["prefill"]["flash_calls"] != cfg.n_layers:
        raise AssertionError(f"[19a] the prefill counted {report['prefill']['flash_calls']} "
                             f"flash calls, not {cfg.n_layers}")
    expected = tcfg.n_layers * max(tcfg.microbatch, 1) * (2 if tcfg.remat else 1)
    if report["train"]["flash_calls"] != expected:
        raise AssertionError(f"[19a] the train step counted {report['train']['flash_calls']} "
                             f"flash calls, not {expected}")

    # (b) bytes: the dry run's accounting against the card's allocator
    args, alloc, n = training["argument_bytes"], training["init_alloc"], training["n_tensors"]
    requested = training["init_requested"]
    peak, temp = training["peak_temp"], training["cost"].peak_bytes
    ratio = peak / temp
    report["bytes"] = {"argument_bytes": args, "allocated": alloc, "requested": requested,
                       "n_tensors": n, "round": ARG_ROUND, "peak_temp": peak,
                       "counted_temp": temp, "ratio": ratio, "ratio_bar": TEMP_RATIO}
    log(f"[19b] {tcfg.name}'s state and batch by the dry run's accounting {args:,} bytes; "
        f"init_train_state and the batch requested {requested:,} of the caching allocator "
        f"(bar: equal) and it allocated {alloc:,} ({alloc - args:,} more; bar 0 to 1 MiB x "
        f"{n} tensors = {ARG_ROUND * n:,})")
    log(f"[19b] one train step's intermediates: counted peak {temp / 1e9:.3f} GB, the card's "
        f"max_memory_allocated over the step {peak / 1e9:.3f} GB above the state: "
        f"{ratio:.4f} x (bar {TEMP_RATIO[0]} to {TEMP_RATIO[1]})")
    if requested != args or not 0 <= alloc - args <= ARG_ROUND * n:
        raise AssertionError(f"[19b] requested {requested}, allocated {alloc} against {args} "
                             "argument bytes")
    if not TEMP_RATIO[0] <= ratio <= TEMP_RATIO[1]:
        raise AssertionError(f"[19b] the step's peak {peak} against the counted {temp}")

    # (c) the CLI where JAX is absent and no card is visible
    total_mem = torch.cuda.get_device_properties(0).total_memory
    report["cli"] = {}
    for (arch, shape), cmd, t0, proc in cli:
        try:
            out, _ = proc.communicate(timeout=ANALYSIS_CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        rec_path = Path(cmd[cmd.index("--out") + 1]) / f"{arch}__{shape}__pod.json"
        rec = json.loads(rec_path.read_text()) if rec_path.exists() else {}
        tag = f"{arch} {shape} pod"
        report["cli"][tag] = {"returncode": proc.returncode, "record": rec,
                              "seconds": time.perf_counter() - t0,
                              "output": out.splitlines()[-3:]}
        loaded = [ln for ln in out.splitlines() if ln.startswith("JAX_LOADED")]
        if (proc.returncode != 0 or rec.get("status") != "OK" or rec.get("n_devices") != 256
                or loaded != ["JAX_LOADED []"]):
            raise AssertionError(f"[19c] the dry run of {tag} exited {proc.returncode}: "
                                 f"{out[-2000:]}")
        mem, rl = rec["memory"], rec["roofline"]
        log(f"[19c] python -m repro_torch.launch.dryrun --arch {arch} --shape {shape} --mesh pod "
            f"(no card visible, jax and the JAX package not importable; jax installed here: "
            f"{_jax_found()}): {rec['status']}, {rec['n_devices']} ranks, traced in {rec['trace_s']} s; a rank "
            f"{rec['flops']:.4e} FLOPs, {rec['bytes_accessed']:.4e} bytes, collectives "
            f"{rec['collectives']['total']['count']} of {rec['collectives']['total']['bytes']:.4e} "
            f"bytes, argument {mem['argument_bytes']:,} bytes, temp peak {mem['temp_bytes']:,}; "
            f"roofline compute {rl['compute_s']:.4e} s, memory {rl['memory_s']:.4e} s, "
            f"collective {rl['collective_s']:.4e} s ({rl['bottleneck']}), useful ratio "
            f"{rl['useful_ratio']:.4f}")
        if shape.startswith("train") and not mem["argument_bytes"] <= total_mem:
            raise AssertionError(f"[19c] {tag}: {mem['argument_bytes']} argument bytes a rank "
                                 f"past the card's {total_mem}")
    report["card_total_memory"] = total_mem
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[19] phase 19 in {report['seconds']:.1f} s on {smi}")
    return report


def _jax_found() -> bool:
    import importlib.util

    return importlib.util.find_spec("jax") is not None


def profiled(tag: str, step, iterations: int | None = None, top: int = 12) -> dict:
    """Device busy time, launches and the ``top`` kernels of ``step()``
    (which ends in a sync), from torch.profiler; launches per PDHG iteration
    over the step's iterations, or over ``iterations`` where given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    # the card's records alone: this reads no host-side event, and a trace of
    # every host op of a cold tenant step took two minutes to process
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a control step's PDHG iterations, over all its solves
    stats = getattr(out, "stats", None)
    if iterations is None and stats is not None:
        iterations = int(np.sum(stats["phase_iterations"]))
    del out
    calls = {k: v for k, v in kernels.launch_counts().items() if v}

    def dev_us(e):
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(dev_us(e) for e in events)
    launches = sum(e.count for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:top]
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
