"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Every source is compiled with ``nvcc`` for ``sm_90a`` into an object, all of
them in parallel, and linked into one shared library with a plain C
interface, loaded with :mod:`ctypes`.  The library lands in
``build/repro_torch/`` at the repository root, named by a hash of the
sources, the headers they share (``csrc/*.cuh``) and the flags, so a
changed source rebuilds and an unchanged one is reused.  Nothing links
against ``libcuda``: the one driver call (``cuTensorMapEncodeTiled``, for
the TMA tensor maps) is reached through the runtime's entry-point query.  The ``nvcc`` log and build time are kept beside the library (same
name, ``.json``) so a reused build still reports them.  Nothing here runs at
import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

__all__ = [
    "AccRows",
    "BuildInfo",
    "ChunkStatsArgs",
    "DualRows",
    "DualUpdateArgs",
    "PrimalStatsRows",
    "PrimalStepArgs",
    "ScaledAdjoint",
    "StatsRows",
    "build",
    "library",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float
_F64 = ctypes.c_double

_SOLVER = ("f64", "f32")  # the allocator's kernels: float64 and float32 twins
# flash attention: the Hopper (TMA + wgmma) and mma.sync bfloat16 kernels and
# the float32 one
_ATTENTION = ("wgmma", "mma", "f32")



class DualRows(ctypes.Structure):
    """One row block of ``dual_update`` (``csrc/pdhg_update.cu``, ``DualRows<T>``):
    the duals, the matvec's raw output, the row scales, the step sizes (a
    stride of 1 or 0 within a lane, ``sig_lane`` between lanes), the bounds,
    the output and the row count (a lane's)."""

    _fields_ = [
        ("y", _PTR), ("a", _PTR), ("d", _PTR), ("sig", _PTR), ("sig_stride", _I64),
        ("sig_lane", _I64), ("lo", _PTR), ("hi", _PTR), ("out", _PTR), ("count", _I64),
    ]


class DualUpdateArgs(ctypes.Structure):
    """The fused dual step's arguments, passed by value (``DualUpdateArgs<T>``):
    the tree, tenant and improvement rows and the ``s_t``, ``t_mov`` and
    ``te`` of the improvement rows' t column (one per lane, read through
    ``scalar_lane``)."""

    _fields_ = [
        ("tree", DualRows), ("sla", DualRows), ("imp", DualRows),
        ("s_t", _PTR), ("t_mov", _PTR), ("te", _PTR), ("scalar_lane", _I64),
    ]


class PrimalStatsRows(ctypes.Structure):
    """The primal block of ``chunk_stats`` (``csrc/pdhg_update.cu``,
    ``PrimalStatsRows<T>``): the iterate, the previous check's iterate, the
    restart anchor, the accumulator, the new accumulator, the four results
    and the count."""

    _fields_ = [
        ("x", _PTR), ("px", _PTR), ("rx", _PTR), ("ax", _PTR), ("axn", _PTR), ("out", _PTR),
        ("count", _I64),
    ]


class StatsRows(ctypes.Structure):
    """One dual block of ``chunk_stats`` (``StatsRows<T>``): the duals, the
    restart anchor, the accumulator, the new accumulator, the three sums and
    the count."""

    _fields_ = [
        ("y", _PTR), ("ry", _PTR), ("ay", _PTR), ("ayn", _PTR), ("out", _PTR), ("count", _I64),
    ]


class AccRows(ctypes.Structure):
    """The accumulators of ``chunk_stats`` (``AccRows<T>``): the 0-d ``t``,
    its accumulator and the new one, the k tenant duals, their accumulator
    and the new one, and k."""

    _fields_ = [
        ("t", _PTR), ("at", _PTR), ("atn", _PTR), ("ys", _PTR), ("ays", _PTR), ("aysn", _PTR),
        ("count", _I64),
    ]


class ChunkStatsArgs(ctypes.Structure):
    """``chunk_stats``' arguments, passed by value (``ChunkStatsArgs<T>``):
    the primal block, two dual blocks, the accumulators, the partial rows of
    the statistics blocks and their three ticket counters (per lane), the
    lanes' counts (null: the one count passed by value) and the results per
    lane."""

    _fields_ = [
        ("primal", PrimalStatsRows), ("first", StatsRows), ("second", StatsRows),
        ("acc", AccRows), ("part", _PTR), ("tickets", _PTR), ("cnt", _PTR),
        ("out_lane", _I64),
    ]


class ScaledAdjoint(ctypes.Structure):
    """The scaled adjoint's inputs (``csrc/tree_matvec.cu``, ``ScaledAdjoint<T>``):
    duals and row scales of the tree, tenant and improvement rows, the two
    CSR indexes, ``s * mov``, the tenant, device and tree-row counts, and
    the indexes' lane strides (0: every lane shares one topology)."""

    _fields_ = [
        ("y_tree", _PTR), ("d_tree", _PTR), ("cover_ptr", _PTR), ("cover_rows", _PTR),
        ("y_sla", _PTR), ("d_sla", _PTR), ("dev_ptr", _PTR), ("dev_ten", _PTR),
        ("y_imp", _PTR), ("d_imp", _PTR), ("sm", _PTR), ("k", _I64), ("n", _I64), ("m", _I64),
        ("cover_ptr_lane", _I64), ("cover_rows_lane", _I64), ("dev_ptr_lane", _I64),
        ("dev_ten_lane", _I64),
    ]


class PrimalStepArgs(ctypes.Structure):
    """``primal_step``'s arguments, passed by value (``PrimalStepArgs<T>``):
    the adjoint's, the primal iterate, the prox's data, the step size (a
    stride of 1 or 0 within a lane, ``tau_lane`` between lanes) and the
    outputs."""

    _fields_ = [
        ("adj", ScaledAdjoint), ("x", _PTR), ("c", _PTR), ("w", _PTR), ("target", _PTR),
        ("lo", _PTR), ("hi", _PTR), ("tau", _PTR), ("tau_stride", _I64), ("tau_lane", _I64),
        ("x1", _PTR), ("xe", _PTR), ("xm", _PTR), ("yi", _PTR),
    ]


# argument types of every exported function, by name stem, and the type
# suffixes of its twins
# (device, v, v_lane, ptr, ptr_lane, idx, idx_lane, nseg, lanes, out, stream)
_LISTS = [_INT, _PTR, _I64, _PTR, _I64, _PTR, _I64, _I64, _I64, _PTR, _PTR]
_SIGNATURES = {
    "tree_matvec": ([_INT] + [_PTR] * 5 + [_I64] * 4 + [_PTR], _SOLVER),
    "primal_update": ([_INT] + [_PTR] * 8 + [_I64] * 4 + [_PTR] * 3, _SOLVER),
    "dual_prox": ([_INT] + [_PTR] * 3 + [_I64, _I64, _PTR, _PTR, _I64, _I64, _PTR, _PTR],
                  _SOLVER),
    "dual_update": ([_INT, DualUpdateArgs, _I64, _PTR], _SOLVER),
    "scaled_rmatvec": ([_INT, ScaledAdjoint, _I64, _PTR, _PTR, _PTR], _SOLVER),
    "primal_step": ([_INT, PrimalStepArgs, _I64, _PTR], _SOLVER),
    "segment_sums": (_LISTS, _SOLVER),
    "sla_matvec": (_LISTS, _SOLVER),
    "chunk_stats": ([_INT, ChunkStatsArgs, _F64, _INT, _I64, _PTR], _SOLVER),
    "flash_attention": (
        [_INT] + [_PTR] * 5 + [_I64] * 6 + [ctypes.POINTER(_I64), _F32, _INT, _PTR],
        _ATTENTION,
    ),
}


class BuildInfo(NamedTuple):
    """Where the library is, how long its build took, what ``nvcc`` said
    (``-Xptxas -v``: registers, shared memory, spills) and whether this call
    reused a library built earlier (then ``seconds`` and ``log`` are that
    build's)."""

    path: Path
    seconds: float
    log: str
    reused: bool


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        f"nvcc not found under {cuda_home}/bin or on PATH; the CUDA kernels "
        "are built on the machine with the card"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the sources (in parallel) and link them, unless a library
    with the same hash exists already."""
    sources = _sources()
    out = BUILD_DIR / f"librepro_torch_{_digest(sources)}.so"
    record = out.with_suffix(".json")
    if out.is_file():
        kept = json.loads(record.read_text()) if record.is_file() else {}
        return BuildInfo(out, kept.get("seconds", 0.0), kept.get("log", ""), True)
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        logs = []
        failed = []
        for src, proc in zip(sources, procs):
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib_tmp), *map(str, objs)],
            capture_output=True,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        seconds, log = time.perf_counter() - t0, "\n".join(logs)
        record_tmp = Path(tmp) / record.name
        record_tmp.write_text(json.dumps({"seconds": seconds, "log": log}))
        os.replace(record_tmp, record)
        os.replace(lib_tmp, out)
    return BuildInfo(out, seconds, log, False)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every exported
    function's argument and return types declared."""
    lib = ctypes.CDLL(str(build().path))
    for stem, (argtypes, suffixes) in _SIGNATURES.items():
        for suffix in suffixes:
            fn = getattr(lib, f"{stem}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.tree_scan_tile.argtypes = []
    lib.tree_scan_tile.restype = ctypes.c_int
    lib.tree_cluster_tiles.argtypes = []
    lib.tree_cluster_tiles.restype = ctypes.c_int
    lib.elementwise_grid_threads.argtypes = []
    lib.elementwise_grid_threads.restype = ctypes.c_int64
    lib.chunk_stats_blocks.argtypes = [_I64]
    lib.chunk_stats_blocks.restype = ctypes.c_int64
    return lib
