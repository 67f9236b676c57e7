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

__all__ = ["BuildInfo", "DualRows", "DualUpdateArgs", "build", "library"]

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
    stride of 1 or 0), the bounds, the output and the row count."""

    _fields_ = [
        ("y", _PTR), ("a", _PTR), ("d", _PTR), ("sig", _PTR), ("sig_stride", _I64),
        ("lo", _PTR), ("hi", _PTR), ("out", _PTR), ("count", _I64),
    ]


class DualUpdateArgs(ctypes.Structure):
    """The fused dual step's arguments, passed by value (``DualUpdateArgs<T>``):
    the tree, tenant and improvement rows and the 0-d ``s_t``, ``t_mov`` and
    ``te`` of the improvement rows' t column."""

    _fields_ = [
        ("tree", DualRows), ("sla", DualRows), ("imp", DualRows),
        ("s_t", _PTR), ("t_mov", _PTR), ("te", _PTR),
    ]


# argument types of every exported function, by name stem, and the type
# suffixes of its twins
_SIGNATURES = {
    "tree_matvec": ([_INT] + [_PTR] * 5 + [_I64, _I64, _PTR], _SOLVER),
    "primal_update": ([_INT] + [_PTR] * 8 + [_I64, _I64, _PTR, _PTR, _PTR], _SOLVER),
    "dual_prox": ([_INT] + [_PTR] * 3 + [_I64, _PTR, _PTR, _I64, _PTR, _PTR], _SOLVER),
    "dual_update": ([_INT, DualUpdateArgs, _PTR], _SOLVER),
    "scaled_rmatvec": ([_INT] + [_PTR] * 11 + [_I64, _I64] + [_PTR] * 3, _SOLVER),
    "segment_sums": ([_INT] + [_PTR] * 3 + [_I64, _PTR, _PTR], _SOLVER),
    "sla_matvec": ([_INT] + [_PTR] * 3 + [_I64, _PTR, _PTR], _SOLVER),
    "primal_chunk_stats": ([_INT] + [_PTR] * 4 + [_F64, _I64] + [_PTR] * 4, _SOLVER),
    "dual_chunk_stats": ([_INT] + [_PTR] * 3 + [_F64, _I64] + [_PTR] * 4, _SOLVER),
    "flash_attention": (
        [_INT] + [_PTR] * 4 + [_I64] * 6 + [ctypes.POINTER(_I64), _F32, _INT, _PTR],
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
