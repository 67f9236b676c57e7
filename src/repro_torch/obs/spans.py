"""Host-side wall-clock spans for the control interval's Python stages.

A control interval spends wall time in host code as well as on the device:
telemetry decode, dispatch bookkeeping, metric evaluation, result fetch.
Spans cover that — nestable, thread-local, near-free when disabled (one
attribute check per call site).

Usage::

    from repro_torch.obs import spans

    spans.enable()
    with spans.span("sim.control"):
        res = controller.step(telemetry)
    ...
    print(spans.summary())   # {"sim.control": {"count": ..., "p95_ms": ...}}

Span names nest by the runtime stack: a ``span("solve")`` opened inside
``span("sim.control")`` records as ``sim.control/solve``, so the summary
shows where each parent's time went.

Profiler: with ``enable(annotate=True)`` — which :func:`profile_trace` turns
on — :func:`span` also opens a ``torch.profiler.record_function`` range, so
host stages line up with the device's kernels in the exported Chrome trace.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np

__all__ = [
    "enable",
    "disable",
    "enabled",
    "span",
    "traced",
    "drain",
    "reset",
    "summary",
    "profile_trace",
]

_lock = threading.Lock()
_records: list[tuple[str, float, float]] = []  # (path, t0, duration_s)
_local = threading.local()

_enabled = False
_annotate = False  # also open a torch.profiler.record_function per span


def enable(*, annotate: bool = False) -> None:
    """Turn span recording on (optionally with profiler annotations)."""
    global _enabled, _annotate
    _enabled = True
    _annotate = annotate


def disable() -> None:
    global _enabled, _annotate
    _enabled = False
    _annotate = False


def enabled() -> bool:
    return _enabled


def _stack() -> list[str]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Record a named wall-clock span (no-op unless :func:`enable` ran)."""
    if not _enabled:
        yield
        return
    stack = _stack()
    path = "/".join(stack + [name]) if stack else name
    stack.append(name)
    ann = None
    if _annotate:
        import torch.profiler

        ann = torch.profiler.record_function(path)
        ann.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        if ann is not None:
            ann.__exit__(None, None, None)
        stack.pop()
        with _lock:
            _records.append((path, t0, dur))


def traced(name: str) -> Callable:
    """Decorator form of :func:`span` for whole host-stage functions."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def drain() -> list[dict[str, Any]]:
    """Pop and return every recorded span as ``{"span", "t0", "ms"}``."""
    with _lock:
        recs, _records[:] = _records[:], []
    return [{"span": p, "t0": t0, "ms": d * 1e3} for p, t0, d in recs]


def reset() -> None:
    with _lock:
        _records[:] = []


def summary(records: list[dict[str, Any]] | None = None) -> dict[str, dict]:
    """Per-path count/total/percentile summary (ms).  Pass the output of
    :func:`drain` to summarize without consuming the live buffer twice."""
    if records is None:
        with _lock:
            records = [{"span": p, "ms": d * 1e3} for p, _, d in _records]
    by_path: dict[str, list[float]] = {}
    for rec in records:
        by_path.setdefault(rec["span"], []).append(rec["ms"])
    out = {}
    for path, ms in sorted(by_path.items()):
        arr = np.asarray(ms)
        out[path] = {
            "count": len(ms),
            "total_ms": float(arr.sum()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "p99_ms": float(np.percentile(arr, 99)),
        }
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Opt-in profiler capture: runs ``torch.profiler.profile`` (the CPU,
    and the card when there is one) with span annotations on, and exports a
    Chrome trace, ``log_dir/trace.json``, on exit (load it at
    ui.perfetto.dev)."""
    global _enabled, _annotate
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    was_enabled, was_annotate = _enabled, _annotate
    enable(annotate=True)
    try:
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(str(out / "trace.json"))
    finally:
        _enabled, _annotate = was_enabled, was_annotate
