"""The benchmark's own spans around its calls into the port's layers, and
the device trace of a ``--trace 1`` run (``torch.profiler`` over the
measured window).

Spans are host-clock intervals kept in memory by name.  A traced run
measures the first half of its window without the profiler, whose CPU
activity slows the host's side of every loop, and reads its spans there
(the per-layer metrics of the host clock); it traces the second half for
the device's metrics.  There each span is also a ``record_function`` range
named ``portbench.<name>``, so that an idle gap of the device can be put
down to what the host was doing then."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

SPAN_PREFIX = "portbench."


def window_parts(seconds: float, traced: bool) -> list:
    """The measured window's parts, each (its end in seconds from the
    window's start, traced): a traced run's first half runs untraced."""
    return [(seconds / 2, False), (seconds, True)] if traced else [(seconds, False)]


class Spans:
    """Host-clock spans by name, and counters; ``traced`` adds a
    ``record_function`` range to each span."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.spans: dict[str, list[float]] = defaultdict(list)  # seconds
        self.counters: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function

            rf = record_function(SPAN_PREFIX + name)
        t0 = time.perf_counter()
        with rf:
            yield
        self.spans[name].append(time.perf_counter() - t0)

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value


def union_length(intervals) -> float:
    """Total length of the union of (start, end) intervals, in their unit."""
    total, end = 0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclass
class Record:
    """What a traced run leaves for the per-layer readers: of its traced
    part, the wall, the device's operations, the benchmark's spans as the
    profiler saw them and the work done (``items``: one dict per forward or
    step, as the driver describes it); of its untraced part, the wall, the
    spans, the counters and the work (``host_items``)."""

    window_s: float
    device_ops: list  # (name, start_ns, end_ns) of each device operation
    host_ranges: list  # (span name, start_ns, end_ns) of the benchmark's spans
    items: list
    host_window_s: float
    spans: dict  # name -> host-clock seconds of each span, untraced
    counters: dict
    host_items: list
    config: dict  # the configuration file
    traffic: dict
    port: dict = field(default_factory=dict)  # the port config's fields, as run

    @property
    def busy_s(self) -> float:
        return union_length((s, e) for _, s, e in self.device_ops) / 1e9

    def device_time_s(self, match) -> float:
        """Summed device time of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device_ops if match(n)) / 1e9

    def count_ops(self, match) -> int:
        return sum(1 for n, _, _ in self.device_ops if match(n))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by name), and the
        device's idle time by the innermost benchmark span the host was in
        at each gap's middle ("outside" where none was open)."""
        by_op = defaultdict(int)
        for n, s, e in self.device_ops:
            by_op[n] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        busy = merged((s, e) for _, s, e in self.device_ops)
        ranges = sorted(self.host_ranges, key=lambda r: r[1])
        by_host = defaultdict(int)
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = (e0 + s1) // 2
            inner = [r for r in ranges if r[1] <= mid < r[2]]
            label = min(inner, key=lambda r: r[2] - r[1])[0] if inner else "outside"
            by_host[label] += s1 - e0
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], t / 1e9] for n, t in ops],
                "idle_gaps": [[n, t / 1e9] for n, t in gaps]}


class DeviceTrace:
    """``torch.profiler`` (CPU and CUDA activity) around a window; after the
    window, ``device_ops`` and ``host_ranges`` hold its events."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.device_ops: list = []
        self.host_ranges: list = []
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        # a record_function range also lays a range of its name on the
        # device's timeline: an annotation, not an operation
        annotations = {e.name() for e in events
                       if e.device_type() != DeviceType.CUDA and e.is_user_annotation()}
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if name not in annotations and not name.startswith(SPAN_PREFIX):
                    self.device_ops.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name.startswith(SPAN_PREFIX):
                self.host_ranges.append((name[len(SPAN_PREFIX):], e.start_ns(),
                                         e.start_ns() + e.duration_ns()))
        self._prof = None
        return False
