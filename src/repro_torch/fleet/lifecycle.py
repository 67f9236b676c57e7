"""Churn-tolerant fleet lifecycle: device join/leave bookkeeping and
double-buffered telemetry ingestion.

Two concerns the orchestrator deliberately does not own:

* **Churn bookkeeping** — :class:`FleetLifecycle` translates scheduler
  events ("these devices left the fleet", "they came back") into the
  orchestrator's re-pin primitives.  A left device is masked to a
  zero-width ``[0, 0]`` power box — its domain's values are swapped on the
  built device tensors (no rebuild, other domains untouched) and its
  minimum draw stops counting against the domain's coordinator floor.
  Rejoin restores the recorded box.  Identities are (domain, local index)
  pairs, so they survive structural rebuilds of *other* domains.

* **Telemetry ingestion** — :class:`TelemetryDoubleBuffer` overlaps trace
  decode with the solve: while the engines chew on step ``t``, a single
  background worker decodes step ``t + 1`` into the back buffer.  Telemetry
  sources are pure functions of the timestamp (see
  :mod:`repro_torch.pdn.telemetry`), so prefetching never changes results —
  only hides the decode latency.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import TYPE_CHECKING, Callable

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - typing only; keeps this module
    # importable without the orchestrator/engine chain (simulator prefetch
    # only needs TelemetryDoubleBuffer)
    from repro_torch.fleet.orchestrator import FleetOrchestrator

__all__ = ["FleetLifecycle", "TelemetryDoubleBuffer"]


class FleetLifecycle:
    """Join/leave state machine over an orchestrator's re-pin primitives."""

    def __init__(self, orch: "FleetOrchestrator"):
        self.orch = orch
        # (domain, local idx) -> recorded (l, u) box for rejoin
        self._left: dict[tuple[int, int], tuple[float, float]] = {}

    def _locate(self, device: int) -> tuple[int, int]:
        offs = self.orch._offsets()
        if not 0 <= device < offs[-1]:
            raise IndexError(f"device {device} out of range [0, {offs[-1]})")
        k = int(np.searchsorted(offs, device, side="right") - 1)
        return k, device - int(offs[k])

    def device_leave(self, devices) -> None:
        """Mask devices out of allocation (zero-width box, zero floor).

        Re-pins only the affected domains; the built device tensors and the
        other domains' warm state are untouched.  The whole batch is validated
        first — notably that every cross-cut tenant's contractual minimum
        stays deliverable by its remaining devices — so a rejected leave
        records nothing and masks nothing.
        """
        by_domain: dict[int, list[int]] = {}
        for d in np.atleast_1d(np.asarray(devices, np.int64)):
            k, i = self._locate(int(d))
            by_domain.setdefault(k, []).append(i)
        masked: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        dev_l = list(self.orch._dev_l)
        dev_u = list(self.orch._dev_u)
        for k, idxs in by_domain.items():
            l = self.orch._dev_l[k].copy()
            u = self.orch._dev_u[k].copy()
            l[idxs] = 0.0
            u[idxs] = 0.0
            masked[k] = (l, u)
            dev_l[k] = l
            dev_u[k] = u
        self.orch._check_effective_floors(dev_l=dev_l, dev_u=dev_u)
        for k, (l, u) in masked.items():
            for i in by_domain[k]:
                if (k, i) not in self._left:
                    self._left[(k, i)] = (
                        float(self.orch._dev_l[k][i]),
                        float(self.orch._dev_u[k][i]),
                    )
            self.orch.repin_domain(k, dev_l=l, dev_u=u)

    def device_join(self, devices) -> None:
        """Restore previously-left devices' recorded power boxes.

        Validates the whole batch — membership AND feasibility of every
        affected domain's restored floors under its current caps *including
        any active supply derates* — before touching any state, so a
        failure raises without consuming recorded boxes or leaving some
        domains re-pinned and others not.
        """
        from repro_torch.pdn.tree import check_caps_fund_minimums

        by_domain: dict[int, list[int]] = {}
        for d in np.atleast_1d(np.asarray(devices, np.int64)):
            k, i = self._locate(int(d))
            if (k, i) not in self._left:
                raise KeyError(f"device (domain {k}, local {i}) was not left")
            by_domain.setdefault(k, []).append(i)
        restored: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for k, idxs in by_domain.items():
            l = self.orch._dev_l[k].copy()
            u = self.orch._dev_u[k].copy()
            for i in idxs:
                l[i], u[i] = self._left[(k, i)]
            p = self.orch._local_pdn[k]
            check_caps_fund_minimums(
                p.node_start,
                p.node_end,
                self.orch._node_cap[k],
                l,
                what=f"rejoin into domain {k}: node",
            )
            restored[k] = (l, u)
        # the full batch's raised floors (device minimums + tenant minimum
        # lifts) must fit under the derated feeds, else a per-domain repin
        # partway through could fail mid-batch
        dev_l = list(self.orch._dev_l)
        dev_u = list(self.orch._dev_u)
        for k, (l, u) in restored.items():
            dev_l[k] = l
            dev_u[k] = u
        self.orch._check_effective_floors(dev_l=dev_l, dev_u=dev_u)
        for k, (l, u) in restored.items():
            for i in by_domain[k]:
                del self._left[(k, i)]
            self.orch.repin_domain(k, dev_l=l, dev_u=u)

    @property
    def n_left(self) -> int:
        return len(self._left)


class TelemetryDoubleBuffer:
    """Async-style telemetry ingestion: decode step t+1 while t solves.

    Wraps any pure ``fetch(t) -> array`` (e.g. ``TelemetrySim.power``).
    ``fetch(t)`` returns the front buffer (waiting for the background
    decode if it has not landed yet) and immediately kicks off the decode
    of ``t + 1`` into the back buffer.  One worker, two slots — classic
    double buffering; sequential access never blocks on decode once warm.
    """

    def __init__(self, fetch: Callable[[int], np.ndarray]):
        self._fetch = fetch
        self._pool: ThreadPoolExecutor | None = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="telemetry-prefetch"
        )
        self._pending: dict[int, Future] = {}

    def fetch(self, t: int) -> np.ndarray:
        if self._pool is None:
            raise RuntimeError("buffer closed")
        fut = self._pending.pop(int(t), None)
        value = fut.result() if fut is not None else self._fetch(t)
        # drop stale prefetches (random access) and prefetch the successor
        for stale in list(self._pending):
            self._pending.pop(stale).cancel()
        self._pending[int(t) + 1] = self._pool.submit(self._fetch, int(t) + 1)
        return value

    def close(self) -> None:
        if self._pool is not None:
            for fut in self._pending.values():
                fut.cancel()
            self._pending.clear()
            self._pool.shutdown(wait=False)
            self._pool = None

    def __enter__(self) -> "TelemetryDoubleBuffer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
