"""Typed per-step solver statistics: one record shape for every path.

A host-only copy of the reference's ``repro.obs.stats.StepStats``.  It
subclasses ``dict`` so consumers can index it (``stats["total_solves"]``,
``stats.get("skipped", False)``); the canonical *and* alias spellings are
both present as keys, and canonical fields are additionally readable as
attributes (``stats.solves``).  :meth:`StepStats.from_tensors` is the
counterpart of the reference's ``from_jit`` for the one-scenario engine,
:meth:`StepStats.from_lanes` for K scenarios (K what-if lanes, or a
stacked fleet's K domains).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["StepStats"]

# canonical name -> legacy alias also stored as a key
_ALIASES = {
    "solves": "total_solves",
    "iterations": "total_iterations",
    "phase_iterations": "iterations_per_phase",
}


class StepStats(dict):
    """Per-step solver statistics (dict-compatible typed record).

    Canonical fields: ``solves``, ``iterations``, ``phase_iterations``
    (``[3]`` or ``[K, 3]``), ``converged``, ``skipped``, ``certify_pass``,
    and (when the producing path reports them) ``kkt_certified``,
    ``truncated``, ``kkt_res``, ``restarts``, ``kkt_hist``.  Values are
    Python scalars on the host path.
    """

    @classmethod
    def build(
        cls,
        *,
        solves: Any,
        iterations: Any,
        phase_iterations: Any,
        converged: Any,
        skipped: Any,
        certify_pass: Any,
        kkt_certified: Any = None,
        truncated: Any = None,
        kkt_res: Any = None,
        restarts: Any = None,
        kkt_hist: Any = None,
        **extras: Any,
    ) -> "StepStats":
        out = cls()
        fields = {
            "solves": solves,
            "iterations": iterations,
            "phase_iterations": phase_iterations,
            "converged": converged,
            "skipped": skipped,
            "certify_pass": certify_pass,
            "kkt_certified": kkt_certified,
            "truncated": truncated,
            "kkt_res": kkt_res,
            "restarts": restarts,
            "kkt_hist": kkt_hist,
        }
        for name, value in fields.items():
            if value is None:
                continue
            out[name] = value
            alias = _ALIASES.get(name)
            if alias is not None:
                out[alias] = value
        out.update(extras)
        return out

    @classmethod
    def from_tensors(cls, stats: dict, **extras: Any) -> "StepStats":
        """Convert the stats dict of
        :func:`repro_torch.core.batched.solve_three_phase` (keys ``solves``,
        ``iterations``, ``iterations_p1..3``, flags; counts and flags are
        host values, ``kkt_res`` and ``kkt_hist`` device tensors) to host
        scalars — the reference's ``from_jit(..., scalar=True)``, the
        engine's (K = 1) record."""

        def host(v):
            return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

        return cls.build(
            solves=int(stats["solves"]),
            iterations=int(stats["iterations"]),
            phase_iterations=[int(stats[f"iterations_p{i}"]) for i in (1, 2, 3)],
            converged=bool(stats["converged"]),
            skipped=bool(stats["skipped"]),
            certify_pass=bool(stats["certify_pass"]),
            kkt_certified=bool(stats["kkt_certified"]),
            truncated=bool(stats["truncated"]),
            kkt_res=float(host(stats["kkt_res"])),
            restarts=int(stats["restarts"]),
            kkt_hist=host(stats["kkt_hist"]),
            **extras,
        )

    @classmethod
    def from_lanes(cls, stats: dict, **extras: Any) -> "StepStats":
        """Convert the stats dict of the K-lane program
        (:func:`repro_torch.core.batched.optimize_batched`; counts and flags
        numpy arrays of K entries, ``kkt_res`` a ``[K, 1]`` and ``kkt_hist`` a
        ``[K, buckets]`` device tensor) to per-scenario host arrays, with
        ``phase_iterations`` ``[K, 3]`` — the reference's ``from_jit``."""
        pi = np.stack([np.asarray(stats[f"iterations_p{i}"]) for i in (1, 2, 3)], axis=-1)
        return cls.build(
            solves=np.asarray(stats["solves"]),
            iterations=np.asarray(stats["iterations"]),
            phase_iterations=pi,
            converged=np.asarray(stats["converged"]),
            skipped=np.asarray(stats["skipped"]),
            certify_pass=np.asarray(stats["certify_pass"]),
            kkt_certified=np.asarray(stats["kkt_certified"]),
            truncated=np.asarray(stats["truncated"]),
            kkt_res=stats["kkt_res"].reshape(-1).cpu().numpy(),
            restarts=np.asarray(stats["restarts"]),
            kkt_hist=stats["kkt_hist"].cpu().numpy(),
            **extras,
        )

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            alias = _ALIASES.get(name)
            if alias is not None and alias in self:
                return self[alias]
            raise AttributeError(name) from None
