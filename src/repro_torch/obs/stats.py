"""Typed per-step solver statistics: one record shape for every path.

A host-only copy of the reference's ``repro.obs.stats.StepStats``.  It
subclasses ``dict`` so consumers can index it (``stats["total_solves"]``,
``stats.get("skipped", False)``); the canonical *and* alias spellings are
both present as keys, and canonical fields are additionally readable as
attributes (``stats.solves``).  The reference's ``from_jit`` converter
belongs to the batched engine and comes with it.
"""

from __future__ import annotations

from typing import Any

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

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            alias = _ALIASES.get(name)
            if alias is not None and alias in self:
                return self[alias]
            raise AttributeError(name) from None
