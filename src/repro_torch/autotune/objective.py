"""Objectives the autotuner can minimize (port of ``repro.autotune.objective``).

All three are computed from the same PowerMonitor ``totals`` dict (the
executed-energy ledger's ``totals`` section, or the pruning model's
per-iteration totals), so model and measurement rank on one quantity:

* ``energy`` — total Joules to solution, ``te_gpu + te_cpu``: static plus
  dynamic, since race-to-idle is a trade-off only when the idle power a
  slower run keeps burning is charged to it;
* ``time``   — modeled runtime (seconds);
* ``edp``    — energy-delay product, ``energy * time``.

Lower is better for all objectives. Every one of them is a model: the
counts are executed, the prices come from ``roofline/hw.py``.
"""

from __future__ import annotations

OBJECTIVES = ("energy", "edp", "time")


def total_energy_j(totals: dict) -> float:
    """Total (static + dynamic) chip + host energy of a ledger/monitor."""
    return float(totals["te_gpu"]) + float(totals["te_cpu"])


def score(objective: str, totals: dict) -> float:
    """Scalar score (lower is better) of one ``totals`` dict."""
    if objective == "energy":
        return total_energy_j(totals)
    if objective == "time":
        return float(totals["runtime"])
    if objective == "edp":
        return total_energy_j(totals) * float(totals["runtime"])
    raise ValueError(
        f"unknown objective {objective!r} (one of {OBJECTIVES})"
    )
