"""Energy-aware autotuning: model-pruned, trial-measured configuration
selection for the port's solver stack (port of ``repro.autotune``).

1. :func:`space.enumerate_space` spans {format × variant × overlap × BCSR
   block × DVFS frequency}, and at 8 shards or more also the 2-D grid and
   the s-step block size;
2. :func:`prune.prune` scores the whole space analytically (stored-bytes
   format model + CG hot-path traffic + the frequency-extended power
   model) and keeps the top-K Pareto candidates;
3. :func:`trial.run_trials` runs each survivor for a few real iterations
   under the region trace, on the tuning device, and scores the *executed*
   ledger extrapolated to convergence;
4. the winner is persisted in a fingerprint-keyed cache
   (:class:`cache.TuneCache`, ``runs/autotune/cache.json``) so repeat
   solves skip the search.

The decision rests on modeled time and energy of executed counts, priced
with ``roofline/hw.H100_SXM``; the frequency axis re-prices those counts
and never touches the card's clocks. Under the same chip model the port
makes the JAX package's decision on the same matrix (the tests price both
with the JAX package's chip).

Entry point: :func:`autotune`. ``launch.solve --autotune`` (``api.solve``
with ``SolverConfig(autotune=True)``) runs it before the solve and
reports the decision in the ledger's ``autotune`` section.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.autotune.cache import DEFAULT_PATH, TuneCache, fingerprint, model_hash
from repro_torch.autotune.objective import OBJECTIVES, score, total_energy_j
from repro_torch.autotune.prune import Prediction, interior_stats, prune
from repro_torch.autotune.space import (
    DEFAULT,
    SSTEP_S,
    Candidate,
    enumerate_space,
    sort_key,
)
from repro_torch.autotune.trial import Trial, extrapolate_iters, run_trials, trial_matrix
from repro_torch.energy.accounting import CostModel

__all__ = [
    "OBJECTIVES", "DEFAULT", "DEFAULT_PATH", "SSTEP_S", "Candidate",
    "Prediction", "Trial", "TuneCache", "TuneResult", "autotune",
    "enumerate_space", "extrapolate_iters", "fingerprint", "interior_stats",
    "model_hash", "prune", "run_trials", "score", "sort_key",
    "total_energy_j",
]


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one :func:`autotune` call (cache hit or full search)."""

    chosen: Candidate
    objective: str
    fingerprint: dict
    cached: bool  # True = served from the tuning cache, nothing ran
    candidates_total: int  # enumerated space size (0 on a cache hit)
    candidates_pruned: int  # dropped by the analytic model stage
    candidates_trialed: int  # executed trial solves (0 on a cache hit)
    trials: tuple  # Trial records, best score first
    # host seconds of the model stage (interior statistics included; the
    # ELL partition it prices on is not) and of the trial stage (its
    # partitions included); 0 on a cache hit
    prune_s: float = dataclasses.field(default=0.0, compare=False)
    trial_s: float = dataclasses.field(default=0.0, compare=False)

    def ledger_section(self) -> dict:
        """The ledger's ``autotune`` section (the JAX package's, key for
        key)."""
        return dict(
            objective=self.objective,
            fingerprint=self.fingerprint,
            cached=self.cached,
            candidates_total=self.candidates_total,
            candidates_pruned=self.candidates_pruned,
            candidates_trialed=self.candidates_trialed,
            chosen=self.chosen.to_dict(),
            chosen_label=self.chosen.label,
            trials=[t.to_ledger() for t in self.trials],
        )


def autotune(
    a_csr,
    n_shards: int,
    *,
    device=None,
    objective: str = "energy",
    budget: int = 6,
    cost: CostModel | None = None,
    cache_path: str = DEFAULT_PATH,
    tol: float = 1e-8,
    trial_iters: int = 8,
    maxiter_cap: int = 10000,
    force: bool = False,
    mats: dict | None = None,
    nrhs: int = 1,
    partition_s: dict | None = None,
) -> TuneResult:
    """Select the solver configuration minimizing ``objective``.

    Args:
        a_csr: host scipy CSR system matrix (SPD).
        n_shards: shard count, all stacked on ``device`` (part of the
            fingerprint: a different partition is a different search).
        device: where the trials run: ``cuda`` unless the caller passes
            ``"cpu"``; raises when CUDA is asked for and absent.
        objective: ``"energy"`` | ``"edp"`` | ``"time"``.
        budget: most executions the trial stage may run (the top-K of the
            model stage's Pareto front; the default configuration always
            rides along, so at most ``budget + 1`` are run).
        cost: cost model to price with (hashed into the cache key; default
            ``CostModel()``, the H100 model).
        cache_path: tuning-cache location (``runs/autotune/cache.json``).
        tol: solve tolerance the iteration extrapolation targets.
        trial_iters: real iterations each trial runs.
        maxiter_cap: extrapolation cap for stagnating trials.
        force: re-tune even on a cache hit (the fresh result overwrites).
        mats: optional partition dict shared with the caller
            (``SolverSession.mats``, keyed by ``SolverSession.matrix_key``),
            so the final solve reuses the winner's partition.
        nrhs: right-hand sides per solve. ``nrhs`` > 1 tunes the batched
            block solver: the variant axis collapses to ``hs`` (the block
            body is block-HS), the model prices the SpMM's amortized matrix
            traffic and the trials run the block solver. The fingerprint
            carries ``nrhs``.
        partition_s: optional dict that records the seconds each new
            partition took, under its ``mats`` key.

    Returns:
        :class:`TuneResult`; ``result.chosen`` is the winning
        :class:`Candidate`. On a cache hit nothing is partitioned or run
        (``cached=True``, ``candidates_trialed == 0``).
    """
    from repro_torch.core.partition import default_grid
    from repro_torch.launch.mesh import resolve_device

    if objective not in OBJECTIVES:
        raise ValueError(f"objective must be one of {OBJECTIVES}: {objective}")
    dev = resolve_device(device)
    nrhs = max(int(nrhs), 1)
    cost = cost or CostModel()
    fp = fingerprint(a_csr, n_shards, objective, nrhs=nrhs)
    cache = TuneCache(cache_path)
    if not force:
        hit = cache.get(fp, cost)
        if hit is not None:
            return TuneResult(
                chosen=hit, objective=objective, fingerprint=fp, cached=True,
                candidates_total=0, candidates_pruned=0,
                candidates_trialed=0, trials=(),
            )

    mats = mats if mats is not None else {}
    mat_ell = trial_matrix(a_csr, n_shards, DEFAULT, mats, device=dev,
                           partition_s=partition_s)
    t0 = time.perf_counter()
    # The grid and s-step axes open only where they can pay: below 8
    # shards the default grid is 1xS or 2x2 (as much halo surface as 1-D),
    # and the exposed all-reduce latency s-step amortizes cannot pay for
    # its redundant ghost compute; small searches stay as they were.
    grids: tuple = (None,)
    if n_shards >= 8:
        g = default_grid(n_shards)
        if g[0] > 1:
            grids = (None, g)
    sstep_s: tuple = SSTEP_S if n_shards >= 8 else ()
    if nrhs > 1:
        # the block body is block-HS; fcg/pipecg have no block counterpart
        candidates = enumerate_space(
            cost.power.chip, variants=("hs",), grids=grids
        )
    else:
        candidates = enumerate_space(
            cost.power.chip, grids=grids, sstep_s=sstep_s
        )
    survivors, _ = prune(
        candidates, a_csr, mat_ell, cost=cost, objective=objective,
        keep=budget, nrhs=nrhs,
    )
    t1 = time.perf_counter()
    trials = run_trials(
        a_csr, n_shards, survivors, device=dev, cost=cost,
        objective=objective, tol=tol, trial_iters=trial_iters,
        maxiter_cap=maxiter_cap, mats=mats, nrhs=nrhs,
        partition_s=partition_s,
    )
    t2 = time.perf_counter()
    trials = sorted(trials, key=lambda t: (t.score, sort_key(t.candidate)))
    chosen = trials[0].candidate
    cache.put(fp, cost, chosen, extra=dict(objective=objective))
    return TuneResult(
        chosen=chosen, objective=objective, fingerprint=fp, cached=False,
        candidates_total=len(candidates),
        candidates_pruned=len(candidates) - len(survivors),
        candidates_trialed=sum(1 for t in trials if t.executed),
        trials=tuple(trials), prune_s=t1 - t0, trial_s=t2 - t1,
    )
