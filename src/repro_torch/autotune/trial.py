"""Stage 2 — measured trials of the pruning survivors (port of
``repro.autotune.trial``).

Each surviving candidate runs a few real iterations through the port's own
machinery: its format is partitioned on the tuning device
(``core/partition.partition_csr``), its solver built (``core/cg.make_solver``
or ``make_block_solver``) and run under the region trace
(``energy/trace.capture``), so a trial's operation counts are the executed
counts of the solve, not the pruning model's. On ``cuda`` the trial runs
the hand-written kernels, as every solve there does. The trial's
convergence rate extrapolates the iteration count to the requested
tolerance, and ``trace.ledger_from_trace`` prices the counts at that
iteration count with the candidate's DVFS-point cost model.

Candidates that differ only in frequency share one execution
(``Candidate.exec_key``): the frequency axis is a model. It re-prices the
executed counts on the downclocked chip model; it never sets a clock or a
power limit on the card.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from repro_torch.autotune.objective import score as objective_score
from repro_torch.autotune.objective import total_energy_j
from repro_torch.autotune.prune import Prediction
from repro_torch.autotune.space import Candidate
from repro_torch.energy import trace
from repro_torch.energy.accounting import CostModel


@dataclasses.dataclass(frozen=True)
class Trial:
    """One scored survivor: model prediction next to measurement."""

    candidate: Candidate
    executed: bool  # False = priced off another candidate's execution
    iters_trial: int  # iterations the trial solve actually ran
    relres_trial: float  # relative residual after the trial iterations
    iters_est: int  # iterations extrapolated to convergence
    predicted_time_s: float  # stage-1 model, extrapolated to iters_est
    predicted_energy_j: float
    measured_time_s: float  # executed-counts ledger at iters_est
    measured_energy_j: float
    score: float  # objective score of the measured ledger

    def to_ledger(self) -> dict:
        d = self.candidate.to_dict()
        d.update(
            label=self.candidate.label,
            executed=self.executed,
            iters_trial=self.iters_trial,
            iters_est=self.iters_est,
            predicted_time_s=self.predicted_time_s,
            predicted_energy_j=self.predicted_energy_j,
            measured_time_s=self.measured_time_s,
            measured_energy_j=self.measured_energy_j,
            score=self.score,
        )
        return d


def extrapolate_iters(
    iters: int, relres: float, tol: float, cap: int = 100000
) -> int:
    """Iterations to reach ``tol`` at the trial's measured reduction rate.

    The trial ran ``iters`` iterations and ended at relative residual
    ``relres``; if the per-iteration reduction factor
    ``rho = relres**(1/iters)`` persists, convergence needs
    ``log(tol)/log(rho)`` iterations. A converged (or zero-iteration) trial
    returns its own count; a stagnating one (rho ~ 1) returns ``cap``.
    """
    iters = int(iters)
    if iters <= 0:
        return 1
    if relres <= tol:
        return iters
    rho = relres ** (1.0 / iters)
    if rho >= 1.0 - 1e-12:
        return int(cap)
    need = math.ceil(math.log(tol) / math.log(rho))
    return int(min(max(need, iters), cap))


def trial_matrix(a_csr, n_shards: int, c: Candidate, mats: dict, *, device,
                 partition_s: dict | None = None):
    """The partition candidate ``c`` executes on, from ``mats`` or built
    there on ``device`` under the session's key
    (``SolverSession.matrix_key``: ``(fmt, block[, grid])``, depth-tagged
    for an s-step candidate's ``halo_depth = s`` ghost zones).
    ``partition_s`` records the seconds a new partition took."""
    import torch

    from repro_torch.api import SolverSession
    from repro_torch.core.partition import partition_csr

    depth = c.s if c.variant == "sstep" else 1
    key = SolverSession.matrix_key(c.fmt, c.block, depth, c.grid)
    if key not in mats:
        t0 = time.perf_counter()
        mats[key] = partition_csr(
            a_csr, n_shards, fmt=c.fmt, block=(c.block, c.block),
            grid=c.grid, halo_depth=depth, device=device,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if partition_s is not None:
            partition_s[key] = time.perf_counter() - t0
    return mats[key]


def run_trials(
    a_csr,
    n_shards: int,
    survivors: list[Prediction],
    *,
    device=None,
    cost: CostModel,
    objective: str,
    tol: float,
    trial_iters: int = 8,
    maxiter_cap: int = 10000,
    mats: dict | None = None,
    nrhs: int = 1,
    partition_s: dict | None = None,
) -> list[Trial]:
    """Run (or share) one trial per survivor and score it.

    ``mats`` optionally seeds and collects the partitions (keyed as
    :func:`trial_matrix` says), so the caller reuses the winner's
    partition for the final solve. With ``nrhs`` > 1 each trial runs the
    block solver on the deterministic RHS block (``default_rhs_block``);
    its convergence is the slowest column's (relres = max over columns),
    so the extrapolated count covers the whole batch. ``device`` is
    ``cuda`` unless the caller passes ``"cpu"``.
    """
    import torch

    from repro_torch.core.cg import default_rhs_block, make_block_solver, make_solver
    from repro_torch.core.partition import pad_block, pad_vector
    from repro_torch.launch.mesh import resolve_device
    from repro_torch.roofline.analysis import reduce_hops

    dev = resolve_device(device)
    mats = mats if mats is not None else {}
    n = a_csr.shape[0]
    executions: dict[tuple, tuple] = {}  # exec_key -> (trace, iters, relres)
    trials: list[Trial] = []
    for pred in survivors:
        c = pred.candidate
        first = c.exec_key not in executions
        if first:
            mat = trial_matrix(a_csr, n_shards, c, mats, device=dev,
                               partition_s=partition_s)
            if nrhs > 1:
                solver = make_block_solver(
                    mat, overlap=c.overlap, tol=tol, maxiter=trial_iters,
                    device=dev,
                )
                rhs = pad_block(default_rhs_block(n, nrhs), mat)
            else:
                skw = {"s": c.s} if c.variant == "sstep" else {}
                solver = make_solver(
                    mat, variant=c.variant, overlap=c.overlap, tol=tol,
                    maxiter=trial_iters, device=dev, **skw,
                )
                rhs = pad_vector(np.ones(n), mat)
            bp = torch.from_numpy(rhs).to(dev, mat.dtype)
            x0 = torch.zeros_like(bp)
            with trace.capture() as tr:
                res = solver(bp, x0)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            relres = float(res.rel_residual.max())
            executions[c.exec_key] = (tr, int(res.iters), relres)
        tr, iters, relres = executions[c.exec_key]
        iters_est = extrapolate_iters(iters, relres, tol, cap=maxiter_cap)
        ccost = cost
        if c.grid is not None:
            ccost = dataclasses.replace(
                cost, coll_hops=float(reduce_hops(n_shards, c.grid))
            )
        led = trace.ledger_from_trace(
            tr, iters=iters_est, n_shards=n_shards,
            cost=ccost.at_freq(c.freq), overlap=c.overlap,
        )
        tot = led["totals"]
        trials.append(
            Trial(
                candidate=c,
                executed=first,
                iters_trial=iters,
                relres_trial=relres,
                iters_est=iters_est,
                predicted_time_s=pred.time_s * iters_est,
                predicted_energy_j=pred.energy_j * iters_est,
                measured_time_s=float(tot["runtime"]),
                measured_energy_j=total_energy_j(tot),
                score=objective_score(objective, tot),
            )
        )
    return trials
