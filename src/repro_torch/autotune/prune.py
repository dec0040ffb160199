"""Stage 1 — analytic model pruning of the tuning space (port of
``repro.autotune.prune``).

Every candidate is priced per CG iteration by composing the models of the
port, without running anything:

* **matrix traffic** — ``roofline/format_model`` stored bytes per interior
  format (``ell_cost``/``hyb_cost``/``bcsr_cost``; ``auto`` resolved by
  ``choose_format``), swapped into the ELL partition's
  :func:`energy/accounting.spmv_counts` (the halo plan and boundary block
  do not depend on the format, so only the interior stored-bytes term
  moves);
* **vector-op traffic** — ``roofline/analysis.CG_HOTPATH`` fused-stream
  counts (``cg_vector_traffic`` / ``cg_vector_flops``) plus the variant's
  all-reduce pattern (``CG_COMM``: pipecg's hidden reduction is credited
  only with the overlap schedule on);
* **time + power** — the :class:`CostModel` engine times and chip/host
  power at the candidate's DVFS point (``CostModel.at_freq``: compute and
  dynamic power scale with frequency, HBM and interconnect stay flat).

The survivors are the Pareto front over (time, energy) ranked by the
objective, cut to the trial budget (counted in *executions*, see
:func:`prune`), with :data:`space.DEFAULT` always kept, so stage 2's argmin
never picks something worse than the out-of-the-box configuration.

The model only ranks: flops come from the ELL layout for every format and
the per-iteration phases simplify the trace regions. Stage 2
(``trial.py``) scores every survivor on executed counts.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.autotune.objective import score as objective_score
from repro_torch.autotune.space import DEFAULT, BCSR_BLOCKS, Candidate, sort_key
from repro_torch.energy.accounting import CostModel, OpCounts, spmv_counts
from repro_torch.roofline.analysis import (
    CG_COMM,
    cg_reduce_scalars,
    cg_vector_flops,
    cg_vector_traffic,
)
from repro_torch.roofline.format_model import (
    bcsr_cost,
    choose_format,
    ell_cost,
    hyb_cost,
)


# ---------------------------------------------------------------------------
# Host-side interior statistics (numpy sweeps over the CSR)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InteriorStats:
    """Per-shard interior row/block statistics of one partitioned problem."""

    n_rows: int  # padded rows per shard (R)
    shard_row_lens: tuple  # per shard: interior nnz of each local row
    shard_blocks: dict  # block side -> per-shard (n_blocks, max bpr)


def _shard_entries(indptr, indices, lo: int, hi: int):
    """One shard's interior entries as local (row, col) arrays, and each
    local row's interior nnz."""
    cols = indices[indptr[lo]:indptr[hi]].astype(np.int64)
    rows = np.repeat(
        np.arange(lo, hi, dtype=np.int64), np.diff(indptr[lo:hi + 1])
    )
    mask = (cols >= lo) & (cols < hi)
    r_loc, c_loc = rows[mask] - lo, cols[mask] - lo
    lens = np.bincount(r_loc, minlength=hi - lo).astype(np.int64)
    return lens, r_loc, c_loc


def interior_stats(a_csr, row_starts, blocks=BCSR_BLOCKS) -> InteriorStats:
    """Interior row-length + BCSR block statistics per shard.

    ``row_starts`` is the contiguous block-row partition the trial stage
    uses (``DistMat.row_starts``), so the stats priced here are the stats
    packed there; the tiles are counted by the BCSR packer's own formula
    (``core/partition.block_stats_from_arrays``). The shards, then the
    (shard, block side) pairs, are counted on a pool of host threads (the
    numpy sorts release the GIL).
    """
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.partition import block_stats_from_arrays

    a = a_csr.tocsr()
    n_shards = len(row_starts) - 1
    R = max(
        row_starts[s + 1] - row_starts[s] for s in range(n_shards)
    )
    blocks = tuple(blocks)
    with ThreadPoolExecutor(max(min(os.cpu_count() or 1, 16), 1)) as pool:
        ents = list(pool.map(
            lambda s: _shard_entries(a.indptr, a.indices, row_starts[s],
                                     row_starts[s + 1]),
            range(n_shards),
        ))
        pairs = [(s, b) for b in blocks for s in range(n_shards)]
        counted = list(pool.map(
            lambda sb: block_stats_from_arrays(
                ents[sb[0]][1], ents[sb[0]][2], R, sb[1], sb[1]),
            pairs,
        ))
    blk = {b: [] for b in blocks}
    for (_, b), st in zip(pairs, counted):
        blk[b].append(st)
    return InteriorStats(
        n_rows=int(R),
        shard_row_lens=tuple(e[0] for e in ents),
        shard_blocks={b: tuple(v) for b, v in blk.items()},
    )


def format_stored_bytes(stats: InteriorStats) -> dict:
    """Modeled interior stored bytes per format key (``ell``, ``hyb``,
    ``bcsr<b>``), the quantity that moves a candidate's SpMV traffic."""
    out = {
        "ell": ell_cost(stats.shard_row_lens, stats.n_rows).stored_bytes,
        "hyb": hyb_cost(stats.shard_row_lens, stats.n_rows).stored_bytes,
    }
    for b, sb in stats.shard_blocks.items():
        out[f"bcsr{b}"] = bcsr_cost(
            sb, stats.n_rows, br=b, bc=b
        ).stored_bytes
    return out


def resolve_auto(stats: InteriorStats, block: int = 4) -> tuple[str, int]:
    """Resolve ``fmt="auto"`` as ``partition_csr`` does, through the
    stored-bytes/traffic model: ``(fmt, block)``."""
    fmt, _ = choose_format(
        stats.shard_row_lens, n_rows=stats.n_rows,
        shard_blocks=stats.shard_blocks.get(block), br=block, bc=block,
    )
    return fmt, block


# ---------------------------------------------------------------------------
# Per-candidate per-iteration prediction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Prediction:
    """Stage-1 output for one candidate: modeled per-iteration cost."""

    candidate: Candidate
    time_s: float  # modeled seconds per iteration
    energy_j: float  # modeled total (static+dynamic) J per iteration
    score: float  # objective score per iteration (lower is better)


def _hotpath_variant(candidate: Candidate, nrhs: int) -> str:
    """The CG_HOTPATH/CG_COMM row a candidate's vector phase is priced
    with: a multi-RHS solve runs the block-HS body whatever the (hs-only)
    variant axis says."""
    return "block_hs" if nrhs > 1 else candidate.variant


def phase_counts(
    mat_ell, candidate: Candidate, stored: dict, *, nrhs: int = 1
) -> tuple[OpCounts, OpCounts]:
    """Per-iteration, per-shard (SpMV-phase, vector-phase) counts.

    The SpMV phase starts from the declared-counts formula on the ELL
    partition and swaps the interior stored-bytes term for the candidate
    format's; the vector phase carries the variant's CG_HOTPATH streams
    and all-reduce pattern. ``nrhs`` > 1 prices the SpMM sweep (matrix
    bytes once, vector bytes r times) and the block-HS vector/Gram phase.
    """
    S = max(mat_ell.n_shards, 1)
    fmt_key = (
        f"bcsr{candidate.block}" if candidate.fmt == "bcsr" else candidate.fmt
    )
    sp = spmv_counts(mat_ell, overlap=candidate.overlap, nrhs=nrhs)
    delta = (stored[fmt_key] - stored["ell"]) / S
    # the format swap moves *matrix* bytes, so both totals shift together
    sp = dataclasses.replace(
        sp,
        hbm_bytes=sp.hbm_bytes + delta,
        hbm_matrix_bytes=sp.hbm_matrix_bytes + delta,
    )
    n = mat_ell.n_own_pad
    v = _hotpath_variant(candidate, nrhs)
    s = max(candidate.s, 1)
    if v == "sstep" and s > 1 and mat_ell.plan.mode in ("ring", "grid"):
        # matrix-powers pricing (a ranking approximation; the trial stage
        # re-scores on the depth-s partition's executed counts): the
        # widened exchange moves about the same bytes per iteration in 1/s
        # the launches; the ghost zone adds about (s-1) boundary layers of
        # about halo rows each, recomputed on all but the last application
        # of the block ((s-1)/s sweeps per iteration)
        halo = max(mat_ell.plan.ext_len - n, 0)
        slots_row = mat_ell.nnz_stored / S / max(n, 1)
        ghost_rows = halo * (s - 1) * (s - 1) / s
        sp = dataclasses.replace(
            sp,
            flops=sp.flops + 2.0 * slots_row * ghost_rows,
            hbm_bytes=sp.hbm_bytes + 12.0 * slots_row * ghost_rows,
            n_collectives=sp.n_collectives / s,
        )
    n_red = float(CG_COMM[v]["allreduces"])
    if v == "sstep":
        n_red /= s  # CG_COMM counts per s-iteration block
    vec = OpCounts(
        flops=cg_vector_flops(n, variant=v, nrhs=nrhs, s=s),
        hbm_bytes=cg_vector_traffic(n, variant=v, nrhs=nrhs, s=s),
        ici_bytes=8.0 * cg_reduce_scalars(v, nrhs, s=s),
        n_collectives=n_red,
    )
    return sp, vec


def iteration_counts(
    mat_ell, candidate: Candidate, stored: dict, *, nrhs: int = 1
) -> OpCounts:
    """Total per-iteration, per-shard :class:`OpCounts` of one candidate."""
    sp, vec = phase_counts(mat_ell, candidate, stored, nrhs=nrhs)
    return sp + vec


def predict(
    mat_ell, candidate: Candidate, stored: dict, *, cost: CostModel,
    objective: str, nrhs: int = 1,
) -> Prediction:
    """Model one candidate's per-iteration (time, energy, score).

    The iteration is SpMV phase + vector phase, as in the trace regions:
    the halo collective is absorbed into the SpMV's max() with the overlap
    schedule on, and the variant's all-reduce latency is hidden behind the
    SpMV only for the reductions ``CG_COMM`` marks hidden (pipecg).
    """
    S = max(mat_ell.n_shards, 1)
    fcost = cost.at_freq(candidate.freq)
    sp, vec = phase_counts(mat_ell, candidate, stored, nrhs=nrhs)
    v = _hotpath_variant(candidate, nrhs)
    t_sp, _ = fcost.times(sp, S, candidate.overlap)
    _, (tc2, tm2, tl2) = fcost.times(vec, S, True)
    hidden = CG_COMM[v]["hidden"] / max(CG_COMM[v]["allreduces"], 1)
    tl_hidden = min(tl2 * hidden, t_sp) if candidate.overlap else 0.0
    t = t_sp + max(tc2, tm2) + (tl2 - tl_hidden)

    c = sp + vec
    power = fcost.power
    p_chip = power.chip_power(c.flops / t, c.hbm_bytes / t, c.ici_bytes / t)
    # The host is priced at idle for ranking: the monitor's active-host
    # increment scales with the communication *fraction*, so here it would
    # reward extra HBM traffic. The trial stage prices trials through the
    # full monitor model.
    p_host = power.host_power(0.0)
    n_hosts = max(S // 4, 1)
    totals = dict(
        runtime=t,
        te_gpu=p_chip * t * S,
        te_cpu=p_host * t * n_hosts,
    )
    return Prediction(
        candidate=candidate,
        time_s=t,
        energy_j=totals["te_gpu"] + totals["te_cpu"],
        score=objective_score(objective, totals),
    )


# ---------------------------------------------------------------------------
# Pareto filter + top-K
# ---------------------------------------------------------------------------


def pareto_front(preds: list[Prediction]) -> list[Prediction]:
    """Predictions not *strictly* dominated on (time, energy).

    Strict domination (worse on both axes): on memory-bound problems
    downclocking is modeled time-free, so a weak filter would drop every
    nominal-frequency candidate on an exact time tie. The tied candidates
    go on to stage 2, whose tie-break (``space.sort_key``) prefers nominal
    frequency.
    """
    out = []
    for p in preds:
        dominated = any(
            q.time_s < p.time_s and q.energy_j < p.energy_j for q in preds
        )
        if not dominated:
            out.append(p)
    return out


def prune(
    candidates: list[Candidate],
    a_csr,
    mat_ell,
    *,
    cost: CostModel,
    objective: str,
    keep: int,
    nrhs: int = 1,
) -> tuple[list[Prediction], InteriorStats]:
    """Stage 1: score ``candidates`` analytically; keep the Pareto front's
    top-``keep`` *executions* (objective-ranked) plus :data:`space.DEFAULT`,
    each with its full frequency column.

    ``mat_ell`` is the ELL partition of ``a_csr`` (built once by the
    caller; the trials reuse it): it gives the halo plan and the padded
    shard shape. ``auto`` candidates are resolved to their concrete format
    here and deduplicated against the explicit ones.
    """
    stats = interior_stats(
        a_csr, mat_ell.row_starts,
        blocks=sorted({c.block for c in candidates if c.fmt == "bcsr"})
        or list(BCSR_BLOCKS),
    )
    stored = format_stored_bytes(stats)

    resolved: list[Candidate] = []
    seen: set[tuple] = set()
    auto: dict[int, tuple[str, int]] = {}  # block -> resolve_auto (one per block)
    for c in sorted(candidates, key=sort_key):
        if c.fmt == "auto":
            if c.block not in auto:
                auto[c.block] = resolve_auto(stats, c.block)
            fmt, block = auto[c.block]
            c = dataclasses.replace(c, fmt=fmt, block=block)
        key = (c.exec_key, c.freq)
        if key in seen:
            continue
        seen.add(key)
        resolved.append(c)

    preds = [
        predict(mat_ell, c, stored, cost=cost, objective=objective, nrhs=nrhs)
        for c in resolved
    ]
    front = sorted(
        pareto_front(preds), key=lambda p: (p.score, sort_key(p.candidate))
    )
    # The budget counts *executions* (trial solves). A candidate that
    # differs from a survivor in frequency alone shares its execution
    # (Candidate.exec_key) and is only re-priced, so every chosen execution
    # brings its whole DVFS column along: the trial stage then makes the
    # race-to-idle against downclock call even where the model's ranking
    # collapsed.
    exec_keys: list[tuple] = []
    for p in front:
        if p.candidate.exec_key not in exec_keys:
            exec_keys.append(p.candidate.exec_key)
        if len(exec_keys) >= max(keep, 1):
            break
    if DEFAULT.exec_key not in exec_keys:
        exec_keys.append(DEFAULT.exec_key)
    survivors = sorted(
        (p for p in preds if p.candidate.exec_key in exec_keys),
        key=lambda p: (p.score, sort_key(p.candidate)),
    )
    return survivors, stats
