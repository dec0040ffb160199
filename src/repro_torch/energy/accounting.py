"""Operation counts + roofline cost/energy accounting (port of
``repro.energy.accounting``: ``OpCounts``, ``ZERO``, ``CostModel``).

``OpCounts`` carries the per-device activity of one operation: useful FLOPs,
HBM bytes moved, interconnect bytes sent, and the number of distinct
collectives (which pays a latency cost per hop).

``CostModel`` turns counts into modeled time and energy:

    T_compute = flops / peak_flops
    T_memory  = hbm_bytes / hbm_bw
    T_coll    = n_collectives * alpha * ceil(log2(S)) + ici_bytes / link_bw

    T = max(T_compute, T_memory) + T_coll          (serialized comm)
    T = max(T_compute, T_memory, T_coll)           (overlapped comm)

Counting conventions of the declared-count helpers (:func:`spmv_counts`,
:func:`cg_iteration_counts`, :func:`vcycle_counts`; double precision, 8 B
values / 4 B indices):

* SpMV: 2 flops per stored slot; HBM = the format-aware stored bytes +
  (n + halo)*8 vector reads + n*8 write.
* dot/axpy/norm: 2 flops per element; HBM = streamed operands + result.
* halo exchange: ici bytes = plan.collective_bytes_per_shard; allgather =
  (S-1)*R*8 per shard.

The ledgers of the solves come from executed counts (energy/trace.py); the
declared counts price what has not run, as the autotuner's pruning stage
does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING

from repro_torch.energy.model import PowerModel

if TYPE_CHECKING:
    from repro_torch.core.partition import DistMat


@dataclasses.dataclass(frozen=True)
class OpCounts:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    ici_bytes: float = 0.0
    n_collectives: float = 0.0
    # The subset of ``hbm_bytes`` that is matrix traffic (stored values +
    # index layout).
    hbm_matrix_bytes: float = 0.0

    def __add__(self, o: "OpCounts") -> "OpCounts":
        return OpCounts(
            self.flops + o.flops,
            self.hbm_bytes + o.hbm_bytes,
            self.ici_bytes + o.ici_bytes,
            self.n_collectives + o.n_collectives,
            self.hbm_matrix_bytes + o.hbm_matrix_bytes,
        )

    def __mul__(self, k: float) -> "OpCounts":
        return OpCounts(
            self.flops * k, self.hbm_bytes * k, self.ici_bytes * k,
            self.n_collectives * k, self.hbm_matrix_bytes * k,
        )

    __rmul__ = __mul__


ZERO = OpCounts()


# ---------------------------------------------------------------------------
# Per-operation declared counts (per device / shard)
# ---------------------------------------------------------------------------

_VB = 8  # value bytes (f64); index bytes (4 B int32 local ids) live in the
# per-format DistMat.stored_bytes accounting (roofline/format_model.py)


def spmv_counts(mat: DistMat, overlap: bool = True, nrhs: int = 1) -> OpCounts:
    """One distributed SpMV (or ``nrhs``-wide SpMM sweep), per shard.

    Matrix traffic is the format-aware stored-bytes term
    (``DistMat.stored_bytes``: values + the index layout of the interior
    format), so the modeled SpMV cost moves with the storage format as the
    executed counts do. With ``nrhs > 1`` the matrix term is paid ONCE
    while flops, vector traffic and halo payload scale with the RHS count.
    ``overlap`` does not change the counts (the schedule is priced by
    :meth:`CostModel.times`).
    """
    S = max(mat.n_shards, 1)
    r = max(int(nrhs), 1)
    slots = mat.nnz_stored / S
    n = mat.n_own_pad
    ringlike = mat.plan.mode in ("ring", "grid")
    halo = mat.plan.ext_len - n if ringlike else n * (mat.n_shards - 1)
    flops = 2.0 * slots * r
    mat_bytes = mat.stored_bytes(_VB) / S
    hbm = mat_bytes + ((n + halo) + n) * _VB * r
    ici = float(mat.plan.collective_bytes_per_shard(_VB)) * r
    if mat.plan.mode == "grid":
        # per-dimension sub-axis launches: corners launch twice (and their
        # payload crosses two links, priced in collective_bytes already)
        n_coll = float(mat.plan.n_launches)
    elif mat.plan.mode == "ring":
        n_coll = len(mat.plan.shifts)
    else:
        n_coll = 1.0
    if mat.n_shards == 1:
        ici, n_coll = 0.0, 0.0
    return OpCounts(flops, hbm, ici, n_coll, hbm_matrix_bytes=mat_bytes)


def dot_counts(n: int, fused_terms: int = 1) -> OpCounts:
    """``fused_terms`` inner products computed in one fused reduction."""
    return OpCounts(
        flops=2.0 * n * fused_terms,
        hbm_bytes=2.0 * n * _VB * fused_terms,
        ici_bytes=8.0 * fused_terms,
        n_collectives=1.0,
    )


def axpy_counts(n: int) -> OpCounts:
    return OpCounts(flops=2.0 * n, hbm_bytes=3.0 * n * _VB)


def cg_iteration_counts(mat: DistMat, variant: str = "hs", *,
                        s: int = 2) -> OpCounts:
    """Per-iteration counts of the *unpreconditioned* CG variants.

    hs   : 1 SpMV + 2 reductions (one fused pair) + 3 axpy-class updates
    fcg  : 1 SpMV + 1 fused reduction (3 terms) + 5 updates
    sstep: amortized per iteration — 1 SpMV + (1/s) fused Gram reduction
           (the (2s² + s + 1)-scalar payload) + ~4 block updates. When
           ``mat`` carries ghost zones at least ``s`` deep the basis routes
           through the matrix-powers SpMV (``core/spmv.matrix_powers``),
           so the halo exchange is paid once per BLOCK (its ici bytes and
           launches divide by ``s``) and the redundant ghost-row recompute
           ((s-1)/s passes per iteration, priced from the packed ghost
           block) is added.
    naive: 1 SpMV + 3 separate reductions + 3 updates (Ginkgo analog)
    amgx : optimized halo SpMV but 3 separate reductions (AmgX-CG analog:
           tuned kernels, no reduction fusion)
    """
    n = mat.n_own_pad
    overlap = variant not in ("naive",)
    sp = spmv_counts(mat, overlap)
    if variant == "hs":
        return sp + dot_counts(n) + dot_counts(n, 2) + 3 * axpy_counts(n)
    if variant == "amgx":
        return sp + 3 * dot_counts(n) + 3 * axpy_counts(n)
    if variant == "fcg":
        return sp + dot_counts(n, 3) + 5 * axpy_counts(n)
    if variant == "sstep":
        s = max(int(s), 1)
        gram = OpCounts(
            flops=2.0 * n * (2 * s * s + s) / s,
            hbm_bytes=2.0 * n * _VB * (s + 1) / s,
            ici_bytes=8.0 * (2 * s * s + s + 1) / s,
            n_collectives=1.0 / s,
        )
        if s > 1 and mat.halo_depth >= s and mat.plan.mode != "allgather":
            # matrix-powers basis: the (widened) exchange is launched once
            # per s-iteration block, not per iteration
            sp = OpCounts(
                sp.flops, sp.hbm_bytes, sp.ici_bytes / s,
                sp.n_collectives / s, sp.hbm_matrix_bytes,
            )
            S = max(mat.n_shards, 1)
            gs = mat.ghost_slots / S  # per-shard packed ghost-row slots
            if gs:
                # one ghost_matvec per interior application except the
                # last — (s-1)/s per iteration; the formulas are
                # core/spmv.ghost_matvec's recorded counts
                gmat = gs * (_VB + 4)
                ghost = OpCounts(
                    flops=2.0 * gs,
                    hbm_bytes=gmat + min(mat.plan.ext_len, gs) * _VB
                    + mat.n_ghost_rows * (_VB + 4),
                    hbm_matrix_bytes=gmat,
                )
                sp = sp + ((s - 1) / s) * ghost
        return sp + gram + 4 * axpy_counts(n)
    if variant == "naive":
        return sp + 3 * dot_counts(n) + 3 * axpy_counts(n)
    raise ValueError(variant)


def vcycle_counts(levels_info, mat0: DistMat, n_smooth: int = 4) -> OpCounts:
    """One V-cycle, per shard; ``levels_info`` = AMGInfo (rows/nnz per level).

    Approximation: each level's SpMV-class work scales with its nnz share;
    smoothing = n_smooth sweeps (each ~1 SpMV + 1 axpy) pre + post, plus one
    residual SpMV and the (local) restriction/prolongation traffic.
    """
    S = max(mat0.n_shards, 1)
    base = spmv_counts(mat0)
    total = ZERO
    nnz0 = max(levels_info.level_nnz[0], 1)
    for lvl in range(levels_info.n_levels - 1):
        scale = levels_info.level_nnz[lvl] / nnz0
        n_l = levels_info.level_rows[lvl] / S
        sweep = base * scale + axpy_counts(int(n_l))
        total = total + (2 * n_smooth + 1) * sweep + 2 * axpy_counts(int(n_l))
    # coarsest: replicated dense solve after an all-gather
    nc = levels_info.coarse_rows
    total = total + OpCounts(
        flops=2.0 * nc * nc / S,
        hbm_bytes=nc * nc * _VB / S,
        ici_bytes=nc * _VB,
        n_collectives=1.0,
    )
    return total


@dataclasses.dataclass(frozen=True)
class CostModel:
    power: PowerModel = PowerModel()
    alpha_latency: float = 5e-6  # per-collective latency per log2(S) hop [s]
    flops_efficiency: float = 0.85  # achievable fraction of peak
    bw_efficiency: float = 0.80
    # Per-collective tree depth override; None keeps ceil(log2(S)).
    coll_hops: float | None = None

    def at_freq(self, freq: float) -> "CostModel":
        """The same cost model on the chip downclocked to ``freq``."""
        if freq == 1.0:
            return self
        return dataclasses.replace(self, power=self.power.at_freq(freq))

    def times(self, c: OpCounts, n_shards: int, overlap: bool):
        chip = self.power.chip
        t_comp = c.flops / (chip.peak_flops_f32 * self.flops_efficiency)
        t_mem = c.hbm_bytes / (chip.hbm_bw * self.bw_efficiency)
        if self.coll_hops is not None:
            hops = self.coll_hops
        else:
            hops = max(math.ceil(math.log2(max(n_shards, 2))), 1)
        t_coll = (
            c.n_collectives * self.alpha_latency * hops
            + c.ici_bytes / chip.ici_bw
        )
        if n_shards == 1:
            t_coll = 0.0
        if overlap:
            t = max(t_comp, t_mem, t_coll)
        else:
            t = max(t_comp, t_mem) + t_coll
        return t, (t_comp, t_mem, t_coll)

    def device_energy(self, c: OpCounts, n_shards: int, overlap: bool):
        """(time, total_J, dynamic_J, peak_W) for ONE device executing c."""
        t, _ = self.times(c, n_shards, overlap)
        if t <= 0:
            return 0.0, 0.0, 0.0, self.power.chip_static_w
        p = self.power.chip_power(
            c.flops / t, c.hbm_bytes / t, c.ici_bytes / t
        )
        total = p * t
        dyn = (p - self.power.chip_static_w) * t
        return t, total, dyn, p
