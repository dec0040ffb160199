"""The V-cycle on the stacked shard layout (port of
``repro.core.amg.vcycle``).

Level data (see hierarchy.py), every array stacked over the S shards:

* ``mat``              — A_l as a halo-planned DistMat (ELL interior);
* ``p_data / p_col``   — the tentative prolongator: ONE nonzero per fine
  row, ``p_col`` the shard-local coarse aggregate id (decoupled aggregation
  keeps it local), so prolongation is a gather along the last axis;
* ``pt_data / pt_col`` — P^T in ELL over coarse rows (width = the largest
  aggregate, 8 in the paper's configuration), ``pt_col`` shard-local fine
  ids: restriction is an ELL matvec;
* ``dinv``             — 1 / l1-Jacobi diagonal of A_l.

The coarsest level is solved with a replicated dense inverse applied to the
gathered coarse residual: the all-gather of the JAX package is the
``(S, Rc) -> (S*Rc,)`` reshape here, recorded as the collective it is, and
the product is ``torch.matmul`` (the JAX package leaves it to XLA too).

Counts: the cycle runs inside ``region("vcycle")`` and its smoother and
residual updates go through the kernel dispatch ``OpSet`` (``axpy``, on the
card the hand-written ``fused_axpy``, with the Python-number scalars passed
by value), so every SpMV, smoother sweep, transfer and the coarse solve
record their executed counts. Sizes are per shard (the last axis), as the
JAX package records them on its local blocks. The level SpMVs use the
overlapped schedule by default, so their counts land in ``"overlap"``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.partition import DistMat, ELLBlock
from repro_torch.core.spmv import _gather, ell_matvec, spmv_shard
from repro_torch.energy import trace
from repro_torch.energy.accounting import OpCounts
from repro_torch.kernels import dispatch as kd


@dataclasses.dataclass(frozen=True)
class _Restriction(ELLBlock):
    """P^T as an ELL block whose column ids index the FINE vector: the flat
    ids are offset by the fine per-shard length ``src_len``, not by the
    block's own row count."""

    src_len: int = 0

    @functools.cached_property
    def flat_col(self) -> torch.Tensor:
        S = self.col.shape[0]
        offs = torch.arange(S, dtype=torch.int32, device=self.col.device) * self.src_len
        return (self.col + offs[:, None, None]).reshape(-1)


@dataclasses.dataclass(frozen=True)
class AMGLevel:
    mat: DistMat
    p_data: torch.Tensor  # (S, Rf)
    p_col: torch.Tensor  # (S, Rf) int32 local coarse ids
    pt_data: torch.Tensor  # (S, Rc, W)
    pt_col: torch.Tensor  # (S, Rc, W) int32 local fine ids
    dinv: torch.Tensor  # (S, Rf)

    @functools.cached_property
    def restriction(self) -> _Restriction:
        return _Restriction(data=self.pt_data, col=self.pt_col, src_len=self.p_data.shape[-1])

    @functools.cached_property
    def flat_p_col(self) -> torch.Tensor:
        """(S*Rf,) int32 ids of each fine row's aggregate into the
        flattened (S*Rc,) coarse stack."""
        S, Rc = self.pt_data.shape[:2]
        offs = torch.arange(S, dtype=torch.int32, device=self.p_col.device) * Rc
        return (self.p_col + offs[:, None]).reshape(-1)


def _record_pointwise(op: str, n: int, itemsize: int, reads: int):
    """Elementwise vector work not covered by a dispatch op."""
    trace.record_op(op, trace.pointwise_counts(n, itemsize, reads))


def jacobi_sweeps(
    mat: DistMat, dinv: torch.Tensor, b: torch.Tensor, x: torch.Tensor | None,
    n: int, omega: float, ops: kd.OpSet | None = None,
) -> torch.Tensor:
    """n sweeps of (damped) l1-Jacobi; x=None means zero initial guess, in
    which case the first sweep is the free half-sweep x = omega*dinv*b."""
    ops = ops or kd.ops_for(None)
    R, ib = b.shape[-1], b.element_size()
    if x is None:
        _record_pointwise("jacobi_scale", R, ib, 2)
        x = omega * dinv * b
        n = n - 1
    for _ in range(n):
        r = ops.axpy(-1.0, spmv_shard(mat, x), b)  # r = b - A x
        _record_pointwise("jacobi_scale", R, ib, 2)
        x = ops.axpy(omega, dinv * r, x)
    return x


def coarse_solve(dense_inv: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """Replicated dense inverse applied to the gathered coarse residual
    ``rc`` (S, Rc); returns each shard's slice of the solution, (S, Rc)."""
    nc = dense_inv.shape[0]
    Rc = rc.shape[-1]
    b = rc.element_size()
    S = max(nc // max(Rc, 1), 1)
    trace.record_op(
        "coarse_gather",
        OpCounts(ici_bytes=float(Rc * (S - 1) * b),
                 n_collectives=1.0 if S > 1 else 0.0),
    )
    trace.record_op(
        "coarse_solve",
        OpCounts(flops=2.0 * nc * nc,
                 hbm_bytes=float(nc * nc * b + 2 * nc * b)),
    )
    r_full = rc.reshape(-1)  # the all-gather: every shard reads the whole stack
    return torch.matmul(dense_inv, r_full).view(rc.shape)


def vcycle(
    levels, dense_inv: torch.Tensor, b: torch.Tensor,
    *, n_smooth: int = 4, omega: float = 1.0, ops: kd.OpSet | None = None,
) -> torch.Tensor:
    """One V(n_smooth, n_smooth) cycle applied to the stacked ``b`` (zero
    initial guess). ``ops`` is the kernel-dispatch OpSet the cycle's vector
    updates route through (None = follow the operands' device)."""
    ops = ops or kd.ops_for(None)

    def down(l: int, bl: torch.Tensor) -> torch.Tensor:
        lev = levels[l]
        x = jacobi_sweeps(lev.mat, lev.dinv, bl, None, n_smooth, omega, ops)
        r = ops.axpy(-1.0, spmv_shard(lev.mat, x), bl)
        rc = ell_matvec(lev.restriction, r)  # restriction (local)
        if l + 1 < len(levels):
            xc = down(l + 1, rc)
        else:
            xc = coarse_solve(dense_inv, rc)
        _record_pointwise("prolongation", x.shape[-1], x.element_size(), 3)
        x = x + lev.p_data * _gather(xc, lev.flat_p_col, x.shape)  # prolongation (local)
        x = jacobi_sweeps(lev.mat, lev.dinv, bl, x, n_smooth, omega, ops)
        return x

    with trace.region("vcycle"):
        return down(0, b)
