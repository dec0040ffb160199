"""Ginkgo-analog baseline: the *algorithmically naive* distributed path.

Port of ``repro.core.baselines``. It removes exactly the design choices the
paper credits for the gap:

* the SpMV gathers the **full global vector** (the all-gather layout) before
  any local work starts — no halo minimization, no overlap;
* CG performs **three separate all-reduces** per iteration (p·Ap, r·z,
  ||r||²) — no reduction fusion, and no fused kernels: its vector updates
  are plain tensor ops, so it launches none of the port's hand kernels.

Both paths share the same local ELL arithmetic. Build the matching layout
with ``partition_csr(..., force_allgather=True)``.
"""

from __future__ import annotations

import torch

from repro_torch.core.cg import Preconditioner, SolveResult, identity_precond
from repro_torch.core.partition import DistMat
from repro_torch.core.spmv import (
    _scatter_boundary,
    boundary_matvec,
    ell_matvec,
    gather_ext,
)
from repro_torch.core.vectors import pdot
from repro_torch.energy import trace
from repro_torch.kernels import dispatch as kd
from repro_torch.launch.mesh import resolve_device


def _rec_updates(x: torch.Tensor, n_updates: int):
    """Unfused axpy-class updates: 3 streamed vectors each."""
    trace.record_op(
        "axpy_unfused",
        trace.streamed_axpy_counts(x.shape[-1], x.element_size(), n_updates),
    )


def spmv_naive_shard(mat: DistMat, x: torch.Tensor) -> torch.Tensor:
    """Ginkgo-analog SpMV: gather the whole vector first, then multiply.

    Requires an allgather-mode DistMat (external columns in padded-global
    layout). The local part reads its slice *from the gathered copy*, which
    serializes communication before compute — deliberately.
    """
    assert mat.plan.mode == "allgather", "naive SpMV needs allgather layout"
    x_full = gather_ext(mat, x)  # the instrumented all-gather (region "halo")
    x_own_from_full = x_full.view(x.shape)
    y = ell_matvec(mat.interior, x_own_from_full)
    yb = boundary_matvec(mat, x_full)
    return _scatter_boundary(mat, y, yb)


def _cg_unfused_body(mat, pre: Preconditioner, pdata, b, x0, *, tol, maxiter):
    """HS PCG with 3 *separate* all-reduces per iteration (no fusion)."""
    with trace.region("spmv"):
        r = b - spmv_naive_shard(mat, x0)
    with trace.region("precond"):
        z = pre.apply(pdata, r)
    with trace.region("reductions"):
        rz = pdot(r, z)  # separate
        rr = pdot(r, r)  # separate
        bb = pdot(b, b)  # separate
    tol2 = tol * tol * bb

    i, x, p = 0, x0, z
    while i < maxiter and bool(rr > tol2):
        with kd.ledger_section("iteration"):
            with trace.region("spmv"):
                w = spmv_naive_shard(mat, p)
            with trace.region("reductions"):
                pw = pdot(p, w)  # all-reduce 1
                alpha = rz / pw
                _rec_updates(x, 2)  # two unfused axpy-class updates
                x = x + alpha * p
                r = r - alpha * w
            with trace.region("precond"):
                z = pre.apply(pdata, r)
            with trace.region("reductions"):
                rz_new = pdot(r, z)  # all-reduce 2
                rr = pdot(r, r)  # all-reduce 3
                beta = rz_new / rz
                _rec_updates(x, 1)
                p = z + beta * p
            rz = rz_new
        i += 1
    return x, i, rr, bb


def make_naive_solver(
    mat: DistMat,
    *,
    precond: Preconditioner | None = None,
    tol: float = 1e-8,
    maxiter: int = 100,
    device=None,
):
    """Ginkgo-analog CG solver: ``solve(b, x0) -> SolveResult``."""
    dev = resolve_device(device)
    mat = mat.to(dev)
    pre = precond or identity_precond()

    def solve(b, x0):
        x, iters, rr, bb = _cg_unfused_body(
            mat, pre, pre.data, b.to(dev), x0.to(dev), tol=tol, maxiter=maxiter
        )
        return SolveResult(x=x, iters=int(iters), rr=rr, bb=bb)

    return solve


def make_naive_spmv(mat: DistMat):
    """Ginkgo-analog distributed SpMV on stacked vectors."""

    def spmv(x):
        return spmv_naive_shard(mat, x)

    return spmv
