"""Distributed Conjugate Gradient (port of ``repro.core.cg``, ``hs`` variant).

``hs`` is the classical Hestenes–Stiefel PCG with two all-reduces per
iteration (the (p, Ap) dot, and the fused ||r||^2 that the x/r update
kernel accumulates in the same pass). The other variants of the JAX
package (fcg, pipecg, sstep, block CG) are later slices of the port and
raise ``NotImplementedError`` here.

The JAX package runs the solver inside one jitted ``shard_map`` with a
``lax.while_loop``; the port runs the same body eagerly over the stacked
``(S, R)`` shard layout on one device:

* every collective is an explicit sum over the shard axis of per-shard
  partials, recorded like the JAX package records its ``psum``;
* the hot-loop vector work goes through the kernel dispatch ``OpSet`` —
  on a CUDA device the hand-written Hopper kernels, three launches per
  iteration outside the SpMV;
* the loop test ``rr > tol2`` reads one scalar back to the host: one
  device-to-host sync per iteration (the only one: the step scalars alpha
  and beta stay on the device). Capturing the body in a CUDA graph would
  remove it and is left to a later slice.

Counts are recorded eagerly: the iteration section is entered once per
executed iteration, so the energy trace and the sweep ledger divide back
to per-iteration counts, the same numbers the JAX package records by
tracing its loop body once.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.partition import DistMat
from repro_torch.core.spmv import overlap_default, spmv_shard
from repro_torch.core.vectors import all_reduce, fused_dots
from repro_torch.energy import trace
from repro_torch.kernels import dispatch as kd
from repro_torch.launch.mesh import resolve_device

VARIANTS = ("hs",)


class Preconditioner(NamedTuple):
    """A distributed preconditioner: ``apply(data, r) -> z`` on stacked
    vectors. Only the identity is ported (AMG is ROADMAP queue 1, item 12)."""

    data: Any
    apply: Callable[[Any, torch.Tensor], torch.Tensor]
    # True for the identity: lets the body skip the apply AND reuse the
    # fused-kernel residual norm for (r, z) — one fewer sweep per iteration.
    is_identity: bool = False


def identity_precond() -> Preconditioner:
    return Preconditioner(data=(), apply=lambda data, r: r, is_identity=True)


@dataclasses.dataclass(frozen=True)
class SolveResult:
    x: torch.Tensor  # (S, R) padded stacked solution
    iters: int
    rr: torch.Tensor  # final ||r||^2 (0-d)
    bb: torch.Tensor  # ||b||^2 (0-d, for relative residual)

    @property
    def rel_residual(self) -> torch.Tensor:
        return torch.sqrt(self.rr / torch.clamp(self.bb, min=1e-300))


def _hs_body(A, pre: Preconditioner, pdata, b, x0, *, tol, maxiter, ops):
    """Hestenes–Stiefel PCG; 2 all-reduces/iter (one fused).

    With the identity preconditioner each iteration is 3 full-vector HBM
    sweeps outside the SpMV (p·w dot; fused x/r update + ||r||²; p update),
    each one kernel launch on the card.
    """
    with trace.region("spmv"):
        r = b - A(x0)
    with trace.region("precond"):
        z = pre.apply(pdata, r)
    with trace.region("reductions"):
        d0 = fused_dots([(r, z), (r, r), (b, b)])
    rz, rr, bb = d0[0], d0[1], d0[2]
    tol2 = tol * tol * bb

    i, x, p = 0, x0, z
    # one device-to-host sync per iteration: the loop test
    while i < maxiter and bool(rr > tol2):
        with kd.ledger_section("iteration"):
            with trace.region("spmv"):
                w = A(p)
            with trace.region("reductions"):
                pw = all_reduce(ops.fused_dots_n([(p, w)])[..., 0])  # all-reduce 1
                trace.record_collective(1, w.element_size())
                alpha = rz / pw
                # x += alpha p ; r -= alpha w ; local r'.r' — ONE pass
                x, r, rr_loc = ops.fused_axpy2_dots(alpha, p, x, -alpha, w, r)
            if pre.is_identity:
                z = r
                with trace.region("reductions"):
                    rr = all_reduce(rr_loc[..., 0])  # all-reduce 2
                    trace.record_collective(1, w.element_size())
                rz_new = rr
            else:
                with trace.region("precond"):
                    z = pre.apply(pdata, r)
                with trace.region("reductions"):
                    rz_loc = ops.fused_dots_n([(r, z)])[..., 0]
                    d = all_reduce(torch.stack([rz_loc, rr_loc[..., 0]], dim=-1))
                    trace.record_collective(2, w.element_size())
                rz_new, rr = d[0], d[1]
            beta = rz_new / rz
            with trace.region("reductions"):
                p = ops.axpy(beta, p, z)
            rz = rz_new
        i += 1
    return x, i, rr, bb


_BODIES = {"hs": _hs_body}


def make_solver(
    mat: DistMat,
    *,
    variant: str = "hs",
    precond: Preconditioner | None = None,
    tol: float = 1e-8,
    maxiter: int = 100,
    kernels: str | None = None,
    overlap: bool = True,
    device=None,
):
    """Build a solver ``solve(b, x0) -> SolveResult`` on stacked vectors.

    Args:
        mat: the stacked distributed matrix (``partition_csr``); moved to
            ``device`` if it is elsewhere.
        variant: ``"hs"`` (the only variant ported so far).
        precond: a :class:`Preconditioner` (None = identity).
        tol: relative residual target; convergence is declared at
            ``||r||^2 <= tol^2 * ||b||^2``.
        maxiter: iteration cap.
        kernels: None/'auto' (follow the device) or one of
            ``kernels.dispatch.BACKENDS`` (checked against the operands).
        overlap: communication-hiding SpMV schedule (default on).
        device: ``cuda`` unless the caller passes ``"cpu"``; raises when
            CUDA is asked for and absent.

    Returns:
        ``solve(b, x0)`` where ``b``/``x0`` are ``(S, R)`` padded stacked
        tensors (``partition.pad_vector``), returning the (S, R) solution,
        the executed iteration count, and ``||r||^2`` / ``||b||^2``.
    """
    if variant not in _BODIES:
        raise NotImplementedError(
            f"CG variant {variant!r} is not ported to repro_torch yet "
            "(ROADMAP.md, queue 1, items 6, 7 and 9)"
        )
    dev = resolve_device(device)
    mat = mat.to(dev)
    pre = precond or identity_precond()
    body = _BODIES[variant]
    ops = kd.ops_for(kernels)

    def solve(b: torch.Tensor, x0: torch.Tensor) -> SolveResult:
        A = lambda v: spmv_shard(mat, v, overlap=overlap)
        with overlap_default(overlap):
            x, iters, rr, bb = body(
                A, pre, pre.data, b.to(dev), x0.to(dev),
                tol=tol, maxiter=maxiter, ops=ops,
            )
        return SolveResult(x=x, iters=int(iters), rr=rr, bb=bb)

    return solve


def solve_cg(mat: DistMat, b_np, *, x0_np=None, device=None, **kw) -> SolveResult:
    """Convenience host-level solve: numpy in, SolveResult out."""
    import numpy as np

    from repro_torch.core.partition import pad_vector

    dev = resolve_device(device)
    bp = pad_vector(np.asarray(b_np), mat)
    xp = pad_vector(np.asarray(x0_np), mat) if x0_np is not None else np.zeros_like(bp)
    solver = make_solver(mat, device=dev, **kw)
    dt = mat.dtype
    return solver(torch.from_numpy(bp).to(dev, dt), torch.from_numpy(xp).to(dev, dt))


# ---------------------------------------------------------------------------
# Session-reusable solver handles
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SolverHandle:
    """A solver plus the energy trace captured at its first solve.

    The JAX package snapshots the trace of the warm-up call because a
    compiled solver never re-traces; the port keeps the same contract, so
    repeat solves through one handle integrate ledgers from the first
    solve's counts (the executed program cannot change without a new
    handle).

    The ``mat``/``precond`` references are load-bearing: the cache key uses
    their ``id()``, and holding them alive keeps those ids from being
    recycled while the handle is cached.
    """

    fn: Callable
    key: tuple
    mat: Any
    precond: Any = None
    trace: Any = None  # EnergyTrace from the first warm(); None = cold

    @property
    def warmed(self) -> bool:
        return self.trace is not None

    def warm(self, *args):
        """Run once under the region trace on first use; no-op afterwards.

        Returns the warm-up result (synchronized), or None when the handle
        is already warm."""
        if self.trace is not None:
            return None
        with trace.capture() as tr:
            res = self.fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.trace = tr
        return res

    def __call__(self, *args):
        return self.fn(*args)


_HANDLES: "collections.OrderedDict[tuple, SolverHandle]" = collections.OrderedDict()
_HANDLE_LIMIT = 32


def solver_handle(
    mat: DistMat,
    *,
    op: str = "cg",
    nrhs: int = 1,
    variant: str = "hs",
    precond: Preconditioner | None = None,
    tol: float = 1e-8,
    maxiter: int = 100,
    kernels: str | None = None,
    overlap: bool = True,
    device=None,
    cache: dict | None = None,
) -> SolverHandle:
    """Cached solver keyed by (matrix identity, config): build once, solve
    many. Routes to the Ginkgo-analog baseline for ``variant="naive"``, the
    distributed SpMV for ``op="spmv"`` (``variant="naive"`` selects the
    all-gather SpMV), and :func:`make_solver` otherwise. ``nrhs > 1``
    (block CG) is not ported yet."""
    if int(nrhs) > 1:
        raise NotImplementedError(
            "multi-RHS block CG is not ported to repro_torch yet "
            "(ROADMAP.md, queue 1, item 7)"
        )
    dev = resolve_device(device)
    key = (
        id(mat), str(op), str(variant),
        None if precond is None else id(precond),
        float(tol), int(maxiter), kernels, bool(overlap), str(dev),
    )
    store = _HANDLES if cache is None else cache
    h = store.get(key)
    if h is not None and h.mat is mat and (precond is None or h.precond is precond):
        if store is _HANDLES:
            _HANDLES.move_to_end(key)
        return h
    if op == "spmv":
        from repro_torch.core.baselines import make_naive_spmv
        from repro_torch.core.spmv import make_spmv

        m = mat.to(dev)
        fn = make_naive_spmv(m) if variant == "naive" else make_spmv(m, overlap=overlap)
    elif variant == "naive":
        from repro_torch.core.baselines import make_naive_solver

        fn = make_naive_solver(mat, precond=precond, tol=tol, maxiter=maxiter, device=dev)
    else:
        fn = make_solver(
            mat, variant=variant, precond=precond, tol=tol, maxiter=maxiter,
            kernels=kernels, overlap=overlap, device=dev,
        )
    h = SolverHandle(fn=fn, key=key, mat=mat, precond=precond)
    store[key] = h
    if store is _HANDLES:
        while len(_HANDLES) > _HANDLE_LIMIT:
            _HANDLES.popitem(last=False)
    return h
