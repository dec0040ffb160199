"""Matrix-free distributed stencil CG (port of ``repro.core.stencil_solver``).

The paper's benchmarks are structured 7/27-point Poisson stencils stored in
CSR; dropping the matrix turns ``y = A x`` into shift-and-add on the local
``(nz_loc, ny, nx)`` grid, and the halo exchange shrinks to ONE boundary
plane per neighbour. Per SpMV this removes all matrix-value and
column-index traffic:

    format        matrix B/row   vector B/row   total B/row   vs matfree
    ELL 7pt       7*(8+4) = 84   ~16            ~100          ~6x
    ELL 27pt      27*(8+4)= 324  ~16            ~340          ~21x
    matrix-free   0              ~16            ~16           1x

(f32 halves the matrix-free number again.) The JAX package maps the
operator over a ``shards`` mesh with ``shard_map``; the port stacks the
slabs on one device. A vector is ``(S, R)`` with ``R = nz_loc*ny*nx``: the
slab partition is uniform (``p.nz % n_shards == 0``), so the stacked layout
is exactly ``b.reshape(S, R)`` with no padding, and its ``(S, nz_loc, ny,
nx)`` view is free. The halo exchange is an index along the shard axis
(``prev[s] = x3[s - 1, -1]``, ``next[s] = x3[s + 1, 0]``, zero planes at
the two ends: not periodic), recorded like the JAX package's ``ppermute``
pairs. The slab product dispatches through ``kernels/dispatch.py``: on a
CUDA device the hand-written ``stencil_spmv_halo`` and
``stencil_spmv_boundary`` kernels (``kernels/spmv_stencil.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.cg import _BODIES, SolveResult, identity_precond
from repro_torch.energy import trace
from repro_torch.energy.accounting import OpCounts
from repro_torch.kernels import dispatch as kd
from repro_torch.launch.mesh import resolve_device


def make_matvec(p, n_shards: int, *, kernels: str | None = None, overlap: bool = True):
    """Stacked matrix-free stencil operator ``A(v)`` on ``(S, R)`` vectors.

    Requires a uniform slab partition (``p.nz % n_shards == 0``).
    ``kernels`` selects the backend (None = follow the device; see
    kernels/dispatch.py).

    ``overlap=True`` (and ``nz_loc >= 2``, ``n_shards > 1``): the
    communication-hiding schedule, all in the ``"overlap"`` energy region —
    the boundary-plane exchange, the full slab with zero halos (every
    interior output plane is already final), then the two slab-edge planes
    patched in place by the boundary kernel. Otherwise: the exchange in
    ``"halo"``, then the product in the caller's region. The split and the
    single-call schedules give the same bits (the boundary kernel's planes
    equal the slab kernel's).
    """
    if p.nz % n_shards:
        raise ValueError(
            f"the matrix-free path needs uniform slabs: nz={p.nz} is not a "
            f"multiple of n_shards={n_shards}"
        )
    nz_loc = p.nz // n_shards
    ops = kd.ops_for(kernels)
    split = overlap and n_shards > 1 and nz_loc >= 2
    kw = dict(stencil=p.stencil, aniso=tuple(p.aniso))
    zeros = {}  # the zero halo planes, one per (dtype, device)

    def _zero(x3):
        key = (x3.dtype, x3.device)
        if key not in zeros:
            zeros[key] = x3.new_zeros((n_shards, p.ny, p.nx))
        return zeros[key]

    def _exchange(x3):
        # one boundary plane to each neighbour
        trace.record_op(
            "halo_exchange",
            OpCounts(ici_bytes=2.0 * p.ny * p.nx * x3.element_size(), n_collectives=2.0),
        )
        prev = F.pad(x3[:-1, -1], (0, 0, 0, 0, 1, 0))  # from the left neighbour
        nxt = F.pad(x3[1:, 0], (0, 0, 0, 0, 0, 1))  # from the right neighbour
        return prev, nxt

    def A(v: torch.Tensor) -> torch.Tensor:
        x3 = v.view(n_shards, nz_loc, p.ny, p.nx)
        if split:
            with trace.region(trace.OVERLAP):
                prev, nxt = _exchange(x3)
                zero = _zero(x3)
                # full slab with zero halos: interior planes final, no
                # dependence on the exchange
                y = ops.stencil_matvec(x3, zero, zero, **kw)
                # on arrival: patch the two slab-edge planes in place
                ops.stencil_boundary(x3, prev, nxt, out=y, **kw)
            return y.view(v.shape)
        if n_shards > 1:
            with trace.region("halo"):
                prev, nxt = _exchange(x3)
        else:
            prev = nxt = _zero(x3)
        return ops.stencil_matvec(x3, prev, nxt, **kw).view(v.shape)

    return A


def make_stencil_solver_fn(
    p,
    n_shards: int,
    *,
    variant: str = "hs",
    tol: float = 1e-8,
    maxiter: int = 100,
    s: int = 2,
    kernels: str | None = None,
    overlap: bool = True,
    device=None,
):
    """Matrix-free stacked CG: ``solve(b, x0) -> SolveResult``.

    ``b``/``x0`` are ``(n_shards, R)`` with ``R = (nz/n_shards)*ny*nx``
    (the global vector reshaped). ``variant`` is one of the port's CG
    bodies (hs, fcg, pipecg, sstep) with the identity preconditioner;
    s-step takes the sequential basis (s SpMVs per block: there is no
    matrix to run the matrix powers on). ``kernels`` selects the backend of
    the slab SpMV and the fused vector ops; ``overlap`` the
    communication-hiding schedule (:func:`make_matvec`, and pipecg's
    reduction beside its SpMV). ``device``: ``cuda`` unless the caller
    passes ``"cpu"`` (the JAX package's ``mesh`` argument).
    """
    if variant not in _BODIES:
        raise ValueError(f"unknown CG variant {variant!r}; want one of {tuple(_BODIES)}")
    dev = resolve_device(device)
    pre = identity_precond()
    body = _BODIES[variant]
    kw = dict(tol=tol, maxiter=maxiter, ops=kd.ops_for(kernels))
    if variant == "sstep":
        kw.update(s=int(s), mat=None)
    if variant == "pipecg":
        kw["overlap"] = overlap
    A = make_matvec(p, n_shards, kernels=kernels, overlap=overlap)

    def solve(b: torch.Tensor, x0: torch.Tensor) -> SolveResult:
        x, iters, rr, bb = body(A, pre, pre.data, b.to(dev), x0.to(dev), **kw)
        return SolveResult(x=x, iters=int(iters), rr=rr, bb=bb)

    return solve
