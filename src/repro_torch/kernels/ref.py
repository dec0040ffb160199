"""Plain PyTorch versions of the port's hand-written kernels.

Counterpart of ``repro.kernels.ref``. Each function computes what its
kernel computes, on the stacked ``(S, R)`` layout (or a single ``(n,)``
vector) — ``(S, R, r)`` column blocks (or one ``(n, r)`` block) for the
block and s-step kernels, ``(S, nz, ny, nx)`` slabs (or one ``(nz, ny,
nx)`` grid) for the stencil kernels — and returns the same per-shard
partials: the kernel wrappers in ``kernels/`` use these for CPU tensors,
and the tests and ``chip_smoke.py`` hold the kernels against them. Sums
accumulate in the input dtype, as the kernels do.

Scalars may be Python numbers, 0-d tensors, or ``(S,)`` tensors (one per
shard).
"""

from __future__ import annotations

import torch


def _scalar(a, x: torch.Tensor):
    """Broadcast a scalar or an (S,) per-shard scalar against ``x``."""
    if isinstance(a, torch.Tensor) and a.dim() == 1 and x.dim() == 2:
        return a[:, None]
    return a


def fused_dots_n_ref(pairs) -> torch.Tensor:
    """Local partial dots ``[(x, y), ...] -> (..., len(pairs))``."""
    return torch.stack([(x * y).sum(-1) for x, y in pairs], dim=-1)


def fused_axpy_ref(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _scalar(a, x) * x + y


def fused_axpy2_dots_ref(a1, x1, y1, a2, x2, y2):
    o1 = _scalar(a1, x1) * x1 + y1
    o2 = _scalar(a2, x2) * x2 + y2
    return o1, o2, (o2 * o2).sum(-1, keepdim=True)


def fused_axpy2_ref(a1, x1, y1, a2, x2, y2):
    return _scalar(a1, x1) * x1 + y1, _scalar(a2, x2) * x2 + y2


# ---------------------------------------------------------------------------
# Multi-RHS block kernels: stacked (S, R, r) blocks or one (n, r) block
# ---------------------------------------------------------------------------


GRAM_ROWS = 1024  # rows per partial product of block_gram_ref


def _gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    n = x.shape[-2]
    m = n - n % GRAM_ROWS
    if not m:
        return x.mT @ y
    xs = x[..., :m, :].unflatten(-2, (-1, GRAM_ROWS))
    ys = y[..., :m, :].unflatten(-2, (-1, GRAM_ROWS))
    g = (xs.mT @ ys).sum(-3)
    return g if m == n else g + x[..., m:, :].mT @ y[..., m:, :]


def block_gram_ref(pairs) -> list:
    """Local Gram blocks ``[Xᵀ @ Y, ...]``: ``(S, r, r)`` per pair for
    stacked blocks, ``(r, r)`` for one ``(n, r)`` block. Order-sensitive:
    XᵀY is the transpose of YᵀX, not the same product.

    The rows are multiplied in chunks of :data:`GRAM_ROWS` and the chunk
    products summed by ``torch.sum``: one matrix product over millions of
    rows accumulates its inner dimension in long runs on the card, whose
    rounding grows with their length (worst on the diagonal of XᵀX, a sum
    of squares), and the comparison with the kernel would then measure the
    plain version's error."""
    return [_gram(x, y) for x, y in pairs]


def block_update_ref(m, x: torch.Tensor, y: torch.Tensor, mask=None) -> torch.Tensor:
    """``y * mask + x @ m`` with ``m`` an ``(r, r)`` block and ``mask`` an
    optional ``(r,)`` column scale."""
    ym = y if mask is None else y * mask
    return ym + x @ m


def block_update2_ref(a1, x1, y1, a2, x2, y2):
    return y1 + x1 @ a1, y2 + x2 @ a2


# ---------------------------------------------------------------------------
# Block-CSR SpMV / SpMM: stacked uniform blocks-per-row tiles
# ---------------------------------------------------------------------------


def _bcsr_x_tiles(bcol: torch.Tensor, x: torch.Tensor, bc: int) -> torch.Tensor:
    """The x tile of every BCSR tile: ``(S, n_tiles, bc)`` (``(..., bc, r)``
    for an ``(S, R, r)`` block), x zero-padded to whole tiles first — the
    ``bcsr_prepare_x`` padding of the JAX package (the kernels mask
    instead)."""
    S, R = x.shape[:2]
    rest = tuple(x.shape[2:])
    n_bcols = -(-R // bc)
    pad = n_bcols * bc - R
    if pad:
        x = torch.cat([x, x.new_zeros((S, pad) + rest)], dim=1)
    tiles = x.reshape((S * n_bcols, bc) + rest)
    offs = torch.arange(S, device=bcol.device)[:, None] * n_bcols
    return tiles[bcol.long() + offs]


def _bcsr_n_out(R: int, n_brows: int, br: int, n_out) -> int:
    return min(R, n_brows * br) if n_out is None else int(n_out)


def bcsr_spmv_ref(blocks, bcol, x, n_brows: int, bpr: int, n_out=None) -> torch.Tensor:
    """``y = A @ x`` for the stacked uniform-layout BCSR interior: blocks
    ``(S, n_brows*bpr, br, bc)``, bcol ``(S, n_brows*bpr)``, x ``(S, R)``
    -> ``(S, n_out)`` (default ``min(R, n_brows*br)``). Each tile's product
    with its x tile, summed over the block-row's tiles; padding tiles carry
    zeros and contribute nothing."""
    S, _, br, bc = blocks.shape
    xb = _bcsr_x_tiles(bcol, x, bc)  # (S, n_tiles, bc)
    contrib = (blocks @ xb.unsqueeze(-1)).squeeze(-1)  # (S, n_tiles, br)
    y = contrib.view(S, n_brows, bpr, br).sum(2).reshape(S, n_brows * br)
    return y[:, : _bcsr_n_out(x.shape[1], n_brows, br, n_out)].contiguous()


def bcsr_spmm_ref(blocks, bcol, x, n_brows: int, bpr: int, n_out=None) -> torch.Tensor:
    """Multi-RHS :func:`bcsr_spmv_ref`: x ``(S, R, r)`` -> ``(S, n_out, r)``."""
    S, _, br, bc = blocks.shape
    r = x.shape[-1]
    xb = _bcsr_x_tiles(bcol, x, bc)  # (S, n_tiles, bc, r)
    contrib = blocks @ xb  # (S, n_tiles, br, r)
    y = contrib.view(S, n_brows, bpr, br, r).sum(2).reshape(S, n_brows * br, r)
    return y[:, : _bcsr_n_out(x.shape[1], n_brows, br, n_out)].contiguous()


# ---------------------------------------------------------------------------
# s-step CG kernels: stacked (S, R, s) basis blocks and (S, R) vectors
# ---------------------------------------------------------------------------


def sstep_gram_ref(pb, wb, wp, r) -> torch.Tensor:
    """Flat local s-step reduction ``[PᵀW | WpᵀP | Pᵀr | rᵀr]`` of length
    2s² + s + 1 per shard: ``(S, 2s²+s+1)`` for stacked ``(S, R, s)``
    blocks and ``(S, R)`` residuals, ``(2s²+s+1,)`` for one ``(n, s)``
    block. The products sum :data:`GRAM_ROWS`-row chunks, as
    :func:`block_gram_ref` does."""
    rc = r.unsqueeze(-1)
    parts = [_gram(pb, wb), _gram(wp, pb), _gram(pb, rc), _gram(rc, rc)]
    return torch.cat([p.flatten(-2) for p in parts], dim=-1)


def sstep_basis_ref(b, dinv, qp, pb, wp, wb):
    """``(Pb·diag(dinv) − Qp @ b, Wb·diag(dinv) − Wp @ b)`` — the s-step
    A-conjugation with the column normalization folded in; ``b`` is
    ``(s, s)``, ``dinv`` ``(s,)``, shared by every shard."""
    return pb * dinv - qp @ b, wb * dinv - wp @ b


def sstep_update_ref(a, q, wq, x, r):
    """``(x + Q @ a, r − WQ @ a)`` for an ``(s,)`` coefficient vector."""
    return x + q @ a, r - wq @ a


# ---------------------------------------------------------------------------
# Matrix-free stencil SpMV (7pt / 27pt, Dirichlet): one (nz, ny, nx) grid, or
# S stacked slabs (S, nz, ny, nx) with (S, ny, nx) halo planes
# ---------------------------------------------------------------------------


def stencil_coefs(stencil: str, aniso, dtype) -> tuple[float, float, float, float]:
    """``(diag, ax, ay, az)`` of the stencil, each rounded to ``dtype`` on
    the host — the JAX package forms them from Python floats in the array's
    type. 7pt: ``diag = 2(ax + ay + az)``; 27pt: ``diag = 27`` (the centre's
    multiplier; ``aniso`` is ignored)."""
    if stencil not in ("7pt", "27pt"):
        raise ValueError(f"unknown stencil {stencil!r}; want '7pt' or '27pt'")
    if stencil == "27pt":
        vals = (27.0, 0.0, 0.0, 0.0)
    else:
        ax, ay, az = (float(a) for a in aniso)
        vals = (2.0 * (ax + ay + az), ax, ay, az)
    return tuple(_round(v, dtype) for v in vals)


def _round(v, dtype) -> float:
    """``v`` rounded to ``dtype`` (exactly representable there)."""
    return float(torch.tensor(float(v), dtype=dtype))


def _shift(x: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """Shift with zero fill along ``axis``: result[i] = x[i - d] (zeros
    flow in)."""
    if d == 0:
        return x
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = abs(d)
    z = x.new_zeros(shape)
    if d > 0:
        return torch.cat([z, x.narrow(axis, 0, n - d)], dim=axis)
    return torch.cat([x.narrow(axis, -d, n + d), z], dim=axis)


def _s9(e: torch.Tensor) -> torch.Tensor:
    """The 3x3 (y, x) neighbourhood sum of every plane, over dy then dx."""
    s9 = torch.zeros_like(e)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s9 = s9 + _shift(_shift(e, dx, -1), dy, -2)
    return s9


def stencil7_ref(x: torch.Tensor, aniso=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """y = A7 @ x on the (nz, ny, nx) grid (each slab of a stacked
    ``(S, nz, ny, nx)`` its own grid), homogeneous Dirichlet."""
    diag, ax, ay, az = stencil_coefs("7pt", aniso, x.dtype)
    y = diag * x
    y = y - ax * (_shift(x, 1, -1) + _shift(x, -1, -1))
    y = y - ay * (_shift(x, 1, -2) + _shift(x, -1, -2))
    y = y - az * (_shift(x, 1, -3) + _shift(x, -1, -3))
    return y


def stencil27_ref(x: torch.Tensor) -> torch.Tensor:
    """y = A27 @ x (HPCG stencil: diag 26, all 26 neighbours -1). The z-sum
    runs ``s9[z+1] + s9[z] + s9[z-1]``, as the JAX package's oracle does."""
    s9 = _s9(x)
    s27 = _shift(s9, -1, -3) + s9 + _shift(s9, 1, -3)
    return 27.0 * x - s27


def stencil_halo_ref(x, prev_halo, next_halo, *, stencil="7pt", aniso=(1.0, 1.0, 1.0)):
    """Local-slab stencil SpMV with explicit z-boundary planes: ``x`` is a
    ``(nz, ny, nx)`` slab with ``(ny, nx)`` halo planes, or ``(S, nz, ny,
    nx)`` slabs with ``(S, ny, nx)`` planes. Zero halo planes reproduce the
    global Dirichlet edges. The 27pt z-sum runs ``s9[z-1] + s9[z] +
    s9[z+1]``, the order of the Pallas kernels (and of the CUDA ones)."""
    ext = torch.cat([prev_halo.unsqueeze(-3), x, next_halo.unsqueeze(-3)], dim=-3)
    c = ext[..., 1:-1, :, :]
    diag, ax, ay, az = stencil_coefs(stencil, aniso, x.dtype)
    if stencil == "7pt":
        y = diag * c
        y = y - ax * (_shift(c, 1, -1) + _shift(c, -1, -1))
        y = y - ay * (_shift(c, 1, -2) + _shift(c, -1, -2))
        y = y - az * (ext[..., :-2, :, :] + ext[..., 2:, :, :])
        return y
    s9 = _s9(ext)
    return diag * c - (s9[..., :-2, :, :] + s9[..., 1:-1, :, :] + s9[..., 2:, :, :])


def stencil_boundary_ref(x, prev_halo, next_halo, *, stencil="7pt", aniso=(1.0, 1.0, 1.0)):
    """Output planes 0 and nz-1 of :func:`stencil_halo_ref` (nz >= 2), as
    ``(2, ny, nx)`` (``(S, 2, ny, nx)`` for stacked slabs), computed on
    one-plane sub-slabs — bitwise the slab oracle's planes."""
    y0 = stencil_halo_ref(x[..., :1, :, :], prev_halo, x[..., 1, :, :],
                          stencil=stencil, aniso=aniso)
    y1 = stencil_halo_ref(x[..., -1:, :, :], x[..., -2, :, :], next_halo,
                          stencil=stencil, aniso=aniso)
    return torch.cat([y0, y1], dim=-3)


def jacobi_stencil_ref(x, b, dinv, *, stencil="7pt", aniso=(1.0, 1.0, 1.0), omega=1.0):
    """One fused l1-Jacobi sweep: x + omega * dinv * (b - A x)."""
    ax = stencil7_ref(x, aniso) if stencil == "7pt" else stencil27_ref(x)
    return x + _round(omega, x.dtype) * dinv * (b - ax)


def stencil_spmv_ref(x, *, stencil="7pt", aniso=(1.0, 1.0, 1.0)):
    """The plain version of the single-grid kernel: :func:`stencil_halo_ref`
    with zero halo planes, in the kernels' order. Bitwise
    :func:`stencil7_ref` for 7pt; for 27pt it differs from
    :func:`stencil27_ref` only in the order of the z-sum."""
    z = x.new_zeros(x.shape[:-3] + x.shape[-2:])
    return stencil_halo_ref(x, z, z, stencil=stencil, aniso=aniso)


def jacobi_sweep_ref(x, b, dinv, *, stencil="7pt", aniso=(1.0, 1.0, 1.0), omega=1.0):
    """The plain version of the fused sweep kernel: :func:`jacobi_stencil_ref`
    with the product of :func:`stencil_spmv_ref` (the kernels' order)."""
    y = stencil_spmv_ref(x, stencil=stencil, aniso=aniso)
    return x + _round(omega, x.dtype) * dinv * (b - y)
