"""Plain PyTorch versions of the port's hand-written kernels.

Counterpart of ``repro.kernels.ref`` for the kernels ported so far. Each
function computes what its kernel computes, on the stacked ``(S, R)``
layout (or a single ``(n,)`` vector) — ``(S, R, r)`` column blocks (or one
``(n, r)`` block) for the block and s-step kernels — and returns the same
per-shard partials: the kernel wrappers in ``kernels/fused_reductions.py`` and
``kernels/spmv_bcsr.py`` use these for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernels against them. Sums accumulate in the
input dtype, as the kernels do.

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
