"""Plain PyTorch versions of the port's hand-written kernels.

Counterpart of ``repro.kernels.ref`` for the kernels ported so far. Each
function computes what its kernel computes, on the stacked ``(S, R)``
layout (or a single ``(n,)`` vector) — ``(S, R, r)`` column blocks (or one
``(n, r)`` block) for the block kernels — and returns the same per-shard
partials: the kernel wrappers in ``kernels/fused_reductions.py`` use these
for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernels
against them. Sums accumulate in the input dtype, as the kernels do.

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
