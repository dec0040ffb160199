"""Plain PyTorch versions of the port's hand-written kernels.

Counterpart of ``repro.kernels.ref`` for the kernels ported so far. Each
function computes what its kernel computes, on the stacked ``(S, R)``
layout (or a single ``(n,)`` vector), and returns the same per-shard
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
