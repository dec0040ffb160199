"""Distributed dense-vector operations over the stacked shard layout.

Port of ``repro.core.vectors``. Vectors are ``(S, R)`` stacks of shard
vectors on one device; a shard's local work is a reduction over the last
axis, and the all-reduce is an explicit sum over the shard axis (dim 0) of
the per-shard partials. Any group of inner products needed at the same
algorithmic point is packed into ONE such all-reduce (the paper's fused
reductions), recorded as one collective.

``fused_dots``/``pdot`` are plain tensor ops here, as they are ``jnp.vdot``
in the JAX package, not kernels.
"""

from __future__ import annotations

import torch

from repro_torch.energy import trace


def all_reduce(v: torch.Tensor) -> torch.Tensor:
    """Sum per-shard partials ``(S, ...)`` over the shard axis (dim 0).

    The caller records the collective (``trace.record_collective`` or the
    counts of the fused op it belongs to), as the JAX package's callers
    record their ``lax.psum``.
    """
    return v.sum(dim=0)


def _local_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-shard partial <x, y>: ``(S,)`` for stacked vectors."""
    return (x * y).sum(dim=-1)


def _record_dots(pairs, n_out: int | None = None):
    """Executed-counts entry for a fused local-dots + all-reduce op."""
    trace.record_op("fused_dots", trace.fused_dots_counts(pairs, n_out))


def pdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Global <x, y> (0-d) — ONE all-reduce."""
    _record_dots([(x, y)])
    return all_reduce(_local_dot(x, y))


def pnorm2(x: torch.Tensor) -> torch.Tensor:
    """Global ||x||^2 — ONE all-reduce."""
    return pdot(x, x)


def fused_dots(pairs) -> torch.Tensor:
    """Global inner products for a list of (x, y) pairs — ONE all-reduce.

    Returns a ``(len(pairs),)`` vector: the per-shard partials are stacked
    ``(S, k)`` and reduced together.
    """
    _record_dots(pairs)
    local = torch.stack([_local_dot(x, y) for x, y in pairs], dim=-1)
    return all_reduce(local)


def fused_blocks(parts) -> torch.Tensor:
    """Fuse per-shard reduction blocks ``(S, ...)`` into ONE all-reduce;
    returns the flat reduced vector (callers re-split with known sizes)."""
    S = parts[0].shape[0]
    flat = torch.cat([p.reshape(S, -1) for p in parts], dim=1)
    trace.record_collective(flat.shape[1], flat.element_size(), op="fused_blocks")
    return all_reduce(flat)
