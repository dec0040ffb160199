"""Distributed dense-vector operations over the stacked shard layout.

Port of ``repro.core.vectors``. Vectors are ``(S, R)`` stacks of shard
vectors on one device; a shard's local work is a reduction over the last
axis, and the all-reduce is an explicit sum over the shard axis (dim 0) of
the per-shard partials. Any group of inner products needed at the same
algorithmic point is packed into ONE such all-reduce (the paper's fused
reductions), recorded as one collective.

On a 2-D ``R x C`` process grid (``grid``, from the matrix's
``GridPlan``) every reduction goes through :func:`all_reduce`, which stages
the sum as the JAX package stages its ``psum``: over the ``C`` shards of a
grid row first, then over the ``R`` row sums — two shallow trees instead
of one deep one, a fixed order with no float atomics.

``fused_dots``/``pdot`` are plain tensor ops here, as they are ``jnp.vdot``
in the JAX package, not kernels.
"""

from __future__ import annotations

import torch

from repro_torch.energy import trace

#: Ledger op name of the extra stage a grid all-reduce launches beyond the
#: single collective the caller records.
HIER_STAGE_OP = "hier_reduce_stage"


def all_reduce(v: torch.Tensor, grid: tuple[int, int] | None = None) -> torch.Tensor:
    """Sum per-shard partials ``(S, ...)`` over the shard axis (dim 0).

    The caller records the collective (``trace.record_collective`` or the
    counts of the fused op it belongs to), as the JAX package's callers
    record their ``lax.psum``. With ``grid = (R, C)``, ``R > 1``, the
    partials are summed as ``(R, C, ...)``: over ``C`` first, then over
    ``R``; the second stage is recorded here as one ``hier_reduce_stage``
    collective of the same payload. Without a grid (or ``R == 1``) it is
    ``v.sum(dim=0)``.
    """
    if grid is None or grid[0] <= 1:
        return v.sum(dim=0)
    gr, gc = grid
    out = v.reshape((gr, gc) + tuple(v.shape[1:])).sum(dim=1).sum(dim=0)
    trace.record_collective(v[0].numel(), v.element_size(), op=HIER_STAGE_OP)
    return out


def _local_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-shard partial <x, y>: ``(S,)`` for stacked vectors."""
    return (x * y).sum(dim=-1)


def _record_dots(pairs, n_out: int | None = None):
    """Executed-counts entry for a fused local-dots + all-reduce op."""
    trace.record_op("fused_dots", trace.fused_dots_counts(pairs, n_out))


def pdot(x: torch.Tensor, y: torch.Tensor, grid=None) -> torch.Tensor:
    """Global <x, y> (0-d) — ONE all-reduce (one per grid dimension)."""
    _record_dots([(x, y)])
    return all_reduce(_local_dot(x, y), grid)


def pnorm2(x: torch.Tensor, grid=None) -> torch.Tensor:
    """Global ||x||^2 — ONE all-reduce."""
    return pdot(x, x, grid)


def fused_dots(pairs, grid=None) -> torch.Tensor:
    """Global inner products for a list of (x, y) pairs — ONE all-reduce.

    Returns a ``(len(pairs),)`` vector: the per-shard partials are stacked
    ``(S, k)`` and reduced together.
    """
    _record_dots(pairs)
    local = torch.stack([_local_dot(x, y) for x, y in pairs], dim=-1)
    return all_reduce(local, grid)


def fused_blocks(parts, grid=None) -> torch.Tensor:
    """Fuse per-shard reduction blocks ``(S, ...)`` into ONE all-reduce;
    returns the flat reduced vector (callers re-split with known sizes)."""
    S = parts[0].shape[0]
    flat = torch.cat([p.reshape(S, -1) for p in parts], dim=1)
    trace.record_collective(flat.shape[1], flat.element_size(), op="fused_blocks")
    return all_reduce(flat, grid)
