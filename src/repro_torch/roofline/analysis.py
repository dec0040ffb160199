"""Closed-form collective and halo models of the 2-D process grid.

Port of the grid helpers of ``repro.roofline.analysis``: the tree depth the
cost model charges per all-reduce (:func:`reduce_hops`), the launches a
staged all-reduce takes (:func:`reduce_launches`) and the per-shift halo
widths of a pencil-partitioned Poisson cube (:func:`pencil_halo_widths`),
which ``GridPlan.widths`` must equal. The rest of the JAX package's
roofline analysis is not ported yet.
"""

from __future__ import annotations

import math


def reduce_hops(n_shards: int, grid: tuple[int, int] | None = None) -> int:
    """Per-collective tree depth the cost model charges.

    1-D (``grid`` is ``None`` or ``(1, N)``): one tree over all ``S``
    shards — ``ceil(log2(S))``. On a ``(R, C)`` grid with ``R > 1`` the
    staged all-reduce runs over the grid's columns and then its rows, so
    no single launch is deeper than the longer of the two:
    ``ceil(log2(max(R, C)))``.
    """
    if grid is not None and grid[0] > 1:
        n_shards = max(grid)
    return max(math.ceil(math.log2(max(n_shards, 2))), 1)


def reduce_launches(grid: tuple[int, int] | None = None) -> int:
    """Collective launches per logical all-reduce: 1 on a flat axis, 2 for
    the staged intra-row + inter-row reduction on a true 2-D grid."""
    return 2 if (grid is not None and grid[0] > 1) else 1


def pencil_halo_widths(p, grid: tuple[int, int]) -> dict:
    """Closed-form per-shift halo widths for a pencil-partitioned Poisson
    cube — the surface-not-volume law the 2-D layout is built on.

    ``p`` is a ``matrices.poisson.PoissonProblem``; ``grid = (R, C)`` splits
    z into ``R`` blocks and y into ``C`` slabs
    (``core.partition.pencil_partition``), every shard keeping full x
    lines. Returns ``{(di, dj): width}``, the receive-buffer length the
    worst-placed shard needs from its ``(i+di, j+dj)`` neighbour:

      z-face (±1, 0):  nx * ceil(ny / C)   one z-plane, own y-slab wide
      y-face (0, ±1):  nx * ceil(nz / R)   one y-plane, own z-block deep
      corner (±1, ±1): nx                  one x line (27pt stencil only)
    """
    gr, gc = grid
    max_zb = -(-p.nz // gr)
    max_yb = -(-p.ny // gc)
    widths: dict[tuple[int, int], int] = {}
    if gr > 1:
        widths[(1, 0)] = widths[(-1, 0)] = p.nx * max_yb
    if gc > 1:
        widths[(0, 1)] = widths[(0, -1)] = p.nx * max_zb
    if p.stencil == "27pt" and gr > 1 and gc > 1:
        for di in (-1, 1):
            for dj in (-1, 1):
                widths[(di, dj)] = p.nx
    return widths
