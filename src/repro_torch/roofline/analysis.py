"""Closed-form models of the CG hot path, its collectives and the 2-D grid.

Port of the CG models of ``repro.roofline.analysis``:

* the vector-op HBM streams and kernel passes per CG iteration outside the
  SpMV (:data:`CG_HOTPATH`, :func:`cg_sstep_hotpath`,
  :func:`cg_vector_traffic`, :func:`cg_vector_sweeps`,
  :func:`cg_vector_flops`) and the SpMV's own traffic
  (:func:`spmv_traffic`, :func:`cg_iteration_memory_s`);
* the all-reduce structure of each variant (:data:`CG_COMM`,
  :func:`cg_reduce_scalars`, :func:`cg_exposed_latency_s`);
* the grid helpers: the tree depth the cost model charges per all-reduce
  (:func:`reduce_hops`), the launches a staged all-reduce takes
  (:func:`reduce_launches`) and the per-shift halo widths of a
  pencil-partitioned Poisson cube (:func:`pencil_halo_widths`), which
  ``GridPlan.widths`` must equal.

The autotuner's pruning stage (``autotune/prune.py``) prices candidates
with these. The JAX package's HLO collective parser, its ``roofline()``
terms and the language-model FLOP counts read compiled XLA programs or
model configs and have no counterpart here.
"""

from __future__ import annotations

import math

from repro_torch.roofline.hw import DEFAULT_CHIP, ChipSpec


# ---------------------------------------------------------------------------
# CG hot-path HBM traffic model (the kernel-fusion term)
# ---------------------------------------------------------------------------

# Full-vector HBM *streams* (one read or write of n elements) per CG
# iteration OUTSIDE the SpMV, and the number of kernel passes ("sweeps")
# they are grouped into. "unfused" is the op-by-op formulation (every
# axpy/dot its own pass); "fused" is the dispatch-layer kernel path
# (fused_dots_n with operand dedup + fused_axpy2[_dots]), identity
# preconditioner. pipecg pays +1 fused sweep (the z recurrence) to buy the
# hidden all-reduce — see CG_COMM below for the latency side of that trade.
CG_HOTPATH = {
    # variant: {mode: (streams, sweeps)}
    "hs": {"unfused": (15, 6), "fused": (11, 3)},
    "fcg": {"unfused": (18, 5), "fused": (14, 3)},
    "pipecg": {"unfused": (22, 8), "fused": (20, 4)},
    # multi-RHS block-HS (core/cg.py:_block_hs_body): streams are in n*r
    # element units (pass nrhs to the traffic helpers below). Fused path:
    # gram(P,W) reads 2 blocks + the fused X/R update reads 4 writes 2 +
    # gram(R,R) reads 1 + P update reads 2 writes 1 = 12 streams in 4
    # kernel passes. Unfused op-by-op: 15 streams / 7 passes.
    "block_hs": {"unfused": (15, 7), "fused": (12, 4)},
    # s-step CG (core/cg.py:_sstep_body), PER-ITERATION amortized values at
    # the s=2 accounting default — exact s-parameterized values come from
    # cg_sstep_hotpath(s). Fused path per block: sstep_gram reads the three
    # (n, s) basis blocks + r (3s+1 streams), sstep_basis reads 4 / writes
    # 2 blocks (6s), sstep_update reads 2 blocks + x, r and writes both
    # (2s+4) -> (11s+5)/s streams in 3/s passes per iteration. Unfused
    # op-by-op Gram algebra: (13s+6)/s streams in 8/s passes.
    "sstep": {"unfused": (16.0, 4.0), "fused": (13.5, 1.5)},
}


def cg_sstep_hotpath(s: int = 2, *, fused: bool = True) -> tuple[float, float]:
    """Exact per-iteration (streams, sweeps) of the s-step body for block
    size ``s`` — the s-parameterized version of ``CG_HOTPATH['sstep']``
    (which carries the s=2 accounting default)."""
    s = max(int(s), 1)
    if fused:
        return ((11 * s + 5) / s, 3 / s)
    return ((13 * s + 6) / s, 8 / s)


# All-reduce phases per iteration and how many of them the variant issues
# concurrently with compute (the hidden-latency term): hs blocks on both of
# its reductions, fcg on its single fused one; pipecg issues its single
# reduction before the SpMV + preconditioner it does not depend on, so its
# latency is absorbed up to the concurrent compute time.
CG_COMM = {
    "hs": {"allreduces": 2, "hidden": 0},
    "fcg": {"allreduces": 1, "hidden": 0},
    "pipecg": {"allreduces": 1, "hidden": 1},
    # block-HS keeps the scalar-HS latency structure (2 blocking
    # all-reduces/iter) but each carries r^2 scalars — see
    # cg_reduce_scalars(nrhs=...)
    "block_hs": {"allreduces": 2, "hidden": 0},
    # s-step CG: ONE blocking all-reduce PER s-ITERATION BLOCK — the
    # communication-avoiding trade. cg_exposed_latency_s divides the
    # latency by s for this variant (pass ``s``); same for the widened
    # halo exchange (1 per block) priced in energy/accounting.py.
    "sstep": {"allreduces": 1, "hidden": 0},
}


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


def cg_exposed_latency_s(
    variant: str, n_shards: int, *, alpha: float = 5e-6,
    hide_budget_s: float = float("inf"),
    grid: tuple[int, int] | None = None,
    s: int = 2,
) -> float:
    """Exposed all-reduce latency per CG iteration (seconds).

    Each all-reduce costs ``alpha * hops * launches`` with ``hops`` from
    :func:`reduce_hops` and ``launches`` from :func:`reduce_launches`; a
    variant's ``hidden`` reductions are absorbed into the concurrent
    SpMV/preconditioner up to ``hide_budget_s`` (pass that phase's compute
    time; the default, an unbounded budget, models the large-problem regime
    where the matvec always covers the latency). ``sstep``'s single
    blocking all-reduce serves a whole s-iteration block, so its
    per-iteration latency is divided by ``s``.
    """
    if n_shards <= 1:
        return 0.0
    c = CG_COMM[variant]
    lat = alpha * reduce_hops(n_shards, grid) * reduce_launches(grid)
    exposed = c["allreduces"] * lat - min(c["hidden"] * lat, hide_budget_s)
    if variant == "sstep":
        exposed = exposed / max(int(s), 1)
    return max(exposed, 0.0)


def _streams(variant: str, fused: bool, s: int | None) -> tuple[float, float]:
    """(streams, sweeps) of ``variant``: exact in ``s`` for ``sstep`` when
    ``s`` is given, else the table row."""
    if variant == "sstep" and s is not None:
        return cg_sstep_hotpath(s, fused=fused)
    return CG_HOTPATH[variant]["fused" if fused else "unfused"]


def cg_vector_traffic(n: int, *, variant: str = "hs", fused: bool = True,
                      dtype_bytes: int = 8, nrhs: int = 1,
                      s: int | None = None) -> float:
    """Vector-op HBM bytes per CG iteration outside the SpMV. For the
    multi-RHS ``block_hs`` body the streams are in n*r units — pass
    ``nrhs``. For ``sstep`` pass ``s`` for the exact block size (the table
    row carries the s=2 accounting default)."""
    streams, _ = _streams(variant, fused, s)
    return float(streams) * n * dtype_bytes * max(int(nrhs), 1)


def cg_vector_sweeps(variant: str = "hs", *, fused: bool = True,
                     s: int | None = None) -> float:
    """Full-vector kernel passes per CG iteration outside the SpMV."""
    return _streams(variant, fused, s)[1]


def cg_vector_flops(n: int, *, variant: str = "hs", fused: bool = True,
                    nrhs: int = 1, s: int | None = None) -> float:
    """Vector-op FLOPs per CG iteration outside the SpMV: ~1 flop per
    streamed element (axpy: 2 flops / 3 streams, dot: 2 flops / 2 streams;
    these ops are all memory-bound). The block body's Gram/update products
    do ~2r flops per streamed element, but at the r <= 16 the solver
    targets they stay memory-bound, so the same per-stream pricing is kept
    (scaled by ``nrhs``)."""
    streams, _ = _streams(variant, fused, s)
    return float(streams) * n * max(int(nrhs), 1)


def cg_reduce_scalars(variant: str = "hs", nrhs: int = 1, s: int = 2) -> float:
    """Scalars carried by the variant's fused all-reduce(s) per iteration
    (hs: alpha pair + beta; fcg: one 3-term fusion; pipecg: the single
    Ghysels–Vanroose fusion; block_hs: two r x r Grams; sstep: the whole
    (2s² + s + 1)-scalar Gram payload amortized over its s iterations)."""
    if variant == "block_hs":
        r = max(int(nrhs), 1)
        return 2 * r * r
    if variant == "sstep":
        s = max(int(s), 1)
        return (2 * s * s + s + 1) / s
    return {"hs": 3, "fcg": 3, "pipecg": 3}[variant]


def spmv_traffic(n: int, k: int, *, matfree: bool = False,
                 dtype_bytes: int = 8, idx_bytes: int = 4,
                 nrhs: int = 1) -> float:
    """SpMV HBM bytes per application: ELL (values + local indices + vector
    r/w) or matrix-free stencil (read x + write y only). With ``nrhs`` > 1
    (the SpMM interior) the matrix term is paid ONCE while the vector r/w
    term scales with r."""
    r = max(int(nrhs), 1)
    if matfree:
        return float(n) * 2 * dtype_bytes * r
    return float(n) * (k * (dtype_bytes + idx_bytes) + 2 * dtype_bytes * r)


def cg_iteration_memory_s(
    n: int, k: int, *, variant: str = "hs", fused: bool = True,
    matfree: bool = False, dtype_bytes: int = 8,
    chip: ChipSpec = DEFAULT_CHIP,
) -> float:
    """Roofline memory term (seconds) for ONE CG iteration on one chip:
    one SpMV + the variant's vector-op traffic."""
    total = spmv_traffic(n, k, matfree=matfree, dtype_bytes=dtype_bytes)
    total += cg_vector_traffic(n, variant=variant, fused=fused,
                               dtype_bytes=dtype_bytes)
    return total / chip.hbm_bw
