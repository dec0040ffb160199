"""AMG hierarchy construction (host setup) -> stacked Preconditioner (port
of ``repro.core.amg.hierarchy``).

Setup follows the paper's configuration: per level, aggregates of up to 8
from 3 composed pairwise matchings (compatible weighting), decoupled
(per-shard) so prolongators stay shard-local; Galerkin RAP on the host;
l1-Jacobi smoother diagonals; a dense inverse at the coarsest level.

``weighting="plain"`` with the scan matcher builds the AmgX-analog
preconditioner: the same aggregate sizes, cycle and smoother, with
strength-only matching weights (the paper's BootCMatchGX-vs-AmgX PCG
comparison).

As in the JAX package the setup is host work (scipy), except the
locally-dominant matcher, which runs in torch on the setup's device. The
per-row loops of the JAX package (``weights_to_ell``, the P arrays, the
coarse dense layout) are vectorised here and give the same arrays, byte
for byte. Each level's matrix is the port's ``partition_csr`` on the
level's row partition, and every array of the hierarchy is stacked over
the shards on the solve's device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.amg.aggregation import decoupled_aggregate
from repro_torch.core.amg.galerkin import l1_diagonal, rap
from repro_torch.core.amg.vcycle import AMGLevel, vcycle
from repro_torch.core.cg import Preconditioner
from repro_torch.core.partition import (
    DistMat,
    RowPartition,
    balanced_partition,
    distmat_from_numpy,
    partition_csr,
)
from repro_torch.kernels import dispatch as kd
from repro_torch.launch.mesh import resolve_device


@dataclasses.dataclass(frozen=True)
class AMGParams:
    sweeps_per_level: int = 3  # 2^3 = size-8 aggregates (paper config)
    max_levels: int = 10
    coarse_size: int = 200  # stop when global size <= this
    n_smooth: int = 4  # paper: 4 l1-Jacobi sweeps
    omega: float = 1.0
    weighting: str = "compatible"  # "compatible" | "plain" (AmgX analog)
    matcher: str = "locdom"  # "locdom" | "scan" (AmgX analog)
    max_ring: int = 3


@dataclasses.dataclass(frozen=True)
class AMGInfo:
    """The hierarchy's shape, as the JAX package reports it; ``setup_s``
    (not compared) splits the setup's seconds into ``aggregation``,
    ``rap``, ``partition`` and ``transfer`` (P arrays, smoother diagonals,
    the coarse inverse)."""

    level_rows: tuple[int, ...]
    level_nnz: tuple[int, ...]
    coarse_rows: int
    setup_s: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def operator_complexity(self) -> float:
        return sum(self.level_nnz) / max(self.level_nnz[0], 1)

    @property
    def n_levels(self) -> int:
        return len(self.level_rows)


def _pad_per_shard(vec: np.ndarray, row_starts, R: int) -> np.ndarray:
    S = len(row_starts) - 1
    starts = np.asarray(row_starts, np.int64)
    out = np.zeros((S, R), vec.dtype)
    rows = np.arange(len(vec), dtype=np.int64)
    shard = np.searchsorted(starts[1:], rows, side="right")
    out[shard, rows - starts[shard]] = vec
    return out


def _build_p_arrays(p_csr, fine_starts, coarse_starts, Rf: int, Rc: int, dtype):
    """Per-shard P (1 nnz/row gather form) and P^T (ELL over coarse rows)."""
    S = len(fine_starts) - 1
    fs = np.asarray(fine_starts, np.int64)
    cs = np.asarray(coarse_starts, np.int64)
    p = p_csr.tocsr()
    pt = p_csr.T.tocsr()
    # max aggregate size across shards = ELL width of P^T
    W = max(int(np.diff(pt.indptr).max()) if pt.nnz else 1, 1)

    p_data = np.zeros((S, Rf), dtype)
    p_col = np.zeros((S, Rf), np.int32)
    pt_data = np.zeros((S, Rc, W), dtype)
    pt_col = np.zeros((S, Rc, W), np.int32)
    # P: each fine row's (one) entry
    rows = np.flatnonzero(np.diff(p.indptr) > 0)
    first = p.indptr[rows]
    s = np.searchsorted(fs[1:], rows, side="right")
    p_data[s, rows - fs[s]] = p.data[first]
    p_col[s, rows - fs[s]] = p.indices[first] - cs[s]
    # P^T: each coarse row's entries, in order
    counts = np.diff(pt.indptr)
    crow = np.repeat(np.arange(pt.shape[0], dtype=np.int64), counts)
    slot = np.arange(int(pt.indptr[-1])) - np.repeat(pt.indptr[:-1], counts)
    s = np.searchsorted(cs[1:], crow, side="right")
    pt_data[s, crow - cs[s], slot] = pt.data[: len(crow)]
    pt_col[s, crow - cs[s], slot] = pt.indices[: len(crow)] - fs[s]
    return p_data, p_col, pt_data, pt_col


def _dense_coarse(cur, row_starts, S: int) -> np.ndarray:
    """The coarsest matrix in the padded ``S * RcL`` layout (identity on the
    padding rows), ``RcL`` the most rows a shard owns there."""
    starts = np.asarray(row_starts, np.int64)
    RcL = max(int(np.diff(starts).max()), 1)
    rows = np.arange(cur.shape[0], dtype=np.int64)
    shard = np.searchsorted(starts[1:], rows, side="right")
    pos = shard * RcL + rows - starts[shard]
    dense = np.eye(S * RcL)
    dense[np.ix_(pos, pos)] = cur.toarray()
    return dense


def _make_preconditioner(levels, dense_inv, params: AMGParams, kernels) -> Preconditioner:
    n_smooth, omega = params.n_smooth, params.omega
    ops = kd.ops_for(kernels)

    def apply(pdata, r):
        lv, dinv_mat = pdata
        return vcycle(lv, dinv_mat, r, n_smooth=n_smooth, omega=omega, ops=ops)

    return Preconditioner(data=(tuple(levels), dense_inv), apply=apply)


def build_amg(
    a_csr,
    n_shards: int,
    params: AMGParams | None = None,
    *,
    partition: RowPartition | None = None,
    smooth_vec: np.ndarray | None = None,
    dtype=np.float64,
    kernels: str | None = None,
    device=None,
    level0: DistMat | None = None,
) -> tuple[Preconditioner, AMGInfo]:
    """Build the stacked AMG preconditioner for ``a_csr`` on ``device``
    (``cuda`` unless ``"cpu"`` is passed).

    ``kernels`` selects the dispatch backend the V-cycle's vector updates
    route through (None = follow the device). The apply is region-marked:
    its executed counts land in the "vcycle" energy region. ``level0`` is
    an ELL partition of ``a_csr`` that the finest level takes instead of
    building its own: it must be ``partition_csr(a_csr, n_shards,
    partition=..., max_ring=params.max_ring, dtype=dtype)`` on the same
    rows (a solver session's default matrix is); one with other rows,
    shards, format, halo depth or dtype raises ``ValueError``.
    """
    params = params or AMGParams()
    dev = resolve_device(device)
    on = lambda arr: torch.from_numpy(arr).to(dev)
    a = a_csr.tocsr().astype(np.float64)
    n = a.shape[0]
    part = partition or balanced_partition(n, n_shards)
    row_starts = part.row_starts
    if level0 is not None:
        want = (n, n_shards, tuple(int(r) for r in row_starts), "ell", 1,
                torch.from_numpy(np.zeros(0, dtype)).dtype)
        got = (level0.n_global, level0.n_shards, tuple(int(r) for r in level0.row_starts),
               level0.fmt, level0.halo_depth, level0.dtype)
        if got != want:
            raise ValueError(f"build_amg: level0 {got} is not the finest level {want}")
    secs = dict.fromkeys(("aggregation", "rap", "partition", "transfer"), 0.0)

    levels = []
    level_rows, level_nnz = [], []
    cur = a
    while (
        len(levels) < params.max_levels - 1
        and cur.shape[0] > max(params.coarse_size, 2 * n_shards)
    ):
        t0 = time.perf_counter()
        p_op, coarse_starts = decoupled_aggregate(
            cur,
            row_starts,
            sweeps=params.sweeps_per_level,
            weighting=params.weighting,
            matcher=params.matcher,
            smooth_vec=smooth_vec if len(levels) == 0 else None,
            device=dev,
        )
        t1 = time.perf_counter()
        secs["aggregation"] += t1 - t0
        if p_op.shape[1] >= cur.shape[0]:  # no coarsening progress
            break
        if level0 is not None and not levels:
            dist = level0.to(dev)
        else:
            dist = partition_csr(
                cur,
                n_shards,
                partition=RowPartition(cur.shape[0], row_starts),
                dtype=dtype,
                max_ring=params.max_ring,
                device=dev,
            )
        t2 = time.perf_counter()
        secs["partition"] += t2 - t1
        Rf = dist.n_own_pad
        Rc = max(
            coarse_starts[s + 1] - coarse_starts[s] for s in range(n_shards)
        )
        Rc = max(Rc, 1)
        pd, pc, ptd, ptc = _build_p_arrays(
            p_op, row_starts, coarse_starts, Rf, Rc, dtype
        )
        d = l1_diagonal(cur)
        dinv_g = np.where(d > 0, 1.0 / np.maximum(d, 1e-300), 0.0)
        levels.append(
            AMGLevel(
                mat=dist, p_data=on(pd), p_col=on(pc), pt_data=on(ptd), pt_col=on(ptc),
                dinv=on(_pad_per_shard(dinv_g.astype(dtype), row_starts, Rf)),
            )
        )
        level_rows.append(cur.shape[0])
        level_nnz.append(cur.nnz)
        t3 = time.perf_counter()
        secs["transfer"] += t3 - t2
        cur = rap(cur, p_op)
        secs["rap"] += time.perf_counter() - t3
        row_starts = coarse_starts

    # ---- coarsest level: replicated dense inverse in padded layout --------
    t0 = time.perf_counter()
    nL = cur.shape[0]
    dense_inv = on(np.linalg.inv(_dense_coarse(cur, row_starts, n_shards)).astype(dtype))
    level_rows.append(nL)
    level_nnz.append(cur.nnz)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs["transfer"] += time.perf_counter() - t0

    pre = _make_preconditioner(levels, dense_inv, params, kernels)
    info = AMGInfo(tuple(level_rows), tuple(level_nnz), nL, setup_s=secs)
    return pre, info


def amg_from_numpy(
    levels,
    dense_inv,
    params: AMGParams | None = None,
    *,
    kernels: str | None = None,
    device="cpu",
) -> Preconditioner:
    """The AMG preconditioner from another builder's arrays (numpy) — e.g.
    the leaves of the JAX package's hierarchy, carried across as they are,
    so that a solve can be checked apart from the setup. ``levels`` is a
    sequence of mappings with ``p_data``, ``p_col``, ``pt_data``, ``pt_col``,
    ``dinv`` (stacked ``(S, ...)`` arrays) and ``mat``, the keyword
    arguments of :func:`~repro_torch.core.partition.distmat_from_numpy`;
    ``dense_inv`` the coarsest level's ``(S*RcL, S*RcL)`` inverse.
    ``params`` gives the cycle's ``n_smooth`` and ``omega``."""
    dev = resolve_device(device)
    on = lambda arr: torch.from_numpy(np.array(arr)).to(dev)
    lv = [
        AMGLevel(
            mat=distmat_from_numpy(**lev["mat"], device=dev),
            p_data=on(lev["p_data"]), p_col=on(lev["p_col"]),
            pt_data=on(lev["pt_data"]), pt_col=on(lev["pt_col"]),
            dinv=on(lev["dinv"]),
        )
        for lev in levels
    ]
    return _make_preconditioner(lv, on(dense_inv), params or AMGParams(), kernels)


def make_amg_preconditioner(
    a_csr,
    n_shards: int,
    params: AMGParams | None = None,
    *,
    amgx_analog: bool = False,
    kernels: str | None = None,
    **kw,
) -> tuple[Preconditioner, AMGInfo]:
    """One-stop executed-AMG entry point for solvers and benchmarks.

    Builds the hierarchy (host setup, the matcher on the device) and
    returns a Preconditioner whose apply runs the real V-cycle through the
    kernel dispatch layer. ``amgx_analog=True`` selects the
    plain-strength/scan-order matching baseline (the paper's AmgX
    comparison). ``kw`` goes to :func:`build_amg` (``device``,
    ``partition``, ``smooth_vec``, ``dtype``).
    """
    params = params or AMGParams()
    if amgx_analog:
        params = dataclasses.replace(params, weighting="plain", matcher="scan")
    return build_amg(a_csr, n_shards, params, kernels=kernels, **kw)
