"""Synthetic analogs of the paper's SuiteSparse SPD test matrices (Table 1).

The SuiteSparse collection is not reachable offline, so we generate SPD
matrices matched on the characteristics the paper's analysis keys on: row
count, average nnz/row, and sparsity-pattern *character* (regular band vs
irregular / long-range couplings), which drives the communication behavior
the paper observes (e.g. G3_circuit scaling poorly, boneS10 scaling well).

Every generator takes ``scale`` (fraction of the original row count) so the
full-size patterns are describable while CPU-run benchmarks stay tractable.
If real MatrixMarket files are present under $REPRO_SUITESPARSE_DIR they are
loaded instead (``load_or_generate``).

The port's copy of ``repro.matrices.suitesparse``, numpy and scipy only and
unchanged, so ``generate`` gives the JAX package's CSR arrays byte for byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class MatrixInfo:
    name: str
    rows: int
    nnz: int
    avg_nnz_row: float
    character: str  # "irregular" | "band" | "grid"


# Paper Table 1.
TABLE1 = {
    "G3_circuit": MatrixInfo("G3_circuit", 1585478, 7660826, 4.8, "irregular"),
    "af_shell8": MatrixInfo("af_shell8", 504855, 17579155, 34.8, "band"),
    "boneS10": MatrixInfo("boneS10", 914898, 40878708, 44.7, "band"),
    "ecology2": MatrixInfo("ecology2", 999999, 4995991, 5.0, "grid"),
    "parabolic_fem": MatrixInfo("parabolic_fem", 525825, 3674625, 7.0, "grid"),
}


def _spd_from_pattern(rows, cols, vals, n, dtype):
    """Symmetrize and make strictly diagonally dominant (hence SPD)."""
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a = (a + a.T) * 0.5
    a.setdiag(0)
    a.eliminate_zeros()
    rowsum = np.abs(a).sum(axis=1).A.ravel()
    d = rowsum + 1.0  # strict dominance margin
    a = a + sp.diags(d)
    return a.tocsr().astype(dtype)


def _grid2d(nx: int, ny: int, k: int, rng, dtype):
    """2-D grid Laplacian-like SPD pattern with k-point stencil (5 or 7)."""
    n = nx * ny
    if k == 5:
        offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    elif k == 7:  # hex/triangular FEM-like
        offs = [(-1, 0), (1, 0), (0, -1), (0, 1), (1, 1), (-1, -1)]
    else:
        raise ValueError(k)
    yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    base = (yy * nx + xx).ravel()
    rows, cols, vals = [], [], []
    for dx, dy in offs:
        nxx, nyy = xx + dx, yy + dy
        valid = ((nxx >= 0) & (nxx < nx) & (nyy >= 0) & (nyy < ny)).ravel()
        rows.append(base[valid])
        cols.append((nyy * nx + nxx).ravel()[valid])
        vals.append(-rng.uniform(0.2, 1.8, int(valid.sum())))
    return _spd_from_pattern(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n, dtype
    )


def _banded(n: int, nnz_row: int, band: int, rng, dtype):
    """Regular banded SPD pattern: ~nnz_row fixed offsets within +-band."""
    half = (nnz_row - 1) // 2
    near = [o for o in range(1, min(half, band) + 1)]
    far_needed = half - len(near)
    far = list(np.unique(rng.integers(2, band + 1, size=max(far_needed * 2, 1))))[:far_needed]
    offsets = sorted(set(near + far))
    rows, cols, vals = [], [], []
    base = np.arange(n, dtype=np.int64)
    for o in offsets:
        valid = base + o < n
        rows.append(base[valid])
        cols.append(base[valid] + o)
        vals.append(-rng.uniform(0.2, 1.8, int(valid.sum())))
    return _spd_from_pattern(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n, dtype
    )


def _irregular(n: int, nnz_row: float, rng, dtype):
    """Circuit-like irregular pattern: mostly local + a tail of long edges."""
    m_local = int(n * (nnz_row - 1) * 0.40)  # off-diag halves
    m_far = int(n * (nnz_row - 1) * 0.10)
    r_loc = rng.integers(0, n - 1, m_local)
    c_loc = np.minimum(n - 1, r_loc + rng.integers(1, 16, m_local))
    r_far = rng.integers(0, n, m_far)
    c_far = rng.integers(0, n, m_far)
    keep = r_far != c_far
    rows = np.concatenate([r_loc, r_far[keep]])
    cols = np.concatenate([c_loc, c_far[keep]])
    vals = -rng.uniform(0.2, 1.8, len(rows))
    return _spd_from_pattern(rows, cols, vals, n, dtype)


def _powerlaw(n: int, rng, dtype):
    """Power-law (hub-dominated) SPD pattern: most rows carry a handful of
    near-diagonal couplings, a Zipf-tail of hub rows reaches a large
    neighborhood — the ``max_row_nnz >> median`` regime where one long row
    inflates the padded-ELL layout on every shard (the HYB format's target
    workload; see docs/formats.md)."""
    # base band: 2 off-diagonal couplings per row
    base = np.arange(n - 1, dtype=np.int64)
    rows = [base]
    cols = [base + 1]
    # Zipf-distributed extra degree, capped so hubs stay local-ish
    extra = np.minimum(rng.zipf(1.5, n), max(n // 4, 4)).astype(np.int64)
    hubs = np.nonzero(extra > 2)[0]
    for h in hubs:
        m = int(extra[h])
        tgt = rng.integers(0, n, m)
        tgt = tgt[tgt != h]
        rows.append(np.full(len(tgt), h, np.int64))
        cols.append(tgt)
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    vals = -rng.uniform(0.2, 1.8, len(r))
    return _spd_from_pattern(r, c, vals, n, dtype)


# Beyond-Table-1 synthetic: the format sweep's power-law stress pattern.
POWERLAW = MatrixInfo("powerlaw", 20000, 140000, 7.0, "powerlaw")


def generate(name: str, scale: float = 1.0, dtype=np.float64, seed: int = 0):
    """Generate the synthetic analog of a Table-1 matrix (or the
    ``powerlaw`` stress pattern) at ``scale``."""
    if name == "powerlaw":
        rng = np.random.default_rng(seed)
        return _powerlaw(max(64, int(POWERLAW.rows * scale)), rng, dtype)
    info = TABLE1[name]
    rng = np.random.default_rng(seed)
    n = max(64, int(info.rows * scale))
    if name == "ecology2":  # genuinely a 2-D 5-pt grid Laplacian
        side = max(8, int(np.sqrt(n)))
        return _grid2d(side, side, 5, rng, dtype)
    if name == "parabolic_fem":  # 2-D FEM, 7 nnz/row
        side = max(8, int(np.sqrt(n)))
        return _grid2d(side, side, 7, rng, dtype)
    if name == "G3_circuit":
        return _irregular(n, info.avg_nnz_row, rng, dtype)
    if name == "af_shell8":
        return _banded(n, int(round(info.avg_nnz_row)), max(16, int(np.sqrt(n))), rng, dtype)
    if name == "boneS10":
        return _banded(n, int(round(info.avg_nnz_row)), max(24, int(np.sqrt(n))), rng, dtype)
    raise KeyError(name)


def load_or_generate(name: str, scale: float = 1.0, dtype=np.float64):
    """Prefer a real MatrixMarket file if $REPRO_SUITESPARSE_DIR provides it."""
    import os

    d = os.environ.get("REPRO_SUITESPARSE_DIR")
    if d:
        path = os.path.join(d, f"{name}.mtx")
        if os.path.exists(path):
            from scipy.io import mmread

            return sp.csr_matrix(mmread(path)).astype(dtype)
    return generate(name, scale=scale, dtype=dtype)
