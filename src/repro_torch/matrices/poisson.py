"""3-D Poisson benchmark matrices (7-point and 27-point stencils).

These mirror the paper's benchmark problems: the 3-D Poisson equation with
homogeneous Dirichlet boundary conditions on a uniform mesh, discretized with
a 7-point stencil (classical FD Laplacian: diag 6, neighbors -1) or the
HPCG-style 27-point stencil (diag 26, all 26 neighbors -1).

Two build paths:

* ``poisson_scipy`` — global scipy CSR, host-side, for small problems / AMG
  setup / oracles.
* ``local_stencil_ell`` — builds ONLY the rows owned by one shard of a slab
  (z-plane) partition, directly in numpy, vectorized, never materializing the
  global matrix. This is what makes O(1e10)-DOF weak-scaling configurations
  describable: per-shard cost is O(n_local * k). Column indices are local
  int32 offsets into ``x_ext = [halo_lo | x_own | halo_hi]`` with halo width
  H = nx*ny (one plane each side — both stencils reach exactly +-1 plane).
"""

from __future__ import annotations

import dataclasses

import numpy as np

STENCILS = ("7pt", "27pt")


def stencil_offsets(stencil: str) -> np.ndarray:
    """(k, 3) integer offsets, diagonal entry first."""
    if stencil == "7pt":
        offs = [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)]
    elif stencil == "27pt":
        offs = [(0, 0, 0)] + [
            (dx, dy, dz)
            for dz in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if (dx, dy, dz) != (0, 0, 0)
        ]
    else:
        raise ValueError(f"unknown stencil {stencil!r}")
    return np.asarray(offs, dtype=np.int64)


def stencil_diag(stencil: str) -> float:
    return 6.0 if stencil == "7pt" else 26.0


def stencil_values(p) -> np.ndarray:
    """Per-offset stencil coefficients, diagonal first (matches
    ``stencil_offsets`` ordering). Honors 7-point anisotropy."""
    offs = stencil_offsets(p.stencil)
    if p.stencil == "7pt":
        ax, ay, az = p.aniso
        per_axis = np.array([ax, ay, az])
        vals = np.empty(len(offs))
        vals[0] = 2.0 * (ax + ay + az)
        for i, off in enumerate(offs[1:], start=1):
            axis = int(np.nonzero(off)[0][0])
            vals[i] = -per_axis[axis]
        return vals
    # 27pt: HPCG-style uniform stencil (diag 26, neighbors -1).
    vals = np.full(len(offs), -1.0)
    vals[0] = 26.0
    return vals


@dataclasses.dataclass(frozen=True)
class PoissonProblem:
    """Global problem description (no data).

    ``aniso`` = per-axis diffusion coefficients (ax, ay, az); only meaningful
    for the 7-point stencil (27-point is the HPCG-style uniform stencil).
    Anisotropy differentiates the compatible-weighted matching from plain
    strength matching (the AmgX-analog comparison).
    """

    nx: int
    ny: int
    nz: int
    stencil: str  # "7pt" | "27pt"
    aniso: tuple[float, float, float] = (1.0, 1.0, 1.0)

    @property
    def n(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def k(self) -> int:
        return 7 if self.stencil == "7pt" else 27

    @property
    def plane(self) -> int:
        return self.nx * self.ny

    @property
    def nnz_estimate(self) -> int:
        # interior rows have k entries; boundary fewer. Upper bound:
        return self.n * self.k


def cube(n_side: int, stencil: str = "7pt") -> PoissonProblem:
    return PoissonProblem(n_side, n_side, n_side, stencil)


def weak_scaled(base: PoissonProblem, n_shards: int) -> PoissonProblem:
    """Weak scaling: extrude the domain along z (paper: local size constant)."""
    return dataclasses.replace(base, nz=base.nz * n_shards)


def _slab_rows(p: PoissonProblem, shard: int, n_shards: int) -> tuple[int, int]:
    """Contiguous z-plane range owned by ``shard`` (balanced; nz >= n_shards)."""
    if p.nz < n_shards:
        raise ValueError(f"cannot slab-partition nz={p.nz} over {n_shards} shards")
    zs = np.linspace(0, p.nz, n_shards + 1).astype(np.int64)
    return int(zs[shard]), int(zs[shard + 1])


def local_stencil_ell(
    p: PoissonProblem,
    shard: int,
    n_shards: int,
    dtype=np.float64,
    uniform_rows: int | None = None,
):
    """Build the local ELL block for one shard of a z-slab partition.

    Returns (data, col, meta) with
      data: (n_rows_padded, k) float
      col : (n_rows_padded, k) int32 — indices into x_ext of length
            H + n_own + H, H = nx*ny.  Padded slots: data=0, col=0.
      meta: dict(z0, z1, n_own, halo=H)

    ``uniform_rows`` pads the row count so every shard has identical shapes
    (required to stack shard blocks into one sharded global array).
    """
    z0, z1 = _slab_rows(p, shard, n_shards)
    n_own = (z1 - z0) * p.plane
    H = p.plane
    offs = stencil_offsets(p.stencil)
    k = len(offs)

    # Global coordinates of owned DOFs, lexicographic x-fastest.
    zz, yy, xx = np.meshgrid(
        np.arange(z0, z1), np.arange(p.ny), np.arange(p.nx), indexing="ij"
    )
    coords = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)  # (n_own, 3)

    nbr = coords[:, None, :] + offs[None, :, :]  # (n_own, k, 3)
    valid = (
        (nbr[..., 0] >= 0)
        & (nbr[..., 0] < p.nx)
        & (nbr[..., 1] >= 0)
        & (nbr[..., 1] < p.ny)
        & (nbr[..., 2] >= 0)
        & (nbr[..., 2] < p.nz)
    )
    gcol = nbr[..., 0] + p.nx * (nbr[..., 1] + p.ny * nbr[..., 2])
    r0 = z0 * p.plane
    lcol = gcol - r0 + H  # into x_ext
    lcol = np.where(valid, lcol, 0).astype(np.int32)

    diag = stencil_diag(p.stencil)
    vals = np.where((offs == 0).all(axis=1)[None, :], diag, -1.0)
    data = (np.broadcast_to(vals, (n_own, k)) * valid).astype(dtype)

    if uniform_rows is not None and uniform_rows > n_own:
        pad = uniform_rows - n_own
        data = np.concatenate([data, np.zeros((pad, k), dtype)])
        lcol = np.concatenate([lcol, np.zeros((pad, k), np.int32)])
    meta = dict(z0=z0, z1=z1, n_own=n_own, halo=H)
    return data, lcol, meta


def poisson_scipy(p: PoissonProblem, dtype=np.float64):
    """Global scipy CSR (host; small problems only)."""
    import scipy.sparse as sp

    n = p.n
    offs = stencil_offsets(p.stencil)
    zz, yy, xx = np.meshgrid(
        np.arange(p.nz), np.arange(p.ny), np.arange(p.nx), indexing="ij"
    )
    coords = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)
    rows, cols, vals = [], [], []
    svals = stencil_values(p)
    base = np.arange(n, dtype=np.int64)
    for oi, off in enumerate(offs):
        nbr = coords + off[None, :]
        valid = (
            (nbr[:, 0] >= 0)
            & (nbr[:, 0] < p.nx)
            & (nbr[:, 1] >= 0)
            & (nbr[:, 1] < p.ny)
            & (nbr[:, 2] >= 0)
            & (nbr[:, 2] < p.nz)
        )
        gcol = nbr[:, 0] + p.nx * (nbr[:, 1] + p.ny * nbr[:, 2])
        rows.append(base[valid])
        cols.append(gcol[valid])
        vals.append(np.full(valid.sum(), svals[oi], dtype))
    a = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)
    )
    return a.tocsr()


def default_rhs(n: int, dtype=np.float64, kind: str = "ones") -> np.ndarray:
    if kind == "ones":
        return np.ones(n, dtype)
    if kind == "rand":
        return np.random.default_rng(0).standard_normal(n).astype(dtype)
    raise ValueError(kind)
