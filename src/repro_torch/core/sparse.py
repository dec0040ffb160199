"""Single-shard sparse formats: host packing (numpy) and the matvec in PyTorch.

Port of ``repro.core.sparse``. The distributed matrix (``core/partition.py``)
splits every shard into an interior and a boundary block; the formats here
are the single-shard building blocks underneath. Device column indices are
``int32`` and padding entries carry ``data == 0`` and ``col == 0``, so every
gather stays in bounds and contributes nothing.

* ``CSR``  — data/col/row_ids triple; the matvec is a scatter-add over
  ``row_ids``.
* ``ELL``  — (n, k) padded rows; the matvec is a gather and a row sum.
* ``BCSR`` — dense (br, bc) tiles in the uniform blocks-per-row layout of
  the ``bcsr_spmv`` kernel (:func:`pack_bcsr`); the matvec runs the dispatch
  op ``bcsr_spmv``, so on the card it launches the hand-written kernel.
  (The JAX package's ``BCSR`` keeps a ragged form with ``brow_ids`` for its
  jnp path; the port has one BCSR layout, the kernel's.)

:func:`block_partition` and :func:`pack_bcsr` are the JAX package's host
functions, unchanged: they give its arrays byte for byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSR:
    """CSR stored as COO-with-sorted-rows (row_ids)."""

    data: torch.Tensor  # (nnz,)
    col: torch.Tensor  # (nnz,) int32, local indices
    row_ids: torch.Tensor  # (nnz,) int32, non-decreasing; padding rows use n_rows
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x, x of length n_cols. Padding row_ids == n_rows are
        dropped. (A float scatter-add: on the card the order of the adds
        into one row may vary from run to run.)"""
        contrib = self.data * x[self.col.long()]
        y = x.new_zeros(self.n_rows + 1).index_add_(0, self.row_ids.long(), contrib)
        return y[: self.n_rows]


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: fixed k slots per row. Padded slots: data=0, col=0."""

    data: torch.Tensor  # (n_rows, k)
    col: torch.Tensor  # (n_rows, k) int32
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.data.shape[0]

    @property
    def k(self) -> int:
        return self.data.shape[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return (self.data * x[self.col.long()]).sum(-1)


@dataclasses.dataclass(frozen=True)
class BCSR:
    """Block-CSR with dense (br, bc) tiles, every block-row padded to
    ``bpr`` tiles (padding tiles are zero with ``bcol == 0``)."""

    blocks: torch.Tensor  # (n_brows * bpr, br, bc)
    bcol: torch.Tensor  # (n_brows * bpr,) int32
    n_brows: int
    bpr: int
    n_bcols: int
    br: int
    bc: int

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x -> (n_brows * br,) for x of length <= n_bcols * bc
        (missing trailing entries read as zero)."""
        from repro_torch.kernels import dispatch as kd

        y = kd.ops_for(None).bcsr_spmv(
            self.blocks[None], self.bcol[None], x[None],
            n_brows=self.n_brows, bpr=self.bpr, n_out=self.n_brows * self.br,
        )
        return y[0]


# ---------------------------------------------------------------------------
# Host-side conversions (numpy; used at partition/setup time only).
# ---------------------------------------------------------------------------


def csr_from_scipy(a, pad_nnz_to: int | None = None, dtype=np.float32) -> CSR:
    """A CSR from a scipy.sparse CSR matrix (host). An insufficient
    capacity request raises; padding slots carry ``data == 0``,
    ``col == 0`` and ``row_ids == n_rows`` (dropped by the matvec)."""
    a = a.tocsr()
    n_rows, n_cols = a.shape
    nnz = a.nnz
    row_ids = np.repeat(np.arange(n_rows, dtype=np.int32), np.diff(a.indptr))
    data = a.data.astype(dtype)
    col = a.indices.astype(np.int32)
    if pad_nnz_to is not None:
        if pad_nnz_to < nnz:
            raise ValueError(
                f"pad_nnz_to={pad_nnz_to} below the matrix nnz={nnz}"
            )
        pad = pad_nnz_to - nnz
        data = np.concatenate([data, np.zeros(pad, dtype)])
        col = np.concatenate([col, np.zeros(pad, np.int32)])
        row_ids = np.concatenate([row_ids, np.full(pad, n_rows, np.int32)])
    return CSR(
        data=torch.from_numpy(data), col=torch.from_numpy(col),
        row_ids=torch.from_numpy(row_ids), n_rows=n_rows, n_cols=n_cols,
    )


def ell_from_scipy(a, k: int | None = None, dtype=np.float32, n_cols: int | None = None) -> ELL:
    """An ELL matrix (host), vectorised. ``k`` defaults to the longest
    row; a row longer than ``k`` raises. Empty rows and the tail of every
    short row carry ``data == 0``, ``col == 0``."""
    a = a.tocsr()
    n_rows, a_cols = a.shape
    n_cols = a_cols if n_cols is None else n_cols
    counts = np.diff(a.indptr)
    kmax = int(counts.max()) if n_rows else 0
    if k is None:
        k = kmax
    if kmax > k:
        raise ValueError(f"row with {kmax} nnz exceeds requested k={k}")
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), counts)
    slot = np.arange(a.nnz, dtype=np.int64) - a.indptr[rows]
    data = np.zeros((n_rows, k), dtype)
    col = np.zeros((n_rows, k), np.int32)
    data[rows, slot] = a.data
    col[rows, slot] = a.indices
    return ELL(data=torch.from_numpy(data), col=torch.from_numpy(col), n_cols=n_cols)


def block_partition(a, br: int, bc: int, dtype=np.float32):
    """Dense-block decomposition of a scipy matrix (host).

    Zero-pads the matrix up to block multiples and materializes every block
    containing a structural nonzero densely. Returns numpy arrays
    ``(blocks (nnzb, br, bc), bcol (nnzb,) int32, brow_ids (nnzb,) int32,
    n_brows, n_bcols)`` with ``brow_ids`` non-decreasing and block columns
    sorted within each block row.
    """
    import scipy.sparse as sp

    a = a.tocsr()
    n, m = a.shape
    n_brows = -(-n // br)
    n_bcols = -(-m // bc)
    ap = sp.csr_matrix((a.data, a.indices, a.indptr), shape=(n, m))
    ap.resize(max(n_brows, 1) * br, max(n_bcols, 1) * bc)
    coo = ap.tocoo()
    bi = (coo.row // br).astype(np.int64)
    bj = (coo.col // bc).astype(np.int64)
    keys = bi * max(n_bcols, 1) + bj
    uniq, inv = np.unique(keys, return_inverse=True)
    nnzb = len(uniq)
    blocks = np.zeros((nnzb, br, bc), dtype)
    blocks[inv, coo.row % br, coo.col % bc] = coo.data
    brow_ids = (uniq // max(n_bcols, 1)).astype(np.int32)
    bcol = (uniq % max(n_bcols, 1)).astype(np.int32)
    return blocks, bcol, brow_ids, n_brows, n_bcols


def pack_bcsr(a_csr, br: int, bc: int, dtype=np.float32):
    """Pack a scipy matrix into the kernel's uniform blocks-per-row layout.

    Returns ``(blocks (n_brows*bpr, br, bc), bcol (n_brows*bpr,), n_brows,
    bpr, n_bcols)``: every block-row padded to the max block count ``bpr``;
    padding blocks are all-zero with ``bcol == 0`` (in-bounds gathers that
    contribute nothing).
    """
    blocks_r, bcol_r, brow_ids, n_brows, n_bcols = block_partition(
        a_csr, br, bc, dtype
    )
    counts = np.bincount(brow_ids, minlength=max(n_brows, 1))
    bpr = max(int(counts.max()) if counts.size else 0, 1)
    blocks = np.zeros((max(n_brows, 1) * bpr, br, bc), dtype)
    bcol = np.zeros((max(n_brows, 1) * bpr,), np.int32)
    # brow_ids is sorted, so the slot of each block within its row is its
    # offset from the row's first block
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(brow_ids), dtype=np.int64) - starts[brow_ids]
    dst = brow_ids.astype(np.int64) * bpr + slot
    blocks[dst] = blocks_r
    bcol[dst] = bcol_r
    return blocks, bcol, max(n_brows, 1), bpr, n_bcols


def bcsr_from_scipy(a, br: int, bc: int, dtype=np.float32) -> BCSR:
    """A :class:`BCSR` in the kernel layout (host; :func:`pack_bcsr`)."""
    blocks, bcol, n_brows, bpr, n_bcols = pack_bcsr(a, br, bc, dtype)
    return BCSR(
        blocks=torch.from_numpy(blocks), bcol=torch.from_numpy(bcol),
        n_brows=n_brows, bpr=bpr, n_bcols=n_bcols, br=br, bc=bc,
    )
