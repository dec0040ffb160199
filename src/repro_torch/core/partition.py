"""Block-row partitioning + halo-exchange planning (host side, numpy).

Port of ``repro.core.partition``:

* matrices are distributed in **blocks of contiguous rows** across shards,
  with 4-byte local column indices;
* every shard's rows are split into an **interior block** (entries whose
  column the shard owns) and a compact **boundary block** holding only the
  ghost-touching rows' external entries, so the SpMV can run the interior
  while the halo is exchanged and scatter-add the boundary block after;
* the interior is stored as ELL, HYB (ELL prefix + COO tail) or BCSR
  (dense tiles), or as the one of them the stored-bytes cost model picks
  (``fmt="auto"``, ``roofline/format_model.py``);
* the halo exchange is planned as ring shifts (every off-shard coupling
  reaches at most ``max_ring`` shards away) or falls back to an all-gather
  of the whole vector ("allgather" mode, also the Ginkgo-analog layout);
* on a 2-D ``R x C`` process grid (``grid=``, :class:`GridPlan`) the
  shifts become per-dimension ``(di, dj)`` deltas; paired with the pencil
  row order of :func:`pencil_partition`, a shard's halo scales with its
  pencil's surface instead of a slab's cross-section;
* ``halo_depth=k`` widens the halo to the depth-k closure of the boundary
  coupling and replicates the rows of the depth ``< k`` ghosts (the
  ghost-row block), so ONE exchange feeds k chained SpMVs — the s-step
  CG's matrix-powers basis (``core/spmv.matrix_powers``).

The builder here is **vectorised**: every step is a numpy array operation
over all rows and entries at once, with no per-row Python loop, and it
produces the same arrays, byte for byte, as the JAX package's builder
(which walks the rows one by one and so takes minutes at the sizes the
port runs on the card).

Shards are stacked on one device: every array carries a leading ``S`` axis
and the solver bodies run over all shards at once (core/spmv.py).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Row partition
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Contiguous block-row partition of ``n_global`` rows over ``n_shards``."""

    n_global: int
    row_starts: tuple[int, ...]  # length n_shards + 1, row_starts[-1] == n_global

    @property
    def n_shards(self) -> int:
        return len(self.row_starts) - 1

    def owner_range(self, shard: int) -> tuple[int, int]:
        return self.row_starts[shard], self.row_starts[shard + 1]

    def n_own(self, shard: int) -> int:
        lo, hi = self.owner_range(shard)
        return hi - lo

    @property
    def max_own(self) -> int:
        return max(self.n_own(s) for s in range(self.n_shards))

    def owner_of(self, gcol: np.ndarray) -> np.ndarray:
        """Shard owning each global column (vectorized)."""
        starts = np.asarray(self.row_starts[1:], dtype=np.int64)
        return np.searchsorted(starts, gcol, side="right").astype(np.int64)


def balanced_partition(n_global: int, n_shards: int) -> RowPartition:
    starts = np.linspace(0, n_global, n_shards + 1).astype(np.int64)
    return RowPartition(n_global, tuple(int(s) for s in starts))


def plane_partition(n_global: int, plane: int, n_shards: int) -> RowPartition:
    """Partition along whole z-planes of size ``plane`` (stencil slabs)."""
    nz = n_global // plane
    if nz * plane != n_global:
        raise ValueError(f"n_global={n_global} must be a multiple of plane={plane}")
    if nz < n_shards:
        raise ValueError(f"cannot slab-partition nz={nz} over {n_shards} shards")
    zs = np.linspace(0, nz, n_shards + 1).astype(np.int64)
    return RowPartition(n_global, tuple(int(z) * plane for z in zs))


def default_grid(n_shards: int) -> tuple[int, int]:
    """Most-square ``(rows, cols)`` factorization with ``rows <= cols``.

    4 -> (2, 2), 8 -> (2, 4), 16 -> (4, 4), 32 -> (4, 8). Primes (and
    shard counts below 4) have no nontrivial factorization and map to
    ``(1, n_shards)`` — the 1-D layout.
    """
    n_shards = int(n_shards)
    r = max(int(np.sqrt(n_shards)), 1)
    while r > 1 and n_shards % r:
        r -= 1
    return (r, n_shards // r)


def pencil_partition(p, grid: tuple[int, int]) -> tuple[np.ndarray, RowPartition]:
    """Pencil (z-block x y-block) row ordering for an ``R x C`` process grid.

    Returns ``(perm, part)``: ``perm[new] = old`` is the symmetric row
    permutation that makes the flat shard ``s = i*C + j`` own the pencil
    ``z_blocks[i] x y_blocks[j] x [0, nx)`` as one contiguous row block, and
    ``part`` is the matching :class:`RowPartition`. Solving the permuted
    system ``A[perm][:, perm] x' = b[perm]`` with ``partition_csr(...,
    grid=grid, partition=part)`` gives per-dimension halos that scale with
    the pencil *surface* (``O(N^2 / sqrt(S))`` per shard), not the slab
    cross-section (``O(N^2)``).

    ``p`` only needs ``nx``/``ny``/``nz`` (``PoissonProblem`` qualifies).
    A grid larger than an axis leaves shards empty, which the partitioner
    handles. Each pencil's ids come from one broadcast, in z, y, x order;
    the pencils follow the flat shard order, as in the JAX package.
    """
    gr, gc = int(grid[0]), int(grid[1])
    z_blocks = np.array_split(np.arange(p.nz, dtype=np.int64), gr)
    y_blocks = np.array_split(np.arange(p.ny, dtype=np.int64), gc)
    xs = np.arange(p.nx, dtype=np.int64)
    parts = [
        ((zb[:, None] * p.ny + yb[None, :])[:, :, None] * p.nx + xs).reshape(-1)
        for zb in z_blocks for yb in y_blocks
    ]
    starts = np.cumsum([0] + [len(ids) for ids in parts])
    return np.concatenate(parts), RowPartition(p.nx * p.ny * p.nz,
                                               tuple(int(v) for v in starts))


# ---------------------------------------------------------------------------
# Halo plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static description of a halo exchange.

    mode == "ring":
        ``shifts[k]`` means every shard i *receives* a buffer of width
        ``widths[k]`` from shard ``i + shifts[k]`` (edge shards receive
        zeros). The receive buffers are concatenated after ``x_own`` in
        shift order, forming ``x_ext = [x_own | buf_0 | buf_1 | ...]``.
    mode == "allgather":
        ``x_ext`` is the full (padded) global vector; widths/shifts are
        empty.
    """

    mode: str  # "ring" | "allgather"
    shifts: tuple[int, ...]
    widths: tuple[int, ...]
    n_own_pad: int  # uniform padded rows per shard
    n_shards: int

    @property
    def ext_len(self) -> int:
        if self.mode == "allgather":
            return self.n_own_pad * self.n_shards
        return self.n_own_pad + sum(self.widths)

    def buf_offset(self, k: int) -> int:
        """Offset of receive buffer ``k`` inside x_ext (ring mode)."""
        return self.n_own_pad + sum(self.widths[:k])

    def collective_bytes_per_shard(self, itemsize: int = 8) -> int:
        """Bytes each shard sends per exchange (roofline collective term)."""
        if self.mode == "allgather":
            return self.n_own_pad * (self.n_shards - 1) * itemsize
        return sum(self.widths) * itemsize


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Static halo-exchange description for a 2-D ``R x C`` process grid.

    Flat shard ``s = i * C + j`` sits at grid position ``(i, j)``. Rows
    stay block-contiguous over the flat shard order (so the padded vector
    layout is the 1-D one); what changes is the neighbour structure:
    ``shifts[k] = (di, dj)`` means shard ``(i, j)`` *receives* a buffer of
    width ``widths[k]`` from shard ``(i + di, j + dj)``, zeros when either
    index leaves the grid. Receive buffers concatenate after ``x_own`` in
    shift order, as in :class:`HaloPlan` ring mode.

    On a cluster each shift runs per dimension: a pure-column shift
    ``(0, dj)`` is one point-to-point launch along the grid row, a pure-row
    shift ``(di, 0)`` one along the grid column, and a corner shift chains
    the two (the column hop first, then the row hop forwards the buffer):
    ``hops(k)`` launches, each moving the buffer over one link. On one
    card every shift is an index along the stacked shard axis; the counts
    recorded are those of the cluster.
    """

    mode: str  # always "grid"
    grid: tuple[int, int]  # (rows, cols) of the process grid
    shifts: tuple[tuple[int, int], ...]  # (di, dj) receive-from deltas
    widths: tuple[int, ...]
    n_own_pad: int  # uniform padded rows per shard
    n_shards: int

    @property
    def ext_len(self) -> int:
        return self.n_own_pad + sum(self.widths)

    def buf_offset(self, k: int) -> int:
        """Offset of receive buffer ``k`` inside x_ext."""
        return self.n_own_pad + sum(self.widths[:k])

    def hops(self, k: int) -> int:
        """Interconnect hops of shift ``k`` (1 pure-axis, 2 corner)."""
        di, dj = self.shifts[k]
        return int(di != 0) + int(dj != 0)

    def perm_rows(self, k: int) -> tuple[tuple[int, int], ...]:
        """(src, dst) grid-row pairs of shift k's row hop."""
        di = self.shifts[k][0]
        gr = self.grid[0]
        return tuple((i, i - di) for i in range(gr) if 0 <= i - di < gr)

    def perm_cols(self, k: int) -> tuple[tuple[int, int], ...]:
        """(src, dst) grid-column pairs of shift k's column hop."""
        dj = self.shifts[k][1]
        gc = self.grid[1]
        return tuple((j, j - dj) for j in range(gc) if 0 <= j - dj < gc)

    @property
    def n_launches(self) -> int:
        """Point-to-point launches per exchange (corners count twice)."""
        return sum(self.hops(k) for k in range(len(self.shifts)))

    def dim_bytes_per_shard(self, itemsize: int = 8) -> tuple[int, int]:
        """(rows_bytes, cols_bytes) each shard moves per exchange. A corner
        buffer crosses both dimensions and counts in both entries; the two
        sum to :meth:`collective_bytes_per_shard`."""
        rows_b = sum(w * itemsize for (di, _), w in zip(self.shifts, self.widths) if di)
        cols_b = sum(w * itemsize for (_, dj), w in zip(self.shifts, self.widths) if dj)
        return rows_b, cols_b

    def collective_bytes_per_shard(self, itemsize: int = 8) -> int:
        """Bytes each shard moves per exchange (hop-weighted: a corner
        buffer crosses two links)."""
        return sum(self.hops(k) * w * itemsize for k, w in enumerate(self.widths))


# ---------------------------------------------------------------------------
# Interior storage blocks (format-polymorphic) + the distributed matrix
# ---------------------------------------------------------------------------


def _size(a) -> int:
    return int(np.prod(tuple(a.shape), dtype=np.int64))


FORMATS = ("ell", "hyb", "bcsr")


def _flat_col(col: torch.Tensor) -> torch.Tensor:
    """(S*R*k,) int32 ids of an (S, R, k) ELL column array into the
    flattened (S*R,) stacked x_own."""
    S, R, _ = col.shape
    offs = torch.arange(S, dtype=torch.int32, device=col.device) * R
    return (col + offs[:, None, None]).reshape(-1)


class _Block:
    """What every interior block shares: the tensors it holds
    (``_TENSORS``, the first one carrying the values), their dtype and
    device, and a copy of the block on another device."""

    _TENSORS: tuple = ()

    @property
    def dtype(self) -> torch.dtype:
        return getattr(self, self._TENSORS[0]).dtype

    @property
    def device(self) -> torch.device:
        return getattr(self, self._TENSORS[0]).device

    def to(self, device):
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self._TENSORS}
        )


class _EllColumns:
    """Gather indices derived once from an (S, R, k) ``col`` array."""

    @functools.cached_property
    def flat_col(self) -> torch.Tensor:
        """(S*R*k,) int32 ids into the flattened (S*R,) stacked x_own."""
        return _flat_col(self.col)

    @functools.cached_property
    def slot_col(self) -> torch.Tensor:
        """(k, S*R) int32: :attr:`flat_col` slot-major, so the SpMM gathers
        one slot's rows with a contiguous index."""
        S, R, k = self.col.shape
        return self.flat_col.view(S * R, k).t().contiguous()


@dataclasses.dataclass(frozen=True)
class ELLBlock(_Block, _EllColumns):
    """Padded-ELL interior: (S, R, k) slots/row, padding data == 0, col == 0.

    Every row gets ``k = max_row_nnz`` slots, so one long row inflates the
    storage of every row on every shard — the blowup HYB exists to avoid.
    """

    data: torch.Tensor  # (S, R, k)
    col: torch.Tensor  # (S, R, k) int32, indexes x_own

    fmt = "ell"
    _TENSORS = ("data", "col")

    @property
    def slots(self) -> int:
        """Stored value slots, padding included."""
        return _size(self.data)

    @property
    def index_bytes(self) -> int:
        return _size(self.col) * 4

    @property
    def k(self) -> int:
        return self.data.shape[-1]


#: Partial sums added per step of the HYB tail reduction (:class:`TailPlan`).
TAIL_FAN_IN = 8


@dataclasses.dataclass(frozen=True)
class TailPlan:
    """How the HYB tail's products reach their rows with no float atomics.

    The tail's products form a flat ``(S*T,)`` vector (``(S*T, r)`` for a
    column block). Each entry of ``levels`` is a ``(V, TAIL_FAN_IN)`` gather
    index into the previous level's values, with index ``len(previous)``
    standing for an appended zero: row ``v`` of it sums up to
    ``TAIL_FAN_IN`` consecutive partial sums of ONE matrix row, in order.
    After the last level every matrix row with a tail holds one sum;
    ``src`` picks those sums and ``rows`` (each row once) are their flat
    ``(S*R,)`` destinations. A fixed tree of sums, then one add per
    destination: the same bits on every run.
    """

    levels: tuple
    src: torch.Tensor
    rows: torch.Tensor


def _tail_plan(tail_row: torch.Tensor, n_tail, R: int) -> TailPlan:
    """The :class:`TailPlan` of an (S, T) ``tail_row`` whose first
    ``n_tail[s]`` slots per shard are genuine (every slot when ``n_tail`` is
    empty: padding slots add exact zeros to row 0)."""
    tr = tail_row.detach().cpu().numpy().astype(np.int64)
    S, T = tr.shape
    counts = np.asarray(n_tail if len(n_tail) == S else [T] * S, np.int64)
    genuine = np.arange(T)[None, :] < counts[:, None]
    pos = np.flatnonzero(genuine.reshape(-1))
    rows = (np.arange(S, dtype=np.int64)[:, None] * R + tr).reshape(-1)[pos]
    order = np.argsort(rows, kind="stable")
    pos, rows = pos[order], rows[order]
    levels = []
    n_prev = S * T
    while len(rows):
        rank = _rank_in_groups(rows)
        if not rank.max():
            break
        chunk = rank // TAIL_FAN_IN
        new = np.r_[True, (rows[1:] != rows[:-1]) | (chunk[1:] != chunk[:-1])]
        gid = np.cumsum(new) - 1
        idx = np.full((int(gid[-1]) + 1, TAIL_FAN_IN), n_prev, np.int64)
        idx[gid, rank % TAIL_FAN_IN] = pos
        levels.append(idx)
        n_prev = idx.shape[0]
        pos = np.arange(n_prev, dtype=np.int64)
        rows = rows[new]
    dev = tail_row.device
    t = lambda a: torch.from_numpy(a).to(dev)
    return TailPlan(tuple(t(i) for i in levels), t(pos), t(rows))


@dataclasses.dataclass(frozen=True)
class HYBBlock(_Block, _EllColumns):
    """Hybrid interior: dense ELL prefix + COO tail for the long rows.

    The first ``k_typ`` entries of every row live in the (S, R, k_typ) ELL
    part; the overflow of the rows longer than ``k_typ`` lives in an (S, T)
    COO tail, in row order, added to its rows after the prefix product.
    ``k_typ`` is chosen by the stored-bytes cost model
    (``roofline/format_model.hyb_split``). Padding: data == 0, col == 0,
    tail_row == 0 (exact-zero adds); ``n_tail`` counts the genuine tail
    entries per shard (host metadata).
    """

    data: torch.Tensor  # (S, R, k_typ)
    col: torch.Tensor  # (S, R, k_typ) int32
    tail_data: torch.Tensor  # (S, T)
    tail_col: torch.Tensor  # (S, T) int32, indexes x_own
    tail_row: torch.Tensor  # (S, T) int32, local destination row
    n_tail: tuple[int, ...] = ()

    fmt = "hyb"
    _TENSORS = ("data", "col", "tail_data", "tail_col", "tail_row")

    @property
    def slots(self) -> int:
        return _size(self.data) + _size(self.tail_data)

    @property
    def index_bytes(self) -> int:
        # ELL part: one col id per slot; tail: col + destination row.
        return _size(self.col) * 4 + _size(self.tail_data) * 8

    @property
    def k_typ(self) -> int:
        return self.data.shape[-1]

    @functools.cached_property
    def flat_tail_col(self) -> torch.Tensor:
        """(S*T,) int32 ids of the tail's columns into the flattened
        (S*R,) stacked x_own."""
        S, T = self.tail_col.shape
        R = self.data.shape[1]
        offs = torch.arange(S, dtype=torch.int32, device=self.device) * R
        return (self.tail_col + offs[:, None]).reshape(-1)

    @functools.cached_property
    def tail_plan(self) -> TailPlan:
        return _tail_plan(self.tail_row, self.n_tail, self.data.shape[1])


@dataclasses.dataclass(frozen=True)
class BCSRBlock(_Block):
    """Blocked interior: dense (br, bc) tiles in the uniform
    blocks-per-row layout of the ``bcsr_spmv`` kernel
    (``core.sparse.pack_bcsr``): block-row ``i`` of shard ``s`` owns tiles
    ``[i*bpr, (i+1)*bpr)``; padding tiles are zero with ``bcol == 0``.

    One block-column id per *tile* instead of per entry — the index-traffic
    win on banded/FEM matrices — at the price of storing the zero fill of
    partly populated tiles. The SpMV runs the dispatch op ``bcsr_spmv``
    (``kernels/dispatch.py``): the hand-written kernel on the card.
    """

    blocks: torch.Tensor  # (S, n_brows * bpr, br, bc)
    bcol: torch.Tensor  # (S, n_brows * bpr) int32, block-column ids
    n_brows: int
    bpr: int
    br: int
    bc: int

    fmt = "bcsr"
    _TENSORS = ("blocks", "bcol")

    @property
    def slots(self) -> int:
        return _size(self.blocks)

    @property
    def index_bytes(self) -> int:
        return _size(self.bcol) * 4


InteriorBlock = ELLBlock | HYBBlock | BCSRBlock


@dataclasses.dataclass(frozen=True)
class DistMat:
    """Block-row-distributed sparse matrix: format-polymorphic interior +
    compact boundary block, stacked over shards on one device.

    * ``interior``          — the entries whose column the shard owns,
      indexing ``x_own`` (R = n_own_pad), stored as one of
      :class:`ELLBlock` / :class:`HYBBlock` / :class:`BCSRBlock` — chosen
      by the ``fmt`` argument of :func:`partition_csr`, or by the
      stored-bytes cost model under ``fmt="auto"``
      (``roofline/format_model.py``).
    * ``data_ext/col_ext``  — (S, B, k_ext): the boundary block, the
      external entries of the ghost-touching rows only; ``col_ext`` indexes
      the shard's ``x_ext`` (see :class:`HaloPlan`). Row ``j`` belongs to
      local row ``bnd_rows[:, j]``. Always ELL.
    * ``bnd_rows``          — (S, B) int32; slots past ``n_bnd[s]`` are
      padding (row 0, zero data — a scatter-add of exact zeros).
    * ``send_sel``          — (S, sum(widths)) int32: per shift k, the slice
      ``send_sel[:, off_k : off_k + widths[k]]`` lists the local indices each
      shard sends for that shift.
    * ``ghost_data/ghost_col/ghost_pos`` — the ghost-row block of a deep-halo
      partition (``halo_depth > 1``): the rows of the depth ``< halo_depth``
      ghost columns, replicated onto the shard as (S, G, kg) padded-ELL rows
      whose column ids index ``x_ext``; ``ghost_pos`` (S, G) is each ghost
      row's own position in ``x_ext``, where
      ``core/spmv.matrix_powers`` writes its recomputed value. Padding rows
      carry ``ghost_pos == ext_len`` (dropped). ``partition_csr`` builds
      0-sized arrays at depth 1; None (a carried partition without them)
      means the same.
    * ``halo_depth``        — ghost-zone depth k: one widened exchange
      delivers the closure of the boundary coupling to depth k, enough for
      k chained SpMVs.

    Padding: data == 0, col == 0 everywhere (gathers stay in bounds and
    contribute nothing).
    """

    interior: InteriorBlock
    data_ext: torch.Tensor
    col_ext: torch.Tensor
    bnd_rows: torch.Tensor
    send_sel: torch.Tensor
    plan: HaloPlan | GridPlan
    n_global: int
    row_starts: tuple[int, ...]
    n_bnd: tuple[int, ...] = ()
    ghost_data: torch.Tensor | None = None
    ghost_col: torch.Tensor | None = None
    ghost_pos: torch.Tensor | None = None
    halo_depth: int = 1

    @property
    def fmt(self) -> str:
        """Interior storage format: 'ell' | 'hyb' | 'bcsr'."""
        return self.interior.fmt

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    @property
    def n_own_pad(self) -> int:
        return self.plan.n_own_pad

    @property
    def dtype(self) -> torch.dtype:
        return self.interior.dtype

    @property
    def device(self) -> torch.device:
        return self.interior.device

    @property
    def n_ghost_rows(self) -> int:
        """Padded ghost-row-block rows per shard (G; 0 unless deep halo)."""
        return 0 if self.ghost_pos is None else self.ghost_pos.shape[-1]

    @property
    def ghost_slots(self) -> int:
        """Stored ghost-row value slots (padding included, all shards)."""
        return 0 if self.ghost_data is None else _size(self.ghost_data)

    # -- storage accounting ---------------------------------------------------

    @property
    def nnz_stored(self) -> int:
        """Stored value slots (incl. format padding) across all shards."""
        return self.interior.slots + _size(self.data_ext)

    def interior_stored_bytes(self, value_bytes: int = 8) -> int:
        """Interior bytes resident in HBM (values + indices, all shards)."""
        return self.interior.slots * value_bytes + self.interior.index_bytes

    def stored_bytes(self, value_bytes: int = 8) -> int:
        """Whole-matrix resident bytes: interior + boundary block + (deep
        halos only) the replicated ghost-row block."""
        return (
            self.interior_stored_bytes(value_bytes)
            + _size(self.data_ext) * (value_bytes + 4)
            + self.ghost_slots * (value_bytes + 4)
        )

    # -- device-side helpers (derived once, cached) --------------------------

    @functools.cached_property
    def flat_send(self) -> torch.Tensor:
        """(S*W,) int32 ids into the flattened stacked x_own of every
        shard's send selection (ring and grid modes)."""
        S, W = self.send_sel.shape
        offs = torch.arange(S, dtype=torch.int32, device=self.device) * self.n_own_pad
        return (self.send_sel + offs[:, None]).reshape(-1)

    @functools.cached_property
    def flat_col_ext(self) -> torch.Tensor:
        """(S*B*k_ext,) int32 ids of the boundary entries into the flattened
        stacked x_ext ((S, ext_len) in ring mode; the one gathered (S*R,)
        vector, shared by all shards, in allgather mode)."""
        if self.plan.mode == "allgather":
            return self.col_ext.reshape(-1)
        S = self.n_shards
        offs = torch.arange(S, dtype=torch.int32, device=self.device) * self.plan.ext_len
        return (self.col_ext + offs[:, None, None]).reshape(-1)

    @functools.cached_property
    def flat_bnd_rows(self) -> torch.Tensor:
        """(S*B,) int32 ids of the boundary rows into the flattened (S*R,)
        result."""
        S = self.n_shards
        offs = torch.arange(S, dtype=torch.int32, device=self.device) * self.n_own_pad
        return (self.bnd_rows + offs[:, None]).reshape(-1)

    @functools.cached_property
    def flat_ghost_col(self) -> torch.Tensor:
        """(S*G*kg,) int32 ids of the ghost-row entries into the flattened
        stacked x_ext (S, ext_len)."""
        offs = torch.arange(self.n_shards, dtype=torch.int32, device=self.device)
        return (self.ghost_col + offs[:, None, None] * self.plan.ext_len).reshape(-1)

    @functools.cached_property
    def ghost_scatter(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(src, dst)``: the genuine ghost rows (flat ids into the
        (S*G,) ghost results) and their halo slots (flat ids into the
        stacked (S, ext_len - R) halo); padding rows are left out."""
        R, halo_len = self.n_own_pad, self.plan.ext_len - self.n_own_pad
        pos = self.ghost_pos.long()
        S, G = pos.shape
        src = torch.nonzero((pos < self.plan.ext_len).reshape(-1)).reshape(-1)
        offs = torch.arange(S, device=self.device)[:, None] * halo_len
        dst = (pos - R + offs).reshape(-1)[src]
        return src, dst

    def to(self, device) -> "DistMat":
        """This matrix with every tensor on ``device`` (self if already there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        mv = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, interior=self.interior.to(device),
            data_ext=mv(self.data_ext), col_ext=mv(self.col_ext),
            bnd_rows=mv(self.bnd_rows), send_sel=mv(self.send_sel),
            ghost_data=mv(self.ghost_data), ghost_col=mv(self.ghost_col),
            ghost_pos=mv(self.ghost_pos),
        )


# ---------------------------------------------------------------------------
# Interior packers: the flat interior entries -> one InteriorBlock
# ---------------------------------------------------------------------------


def _rank_in_groups(keys: np.ndarray) -> np.ndarray:
    """Position of each element inside its run of equal ``keys`` (keys
    non-decreasing): [5, 5, 7, 9, 9, 9] -> [0, 1, 0, 0, 1, 2]."""
    if not len(keys):
        return np.zeros(0, np.int64)
    starts = np.r_[True, keys[1:] != keys[:-1]]
    first = np.flatnonzero(starts)
    run = np.cumsum(starts) - 1
    return np.arange(len(keys), dtype=np.int64) - first[run]


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass(frozen=True)
class InteriorEntries:
    """A partition's interior (own-column) entries in flat form, in CSR
    order: entry ``e`` is ``val[e]`` at local row ``row[e]`` and local
    column ``col[e]`` of shard ``shard[e]``, the ``slot[e]``-th interior
    entry of its row. ``row_len`` counts the interior entries of every
    global row (rows in global order, i.e. shard by shard); R is the padded
    rows per shard. The host-side stand-in for the JAX package's per-shard
    row lists."""

    shard: np.ndarray
    row: np.ndarray
    col: np.ndarray
    val: np.ndarray
    slot: np.ndarray
    row_len: np.ndarray
    row_starts: tuple[int, ...]
    R: int

    @property
    def S(self) -> int:
        return len(self.row_starts) - 1

    def shard_row_lens(self) -> list:
        """Per shard, the interior entry count of each of its rows."""
        st = self.row_starts
        return [self.row_len[st[s]:st[s + 1]] for s in range(self.S)]

    def shard_slices(self) -> list:
        """Per shard, the slice of the (shard-sorted) entry arrays it owns."""
        cuts = np.searchsorted(self.shard, np.arange(self.S + 1))
        return [slice(int(cuts[s]), int(cuts[s + 1])) for s in range(self.S)]


def _pack_interior_ell(e: InteriorEntries, dtype, device) -> ELLBlock:
    S, R = e.S, e.R
    k = max(int(e.row_len.max()) if len(e.row_len) else 0, 1)
    flat = (e.shard * R + e.row) * k + e.slot
    data = np.zeros((S, R, k), dtype)
    col = np.zeros((S, R, k), np.int32)
    data.reshape(-1)[flat] = e.val
    col.reshape(-1)[flat] = e.col
    return ELLBlock(data=_to_torch(data, device), col=_to_torch(col, device))


def _pack_interior_hyb(e: InteriorEntries, dtype, device,
                       k_typ: int | None = None) -> HYBBlock:
    from repro_torch.roofline.format_model import hyb_split

    S, R = e.S, e.R
    if k_typ is None:
        k_typ, _ = hyb_split(e.row_len, n_rows=R * S)
    k_typ = max(int(k_typ), 1)
    pre = e.slot < k_typ
    flat = (e.shard[pre] * R + e.row[pre]) * k_typ + e.slot[pre]
    data = np.zeros((S, R, k_typ), dtype)
    col = np.zeros((S, R, k_typ), np.int32)
    data.reshape(-1)[flat] = e.val[pre]
    col.reshape(-1)[flat] = e.col[pre]
    # the tail: every row's entries past k_typ, in row order per shard
    tail = np.flatnonzero(~pre)
    ts = e.shard[tail]
    tj = _rank_in_groups(ts)
    n_tail = tuple(int(c) for c in np.bincount(ts, minlength=S))
    T = max(max(n_tail), 1)
    tail_data = np.zeros((S, T), dtype)
    tail_col = np.zeros((S, T), np.int32)
    tail_row = np.zeros((S, T), np.int32)
    tail_data[ts, tj] = e.val[tail]
    tail_col[ts, tj] = e.col[tail]
    tail_row[ts, tj] = e.row[tail]
    t = lambda a: _to_torch(a, device)
    return HYBBlock(data=t(data), col=t(col), tail_data=t(tail_data),
                    tail_col=t(tail_col), tail_row=t(tail_row), n_tail=n_tail)


def _pack_interior_bcsr(e: InteriorEntries, dtype, device, br: int,
                        bc: int) -> BCSRBlock:
    """The JAX package's per-shard ``pack_bcsr`` of every shard's R x R
    interior, re-laid to the largest blocks-per-row of all shards, done
    for all shards at once: tiles sorted by (shard, block-row, block-col),
    slot = rank inside the block-row."""
    S, R = e.S, e.R
    NB = max(-(-R // br), 1)
    n_bcols = max(-(-R // bc), 1)
    key = (e.shard * NB + e.row // br) * n_bcols + e.col // bc
    uk, inv = np.unique(key, return_inverse=True)
    sb = uk // n_bcols  # shard * NB + block-row of every tile
    slot = _rank_in_groups(sb)
    bpr = max(int(slot.max()) + 1 if len(slot) else 0, 1)
    dst = sb * bpr + slot
    blocks = np.zeros((S * NB * bpr, br, bc), dtype)
    bcol = np.zeros(S * NB * bpr, np.int32)
    bcol[dst] = uk % n_bcols
    blocks[dst[inv.reshape(-1)], e.row % br, e.col % bc] = e.val
    return BCSRBlock(
        blocks=_to_torch(blocks.reshape(S, NB * bpr, br, bc), device),
        bcol=_to_torch(bcol.reshape(S, NB * bpr), device),
        n_brows=NB, bpr=bpr, br=br, bc=bc,
    )


def block_stats_from_arrays(
    r_loc: np.ndarray, c_loc: np.ndarray, R: int, br: int, bc: int
) -> tuple[int, int]:
    """(n_blocks, max_blocks_per_block_row) of one shard's interior, from
    flat local (row, col) index arrays — the JAX package's BCSR
    block-counting formula, which ``fmt="auto"`` prices."""
    n_bcols = -(-R // bc)
    if not len(c_loc):
        return 0, 0
    # distinct tile keys by one stable sort and a neighbour test, not
    # np.unique: NumPy 2.3 hashes integer keys there while holding the GIL,
    # so the tuner's per-shard counts on host threads ran one at a time
    keys = np.sort(
        (np.asarray(r_loc, np.int64) // br) * n_bcols
        + np.asarray(c_loc, np.int64) // bc,
        kind="stable",
    )
    keys = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
    counts = np.bincount(keys // n_bcols)
    return len(keys), int(counts.max())


def pack_interior(
    fmt: str, entries: InteriorEntries, *, dtype=np.float64, block=(4, 4),
    device="cpu",
) -> InteriorBlock:
    """Pack the interior entries into one :class:`InteriorBlock` on
    ``device``. ``fmt`` is one of :data:`FORMATS` or ``"auto"``, which
    resolves the format minimizing the stored-bytes / traffic cost model
    (``roofline/format_model.choose_format``) — never costlier than ELL by
    construction, since ELL is always a candidate. ``block`` is the BCSR
    tile shape. Every packer is vectorised over all entries and gives the
    JAX package's arrays byte for byte."""
    e = entries
    if fmt == "auto":
        from repro_torch.roofline.format_model import choose_format

        fmt, _ = choose_format(
            e.shard_row_lens(),
            n_rows=e.R,
            shard_blocks=[
                block_stats_from_arrays(e.row[sl], e.col[sl], e.R, block[0], block[1])
                for sl in e.shard_slices()
            ],
            br=block[0],
            bc=block[1],
        )
    if fmt == "ell":
        return _pack_interior_ell(e, dtype, device)
    if fmt == "hyb":
        return _pack_interior_hyb(e, dtype, device)
    if fmt == "bcsr":
        return _pack_interior_bcsr(e, dtype, device, block[0], block[1])
    raise ValueError(f"unknown interior format {fmt!r}; want {FORMATS} or 'auto'")


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def partition_csr(
    a_csr,
    n_shards: int,
    *,
    max_ring: int = 3,
    partition: RowPartition | None = None,
    dtype=np.float64,
    force_allgather: bool = False,
    fmt: str = "ell",
    block: tuple[int, int] = (4, 4),
    grid: tuple[int, int] | None = None,
    halo_depth: int = 1,
    device="cpu",
) -> DistMat:
    """Partition a host scipy CSR matrix into a stacked :class:`DistMat`.

    Chooses ring mode iff every off-shard coupling reaches at most
    ``max_ring`` shards away; otherwise falls back to allgather mode.
    ``force_allgather=True`` always uses allgather mode — the Ginkgo-analog
    baseline layout. The arrays equal those of
    ``repro.core.partition.partition_csr`` for the same arguments, byte for
    byte; they are built with numpy over all entries at once and moved to
    ``device`` at the end (a host function: ``cpu`` by default).

    ``fmt`` selects the interior storage format — one of :data:`FORMATS`
    (``ell``/``hyb``/``bcsr``) or ``"auto"`` (stored-bytes cost model, see
    ``roofline/format_model.py``); ``block`` is the BCSR tile shape. The
    boundary block and halo plan do not depend on it. The input is a
    canonical CSR matrix (no duplicate entries), as every builder of the
    repository gives.

    ``halo_depth=k`` builds k-deep ghost zones: the ghost columns of a
    shard are the closure of its boundary coupling to depth k (the depth
    d + 1 ghosts are the off-shard columns of the depth-d ghost rows), all
    in one sorted set, so the halo plan below widens without change; the
    rows of the depth ``< k`` ghosts form the ghost-row block. The ring
    criterion scales with the depth (``max_ring * k`` shards of reach).
    ``halo_depth=1`` gives the historical arrays bit for bit (and 0-sized
    ghost arrays).

    ``grid=(R, C)`` (with ``R * C == n_shards``) plans the halo exchange
    for a 2-D process grid instead (:class:`GridPlan`): the shifts become
    per-dimension ``(di, dj)`` deltas, and the ring criterion applies to
    ``max(|di|, |dj|)``. Rows stay block-contiguous over the flat shard
    order, so ``grid=(1, N)`` builds the 1-D layout, array for array. Pair
    with :func:`pencil_partition` to make a shard's halo scale with its
    pencil's surface.
    """
    if fmt not in FORMATS + ("auto",):
        raise ValueError(f"unknown interior format {fmt!r}; want {FORMATS} or 'auto'")
    halo_depth = int(halo_depth)
    if halo_depth < 1:
        raise ValueError(f"halo_depth must be >= 1, got {halo_depth}")
    if grid is not None:
        gr, gc = int(grid[0]), int(grid[1])
        if gr * gc != n_shards:
            raise ValueError(f"grid {gr}x{gc} does not cover n_shards={n_shards}")
        if gr == 1:
            grid = None  # 1 x N is the 1-D layout; build it identically
    a = a_csr.tocsr()
    n = a.shape[0]
    part = partition or balanced_partition(n, n_shards)
    S = n_shards
    R = part.max_own
    starts = np.asarray(part.row_starts, np.int64)

    indptr = a.indptr.astype(np.int64)
    indices = a.indices.astype(np.int64)
    vals = a.data
    row_len = np.diff(indptr)
    rows = np.arange(n, dtype=np.int64)
    row_shard = part.owner_of(rows)
    row_lo = starts[row_shard]

    ent_row = np.repeat(rows, row_len)
    ent_lo = np.repeat(row_lo, row_len)
    ent_hi = np.repeat(starts[row_shard + 1], row_len)
    own = (indices >= ent_lo) & (indices < ent_hi)
    del ent_lo, ent_hi

    # --- external entries: ghost columns, shifts, halo plan, x_ext slots ---
    ext_e = np.flatnonzero(~own)
    e_row = ent_row[ext_e]
    e_shard = row_shard[e_row]
    e_col = indices[ext_e]
    # (shard, column) pairs, sorted by shard then column: each shard's
    # sorted ghost-column set, as the reference's per-shard np.unique,
    # widened to the depth-k closure and merged into one sorted set
    pair = e_shard * n + e_col
    upair, u_depth = _ghost_closure(np.unique(pair), indptr, indices, starts, n,
                                    halo_depth)
    u_shard = upair // n
    u_col = upair % n
    u_owner = part.owner_of(u_col)
    reach = max_ring * halo_depth
    if grid is None:
        d = u_owner - u_shard
        seen = np.unique(d)
        seen_shift = [int(v) for v in seen]
        mode = "ring" if all(abs(v) <= reach for v in seen_shift) else "allgather"
        shifts = tuple(sorted(seen_shift, key=lambda v: (abs(v), v)))
    else:
        # receive-from deltas on the grid: shard (i, j) takes the column
        # from the shard at (i + di, j + dj); one int key per pair, in the
        # pair's lexicographic order (|dj| < gc)
        di = u_owner // gc - u_shard // gc
        dj = u_owner % gc - u_shard % gc
        d = di * (2 * gc) + dj
        seen, first = np.unique(d, return_index=True)
        seen_shift = [(int(di[i]), int(dj[i])) for i in first]
        near = all(max(abs(a), abs(b)) <= reach for a, b in seen_shift)
        mode = "grid" if near else "allgather"
        shifts = tuple(sorted(seen_shift, key=lambda t: (max(abs(t[0]), abs(t[1])), t)))
    if force_allgather:
        mode = "allgather"

    if mode != "allgather":
        # shift index of every (shard, column) pair: seen is sorted, so
        # searchsorted finds d in it; k_of_seen maps that to shift order
        k_of_seen = np.asarray([shifts.index(v) for v in seen_shift], np.int64)
        u_k = k_of_seen[np.searchsorted(seen, d)]
        # within a shard the owner grows with the column, so (shard, owner)
        # groups — one per shift — are contiguous runs in upair order: the
        # rank inside the run is the position in the sorted receive list
        rank = _rank_in_groups(u_shard * S + u_owner)
        cnt = np.zeros((S, len(shifts)), np.int64)
        np.add.at(cnt, (u_shard, u_k), 1)
        widths = tuple(int(w) for w in cnt.max(axis=0)) if S else ()
        if grid is None:
            plan = HaloPlan("ring", shifts, widths, R, S)
        else:
            plan = GridPlan("grid", (gr, gc), shifts, widths, R, S)
        off = np.concatenate([[0], np.cumsum(widths, dtype=np.int64)])
        u_pos = R + off[u_k] + rank
        # sender (the owner) packs each receiver's list in its sorted order
        # (on the grid the chained hops deliver the buffer unchanged)
        W = sum(widths)
        send_sel = np.zeros((S, max(W, 1)), np.int32)
        send_sel[u_owner, off[u_k] + rank] = (u_col - starts[u_owner]).astype(np.int32)
        e_lidx = u_pos[np.searchsorted(upair, pair)]
    else:
        plan = HaloPlan("allgather", (), (), R, S)
        send_sel = np.zeros((S, 1), np.int32)
        e_owner = part.owner_of(e_col)
        e_lidx = e_owner * R + (e_col - starts[e_owner])
        u_pos = None
    del pair

    # --- interior block ----------------------------------------------------
    own_e = np.flatnonzero(own)
    o_row = ent_row[own_e]
    del ent_row
    own_cnt = np.bincount(o_row, minlength=n)
    o_ptr = np.concatenate([[0], np.cumsum(own_cnt)])
    o_lo = row_lo[o_row]
    entries = InteriorEntries(
        shard=row_shard[o_row], row=o_row - o_lo, col=indices[own_e] - o_lo,
        val=vals[own_e], slot=np.arange(len(o_row), dtype=np.int64) - o_ptr[o_row],
        row_len=own_cnt, row_starts=part.row_starts, R=R,
    )
    del own_e, o_row, o_lo
    interior = pack_interior(fmt, entries, dtype=dtype, block=tuple(block),
                             device=device)
    del entries

    # --- compact boundary block --------------------------------------------
    # boundary rows: rows with at least one external entry, in row order
    b_rows, b_first, b_cnt = np.unique(e_row, return_index=True, return_counts=True)
    k_ext = max(int(b_cnt.max()) if len(b_cnt) else 0, 1)
    b_shard = row_shard[b_rows]
    n_bnd = tuple(int(c) for c in np.bincount(b_shard, minlength=S))
    B = max(max(n_bnd), 1)
    b_j = _rank_in_groups(b_shard)  # boundary slot inside its shard
    e_b = np.repeat(np.arange(len(b_rows)), b_cnt)  # ext entry -> boundary row
    e_slot = np.arange(len(e_row), dtype=np.int64) - b_first[e_b]
    bflat = (b_shard[e_b] * B + b_j[e_b]) * k_ext + e_slot
    data_ext = np.zeros((S, B, k_ext), dtype)
    col_ext = np.zeros((S, B, k_ext), np.int32)
    data_ext.reshape(-1)[bflat] = vals[ext_e]
    col_ext.reshape(-1)[bflat] = e_lidx.astype(np.int32)
    bnd_rows = np.zeros((S, B), np.int32)
    bnd_rows[b_shard, b_j] = (b_rows - starts[b_shard]).astype(np.int32)

    # --- ghost-row block: the rows of the depth < k ghosts (none at depth 1,
    # none in allgather mode) ------------------------------------------------
    deep = np.flatnonzero(u_depth < halo_depth) if mode != "allgather" else u_depth[:0]
    ghost = _ghost_rows(deep, upair, u_pos, indptr, indices, vals, starts, n, S,
                        plan.ext_len, dtype)

    return DistMat(
        interior=interior,
        data_ext=_to_torch(data_ext, device),
        col_ext=_to_torch(col_ext, device),
        bnd_rows=_to_torch(bnd_rows, device),
        send_sel=_to_torch(send_sel, device),
        plan=plan,
        n_global=n,
        row_starts=part.row_starts,
        n_bnd=n_bnd,
        ghost_data=_to_torch(ghost[0], device),
        ghost_col=_to_torch(ghost[1], device),
        ghost_pos=_to_torch(ghost[2], device),
        halo_depth=halo_depth if mode != "allgather" else 1,
    )


def partition_stencil(
    p, n_shards: int, dtype=np.float64, mode: str = "ring",
    fmt: str = "ell", block: tuple[int, int] = (4, 4), device="cpu",
) -> DistMat:
    """A :class:`DistMat` for a Poisson stencil problem built WITHOUT the
    global matrix, straight from the stencil (``matrices/poisson.py``).

    Slab (z-plane) partition (:func:`plane_partition`); both stencils reach
    exactly +-1 plane, so the ring plan has shifts (-1, +1) of width
    ``nx*ny`` (no exchange on a single shard). ``mode="allgather"`` builds
    the Ginkgo-analog layout instead (external columns in the padded-global
    layout). ``fmt`` selects the interior as in :func:`partition_csr`;
    stencil rows are uniform-width, so ``"auto"`` resolves to ELL and the
    other formats exist for A/B measurements only. The arrays equal those
    of ``repro.core.partition.partition_stencil`` byte for byte; they are
    built for every row of every shard at once (the JAX package loops over
    the shards) and moved to ``device`` at the end.
    """
    from repro_torch.matrices.poisson import stencil_offsets, stencil_values

    if fmt not in FORMATS + ("auto",):
        raise ValueError(f"unknown interior format {fmt!r}; want {FORMATS} or 'auto'")
    if mode not in ("ring", "allgather"):
        raise ValueError(f"unknown halo mode {mode!r}; want 'ring' or 'allgather'")
    part = plane_partition(p.n, p.plane, n_shards)
    S, R, H = n_shards, part.max_own, p.plane
    starts = np.asarray(part.row_starts, np.int64)
    offs = stencil_offsets(p.stencil)
    svals = stencil_values(p)
    # entries per row reaching planes z-1 / z+1
    k_ext = max(int((offs[:, 2] == -1).sum()), int((offs[:, 2] == 1).sum()))
    if S > 1 and mode == "ring":
        shifts, widths = (-1, 1), (H, H)
    else:
        shifts, widths = (), ()
    plan = HaloPlan(mode if S > 1 else "ring", shifts, widths, R, S)

    # every global row and its k stencil neighbours
    g = np.arange(p.n, dtype=np.int64)
    shard = part.owner_of(g)
    lo = starts[shard][:, None]
    hi = starts[shard + 1][:, None]
    lrow = g - lo[:, 0]
    nx_ = (g % p.nx)[:, None] + offs[None, :, 0]
    ny_ = (g // p.nx % p.ny)[:, None] + offs[None, :, 1]
    nz_ = (g // H)[:, None] + offs[None, :, 2]
    valid = ((nx_ >= 0) & (nx_ < p.nx) & (ny_ >= 0) & (ny_ < p.ny)
             & (nz_ >= 0) & (nz_ < p.nz))
    gcol = nx_ + p.nx * (ny_ + p.ny * nz_)
    del nx_, ny_, nz_
    vals = np.broadcast_to(svals[None, :], valid.shape) * valid
    own = valid & (gcol >= lo) & (gcol < hi)
    ext = valid & ~own

    data_loc = np.zeros((S, R, len(offs)), dtype)
    col_loc = np.zeros((S, R, len(offs)), np.int32)
    data_loc[shard, lrow] = np.where(own, vals, 0.0).astype(dtype)
    col_loc[shard, lrow] = np.where(own, gcol - lo, 0).astype(np.int32)

    # boundary rows live in the slab's first/last z-plane only: at most 2H
    # ghost-touching rows per shard (H for the edge shards / S == 2)
    B_ub = min(2 * H, R) if S > 1 else 1
    data_ext = np.zeros((S, B_ub, max(k_ext, 1)), dtype)
    col_ext = np.zeros((S, B_ub, max(k_ext, 1)), np.int32)
    bnd_rows = np.zeros((S, B_ub), np.int32)
    n_bnd = np.zeros(S, np.int64)
    send_sel = np.zeros((S, max(sum(widths), 1)), np.int32)
    if S > 1:
        if mode == "ring":
            # left plane (z0 - 1) -> buffer 0, right plane (z1) -> buffer 1
            pos = gcol % H
            lcol = (np.where(ext & (gcol < lo), R + pos, 0)
                    + np.where(ext & (gcol >= hi), R + H + pos, 0))
        else:
            gsafe = np.where(ext, gcol, lo)
            owners = part.owner_of(gsafe.ravel()).reshape(gsafe.shape)
            lcol = np.where(ext, owners * R + (gsafe - starts[owners]), 0)
        de = np.where(ext, vals, 0.0).astype(dtype)
        # compact each row's ext entries into k_ext slots, ext first
        order = np.argsort(~ext, axis=1, kind="stable")
        de_s = np.take_along_axis(de, order, axis=1)[:, :k_ext]
        ce_s = np.take_along_axis(np.where(ext, lcol, 0).astype(np.int32), order,
                                  axis=1)[:, :k_ext]
        # ... and the ghost-touching rows into each shard's boundary block
        bnd = np.flatnonzero(ext.any(axis=1))
        b_shard = shard[bnd]
        bj = _rank_in_groups(b_shard)
        n_bnd = np.bincount(b_shard, minlength=S)
        data_ext[b_shard, bj] = de_s[bnd]
        col_ext[b_shard, bj] = ce_s[bnd]
        bnd_rows[b_shard, bj] = lrow[bnd].astype(np.int32)
        # send selectors: for shift -1 shard j sends its LAST plane to j+1,
        # for shift +1 its FIRST plane to j-1
        n_own = np.diff(starts)
        ar = np.arange(H, dtype=np.int64)
        off = 0
        for d, w in zip(shifts, widths):
            send_sel[:, off: off + H] = (n_own[:, None] - H + ar) if d == -1 else ar
            off += w

    B = max(int(n_bnd.max()), 1)
    if fmt in ("ell", "auto"):
        interior = ELLBlock(data=_to_torch(data_loc, device), col=_to_torch(col_loc, device))
    else:
        interior = pack_interior(fmt, _ell_entries(data_loc, col_loc, part.row_starts),
                                 dtype=dtype, block=tuple(block), device=device)
    return DistMat(
        interior=interior,
        data_ext=_to_torch(data_ext[:, :B], device),
        col_ext=_to_torch(col_ext[:, :B], device),
        bnd_rows=_to_torch(bnd_rows[:, :B], device),
        send_sel=_to_torch(send_sel, device),
        plan=plan,
        n_global=p.n,
        row_starts=part.row_starts,
        n_bnd=tuple(int(v) for v in n_bnd),
    )


def _ell_entries(data: np.ndarray, col: np.ndarray, row_starts) -> InteriorEntries:
    """The interior entries of a stacked ``(S, R, k)`` ELL block, in CSR
    order — the JAX package's ``_ell_to_shard_rows`` in flat form. Entries
    are identified by ``data != 0 or col != 0``, the repo-wide padding
    convention (a genuine zero-valued entry at column 0, which no stencil
    produces, would be dropped)."""
    keep = (data != 0) | (col != 0)
    s, r, j = np.nonzero(keep)
    slot = (np.cumsum(keep, axis=2) - 1)[s, r, j]
    cnt = keep.sum(axis=2)
    n_own = np.diff(np.asarray(row_starts, np.int64))
    row_len = np.concatenate([cnt[sh, : n_own[sh]] for sh in range(len(n_own))])
    return InteriorEntries(
        shard=s.astype(np.int64), row=r.astype(np.int64), col=col[s, r, j].astype(np.int64),
        val=data[s, r, j], slot=slot.astype(np.int64), row_len=row_len.astype(np.int64),
        row_starts=tuple(row_starts), R=data.shape[1],
    )


def _csr_entries(indptr: np.ndarray, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(entry ids, entry count of each row)`` of CSR ``rows``, entries
    row by row in CSR order."""
    lens = indptr[rows + 1] - indptr[rows]
    tot = int(lens.sum())
    if not tot:
        return np.zeros(0, np.int64), lens
    first = np.cumsum(lens) - lens
    return np.repeat(indptr[rows] - first, lens) + np.arange(tot), lens


def _ghost_closure(pairs: np.ndarray, indptr, indices, starts, n: int, depth: int):
    """The depth-``depth`` ghost set of every shard at once.

    ``pairs`` are the sorted ``shard * n + column`` keys of the depth-1
    ghosts. The depth-(d + 1) ghosts of a shard are the off-shard columns
    of the rows of its depth-d ghosts not seen yet (the reference's frontier
    loop, for all shards in one pass). Returns the merged sorted keys and
    the depth of each."""
    keys, depths = [pairs], [np.ones(len(pairs), np.int64)]
    frontier, seen = pairs, pairs
    for dd in range(2, depth + 1):
        if not len(frontier):
            break
        f_shard = frontier // n
        ent, lens = _csr_entries(indptr, frontier % n)
        sh = np.repeat(f_shard, lens)
        cols = indices[ent]
        off = (cols < starts[sh]) | (cols >= starts[sh + 1])
        ref = np.unique(sh[off] * n + cols[off])
        frontier = np.setdiff1d(ref, seen, assume_unique=True)
        seen = np.union1d(seen, frontier)
        keys.append(frontier)
        depths.append(np.full(len(frontier), dd, np.int64))
    merged = np.concatenate(keys)
    order = np.argsort(merged, kind="stable")
    return merged[order], np.concatenate(depths)[order]


def _ghost_rows(deep, upair, u_pos, indptr, indices, vals, starts, n: int, S: int,
                ext_len: int, dtype):
    """The ghost-row block ``(ghost_data, ghost_col, ghost_pos)``: one
    padded-ELL row per ghost ``upair[deep]`` (``shard * n + global row``,
    sorted) with its columns in the shard's ``x_ext`` space — own columns
    at ``column - row_start``, off-shard ones at their halo slot ``u_pos``
    — and its own halo slot. Padding rows keep ``ghost_pos == ext_len``."""
    g_keys = upair[deep]
    g_shard = g_keys // n
    gj = _rank_in_groups(g_shard)
    G = int(np.bincount(g_shard, minlength=S).max()) if len(g_keys) else 0
    ent, lens = _csr_entries(indptr, g_keys % n)
    kg = max(int(lens.max()) if len(lens) else 0, 1)
    ghost_data = np.zeros((S, G, kg), dtype)
    ghost_col = np.zeros((S, G, kg), np.int32)
    ghost_pos = np.full((S, G), ext_len, np.int32)
    if len(g_keys):
        es = np.repeat(g_shard, lens)
        ej = np.repeat(gj, lens)
        slot = np.arange(len(ent), dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens)
        c = indices[ent]
        lo = starts[es]
        own = (c >= lo) & (c < starts[es + 1])
        # the closure holds every off-shard column of a depth < k ghost row
        lidx = c - lo
        key = es[~own] * n + c[~own]
        at = np.searchsorted(upair, key)
        assert np.array_equal(upair[np.minimum(at, len(upair) - 1)], key)
        lidx[~own] = u_pos[at]
        ghost_data[es, ej, slot] = vals[ent]
        ghost_col[es, ej, slot] = lidx.astype(np.int32)
        ghost_pos[g_shard, gj] = u_pos[deep].astype(np.int32)
    return ghost_data, ghost_col, ghost_pos


def distmat_from_numpy(
    *,
    data_ext,
    col_ext,
    bnd_rows,
    send_sel,
    mode: str,
    shifts,
    widths,
    n_own_pad: int,
    n_shards: int,
    n_global: int,
    row_starts,
    n_bnd=(),
    data=None,
    col=None,
    tail_data=None,
    tail_col=None,
    tail_row=None,
    n_tail=(),
    blocks=None,
    bcol=None,
    n_brows: int = 0,
    bpr: int = 0,
    ghost_data=None,
    ghost_col=None,
    ghost_pos=None,
    halo_depth: int = 1,
    grid=None,
    device="cpu",
) -> DistMat:
    """A :class:`DistMat` from another builder's arrays (numpy) and plan
    metadata — e.g. the leaves of a ``repro.core.partition.DistMat``,
    carried across as they are. The interior is a :class:`BCSRBlock` when
    ``blocks``/``bcol`` are given (``n_brows``, ``bpr``; the tile shape is
    that of ``blocks``), a :class:`HYBBlock` when the ``tail_*`` arrays are
    given beside ``data``/``col`` (``n_tail``), else an :class:`ELLBlock`.
    A deep-halo partition carries its ghost-row block (``ghost_data``,
    ``ghost_col``, ``ghost_pos``) and ``halo_depth``. ``mode="grid"``
    builds a :class:`GridPlan` over ``grid = (R, C)``, its ``shifts`` the
    ``(di, dj)`` pairs."""
    t = lambda a: None if a is None else _to_torch(np.array(a), device)  # a copy
    if blocks is not None:
        _, _, br, bc = np.shape(blocks)
        interior = BCSRBlock(blocks=t(blocks), bcol=t(bcol), n_brows=int(n_brows),
                             bpr=int(bpr), br=int(br), bc=int(bc))
    elif tail_data is not None:
        interior = HYBBlock(data=t(data), col=t(col), tail_data=t(tail_data),
                            tail_col=t(tail_col), tail_row=t(tail_row),
                            n_tail=tuple(int(v) for v in n_tail))
    else:
        interior = ELLBlock(data=t(data), col=t(col))
    widths = tuple(int(w) for w in widths)
    if str(mode) == "grid":
        plan = GridPlan("grid", (int(grid[0]), int(grid[1])),
                        tuple((int(a), int(b)) for a, b in shifts), widths,
                        int(n_own_pad), int(n_shards))
    else:
        plan = HaloPlan(str(mode), tuple(int(v) for v in shifts), widths,
                        int(n_own_pad), int(n_shards))
    return DistMat(
        interior=interior,
        data_ext=t(data_ext),
        col_ext=t(col_ext),
        bnd_rows=t(bnd_rows),
        send_sel=t(send_sel),
        plan=plan,
        n_global=int(n_global),
        row_starts=tuple(int(r) for r in row_starts),
        n_bnd=tuple(int(b) for b in n_bnd),
        ghost_data=t(ghost_data),
        ghost_col=t(ghost_col),
        ghost_pos=t(ghost_pos),
        halo_depth=int(halo_depth),
    )


def expand_boundary(mat: DistMat) -> tuple[np.ndarray, np.ndarray]:
    """Full-row ``(S, R, k_ext)`` view of the compact boundary block (host).

    Inverse of the boundary-row compaction: each shard's compact
    ``(B, k_ext)`` ghost-entry rows go back to their ``bnd_rows`` positions,
    for all shards at once (padding rows past ``n_bnd[s]`` are left out).
    """
    S, R = mat.n_shards, mat.n_own_pad
    de = mat.data_ext.detach().cpu().numpy()
    ce = mat.col_ext.detach().cpu().numpy()
    rows = mat.bnd_rows.detach().cpu().numpy().astype(np.int64)
    B, k = de.shape[1], de.shape[2]
    full_d = np.zeros((S, R, k), de.dtype)
    full_c = np.zeros((S, R, k), ce.dtype)
    nb = np.asarray(mat.n_bnd if mat.n_bnd else [0] * S, np.int64)
    s_idx, j_idx = np.nonzero(np.arange(B)[None, :] < nb[:, None])
    full_d[s_idx, rows[s_idx, j_idx]] = de[s_idx, j_idx]
    full_c[s_idx, rows[s_idx, j_idx]] = ce[s_idx, j_idx]
    return full_d, full_c


# ---------------------------------------------------------------------------
# Distributed vectors (host <-> stacked layout helpers)
# ---------------------------------------------------------------------------


def pad_vector(x: np.ndarray, mat: DistMat) -> np.ndarray:
    """Global vector -> (S, R) padded shard layout (trailing axes, as of
    an (n, r) block, are carried along)."""
    S, R = mat.n_shards, mat.n_own_pad
    starts = np.asarray(mat.row_starts, np.int64)
    out = np.zeros((S, R) + x.shape[1:], x.dtype)
    rows = np.arange(len(x), dtype=np.int64)
    shard = np.searchsorted(starts[1:], rows, side="right")
    out[shard, rows - starts[shard]] = x
    return out


def unpad_vector(xp, mat: DistMat) -> np.ndarray:
    """(S, R) padded shard layout -> global vector (trailing axes carried)."""
    if isinstance(xp, torch.Tensor):
        xp = xp.detach().cpu().numpy()
    xp = np.asarray(xp)
    starts = np.asarray(mat.row_starts, np.int64)
    n = int(starts[-1])
    rows = np.arange(n, dtype=np.int64)
    shard = np.searchsorted(starts[1:], rows, side="right")
    return xp[shard, rows - starts[shard]]


def pad_block(X: np.ndarray, mat: DistMat) -> np.ndarray:
    """Global (n, r) right-hand-side block -> (S, R, r) padded shard layout."""
    return pad_vector(np.asarray(X), mat)


def unpad_block(Xp, mat: DistMat) -> np.ndarray:
    """(S, R, r) padded shard layout -> global (n, r) block."""
    return unpad_vector(Xp, mat)
