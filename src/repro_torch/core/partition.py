"""Block-row partitioning + halo-exchange planning (host side, numpy).

Port of the ELL / 1-D ring path of ``repro.core.partition``:

* matrices are distributed in **blocks of contiguous rows** across shards,
  with 4-byte local column indices;
* every shard's rows are split into an **interior block** (entries whose
  column the shard owns) and a compact **boundary block** holding only the
  ghost-touching rows' external entries, so the SpMV can run the interior
  while the halo is exchanged and scatter-add the boundary block after;
* the halo exchange is planned as ring shifts (every off-shard coupling
  reaches at most ``max_ring`` shards away) or falls back to an all-gather
  of the whole vector ("allgather" mode, also the Ginkgo-analog layout).

The builder here is **vectorised**: every step is a numpy array operation
over all rows and entries at once, with no per-row Python loop, and it
produces the same arrays, byte for byte, as the JAX package's builder
(which walks the rows one by one and so takes minutes at the sizes the
port runs on the card). HYB/BCSR interiors, 2-D process grids and deep
halos are later slices of the port.

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


# ---------------------------------------------------------------------------
# Interior storage + the distributed matrix
# ---------------------------------------------------------------------------


def _size(a) -> int:
    return int(np.prod(tuple(a.shape), dtype=np.int64))


@dataclasses.dataclass(frozen=True)
class ELLBlock:
    """Padded-ELL interior: (S, R, k) slots/row, padding data == 0, col == 0."""

    data: torch.Tensor  # (S, R, k)
    col: torch.Tensor  # (S, R, k) int32, indexes x_own

    fmt = "ell"

    @property
    def slots(self) -> int:
        """Stored value slots, padding included."""
        return _size(self.data)

    @property
    def index_bytes(self) -> int:
        return _size(self.col) * 4

    @functools.cached_property
    def flat_col(self) -> torch.Tensor:
        """(S*R*k,) int32 ids into the flattened (S*R,) stacked x_own."""
        S, R, _ = self.col.shape
        offs = torch.arange(S, dtype=torch.int32, device=self.col.device) * R
        return (self.col + offs[:, None, None]).reshape(-1)


@dataclasses.dataclass(frozen=True)
class DistMat:
    """Block-row-distributed sparse matrix: ELL interior + compact boundary
    block, stacked over shards on one device.

    * ``interior``          — (S, R, k) :class:`ELLBlock` of the entries
      whose column the shard owns, indexing ``x_own`` (R = n_own_pad).
    * ``data_ext/col_ext``  — (S, B, k_ext): the boundary block, the
      external entries of the ghost-touching rows only; ``col_ext`` indexes
      the shard's ``x_ext`` (see :class:`HaloPlan`). Row ``j`` belongs to
      local row ``bnd_rows[:, j]``.
    * ``bnd_rows``          — (S, B) int32; slots past ``n_bnd[s]`` are
      padding (row 0, zero data — a scatter-add of exact zeros).
    * ``send_sel``          — (S, sum(widths)) int32: per shift k, the slice
      ``send_sel[:, off_k : off_k + widths[k]]`` lists the local indices each
      shard sends for that shift.

    Padding: data == 0, col == 0 everywhere (gathers stay in bounds and
    contribute nothing).
    """

    interior: ELLBlock
    data_ext: torch.Tensor
    col_ext: torch.Tensor
    bnd_rows: torch.Tensor
    send_sel: torch.Tensor
    plan: HaloPlan
    n_global: int
    row_starts: tuple[int, ...]
    n_bnd: tuple[int, ...] = ()

    @property
    def fmt(self) -> str:
        return self.interior.fmt

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    @property
    def n_own_pad(self) -> int:
        return self.plan.n_own_pad

    @property
    def dtype(self) -> torch.dtype:
        return self.interior.data.dtype

    @property
    def device(self) -> torch.device:
        return self.interior.data.device

    # -- storage accounting ---------------------------------------------------

    @property
    def nnz_stored(self) -> int:
        """Stored value slots (incl. format padding) across all shards."""
        return self.interior.slots + _size(self.data_ext)

    def interior_stored_bytes(self, value_bytes: int = 8) -> int:
        """Interior bytes resident in HBM (values + indices, all shards)."""
        return self.interior.slots * value_bytes + self.interior.index_bytes

    def stored_bytes(self, value_bytes: int = 8) -> int:
        """Whole-matrix resident bytes: interior + boundary block."""
        return (
            self.interior_stored_bytes(value_bytes)
            + _size(self.data_ext) * (value_bytes + 4)
        )

    # -- device-side helpers (derived once, cached) --------------------------

    @functools.cached_property
    def flat_send(self) -> torch.Tensor:
        """(S*W,) int32 ids into the flattened stacked x_own of every
        shard's send selection (ring mode)."""
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

    def to(self, device) -> "DistMat":
        """This matrix with every tensor on ``device`` (self if already there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        mv = lambda t: t.to(device)
        return dataclasses.replace(
            self,
            interior=ELLBlock(data=mv(self.interior.data), col=mv(self.interior.col)),
            data_ext=mv(self.data_ext), col_ext=mv(self.col_ext),
            bnd_rows=mv(self.bnd_rows), send_sel=mv(self.send_sel),
        )


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, {item})"
    )


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

    Only ``fmt="ell"``, ``grid=None`` and ``halo_depth=1`` are ported;
    the other layouts raise ``NotImplementedError``.
    """
    if fmt != "ell":
        _not_ported(f"interior format {fmt!r}", "queue 1, item 8")
    if grid is not None and int(grid[0]) > 1:
        _not_ported("the 2-D process grid", "queue 1, item 10")
    if int(halo_depth) != 1:
        _not_ported("deep halos (halo_depth > 1)", "queue 1, item 9")
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
    # padded stacked row id of every global row: shard * R + local row
    prow = rows - row_lo + row_shard * R

    ent_row = np.repeat(rows, row_len)
    ent_lo = np.repeat(row_lo, row_len)
    ent_hi = np.repeat(starts[row_shard + 1], row_len)
    own = (indices >= ent_lo) & (indices < ent_hi)
    del ent_lo, ent_hi

    # --- external entries: shifts, halo plan, x_ext positions --------------
    ext_e = np.flatnonzero(~own)
    e_row = ent_row[ext_e]
    e_shard = row_shard[e_row]
    e_col = indices[ext_e]
    # (shard, column) pairs, sorted by shard then column: each shard's
    # sorted ghost-column set, as the reference's per-shard np.unique
    pair = e_shard * n + e_col
    upair, inv = np.unique(pair, return_inverse=True)
    u_shard = upair // n
    u_col = upair % n
    u_owner = part.owner_of(u_col)
    d = u_owner - u_shard
    seen = np.unique(d)
    mode = "ring" if all(abs(int(v)) <= max_ring for v in seen) else "allgather"
    if force_allgather:
        mode = "allgather"
    shifts = tuple(sorted((int(v) for v in seen), key=lambda v: (abs(v), v)))

    if mode == "ring":
        # shift index of every (shard, column) pair: seen is sorted, so
        # searchsorted finds d in it; k_of_seen maps that to shift order
        k_of_seen = np.asarray([shifts.index(int(v)) for v in seen], np.int64)
        u_k = k_of_seen[np.searchsorted(seen, d)]
        # within a shard the owner grows with the column, so (shard, owner)
        # groups are contiguous runs in upair order: the rank inside the run
        # is the position in the sorted receive list
        rank = _rank_in_groups(u_shard * S + u_owner)
        cnt = np.zeros((S, len(shifts)), np.int64)
        np.add.at(cnt, (u_shard, u_k), 1)
        widths = tuple(int(w) for w in cnt.max(axis=0)) if S else ()
        plan = HaloPlan("ring", shifts, widths, R, S)
        off = np.concatenate([[0], np.cumsum(widths, dtype=np.int64)])
        u_pos = R + off[u_k] + rank
        # sender (the owner) packs each receiver's list in its sorted order
        W = sum(widths)
        send_sel = np.zeros((S, max(W, 1)), np.int32)
        send_sel[u_owner, off[u_k] + rank] = (u_col - starts[u_owner]).astype(np.int32)
        e_lidx = u_pos[inv]
    else:
        plan = HaloPlan("allgather", (), (), R, S)
        send_sel = np.zeros((S, 1), np.int32)
        e_owner = part.owner_of(e_col)
        e_lidx = e_owner * R + (e_col - starts[e_owner])

    # --- interior ELL block ------------------------------------------------
    own_e = np.flatnonzero(own)
    o_row = ent_row[own_e]
    del ent_row
    own_cnt = np.bincount(o_row, minlength=n)
    k = max(int(own_cnt.max()) if n else 0, 1)
    o_ptr = np.concatenate([[0], np.cumsum(own_cnt)])
    o_slot = np.arange(len(o_row), dtype=np.int64) - o_ptr[o_row]
    flat = prow[o_row] * k + o_slot
    data = np.zeros((S, R, k), dtype)
    col = np.zeros((S, R, k), np.int32)
    data.reshape(-1)[flat] = vals[own_e]
    col.reshape(-1)[flat] = (indices[own_e] - row_lo[o_row]).astype(np.int32)
    del own_e, o_row, o_slot, flat

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

    return DistMat(
        interior=ELLBlock(data=_to_torch(data, device), col=_to_torch(col, device)),
        data_ext=_to_torch(data_ext, device),
        col_ext=_to_torch(col_ext, device),
        bnd_rows=_to_torch(bnd_rows, device),
        send_sel=_to_torch(send_sel, device),
        plan=plan,
        n_global=n,
        row_starts=part.row_starts,
        n_bnd=n_bnd,
    )


def distmat_from_numpy(
    *,
    data,
    col,
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
    device="cpu",
) -> DistMat:
    """A :class:`DistMat` from another builder's arrays (numpy) and plan
    metadata — e.g. the leaves of a ``repro.core.partition.DistMat`` with an
    ELL interior, carried across as they are."""
    t = lambda a: _to_torch(np.array(a), device)  # a copy: inputs may be read-only
    return DistMat(
        interior=ELLBlock(data=t(data), col=t(col)),
        data_ext=t(data_ext),
        col_ext=t(col_ext),
        bnd_rows=t(bnd_rows),
        send_sel=t(send_sel),
        plan=HaloPlan(str(mode), tuple(int(s) for s in shifts),
                      tuple(int(w) for w in widths), int(n_own_pad), int(n_shards)),
        n_global=int(n_global),
        row_starts=tuple(int(r) for r in row_starts),
        n_bnd=tuple(int(b) for b in n_bnd),
    )


# ---------------------------------------------------------------------------
# Distributed vectors (host <-> stacked layout helpers)
# ---------------------------------------------------------------------------


def pad_vector(x: np.ndarray, mat: DistMat) -> np.ndarray:
    """Global vector -> (S, R) padded shard layout."""
    S, R = mat.n_shards, mat.n_own_pad
    starts = np.asarray(mat.row_starts, np.int64)
    out = np.zeros((S, R), x.dtype)
    rows = np.arange(len(x), dtype=np.int64)
    shard = np.searchsorted(starts[1:], rows, side="right")
    out[shard, rows - starts[shard]] = x
    return out


def unpad_vector(xp, mat: DistMat) -> np.ndarray:
    """(S, R) padded shard layout -> global vector."""
    if isinstance(xp, torch.Tensor):
        xp = xp.detach().cpu().numpy()
    xp = np.asarray(xp)
    starts = np.asarray(mat.row_starts, np.int64)
    n = int(starts[-1])
    rows = np.arange(n, dtype=np.int64)
    shard = np.searchsorted(starts[1:], rows, side="right")
    return xp[shard, rows - starts[shard]]
