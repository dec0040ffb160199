"""Block-row partitioning + halo-exchange planning (host side, numpy).

Port of the 1-D ring path of ``repro.core.partition``:

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
  of the whole vector ("allgather" mode, also the Ginkgo-analog layout).

The builder here is **vectorised**: every step is a numpy array operation
over all rows and entries at once, with no per-row Python loop, and it
produces the same arrays, byte for byte, as the JAX package's builder
(which walks the rows one by one and so takes minutes at the sizes the
port runs on the card). 2-D process grids and deep halos are later
slices of the port.

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

    Padding: data == 0, col == 0 everywhere (gathers stay in bounds and
    contribute nothing).
    """

    interior: InteriorBlock
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
            self, interior=self.interior.to(device),
            data_ext=mv(self.data_ext), col_ext=mv(self.col_ext),
            bnd_rows=mv(self.bnd_rows), send_sel=mv(self.send_sel),
        )


# ---------------------------------------------------------------------------
# Interior packers: the flat interior entries -> one InteriorBlock
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
    keys = np.unique(
        (np.asarray(r_loc, np.int64) // br) * n_bcols
        + np.asarray(c_loc, np.int64) // bc
    )
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

    Only ``grid=None`` and ``halo_depth=1`` are ported; the 2-D grid and
    deep halos raise ``NotImplementedError``.
    """
    if fmt not in FORMATS + ("auto",):
        raise ValueError(f"unknown interior format {fmt!r}; want {FORMATS} or 'auto'")
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
    )


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
    device="cpu",
) -> DistMat:
    """A :class:`DistMat` from another builder's arrays (numpy) and plan
    metadata — e.g. the leaves of a ``repro.core.partition.DistMat``,
    carried across as they are. The interior is a :class:`BCSRBlock` when
    ``blocks``/``bcol`` are given (``n_brows``, ``bpr``; the tile shape is
    that of ``blocks``), a :class:`HYBBlock` when the ``tail_*`` arrays are
    given beside ``data``/``col`` (``n_tail``), else an :class:`ELLBlock`."""
    t = lambda a: _to_torch(np.array(a), device)  # a copy: inputs may be read-only
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
    return DistMat(
        interior=interior,
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
