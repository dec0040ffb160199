"""Distributed SpMV + halo exchange over the stacked shard layout.

Port of the 1-D ring path of ``repro.core.spmv``. Every shard lives
on the same device: vectors are ``(S, R)`` stacks, the matrix a stacked
:class:`~repro_torch.core.partition.DistMat`, and each function is written
once over all shards (no Python loop over shards). The ring ``ppermute``
becomes a shift along the shard axis with zeros at the ring's edges; the
all-gather becomes the flattened ``(S*R,)`` stack, which every shard reads.

Each shard's rows are split into an interior block (own columns) and a
compact boundary block (ghost-touching rows' external entries only).
``spmv_shard`` with ``overlap=True`` runs the interior matvec beside the
halo exchange and scatter-adds the boundary block after it; the whole phase
is attributed to the ``"overlap"`` energy region. ``overlap=False`` keeps
the serialized order (regions ``"halo"`` + ``"spmv"``). Both give the same
result; only the schedule and the region attribution differ.

Every function also takes an ``(S, R, r)`` stack of column blocks (the
multi-RHS SpMM of block CG): the matrix is streamed once for all ``r``
right-hand sides, the vector traffic and the halo payload scale with
``r``, and the counts are recorded under the ``*_spmm`` names, as in the
JAX package.

The interior matvec dispatches on the storage format
(:func:`interior_matvec`): the ELL matvec and HYB's ELL prefix are a gather
+ reduction in PyTorch, as they are ``jnp`` gathers in the JAX package (no
Pallas kernel); the HYB tail is added by a fixed tree of sums
(``partition.TailPlan``), deterministic on the card; the BCSR interior runs
the dispatch op ``bcsr_spmv`` / ``bcsr_spmm``, on the card the hand-written
kernels. Counts are recorded per shard, with the per-shard sizes the JAX
package's local blocks have.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core.partition import BCSRBlock, DistMat, ELLBlock, HaloPlan, HYBBlock
from repro_torch.energy import trace
from repro_torch.energy.accounting import OpCounts
from repro_torch.kernels import dispatch as kd


def _gather(x: torch.Tensor, flat_idx: torch.Tensor, shape, r: int = 0) -> torch.Tensor:
    """Rows ``flat_idx`` of the flattened stack ``x``, viewed as ``shape``
    (vectors, ``r == 0``) or ``shape + (r,)`` (column blocks).

    A block's r-wide rows are gathered element by element through the flat
    view: on the card a row-wise ``index_select`` of short rows runs far
    below the memory rate, a flat one near it."""
    if not r:
        return x.reshape(-1).index_select(0, flat_idx).view(shape)
    idx = flat_idx if x.numel() < 2 ** 31 else flat_idx.long()
    cols = torch.arange(r, dtype=idx.dtype, device=idx.device)
    eidx = (idx[:, None] * r + cols).reshape(-1)
    return x.reshape(-1).index_select(0, eidx).view(*shape, r)


def _nrhs(x: torch.Tensor, stack_dims: int = 2) -> int:
    """0 for a vector operand, ``r`` for a column block (trailing axis
    beyond the ``stack_dims`` axes of the stacked layout)."""
    return x.shape[-1] if x.dim() > stack_dims else 0


def _ell_product(block, x: torch.Tensor) -> torch.Tensor:
    """The (S, R, k) ELL slots of ``block`` (an ELL interior or HYB's ELL
    prefix) times stacked ``x``: (S, R), or (S, R, r) for a block."""
    data = block.data
    S, R, k = data.shape
    r = _nrhs(x)
    if not r:
        return (data * _gather(x, block.flat_col, data.shape)).sum(-1)
    # SpMM one slot at a time: the gathered temporary is (S, R, r), not the
    # (S, R, k, r) of a single gather (7.5 GB in f64 at side 256, r = 8)
    y = None
    for j in range(k):
        g = _gather(x, block.slot_col[j], (S, R), r)
        d = data[:, :, j, None]
        y = g.mul_(d) if y is None else y.addcmul_(g, d)
    return y


def ell_matvec(block: ELLBlock, x: torch.Tensor) -> torch.Tensor:
    """``y[s, r] = sum_k data[s,r,k] * x[s, col[s,r,k]]`` for stacked
    ``x`` (S, R), or the SpMM for an (S, R, r) block. Padding (data=0,
    col=0) is free."""
    S, R, k = block.data.shape
    r = _nrhs(x)
    b = block.data.element_size()
    mat_bytes = float(R * k * (b + block.col.element_size()))
    trace.record_op(
        "ell_spmm" if r > 1 else "ell_matvec",
        OpCounts(
            flops=2.0 * R * k * max(r, 1),
            hbm_bytes=mat_bytes + float(x.shape[1] + R) * max(r, 1) * b,
            hbm_matrix_bytes=mat_bytes,
        ),
    )
    return _ell_product(block, x)


def hyb_matvec(block: HYBBlock, x: torch.Tensor) -> torch.Tensor:
    """HYB interior matvec: the ELL prefix's product plus the COO tail's,
    for stacked ``x`` (S, R) or an (S, R, r) block.

    The tail's products ``tail_data * x[tail_col]`` are summed per row by
    the block's :class:`~repro_torch.core.partition.TailPlan` — a fixed
    tree of gathers and sums over the row-sorted tail, then one
    ``index_add_`` with each destination row once — instead of a float
    scatter-add over ``tail_row``: ``tail_row`` repeats within a row, and
    an atomic scatter-add on the card may add a row's products in another
    order on every run, changing the last bits and with them iteration
    counts. Tail padding (data 0, col 0, row 0) is left out. Accounted with
    the bytes this layout moves: ``k_typ`` slots/row with one 4 B index
    each, plus value + (col, row) index pairs for the tail.
    """
    S, R, k = block.data.shape
    T = block.tail_data.shape[1]
    r = _nrhs(x)
    nr = max(r, 1)
    b = block.data.element_size()
    mat_bytes = float(
        R * k * (b + block.col.element_size())
        + T * (b + 2 * block.tail_col.element_size())
    )
    trace.record_op(
        "hyb_spmm" if r > 1 else "hyb_matvec",
        OpCounts(
            flops=2.0 * (R * k + T) * nr,
            hbm_bytes=mat_bytes + float(x.shape[1] + R) * nr * b,
            hbm_matrix_bytes=mat_bytes,
        ),
    )
    y = _ell_product(block, x)
    plan = block.tail_plan
    if not len(plan.rows):
        return y
    g = _gather(x, block.flat_tail_col, (S * T,), r)
    v = g * (block.tail_data.reshape(-1)[:, None] if r else block.tail_data.reshape(-1))
    for idx in plan.levels:
        v = torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))])[idx].sum(1)
    flat = (-1,) + tuple(y.shape[2:])
    out = y.reshape(flat).index_add(0, plan.rows, v[plan.src])
    return out.view(y.shape)


def interior_matvec(interior, x_own: torch.Tensor) -> torch.Tensor:
    """``y_own = A_interior @ x_own`` for the stacked interior block.

    Dispatches on the storage format: ELL and HYB run their gather forms
    here; BCSR runs the dispatch op ``bcsr_spmv`` (``bcsr_spmm`` for a
    column block), which on the card launches the hand-written kernel.
    All formats return the same (S, R) stack within fp tolerance.
    """
    if isinstance(interior, ELLBlock):
        return ell_matvec(interior, x_own)
    if isinstance(interior, HYBBlock):
        return hyb_matvec(interior, x_own)
    if isinstance(interior, BCSRBlock):
        op = kd.ops_for(None)
        fn = op.bcsr_spmm if x_own.dim() == 3 else op.bcsr_spmv
        return fn(
            interior.blocks, interior.bcol, x_own, n_brows=interior.n_brows,
            bpr=interior.bpr, n_out=x_own.shape[1],
        )
    raise TypeError(f"unknown interior block type {type(interior).__name__}")


def boundary_matvec(
    mat: DistMat, x_ext: torch.Tensor, *, src_elems: int | None = None
) -> torch.Tensor:
    """Compact boundary-block matvec: ``yb[s, j] = sum_k data_ext[s,j,k] *
    x_ext[s, col_ext[s,j,k]]`` -> (S, B).

    ``x_ext`` is the stacked ``(S, ext_len)`` extended vector (ring mode) or
    the gathered ``(S*R,)`` vector every shard reads (allgather mode).
    ``src_elems`` is the number of distinct gatherable source elements per
    shard (the halo length for the ring layouts); the default bounds it by
    the entry count, as in the JAX package.
    """
    data_bnd = mat.data_ext
    S, B, k_ext = data_bnd.shape
    b = data_bnd.element_size()
    per_shard = B * k_ext
    ring = mat.plan.mode == "ring"
    r = _nrhs(x_ext, 2 if ring else 1)
    nr = max(r, 1)
    ext_len = x_ext.shape[1] if ring else x_ext.shape[0]
    if src_elems is None:
        src_elems = min(ext_len, per_shard)
    mat_bytes = float(per_shard * (b + mat.col_ext.element_size()))
    trace.record_op(
        "bnd_spmm" if r > 1 else "bnd_matvec",
        OpCounts(
            flops=2.0 * per_shard * nr,
            hbm_bytes=mat_bytes
            + float(min(int(src_elems), per_shard) * nr * b + B * (2 * b * nr + 4)),
            hbm_matrix_bytes=mat_bytes,
        ),
    )
    g = _gather(x_ext, mat.flat_col_ext, data_bnd.shape, r)
    if not r:
        return (data_bnd * g).sum(-1)
    return (data_bnd[..., None] * g).sum(-2)


def _scatter_boundary(mat: DistMat, y: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """``y[s, bnd_rows[s, j]] += yb[s, j]`` (padding rows add exact zeros)."""
    flat = (-1,) + tuple(y.shape[2:])
    out = y.reshape(flat).index_add(0, mat.flat_bnd_rows, yb.reshape(flat))
    return out.view(y.shape)


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def _halo_exchange(x: torch.Tensor, mat: DistMat) -> torch.Tensor:
    """Ring halo exchange body (records counts in the *caller's* region).

    Every shard's send selection is gathered at once; receive buffer ``k``
    of shard ``i`` is the selection shard ``i + shifts[k]`` sent, i.e. the
    gathered block shifted by ``shifts[k]`` along the shard axis, with zeros
    where ``i + shifts[k]`` falls off the ring. Returns ``(S, sum(widths))``
    (``(S, sum(widths), r)`` for column blocks: r-wide rows, so the payload
    scales with ``r`` over the same number of launches).
    """
    plan: HaloPlan = mat.plan
    r = _nrhs(x)
    trace.record_op(
        "halo_exchange",
        OpCounts(
            ici_bytes=float(
                plan.collective_bytes_per_shard(x.element_size() * max(r, 1))
            ),
            n_collectives=float(len(plan.shifts)),
        ),
    )
    S = x.shape[0]
    W = sum(plan.widths)
    if not W:
        return x.new_zeros((S, 0) + tuple(x.shape[2:]))
    sent = _gather(x, mat.flat_send, (S, mat.send_sel.shape[1]), r)
    halo = x.new_zeros((S, W) + tuple(x.shape[2:]))
    off = 0
    for d, w in zip(plan.shifts, plan.widths):
        if abs(d) < S:
            src = sent[:, off : off + w]
            if d >= 0:
                halo[: S - d, off : off + w] = src[d:]
            else:
                halo[-d:, off : off + w] = src[: S + d]
        off += w
    return halo


def halo_exchange(x: torch.Tensor, mat: DistMat) -> torch.Tensor:
    """Ring halo exchange attributed to the ``"halo"`` region (the
    serialized path); the overlapped SpMV calls :func:`_halo_exchange`
    directly so the exchange lands in its ``"overlap"`` region."""
    with trace.region("halo"):
        return _halo_exchange(x, mat)


def gather_ext(mat: DistMat, x: torch.Tensor) -> torch.Tensor:
    """The external-vector buffer: ``(S, ext_len)`` in ring mode, the
    gathered ``(S*R,)`` vector in allgather mode (``(S, ext_len, r)`` and
    ``(S*R, r)`` for column blocks)."""
    if mat.plan.mode == "ring":
        return torch.cat([x, halo_exchange(x, mat)], dim=1)
    # allgather mode: padded-global layout owner*R + local — exactly the
    # flattened stack of the padded shard vectors
    with trace.region("halo"):
        trace.record_op(
            "allgather",
            OpCounts(
                ici_bytes=float(
                    mat.plan.collective_bytes_per_shard(
                        x.element_size() * max(_nrhs(x), 1)
                    )
                ),
                n_collectives=1.0,
            ),
        )
        return x.reshape((-1,) + tuple(x.shape[2:]))


# ---------------------------------------------------------------------------
# Distributed SpMV
# ---------------------------------------------------------------------------


_OVERLAP_DEFAULT = True


@contextlib.contextmanager
def overlap_default(on: bool):
    """Scoped default for :func:`spmv_shard`'s ``overlap``."""
    global _OVERLAP_DEFAULT
    prev = _OVERLAP_DEFAULT
    _OVERLAP_DEFAULT = bool(on)
    try:
        yield
    finally:
        _OVERLAP_DEFAULT = prev


def spmv_shard(mat: DistMat, x: torch.Tensor, *, overlap: bool | None = None) -> torch.Tensor:
    """``y = A @ x`` for the stacked ``(S, R)`` vector ``x`` (or the SpMM
    for an ``(S, R, r)`` block), via the interior/boundary row-block split.

    ``overlap=True`` (ring layouts with a real exchange): the halo
    exchange, the interior matvec and the boundary scatter-add, all in the
    ``"overlap"`` energy region. ``overlap=False`` (and the allgather /
    single-shard layouts): gather ``x_ext`` fully (region ``"halo"``), then
    multiply both blocks.
    """
    if overlap is None:
        overlap = _OVERLAP_DEFAULT
    ring = mat.plan.mode == "ring" and len(mat.plan.shifts) > 0
    if overlap and ring:
        with trace.region(trace.OVERLAP):
            halo = _halo_exchange(x, mat)
            y = interior_matvec(mat.interior, x)
            x_ext = torch.cat([x, halo], dim=1)
            yb = boundary_matvec(mat, x_ext, src_elems=halo.shape[1])
            return _scatter_boundary(mat, y, yb)
    x_ext = gather_ext(mat, x)
    y = interior_matvec(mat.interior, x)
    # ring: the boundary gathers touch only the received halo buffers
    src = x_ext.shape[1] - x.shape[1] if ring else None
    yb = boundary_matvec(mat, x_ext, src_elems=src)
    return _scatter_boundary(mat, y, yb)


def make_spmv(mat: DistMat, *, overlap: bool = True):
    """``spmv(x) -> A @ x`` on stacked ``(S, R)`` vectors (``mat``'s device)."""

    def spmv(x: torch.Tensor) -> torch.Tensor:
        return spmv_shard(mat, x, overlap=overlap)

    return spmv
