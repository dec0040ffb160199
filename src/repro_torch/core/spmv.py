"""Distributed SpMV + halo exchange over the stacked shard layout.

Port of the ELL / 1-D ring path of ``repro.core.spmv``. Every shard lives
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

The ELL matvec is a gather + reduction in PyTorch, as it is a ``jnp``
gather in the JAX package (no Pallas kernel). Counts are recorded per
shard, with the per-shard sizes the JAX package's local blocks have.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core.partition import DistMat, ELLBlock, HaloPlan
from repro_torch.energy import trace
from repro_torch.energy.accounting import OpCounts


def _gather(x: torch.Tensor, flat_idx: torch.Tensor, shape) -> torch.Tensor:
    return x.reshape(-1).index_select(0, flat_idx).view(shape)


def ell_matvec(block: ELLBlock, x: torch.Tensor) -> torch.Tensor:
    """``y[s, r] = sum_k data[s,r,k] * x[s, col[s,r,k]]`` for stacked
    ``x`` (S, R). Padding (data=0, col=0) is free."""
    data = block.data
    S, R, k = data.shape
    b = data.element_size()
    mat_bytes = float(R * k * (b + block.col.element_size()))
    trace.record_op(
        "ell_matvec",
        OpCounts(
            flops=2.0 * R * k,
            hbm_bytes=mat_bytes + float(x.shape[-1] + R) * b,
            hbm_matrix_bytes=mat_bytes,
        ),
    )
    return (data * _gather(x, block.flat_col, data.shape)).sum(-1)


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
    ext_len = x_ext.shape[-1]
    if src_elems is None:
        src_elems = min(ext_len, per_shard)
    mat_bytes = float(per_shard * (b + mat.col_ext.element_size()))
    trace.record_op(
        "bnd_matvec",
        OpCounts(
            flops=2.0 * per_shard,
            hbm_bytes=mat_bytes
            + float(min(int(src_elems), per_shard) * b + B * (2 * b + 4)),
            hbm_matrix_bytes=mat_bytes,
        ),
    )
    return (data_bnd * _gather(x_ext, mat.flat_col_ext, data_bnd.shape)).sum(-1)


def _scatter_boundary(mat: DistMat, y: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """``y[s, bnd_rows[s, j]] += yb[s, j]`` (padding rows add exact zeros)."""
    out = y.reshape(-1).index_add(0, mat.flat_bnd_rows, yb.reshape(-1))
    return out.view(y.shape)


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def _halo_exchange(x: torch.Tensor, mat: DistMat) -> torch.Tensor:
    """Ring halo exchange body (records counts in the *caller's* region).

    Every shard's send selection is gathered at once; receive buffer ``k``
    of shard ``i`` is the selection shard ``i + shifts[k]`` sent, i.e. the
    gathered block shifted by ``shifts[k]`` along the shard axis, with zeros
    where ``i + shifts[k]`` falls off the ring. Returns ``(S, sum(widths))``.
    """
    plan: HaloPlan = mat.plan
    trace.record_op(
        "halo_exchange",
        OpCounts(
            ici_bytes=float(plan.collective_bytes_per_shard(x.element_size())),
            n_collectives=float(len(plan.shifts)),
        ),
    )
    S = x.shape[0]
    W = sum(plan.widths)
    if not W:
        return x.new_zeros((S, 0))
    sent = _gather(x, mat.flat_send, (S, mat.send_sel.shape[1]))
    halo = x.new_zeros((S, W))
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
    gathered ``(S*R,)`` vector in allgather mode."""
    if mat.plan.mode == "ring":
        return torch.cat([x, halo_exchange(x, mat)], dim=1)
    # allgather mode: padded-global layout owner*R + local — exactly the
    # flattened stack of the padded shard vectors
    with trace.region("halo"):
        trace.record_op(
            "allgather",
            OpCounts(
                ici_bytes=float(
                    mat.plan.collective_bytes_per_shard(x.element_size())
                ),
                n_collectives=1.0,
            ),
        )
        return x.reshape(-1)


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
    """``y = A @ x`` for the stacked ``(S, R)`` vector ``x``, via the
    interior/boundary row-block split.

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
            y = ell_matvec(mat.interior, x)
            x_ext = torch.cat([x, halo], dim=1)
            yb = boundary_matvec(mat, x_ext, src_elems=halo.shape[1])
            return _scatter_boundary(mat, y, yb)
    x_ext = gather_ext(mat, x)
    y = ell_matvec(mat.interior, x)
    # ring: the boundary gathers touch only the received halo buffers
    src = x_ext.shape[-1] - x.shape[-1] if ring else None
    yb = boundary_matvec(mat, x_ext, src_elems=src)
    return _scatter_boundary(mat, y, yb)


def make_spmv(mat: DistMat, *, overlap: bool = True):
    """``spmv(x) -> A @ x`` on stacked ``(S, R)`` vectors (``mat``'s device)."""

    def spmv(x: torch.Tensor) -> torch.Tensor:
        return spmv_shard(mat, x, overlap=overlap)

    return spmv
