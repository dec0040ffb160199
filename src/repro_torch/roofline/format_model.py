"""Stored-bytes / traffic cost model for the DistMat interior formats.

The paper's central lever is minimizing data movement: on memory-bound
sparse kernels, the bytes a format keeps resident (and therefore streams on
every SpMV) are the time *and* energy proxy. This module scores the three
interior layouts of ``core/partition.py`` — ELL, HYB, BCSR — on the host
row-length / block statistics available at partition time, in the same
counting conventions as the rest of the roofline layer (8 B values, 4 B
int32 local indices; cf. ``roofline/analysis.cg_vector_traffic`` and
``energy/accounting.spmv_counts``):

* ELL   — ``R * max_row_nnz`` slots, one 4 B column id per slot. One long
  row pads every row.
* HYB   — an ELL prefix of ``k_typ`` slots/row plus a COO tail (value +
  (col, row) id pair = 16 B/entry) for the overflow of rows longer than
  ``k_typ``. :func:`hyb_split` picks the ``k_typ`` minimizing the total.
* BCSR  — dense (br, bc) tiles in the uniform blocks-per-row kernel layout:
  ``n_brows * bpr`` blocks of ``br*bc`` values + ONE 4 B id per block
  (the index-traffic win), zero fill inside partial tiles (the price).

``choose_format`` resolves ``fmt="auto"``: it picks the candidate with the
smallest modeled SpMV traffic (stored bytes + the format-independent vector
read/write term), so by construction auto never selects a layout storing
more bytes than ELL.

The port's copy of ``repro.roofline.format_model``, numpy only and
unchanged, so ``fmt="auto"`` resolves the format the JAX package resolves.
"""

from __future__ import annotations

import dataclasses

import numpy as np

VALUE_BYTES = 8
INDEX_BYTES = 4


@dataclasses.dataclass(frozen=True)
class FormatCost:
    """Modeled cost of storing one distributed interior in one format."""

    fmt: str
    stored_bytes: int  # values + indices resident in HBM, all shards
    traffic_bytes: int  # bytes one distributed SpMV streams (all shards)
    params: dict  # format-specific packing parameters


def spmv_traffic_bytes(
    stored_bytes: int, n_rows: int, n_shards: int, value_bytes: int = VALUE_BYTES
) -> int:
    """Bytes one SpMV streams: the stored matrix once + the source vector
    read and the result written per shard (``cg_vector_traffic``-style
    stream counting; the halo term is format-independent and omitted)."""
    return int(stored_bytes + 2 * n_rows * n_shards * value_bytes)


def ell_cost(
    shard_row_lens, n_rows: int, *, value_bytes: int = VALUE_BYTES
) -> FormatCost:
    """``shard_row_lens``: per shard, the interior nnz of each local row;
    ``n_rows`` the padded rows per shard (R = n_own_pad)."""
    k = max((int(np.max(lens)) if len(lens) else 0 for lens in shard_row_lens),
            default=0)
    k = max(k, 1)
    S = len(shard_row_lens)
    stored = S * n_rows * k * (value_bytes + INDEX_BYTES)
    return FormatCost(
        "ell", stored, spmv_traffic_bytes(stored, n_rows, S, value_bytes),
        {"k": k},
    )


def hyb_split(
    row_lens, *, n_rows: int, value_bytes: int = VALUE_BYTES
) -> tuple[int, int]:
    """Optimal ELL-prefix width for a pooled row-length distribution.

    Returns ``(k_typ, stored_bytes)`` minimizing
    ``n_rows * k * (vb + 4) + tail(k) * (vb + 8)`` over ``k`` in
    ``[0, max_row_nnz]``, where ``tail(k) = sum(max(len - k, 0))`` — the
    exact byte count of the HYBBlock layout (per-shard tail padding not
    included; it is second-order and bounded by S-1 entries per slot row).
    """
    lens = np.asarray(row_lens, np.int64)
    kmax = int(lens.max()) if lens.size else 0
    if kmax == 0:
        return 1, n_rows * (value_bytes + INDEX_BYTES)
    ks = np.arange(kmax + 1, dtype=np.int64)
    # tail(k) via the sorted suffix: tail(k) = sum_{l > k} (l - k)
    sorted_lens = np.sort(lens)
    suffix_sum = np.cumsum(sorted_lens[::-1])[::-1]
    idx = np.searchsorted(sorted_lens, ks, side="right")
    n_longer = lens.size - idx
    tail = np.where(
        n_longer > 0, suffix_sum[np.minimum(idx, lens.size - 1)] - ks * n_longer, 0
    )
    cost = n_rows * ks * (value_bytes + INDEX_BYTES) + tail * (
        value_bytes + 2 * INDEX_BYTES
    )
    # clamp to the packed layout's minimum prefix of 1 slot/row, and price
    # the tail at the *clamped* k so the return is the exact layout bytes
    k_typ = max(int(ks[np.argmin(cost)]), 1)  # kmax >= 1 here, so k_typ <= kmax
    return k_typ, int(cost[k_typ])


def hyb_cost(
    shard_row_lens, n_rows: int, *, value_bytes: int = VALUE_BYTES
) -> FormatCost:
    pooled = np.concatenate(
        [np.asarray(lens, np.int64) for lens in shard_row_lens]
    ) if shard_row_lens else np.zeros(0, np.int64)
    S = len(shard_row_lens)
    # same pooled-distribution call the packer makes, so the k_typ priced
    # here is the k_typ actually packed
    k_typ, _ = hyb_split(
        pooled, n_rows=n_rows * S, value_bytes=value_bytes
    )
    # rebuild the stored size exactly: S shards of ELL prefix + the tail
    # padded to the max per-shard tail length (the stacked (S, T) layout)
    tails = [
        int(np.maximum(np.asarray(lens, np.int64) - k_typ, 0).sum())
        for lens in shard_row_lens
    ]
    T = max(max(tails, default=0), 1)
    stored = S * (
        n_rows * k_typ * (value_bytes + INDEX_BYTES)
        + T * (value_bytes + 2 * INDEX_BYTES)
    )
    return FormatCost(
        "hyb", stored, spmv_traffic_bytes(stored, n_rows, S, value_bytes),
        {"k_typ": k_typ, "tail": tails},
    )


def bcsr_cost(
    shard_blocks, n_rows: int, *, br: int = 4, bc: int = 4,
    value_bytes: int = VALUE_BYTES,
) -> FormatCost:
    """``shard_blocks``: per shard, ``(n_blocks, max_blocks_per_block_row)``
    of the interior (``partition._shard_block_stats``)."""
    S = len(shard_blocks)
    n_brows = -(-n_rows // br)
    bpr = max((b for _, b in shard_blocks), default=0)
    bpr = max(bpr, 1)
    stored = S * n_brows * bpr * (br * bc * value_bytes + INDEX_BYTES)
    return FormatCost(
        "bcsr", stored, spmv_traffic_bytes(stored, n_rows, S, value_bytes),
        {"n_brows": n_brows, "bpr": bpr, "br": br, "bc": bc},
    )


def format_costs(
    shard_row_lens, *, n_rows: int, shard_blocks=None, br: int = 4,
    bc: int = 4, value_bytes: int = VALUE_BYTES,
) -> dict[str, FormatCost]:
    """All candidate costs for one partitioned interior (keyed by format)."""
    out = {
        "ell": ell_cost(shard_row_lens, n_rows, value_bytes=value_bytes),
        "hyb": hyb_cost(shard_row_lens, n_rows, value_bytes=value_bytes),
    }
    if shard_blocks is not None:
        out["bcsr"] = bcsr_cost(
            shard_blocks, n_rows, br=br, bc=bc, value_bytes=value_bytes
        )
    return out


def choose_format(
    shard_row_lens, *, n_rows: int, shard_blocks=None, br: int = 4,
    bc: int = 4, value_bytes: int = VALUE_BYTES,
) -> tuple[str, FormatCost]:
    """Resolve ``fmt="auto"``: the candidate with the least modeled SpMV
    traffic. Ties break toward ELL (the simplest kernel), then HYB.

    ELL is always a candidate, so the winner never stores more bytes than
    ELL — the invariant the property tests pin down.
    """
    costs = format_costs(
        shard_row_lens, n_rows=n_rows, shard_blocks=shard_blocks, br=br,
        bc=bc, value_bytes=value_bytes,
    )
    order = {"ell": 0, "hyb": 1, "bcsr": 2}
    fmt = min(costs, key=lambda f: (costs[f].traffic_bytes, order[f]))
    return fmt, costs[fmt]
