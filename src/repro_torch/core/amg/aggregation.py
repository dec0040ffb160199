"""Aggregation from composed pairwise matchings + tentative prolongator
(port of ``repro.core.amg.aggregation``).

BootCMatch composes ``k`` matching sweeps per AMG level so aggregates reach
size 2^k (k=3 -> 8, the paper's configuration): match the fine graph,
collapse matched pairs into super-vertices, re-match the collapsed graph,
repeat. Unmatched vertices stay as singletons (so sizes are *up to* 2^k).

The prolongator is the compatible-matching tentative operator, one nonzero
per fine row: ``P[i, agg(i)] = w_i / || w|_{agg(i)} ||_2``.

``decoupled_aggregate`` restricts matching to intra-shard edges, which makes
P block-diagonal w.r.t. the row partition, so every AMG level stays a
halo-planned DistMat. Its ``locdom`` matcher runs in torch on the setup's
device (``matching.locally_dominant_matching``); ``scan`` stays on the host.
"""

from __future__ import annotations

import concurrent.futures
import functools
import itertools
import os

import numpy as np
import scipy.sparse as sp

from repro_torch.core.amg.matching import (
    compatible_weights,
    greedy_scan_matching_np,
    locally_dominant_matching,
    locally_dominant_matching_np,
    plain_weights,
    weights_to_ell,
)


def match_to_aggregates(match: np.ndarray) -> np.ndarray:
    """match array -> agg id per vertex (pairs share an id; singletons own).

    Ids are compact 0..n_agg-1, ordered by smallest member.
    """
    n = len(match)
    rep = np.minimum(np.arange(n), match)  # pair representative
    _, agg = np.unique(rep, return_inverse=True)
    return agg


def compose_matchings(w_csr, sweeps: int, weighting_fn, matcher=locally_dominant_matching_np) -> np.ndarray:
    """Run ``sweeps`` matching rounds with graph collapsing; returns agg ids.

    ``w_csr`` is the level matrix A (weights are derived per round from the
    collapsed matrix via ``weighting_fn``).
    """
    a = w_csr.tocsr()
    n = a.shape[0]
    agg = np.arange(n)  # current aggregate id per original vertex
    cur = a
    for _ in range(sweeps):
        m = cur.shape[0]
        if m <= 1:
            break
        w = weighting_fn(cur)
        if w.nnz == 0:
            break
        wdata, wcol = weights_to_ell(w)
        match = matcher(wdata, wcol)
        sub = match_to_aggregates(match)
        agg = sub[agg]
        # collapse: Q (m x m') boolean aggregation, cur' = Q^T cur Q
        mprime = int(sub.max()) + 1
        q = sp.csr_matrix(
            (np.ones(m), (np.arange(m), sub)), shape=(m, mprime)
        )
        cur = (q.T @ cur @ q).tocsr()
    return agg


def tentative_prolongator(agg: np.ndarray, w: np.ndarray | None = None) -> sp.csr_matrix:
    """P (n x n_agg): P[i, agg[i]] = w_i / ||w|_agg||."""
    n = len(agg)
    w = np.ones(n) if w is None else np.asarray(w, np.float64)
    n_agg = int(agg.max()) + 1 if n else 0
    norm2 = np.zeros(n_agg)
    np.add.at(norm2, agg, w * w)
    vals = w / np.sqrt(norm2[agg])
    return sp.csr_matrix((vals, (np.arange(n), agg)), shape=(n, n_agg))


def matcher_for(name: str, device="cpu"):
    """The matcher ``name`` (``locdom`` | ``scan``): the locally-dominant
    one in torch on ``device``, the scan-order one on the host."""
    if name == "locdom":
        return functools.partial(locally_dominant_matching, device=device)
    if name == "scan":
        return greedy_scan_matching_np
    raise ValueError(f"unknown matcher {name!r}; want 'locdom' or 'scan'")


def decoupled_aggregate(
    a_csr,
    row_starts,
    *,
    sweeps: int = 3,
    weighting: str = "compatible",
    smooth_vec: np.ndarray | None = None,
    matcher: str = "locdom",
    device="cpu",
):
    """Per-shard (decoupled) aggregation.

    Returns (P global csr — block-diagonal w.r.t. the partition,
             coarse_row_starts tuple). ``device`` is where the ``locdom``
    matcher runs. The shards run in host threads; their results do not
    depend on the order they finish in.
    """
    a = a_csr.tocsr()
    w_fn = compatible_weights if weighting == "compatible" else plain_weights
    match_fn = matcher_for(matcher, device)
    n_shards = len(row_starts) - 1

    def aggregate(s):
        lo, hi = row_starts[s], row_starts[s + 1]
        agg = compose_matchings(a[lo:hi, lo:hi].tocsr(), sweeps, w_fn, match_fn)
        wv = None if smooth_vec is None else smooth_vec[lo:hi]
        return tentative_prolongator(agg, wv)

    # the shards aggregate independently, one host thread each: numpy,
    # scipy's sparse kernels and the matcher's torch ops release the GIL
    with concurrent.futures.ThreadPoolExecutor(min(n_shards, os.cpu_count() or 1)) as pool:
        blocks = list(pool.map(aggregate, range(n_shards)))
    coarse_starts = tuple(itertools.accumulate((b.shape[1] for b in blocks), initial=0))
    return sp.block_diag(blocks, format="csr"), coarse_starts
