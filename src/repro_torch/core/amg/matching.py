"""Weighted graph matching for AMG aggregation (port of
``repro.core.amg.matching``).

Two weightings:

* ``compatible`` — BootCMatch's compatible weighted matching: for a smooth
  vector ``w`` (default: ones), edge (i, j) gets

      c_ij = 1 - (2 a_ij w_i w_j) / (a_ii w_i^2 + a_jj w_j^2)

  so pairs that a pointwise smoother handles badly get aggregated;
* ``plain`` — |a_ij| (strength of connection only), the AmgX-analog
  baseline: same aggregate sizes and cycle cost, weaker convergence.

The matching is the **locally-dominant** algorithm the GPU library uses:
every unmatched vertex points at its heaviest unmatched neighbour, and
mutual pairs are matched, round after round. :func:`locally_dominant_matching`
runs it in torch on the setup's device (the JAX package's
``locally_dominant_matching_jax``); :func:`locally_dominant_matching_np`
is the host version, kept as its oracle. Both break ties the same way and
give the same ``match`` array. The AmgX analog's scan-order matcher is
sequential by construction and stays on the host.

:func:`weights_to_ell` is vectorised: the JAX package fills the ELL rows one
by one, which takes seconds per call at the sizes the port runs on the card;
this gives the same arrays, byte for byte.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

# ---------------------------------------------------------------------------
# Edge weights
# ---------------------------------------------------------------------------


def compatible_weights(a_csr, w: np.ndarray | None = None):
    """Return CSR-like weight matrix (same sparsity, off-diag only).

    c_ij = 1 - 2 a_ij w_i w_j / (a_ii w_i^2 + a_jj w_j^2).
    """
    a = a_csr.tocsr()
    n = a.shape[0]
    w = np.ones(n) if w is None else np.asarray(w, dtype=np.float64)
    d = a.diagonal() * w * w  # a_ii w_i^2
    coo = a.tocoo()
    off = coo.row != coo.col
    r, c, v = coo.row[off], coo.col[off], coo.data[off]
    denom = d[r] + d[c]
    denom = np.where(np.abs(denom) < 1e-300, 1e-300, denom)
    cw = 1.0 - (2.0 * v * w[r] * w[c]) / denom
    return sp.csr_matrix((cw, (r, c)), shape=(n, n))


def plain_weights(a_csr):
    """AmgX-analog strength weights: |a_ij| off-diagonal."""
    a = a_csr.tocoo()
    off = a.row != a.col
    return sp.csr_matrix(
        (np.abs(a.data[off]), (a.row[off], a.col[off])), shape=a.shape
    )


# ---------------------------------------------------------------------------
# ELL padding of a weight matrix (shared by the matchers)
# ---------------------------------------------------------------------------


def weights_to_ell(w_csr):
    """(wdata (n,k), wcol (n,k) int32); padded slots weight=-inf, col=self."""
    w = w_csr.tocsr()
    n = w.shape[0]
    counts = np.diff(w.indptr)
    k = max(int(counts.max()) if n else 0, 1)
    wdata = np.full((n, k), -np.inf)
    wcol = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k))
    rows = np.repeat(np.arange(n), counts)
    slot = np.arange(int(w.indptr[-1])) - np.repeat(w.indptr[:-1], counts)
    wdata[rows, slot] = w.data[: len(rows)]
    wcol[rows, slot] = w.indices[: len(rows)]
    return wdata, wcol


# ---------------------------------------------------------------------------
# Locally-dominant matching
# ---------------------------------------------------------------------------


def locally_dominant_matching_np(wdata: np.ndarray, wcol: np.ndarray) -> np.ndarray:
    """match[i] = partner of i, or i if unmatched. Deterministic.

    Ties are broken toward the smaller column index (achieved by a tiny
    index-dependent perturbation identical in the torch version).
    """
    n, k = wdata.shape
    eps = 1e-12
    wd = wdata - eps * wcol  # deterministic tie-break
    match = np.arange(n, dtype=np.int64)
    unmatched = np.ones(n, dtype=bool)
    for _ in range(64):  # converges in O(log n) rounds in practice
        # candidate: heaviest unmatched neighbor of each unmatched vertex
        avail = unmatched[wcol] & (wcol != np.arange(n)[:, None])
        masked = np.where(avail, wd, -np.inf)
        best_slot = np.argmax(masked, axis=1)
        has = masked[np.arange(n), best_slot] > -np.inf
        cand = np.where(has & unmatched, wcol[np.arange(n), best_slot], np.arange(n))
        mutual = (cand[cand] == np.arange(n)) & (cand != np.arange(n))
        if not mutual.any():
            break
        match = np.where(mutual, cand, match)
        unmatched = unmatched & ~mutual
    return match


def locally_dominant_matching(wdata: np.ndarray, wcol: np.ndarray, device="cpu") -> np.ndarray:
    """The locally-dominant matcher in torch on ``device``: the same rounds,
    tie-break (``1e-12 * wcol``, first-index ``argmax``) and 64-round cap
    as :func:`locally_dominant_matching_np`, and the same ``match`` array
    (int64, on the host). Each round reads one flag back to the host (its
    loop test), as the numpy version does."""
    dev = torch.device(device)
    wc = torch.as_tensor(wcol, device=dev).long()
    # the two roundings of the numpy version: eps * wcol, then the subtraction
    wd = torch.as_tensor(wdata, dtype=torch.float64, device=dev) - wc.double() * 1e-12
    n = wd.shape[0]
    idx = torch.arange(n, device=dev)
    not_self = wc != idx[:, None]
    neg_inf = torch.tensor(-torch.inf, dtype=torch.float64, device=dev)
    match = idx.clone()
    unmatched = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(64):
        avail = unmatched[wc] & not_self
        masked = torch.where(avail, wd, neg_inf)
        best_slot = masked.argmax(dim=1, keepdim=True)
        has = masked.gather(1, best_slot)[:, 0] > -torch.inf
        cand = torch.where(has & unmatched, wc.gather(1, best_slot)[:, 0], idx)
        mutual = (cand[cand] == idx) & (cand != idx)
        if not bool(mutual.any()):
            break
        match = torch.where(mutual, cand, match)
        unmatched &= ~mutual
    return match.cpu().numpy()


def greedy_scan_matching_np(wdata: np.ndarray, wcol: np.ndarray) -> np.ndarray:
    """Scan-order greedy matching (the AmgX plain-aggregation analog).

    Visits vertices in index order and pairs each unmatched vertex with its
    strongest still-unmatched neighbor — commits early, so it produces
    lower-weight matchings than the locally-dominant algorithm when edge
    weights vary. Sequential by construction (host setup only); the rows'
    candidates are sorted once with numpy and walked as Python lists.
    """
    n, k = wdata.shape
    order = np.argsort(-wdata, axis=1, kind="stable")
    cols = np.take_along_axis(wcol, order, axis=1)
    # a row's scan stops at its first -inf slot (the padding sorts last)
    live = np.cumprod(np.take_along_axis(wdata, order, axis=1) != -np.inf, axis=1)
    cands = [row[: int(m)] for row, m in zip(cols.tolist(), live.sum(axis=1).tolist())]
    match = list(range(n))
    unmatched = [True] * n
    for i in range(n):
        if not unmatched[i]:
            continue
        for j in cands[i]:
            if j != i and unmatched[j]:
                match[i] = j
                match[j] = i
                unmatched[i] = unmatched[j] = False
                break
    return np.asarray(match, dtype=np.int64)
