"""Galerkin triple product A_c = P^T A P and the l1-Jacobi diagonal (host
setup, scipy) — port of ``repro.core.amg.galerkin``, unchanged.

The paper's library computes the RAP on the device; here, as in the JAX
package, the setup runs it on the host with scipy, while the solve phase
(SpMVs, smoothing, cycling) runs on the device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def rap(a_csr, p_csr) -> sp.csr_matrix:
    ac = (p_csr.T @ (a_csr @ p_csr)).tocsr()
    ac.sum_duplicates()
    # Drop numerically-zero fill to keep ELL widths tight.
    ac.data[np.abs(ac.data) < 1e-300] = 0.0
    ac.eliminate_zeros()
    return ac


def l1_diagonal(a_csr) -> np.ndarray:
    """l1-Jacobi diagonal: d_i = a_ii + sum_{j != i} |a_ij|.

    Guaranteed-convergent Jacobi scaling for SPD matrices (the paper's
    smoother choice: 4 l1-Jacobi sweeps in the V-cycle).
    """
    a = a_csr.tocsr()
    diag = a.diagonal()
    absrow = np.abs(a).sum(axis=1)
    absrow = np.asarray(absrow).ravel()
    return diag + (absrow - np.abs(diag))
