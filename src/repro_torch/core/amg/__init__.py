"""Algebraic MultiGrid preconditioner via compatible weighted matching
(port of ``repro.core.amg``).

The paper's AMG coarsens by aggregating DOFs with a maximum-weight matching
on a weighted graph derived from the system matrix; aggregates of size 8
come from three composed pairwise matching sweeps per level; the V-cycle
smoother is 4 sweeps of l1-Jacobi; coarsening is decoupled (per shard), so
prolongators never cross shard boundaries and every inter-shard coupling
stays inside the halo-planned level matrices.
"""

from repro_torch.core.amg.hierarchy import (  # noqa: F401
    AMGInfo,
    AMGParams,
    amg_from_numpy,
    build_amg,
    make_amg_preconditioner,
)
