"""AmgX-analog AMG baseline (port of ``repro.core.amg.baseline``).

The paper configures NVIDIA AmgX "with the matching-based aggregation
preconditioner, using aggregates of size 8, as in BootCMatchGX", the same
4-sweep l1-Jacobi smoother, and default hierarchy settings — so the PCG gap
it reports comes from the *quality* of the aggregation, not the cycle
structure. The analog is therefore ``build_amg`` with plain strength
weights and the scan-order matcher.
"""

from __future__ import annotations

from repro_torch.core.amg.hierarchy import AMGParams, make_amg_preconditioner


def build_amgx_analog(a_csr, n_shards: int, params: AMGParams | None = None, **kw):
    return make_amg_preconditioner(
        a_csr, n_shards, params, amgx_analog=True, **kw
    )
