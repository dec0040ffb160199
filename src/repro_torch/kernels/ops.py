"""Public entry points of the port's hand-written kernels (port of
``repro.kernels.ops``).

The JAX package's wrappers take ``interpret`` (Pallas interpret mode off
the TPU); here the device decides: a CUDA tensor launches the Hopper kernel
and a CPU tensor runs its plain version from :mod:`kernels.ref`
(re-exported), so there is no such argument. The stencil kernels take one
``(nz, ny, nx)`` grid, as in the JAX package, or ``(S, nz, ny, nx)``
stacked slabs; the fused vector kernels take ``(n,)`` vectors or stacked
``(S, R)`` ones and return per-shard partials.
"""

from __future__ import annotations

from repro_torch.core.sparse import pack_bcsr  # noqa: F401
from repro_torch.kernels import ref  # noqa: F401  (re-exported oracle module)
from repro_torch.kernels.fused_reductions import (  # noqa: F401
    fused_axpy,
    fused_axpy2,
    fused_axpy2_dots,
    fused_dots_n,
)
from repro_torch.kernels.jacobi_stencil import jacobi_stencil_sweep  # noqa: F401
from repro_torch.kernels.spmv_bcsr import bcsr_spmv  # noqa: F401
from repro_torch.kernels.spmv_stencil import (  # noqa: F401
    pick_bz,
    stencil_spmv,
    stencil_spmv_boundary,
    stencil_spmv_halo,
)
