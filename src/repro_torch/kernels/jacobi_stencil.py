"""Launch wrapper of the hand-written Hopper fused stencil l1-Jacobi sweep.

Port of ``repro.kernels.jacobi_stencil``. One smoothing sweep is
``x <- x + omega * dinv * (b - A x)``; composed from separate ops it streams
x twice plus b and dinv and writes ``A x`` and ``x_new``. The kernel
(``st_jacobi_*`` in ``csrc/spmv_stencil.cu``, forming ``A x`` by the SpMV
kernels' operations in their order) does the whole sweep in one pass: it reads x,
b and dinv once and writes ``x_new``. On a CPU tensor the wrapper runs the
plain version from ``kernels/ref.py`` — the only reason it ever does so;
it counts its launches in ``jacobi_stencil_sweep.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import spmv_stencil as st


def jacobi_stencil_sweep(x, b, dinv, *, stencil="7pt", aniso=(1.0, 1.0, 1.0), omega=1.0,
                         bz=8):
    """One fused damped l1-Jacobi sweep on the ``(nz, ny, nx)`` grid (or
    ``(S, nz, ny, nx)`` stacked grids): ``x + omega * dinv * (b - A x)``
    with zero Dirichlet edges; ``b`` and ``dinv`` of ``x``'s shape,
    ``nz % bz == 0``."""
    S, nz, ny, nx = st.grid_shape("jacobi_stencil_sweep", x)
    st.check_bz(nz, bz)
    st.check_operands("jacobi_stencil_sweep", x, (b, dinv), (x.shape, x.shape))
    if x.device.type != "cuda":
        return ref.jacobi_sweep_ref(x, b, dinv, stencil=stencil, aniso=aniso, omega=omega)
    y = torch.empty_like(x)
    fn = getattr(st._lib(), f"st_jacobi_{st._SUFFIX[x.dtype]}")
    _build.check(fn(x.data_ptr(), b.data_ptr(), dinv.data_ptr(), y.data_ptr(), S, nz, ny, nx,
                    *st.coef_args(stencil, aniso, x.dtype), ref._round(omega, x.dtype),
                    st.stream(x)), "jacobi_stencil_sweep")
    jacobi_stencil_sweep.launches += 1
    return y


jacobi_stencil_sweep.launches = 0

#: The kernel of this module: what it replaces and what bounds it.
KERNELS = {
    "jacobi_stencil_sweep": dict(
        wrapper=jacobi_stencil_sweep, plain=ref.jacobi_sweep_ref, source=st.SOURCE,
        replaces="src/repro/kernels/jacobi_stencil.py:56",
        bound_by="bytes",  # x, b, dinv in, x_new out; 2k + 4 flops per 32 bytes (f64)
    ),
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def launches() -> dict[str, int]:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}
