"""Launch wrappers of the hand-written Hopper matrix-free stencil kernels.

Port of ``repro.kernels.spmv_stencil``. The kernels live in
``csrc/spmv_stencil.cu`` (CUDA C++ for ``sm_90a``), built by
``kernels/_build.py`` and called through ctypes. :func:`stencil_spmv` and
:func:`stencil_spmv_halo` run one z-marching kernel, :func:`stencil_spmv_boundary`
a kernel of staged edge-plane tiles, and ``kernels/jacobi_stencil.py``'s
sweep a kernel of one thread per point; all four form each output by the
same rounded operations in the same order, so they agree bit for bit. The
operator is the 7-point (``aniso = (ax, ay, az)``) or 27-point Poisson
stencil with homogeneous Dirichlet x/y edges:

* :func:`stencil_spmv` — one ``(nz, ny, nx)`` grid with zero z-edges (or
  ``(S, nz, ny, nx)`` stacked grids, each its own);
* :func:`stencil_spmv_halo` — the local-slab product of the distributed
  operator: ``(nz, ny, nx)`` with ``(ny, nx)`` previous/next halo planes,
  or S stacked slabs ``(S, nz, ny, nx)`` with ``(S, ny, nx)`` planes;
* :func:`stencil_spmv_boundary` — output planes 0 and ``nz - 1`` of the
  slab product only (``nz >= 2``): the overlapped SpMV's fix-up once the
  halo planes arrive, bitwise equal to the slab kernel's planes. With
  ``out=`` it writes them into a full slab result in place.

``bz`` is the JAX package's z-block size and keeps its check
(``nz % bz == 0``, :func:`pick_bz`); the CUDA kernels choose their own
tiling. Each wrapper launches its kernel on a CUDA tensor (checking the
launch) and runs its plain version from ``kernels/ref.py`` on a CPU tensor
— the only reason it ever does so — and counts its launches in
``<wrapper>.launches``. The stencil coefficients are rounded to the working
type on the host before the launch, as the JAX package forms them from
Python floats in the array's type.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

SOURCE = "src/repro_torch/kernels/csrc/spmv_stencil.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_C = {"f32": ctypes.c_float, "f64": ctypes.c_double}
_SIGNATURES = {}
for _t, _c in _C.items():
    _SIGNATURES.update({
        f"st_spmv_{_t}": (_P, _P, _L, _L, _L, _L, _I, _c, _c, _c, _c, _P),
        f"st_halo_{_t}": (_P, _P, _P, _P, _L, _L, _L, _L, _I, _c, _c, _c, _c, _P),
        f"st_boundary_{_t}": (_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _I,
                              _c, _c, _c, _c, _P),
        f"st_jacobi_{_t}": (_P, _P, _P, _P, _L, _L, _L, _L, _I, _c, _c, _c, _c, _c, _P),
    })
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _lib():
    """The library of ``csrc/spmv_stencil.cu`` (every entry's signature,
    the sweep's included: the library is loaded once)."""
    return _build.library("spmv_stencil", _SIGNATURES)


def pick_bz(nz: int, target: int = 8) -> int:
    """Largest z-block size <= target that divides nz (>= 1 always works)."""
    for bz in range(min(target, nz), 0, -1):
        if nz % bz == 0:
            return bz
    return 1


def check_bz(nz: int, bz: int) -> None:
    if bz < 1 or nz % bz:
        raise ValueError(f"nz={nz} must be a multiple of bz={bz} (use pick_bz)")


def grid_shape(name: str, x: torch.Tensor) -> tuple[int, int, int, int]:
    """``(S, nz, ny, nx)`` of a ``(nz, ny, nx)`` grid (S = 1) or ``(S, nz,
    ny, nx)`` stacked slabs."""
    if x.dim() not in (3, 4):
        raise ValueError(
            f"{name} expects a (nz, ny, nx) grid or (S, nz, ny, nx) slabs, "
            f"got shape {tuple(x.shape)}"
        )
    S = int(x.shape[0]) if x.dim() == 4 else 1
    nz, ny, nx = (int(v) for v in x.shape[-3:])
    return S, nz, ny, nx


def check_operands(name: str, x: torch.Tensor, others, shapes) -> None:
    """Same dtype and device for every operand, each of its expected
    shape; on the card, float32/float64 and contiguous."""
    for t, shape in zip(others, shapes):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: operands differ in dtype or device")
    if x.device.type == "cuda":
        if x.dtype not in _SUFFIX:
            raise TypeError(f"{name}: the kernel takes float32/float64, got {x.dtype}")
        if not all(t.is_contiguous() for t in (x, *others)):
            raise ValueError(f"{name}: the kernel takes contiguous operands")


def coef_args(stencil: str, aniso, dtype) -> tuple:
    """``(s27, diag, ax, ay, az)`` for a C entry, rounded to ``dtype``."""
    return (int(stencil == "27pt"),) + ref.stencil_coefs(stencil, aniso, dtype)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _halo_shape(x: torch.Tensor) -> tuple:
    return tuple(x.shape[:-3]) + tuple(x.shape[-2:])


def stencil_spmv(x, *, stencil="7pt", aniso=(1.0, 1.0, 1.0), bz=8):
    """``y = A_stencil @ x`` for ``x`` of shape ``(nz, ny, nx)`` (or ``(S,
    nz, ny, nx)`` stacked grids), zero Dirichlet edges; ``nz % bz == 0``."""
    S, nz, ny, nx = grid_shape("stencil_spmv", x)
    check_bz(nz, bz)
    check_operands("stencil_spmv", x, (), ())
    if x.device.type != "cuda":
        return ref.stencil_spmv_ref(x, stencil=stencil, aniso=aniso)
    y = torch.empty_like(x)
    fn = getattr(_lib(), f"st_spmv_{_SUFFIX[x.dtype]}")
    _build.check(fn(x.data_ptr(), y.data_ptr(), S, nz, ny, nx,
                    *coef_args(stencil, aniso, x.dtype), stream(x)), "stencil_spmv")
    stencil_spmv.launches += 1
    return y


def stencil_spmv_halo(x, prev_halo, next_halo, *, stencil="7pt", aniso=(1.0, 1.0, 1.0),
                      bz=8):
    """Local-slab SpMV with explicit z-boundary planes (distributed form).

    ``x`` is the ``(nz_loc, ny, nx)`` slab (or ``(S, nz_loc, ny, nx)``
    stacked slabs); ``prev_halo``/``next_halo`` the ``(ny, nx)`` (``(S, ny,
    nx)``) planes received from the z-neighbours, zeros at the global edges.
    ``nz_loc % bz == 0`` (use :func:`pick_bz`)."""
    S, nz, ny, nx = grid_shape("stencil_spmv_halo", x)
    check_bz(nz, bz)
    hs = _halo_shape(x)
    check_operands("stencil_spmv_halo", x, (prev_halo, next_halo), (hs, hs))
    if x.device.type != "cuda":
        return ref.stencil_halo_ref(x, prev_halo, next_halo, stencil=stencil, aniso=aniso)
    y = torch.empty_like(x)
    fn = getattr(_lib(), f"st_halo_{_SUFFIX[x.dtype]}")
    _build.check(fn(x.data_ptr(), prev_halo.data_ptr(), next_halo.data_ptr(), y.data_ptr(),
                    S, nz, ny, nx, *coef_args(stencil, aniso, x.dtype), stream(x)),
                 "stencil_spmv_halo")
    stencil_spmv_halo.launches += 1
    return y


def stencil_spmv_boundary(x, prev_halo, next_halo, *, stencil="7pt",
                          aniso=(1.0, 1.0, 1.0), out=None):
    """The slab's first and last output planes only (communication hiding).

    ``x`` is the ``(nz_loc, ny, nx)`` slab (``nz_loc >= 2``) or ``(S,
    nz_loc, ny, nx)`` slabs, the halo planes as in
    :func:`stencil_spmv_halo`. Returns ``(2, ny, nx)`` (``(S, 2, ny, nx)``):
    row 0 is output plane 0, row 1 output plane ``nz_loc - 1``, bitwise
    equal to those planes of :func:`stencil_spmv_halo`. With ``out`` (a
    result of ``x``'s shape), writes them there as planes 0 and
    ``nz_loc - 1`` instead — the other planes untouched — and returns
    ``out``."""
    S, nz, ny, nx = grid_shape("stencil_spmv_boundary", x)
    if nz < 2:
        raise ValueError("stencil_spmv_boundary: the boundary split needs at least 2 "
                         f"local z-planes, got nz={nz}")
    hs = _halo_shape(x)
    operands = (prev_halo, next_halo) + (() if out is None else (out,))
    check_operands("stencil_spmv_boundary", x, operands,
                   (hs, hs) + (() if out is None else (tuple(x.shape),)))
    if x.device.type != "cuda":
        yb = ref.stencil_boundary_ref(x, prev_halo, next_halo, stencil=stencil, aniso=aniso)
        if out is None:
            return yb
        out[..., 0, :, :] = yb[..., 0, :, :]
        out[..., nz - 1, :, :] = yb[..., 1, :, :]
        return out
    if out is None:
        y, y_planes, y_last = x.new_empty(hs[:-2] + (2,) + hs[-2:]), 2, 1
    else:
        y, y_planes, y_last = out, nz, nz - 1
    fn = getattr(_lib(), f"st_boundary_{_SUFFIX[x.dtype]}")
    _build.check(fn(x.data_ptr(), prev_halo.data_ptr(), next_halo.data_ptr(), y.data_ptr(),
                    S, nz, ny, nx, y_planes, y_last, *coef_args(stencil, aniso, x.dtype),
                    stream(x)), "stencil_spmv_boundary")
    stencil_spmv_boundary.launches += 1
    return y


stencil_spmv.launches = 0
stencil_spmv_halo.launches = 0
stencil_spmv_boundary.launches = 0

#: The kernels of this module: what each replaces and what bounds it.
KERNELS = {
    "stencil_spmv_halo": dict(
        wrapper=stencil_spmv_halo, plain=ref.stencil_halo_ref, source=SOURCE,
        replaces="src/repro/kernels/spmv_stencil.py:177",
        bound_by="bytes",  # x + 2 halo planes in, y out; 2k flops per 16 bytes (f64)
    ),
    "stencil_spmv_boundary": dict(
        wrapper=stencil_spmv_boundary, plain=ref.stencil_boundary_ref, source=SOURCE,
        replaces="src/repro/kernels/spmv_stencil.py:221",
        bound_by="bytes",  # 6 planes in, 2 out per slab
    ),
    "stencil_spmv": dict(
        wrapper=stencil_spmv, plain=ref.stencil_spmv_ref, source=SOURCE,
        replaces="src/repro/kernels/spmv_stencil.py:131",
        bound_by="bytes",  # x in, y out
    ),
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def launches() -> dict[str, int]:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}
