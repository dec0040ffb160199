"""Launch wrappers of the hand-written Hopper BCSR kernels (SpMV and SpMM).

Port of ``repro.kernels.spmv_bcsr``. The kernels live in
``csrc/spmv_bcsr.cu`` (CUDA C++ for ``sm_90a``), built by
``kernels/_build.py`` and called through ctypes. Both take the BCSR
interior of a stacked :class:`~repro_torch.core.partition.DistMat`, in the
uniform blocks-per-row layout of ``core.sparse.pack_bcsr``:

* ``blocks`` ``(S, n_brows*bpr, br, bc)``, ``bcol`` ``(S, n_brows*bpr)``
  int32 — block-row ``i`` of shard ``s`` owns tiles ``[i*bpr, (i+1)*bpr)``,
  padding tiles are zero with ``bcol == 0``;
* ``x`` ``(S, R)`` (``(S, R, r)`` for the SpMM), and the result
  ``(S, n_out)`` (``(S, n_out, r)``), ``n_out`` defaulting to
  ``min(R, n_brows*br)`` as in the JAX package.

Ragged sizes: the JAX package's ``bcsr_prepare_x``/``bcsr_finish_y`` pad x
to whole tiles and trim y on the host. Here the kernels mask the ragged edge
themselves (x entries at or past R read as zero, rows at or past ``n_out``
are not written), and only the plain versions in ``kernels/ref.py`` pad.

Each wrapper, like those of ``kernels/fused_reductions.py``, launches its
kernel on a CUDA tensor (checking the launch) and runs the plain version on
a CPU tensor — the only reason it ever does so — and counts its launches in
``<wrapper>.launches``. Tiles up to :data:`MAX_BLOCK` on a side are taken on
the card; larger ones raise ``ValueError`` there.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

SOURCE = "src/repro_torch/kernels/csrc/spmv_bcsr.cu"
MAX_BLOCK = 16

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    **{f"bs_spmv_{t}": (_P, _P, _P, _P, _L, _L, _I, _I, _I, _L, _L, _P)
       for t in ("f32", "f64")},
    **{f"bs_spmm_{t}": (_P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _L, _L, _P)
       for t in ("f32", "f64")},
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _lib():
    return _build.library("spmv_bcsr", _SIGNATURES)


def _shapes(name: str, blocks, bcol, x, *, n_brows: int, bpr: int,
                n_out: int | None, rhs: bool):
    """Validate one call; return ``(S, br, bc, R, r, n_out)`` (``r = 0``
    for a vector ``x``). The packing must be the uniform layout
    (``blocks.shape[1] == n_brows*bpr``), as ``bcsr_prepare_x`` checks in
    the JAX package; ``n_out`` must not exceed the ``n_brows*br`` rows the
    tiles cover."""
    if blocks.dim() != 4 or bcol.dim() != 2:
        raise ValueError(
            f"{name} expects stacked (S, n_brows*bpr, br, bc) blocks and "
            f"(S, n_brows*bpr) bcol, got {tuple(blocks.shape)} and {tuple(bcol.shape)}"
        )
    S, nbk, br, bc = (int(v) for v in blocks.shape)
    if nbk != n_brows * bpr or tuple(bcol.shape) != (S, nbk):
        raise ValueError(
            f"{name}: blocks {tuple(blocks.shape)} / bcol {tuple(bcol.shape)} are "
            f"not the uniform layout of n_brows={n_brows}, bpr={bpr}; pack with "
            "core.sparse.pack_bcsr"
        )
    if x.dim() != (3 if rhs else 2) or x.shape[0] != S:
        want = "(S, R, r)" if rhs else "(S, R)"
        raise ValueError(f"{name} expects x as {want} with S={S}, got {tuple(x.shape)}")
    R = int(x.shape[1])
    r = int(x.shape[2]) if rhs else 0
    if n_out is None:
        n_out = min(R, n_brows * br)
    if n_out > n_brows * br:
        raise ValueError(f"{name}: n_out={n_out} exceeds the {n_brows * br} rows of the tiles")
    if x.dtype != blocks.dtype or x.device != blocks.device or bcol.device != blocks.device:
        raise ValueError(f"{name}: blocks and x differ in dtype or device")
    if blocks.device.type == "cuda":
        if blocks.dtype not in _SUFFIX:
            raise TypeError(f"{name}: the kernel takes float32/float64, got {blocks.dtype}")
        if bcol.dtype != torch.int32:
            raise TypeError(f"{name}: the kernel takes int32 block ids, got {bcol.dtype}")
        if max(br, bc) > MAX_BLOCK:
            raise ValueError(
                f"{name}: the kernel takes tiles up to {MAX_BLOCK}x{MAX_BLOCK}, "
                f"got {br}x{bc}"
            )
        if not (blocks.is_contiguous() and bcol.is_contiguous() and x.is_contiguous()):
            raise ValueError(f"{name}: the kernel takes contiguous operands")
        if blocks.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads tile rows as 16-byte vectors; "
                             "blocks must start on a 16-byte boundary")
        if n_out * max(r, 1) >= 2 ** 31:
            raise ValueError(f"{name}: n_out * r must stay below 2^31 per shard")
    return S, br, bc, R, r, int(n_out)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def bcsr_spmv(blocks, bcol, x, *, n_brows: int, bpr: int, n_out: int | None = None):
    """``y = A @ x`` for the stacked uniform-layout BCSR interior: ``x``
    ``(S, R)`` -> ``(S, n_out)``."""
    S, br, bc, R, _, n_out = _shapes(
        "bcsr_spmv", blocks, bcol, x, n_brows=n_brows, bpr=bpr, n_out=n_out, rhs=False
    )
    if x.device.type != "cuda":
        return ref.bcsr_spmv_ref(blocks, bcol, x, n_brows, bpr, n_out)
    lib = _lib()
    y = torch.empty((S, n_out), dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"bs_spmv_{_SUFFIX[x.dtype]}")
    _build.check(fn(blocks.data_ptr(), bcol.data_ptr(), x.data_ptr(), y.data_ptr(),
                    S, n_brows, bpr, br, bc, R, n_out, _stream(x)), "bcsr_spmv")
    bcsr_spmv.launches += 1
    return y


def bcsr_spmm(blocks, bcol, x, *, n_brows: int, bpr: int, n_out: int | None = None):
    """Multi-RHS :func:`bcsr_spmv`: ``x`` ``(S, R, r)`` -> ``(S, n_out, r)``.
    Each tile is read once per pass over the block-row's outputs and
    contracted against the ``(bc, r)`` x tile it meets, so the matrix
    traffic does not grow with ``r``."""
    S, br, bc, R, r, n_out = _shapes(
        "bcsr_spmm", blocks, bcol, x, n_brows=n_brows, bpr=bpr, n_out=n_out, rhs=True
    )
    if x.device.type != "cuda":
        return ref.bcsr_spmm_ref(blocks, bcol, x, n_brows, bpr, n_out)
    lib = _lib()
    y = torch.empty((S, n_out, r), dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"bs_spmm_{_SUFFIX[x.dtype]}")
    _build.check(fn(blocks.data_ptr(), bcol.data_ptr(), x.data_ptr(), y.data_ptr(),
                    S, n_brows, bpr, br, bc, r, R, n_out, _stream(x)), "bcsr_spmm")
    bcsr_spmm.launches += 1
    return y


bcsr_spmv.launches = 0
bcsr_spmm.launches = 0

#: The kernels of this module: what each replaces and what bounds it.
KERNELS = {
    "bcsr_spmv": dict(
        wrapper=bcsr_spmv, plain=ref.bcsr_spmv_ref, source=SOURCE,
        replaces="src/repro/kernels/spmv_bcsr.py:39",
        bound_by="bytes",  # tiles + ids + x + y; 2 flops per 8-byte tile value
    ),
    "bcsr_spmm": dict(
        wrapper=bcsr_spmm, plain=ref.bcsr_spmm_ref, source=SOURCE,
        replaces="src/repro/kernels/spmv_bcsr.py:80",
        bound_by="bytes",  # as bcsr_spmv, with r-wide x and y; 2r flops per tile value
    ),
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def launches() -> dict[str, int]:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}
