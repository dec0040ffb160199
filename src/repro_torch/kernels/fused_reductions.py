"""Launch wrappers for the hand-written Hopper kernels of the hs-CG hot path.

The kernels live in ``csrc/fused_reductions.cu`` (CUDA C++ for ``sm_90a``,
built by ``kernels/_build.py`` and called through ctypes). Each wrapper:

* takes vectors in the stacked ``(S, R)`` layout (S shards on one device)
  or as one ``(n,)`` vector, and returns **per-shard partials** for its
  reductions — ``(S, k)`` (``(k,)`` for a vector) — so the all-reduce
  stays an explicit, recorded step of the caller;
* on a CUDA tensor, launches its kernel on the current stream and checks
  the launch; on a CPU tensor, runs the plain version from
  ``kernels/ref.py`` — the only reason it ever does so. No flag, setting
  or failure sends a CUDA tensor to the plain version;
* counts its launches in ``<wrapper>.launches`` (a plain int, incremented
  where the kernel is launched and nowhere else; :func:`reset_launches`).

Scalars (alpha, beta) may be 0-d or ``(S,)`` tensors; on the card the
kernels read them through a device pointer, so no scalar ever crosses to
the host here.

:data:`KERNELS` describes each kernel: the TPU kernel it replaces, what
bounds it on the card (bytes: these are streaming passes with one or two
flops per element read and no tensor-core work), its source file and its
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

SOURCE = "src/repro_torch/kernels/csrc/fused_reductions.cu"
MAX_OPERANDS = 4
MAX_PRODUCTS = 6

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "fr_tile": (),
    **{f"fr_dots_{t}": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _P, _P, _P)
       for t in ("f32", "f64")},
    **{f"fr_axpy_{t}": (_P, _L, _P, _P, _P, _L, _L, _P) for t in ("f32", "f64")},
    **{f"fr_axpy2_dots_{t}": (_P, _L, _P, _P, _P, _L, _P, _P, _P, _P, _L, _L,
                              _P, _P, _P)
       for t in ("f32", "f64")},
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _lib():
    return _build.library("fused_reductions", _SIGNATURES)


def _as_stack(name: str, ts) -> tuple[int, int]:
    """Validate operands; return the ``(S, R)`` they share."""
    t0 = ts[0]
    if t0.dim() not in (1, 2):
        raise ValueError(
            f"{name} expects (S, R) stacked shard vectors or one (n,) vector, "
            f"got shape {tuple(t0.shape)}"
        )
    for t in ts:
        if t.shape != t0.shape:
            raise ValueError(f"{name}: shape mismatch {tuple(t.shape)} vs {tuple(t0.shape)}")
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"{name}: operands differ in dtype or device")
    if t0.device.type == "cuda":
        if t0.dtype not in _SUFFIX:
            raise TypeError(f"{name}: the kernel takes float32/float64, got {t0.dtype}")
        for t in ts:
            if not t.is_contiguous():
                raise ValueError(f"{name}: the kernel takes contiguous operands")
    S, R = (1, t0.shape[0]) if t0.dim() == 1 else tuple(t0.shape)
    return int(S), int(R)


def _scalar_arg(name: str, a, like: torch.Tensor, S: int):
    """A device scalar for the kernel: ``(tensor, shard stride)``."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=like.dtype, device=like.device)
    if a.device != like.device:
        raise ValueError(f"{name}: scalar on {a.device}, vectors on {like.device}")
    a = a.to(like.dtype).contiguous()
    if a.numel() == 1:
        return a, 0
    if a.numel() == S:
        return a, 1
    raise ValueError(f"{name}: scalar must be 0-d or one per shard ({S},), got {tuple(a.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _tiles(lib, R: int) -> int:
    tile = lib.fr_tile()
    return -(-R // tile)


def dedup_pairs(pairs):
    """Unique operands (by identity), unique products, and the map from
    output slot to product — ``repro.kernels.fused_reductions._dedup_pairs``."""
    uniq: list = []
    ids: dict[int, int] = {}

    def idx(a):
        if id(a) not in ids:
            ids[id(a)] = len(uniq)
            uniq.append(a)
        return ids[id(a)]

    out_map = []
    prod_ids: dict[tuple[int, int], int] = {}
    prods = []
    for x, y in pairs:
        key = tuple(sorted((idx(x), idx(y))))
        if key not in prod_ids:
            prod_ids[key] = len(prods)
            prods.append(key)
        out_map.append(prod_ids[key])
    return uniq, tuple(prods), tuple(out_map)


def fused_dots_n(pairs) -> torch.Tensor:
    """Local partial dots for ``pairs = [(x, y), ...]`` in ONE pass.

    Returns ``(S, len(pairs))`` per-shard partials (``(len(pairs),)`` for
    ``(n,)`` vectors). Operands shared between pairs (by identity) are read
    once; identical pairs are multiplied once. At most
    :data:`MAX_OPERANDS` distinct operands and :data:`MAX_PRODUCTS`
    distinct products (``ValueError`` beyond).
    """
    uniq, prods, out_map = dedup_pairs(pairs)
    if len(uniq) > MAX_OPERANDS or len(prods) > MAX_PRODUCTS:
        raise ValueError(
            f"fused_dots_n takes at most {MAX_OPERANDS} distinct operands and "
            f"{MAX_PRODUCTS} distinct products; got {len(uniq)} and {len(prods)}"
        )
    S, R = _as_stack("fused_dots_n", uniq)
    x0 = uniq[0]
    if x0.device.type != "cuda":
        return ref.fused_dots_n_ref(pairs)
    lib = _lib()
    k = len(prods)
    code = 0
    for j, (a, b) in enumerate(prods):
        code |= ((a << 2) | b) << (4 * j)
    ptrs = [u.data_ptr() for u in uniq] + [None] * (MAX_OPERANDS - len(uniq))
    partials = torch.empty(S * _tiles(lib, R) * MAX_PRODUCTS, dtype=x0.dtype,
                           device=x0.device)
    out = torch.empty((S, k), dtype=x0.dtype, device=x0.device)
    fn = getattr(lib, f"fr_dots_{_SUFFIX[x0.dtype]}")
    _build.check(fn(*ptrs, len(uniq), k, code, S, R, partials.data_ptr(),
                    out.data_ptr(), _stream(x0)), "fused_dots_n")
    fused_dots_n.launches += 1
    if out_map != tuple(range(k)):
        out = out[:, list(out_map)]
    return out if x0.dim() == 2 else out[0]


def fused_axpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a*x + y`` in one pass; ``a`` a 0-d or per-shard ``(S,)`` scalar."""
    S, R = _as_stack("fused_axpy", (x, y))
    if x.device.type != "cuda":
        return ref.fused_axpy_ref(a, x, y)
    lib = _lib()
    av, astride = _scalar_arg("fused_axpy", a, x, S)
    o = torch.empty_like(x)
    fn = getattr(lib, f"fr_axpy_{_SUFFIX[x.dtype]}")
    _build.check(fn(av.data_ptr(), astride, x.data_ptr(), y.data_ptr(),
                    o.data_ptr(), S, R, _stream(x)), "fused_axpy")
    fused_axpy.launches += 1
    return o


def fused_axpy2_dots(a1, x1, y1, a2, x2, y2):
    """``(a1*x1 + y1, a2*x2 + y2, partial[o2 . o2])`` in ONE pass.

    The third output is the per-shard partial squared norm of the second
    output, ``(S, 1)`` (``(1,)`` for ``(n,)`` vectors), accumulated while
    that output is still in registers.
    """
    S, R = _as_stack("fused_axpy2_dots", (x1, y1, x2, y2))
    if x1.device.type != "cuda":
        return ref.fused_axpy2_dots_ref(a1, x1, y1, a2, x2, y2)
    lib = _lib()
    av1, s1 = _scalar_arg("fused_axpy2_dots", a1, x1, S)
    av2, s2 = _scalar_arg("fused_axpy2_dots", a2, x1, S)
    o1 = torch.empty_like(x1)
    o2 = torch.empty_like(x1)
    partials = torch.empty(S * _tiles(lib, R), dtype=x1.dtype, device=x1.device)
    d = torch.empty((S, 1), dtype=x1.dtype, device=x1.device)
    fn = getattr(lib, f"fr_axpy2_dots_{_SUFFIX[x1.dtype]}")
    _build.check(fn(av1.data_ptr(), s1, x1.data_ptr(), y1.data_ptr(),
                    av2.data_ptr(), s2, x2.data_ptr(), y2.data_ptr(),
                    o1.data_ptr(), o2.data_ptr(), S, R, partials.data_ptr(),
                    d.data_ptr(), _stream(x1)), "fused_axpy2_dots")
    fused_axpy2_dots.launches += 1
    return o1, o2, (d if x1.dim() == 2 else d[0])


fused_dots_n.launches = 0
fused_axpy.launches = 0
fused_axpy2_dots.launches = 0

#: The kernels of this module: what each replaces and what bounds it.
KERNELS = {
    "fused_dots_n": dict(
        wrapper=fused_dots_n, plain=ref.fused_dots_n_ref, source=SOURCE,
        replaces="src/repro/kernels/fused_reductions.py:104",
        bound_by="bytes",  # each distinct operand read once
    ),
    "fused_axpy": dict(
        wrapper=fused_axpy, plain=ref.fused_axpy_ref, source=SOURCE,
        replaces="src/repro/kernels/fused_reductions.py:156",
        bound_by="bytes",  # 2 vectors read, 1 written
    ),
    "fused_axpy2_dots": dict(
        wrapper=fused_axpy2_dots, plain=ref.fused_axpy2_dots_ref, source=SOURCE,
        replaces="src/repro/kernels/fused_reductions.py:196",
        bound_by="bytes",  # 4 vectors read, 2 written
    ),
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def launches() -> dict[str, int]:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}
