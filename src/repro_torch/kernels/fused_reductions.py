"""Launch wrappers for the hand-written Hopper kernels of the CG hot paths.

The kernels live in ``csrc/fused_reductions.cu`` (the vector kernels of hs,
fcg and pipecg), ``csrc/block_reductions.cu`` (the block-HS kernels) and
``csrc/sstep_reductions.cu`` (the s-step kernels), CUDA C++ for ``sm_90a``,
built by ``kernels/_build.py`` and called through ctypes. Each wrapper:

* takes vectors in the stacked ``(S, R)`` layout (S shards on one device)
  or as one ``(n,)`` vector — column blocks as ``(S, R, r)`` or one
  ``(n, r)`` block — and returns **per-shard partials** for its
  reductions — ``(S, k)`` (``(k,)`` for a vector), ``(S, r, r)`` Grams —
  so the all-reduce stays an explicit, recorded step of the caller;
* on a CUDA tensor, launches its kernel on the current stream and checks
  the launch; on a CPU tensor, runs the plain version from
  ``kernels/ref.py`` — the only reason it ever does so. No flag, setting
  or failure sends a CUDA tensor to the plain version;
* counts its launches in ``<wrapper>.launches`` (a plain int, incremented
  where the kernel is launched and nowhere else; :func:`reset_launches`).

Scalars (alpha, beta) may be 0-d or ``(S,)`` tensors, coefficient blocks
are ``(r, r)`` (``(s, s)`` and ``(s,)`` for the s-step kernels); on the
card the kernels read them through a device pointer, so no scalar or block
ever crosses to the host here. :func:`fused_axpy` also takes a Python
number, which its kernel receives by value: no device tensor is made for
it and the host does not wait. A non-contiguous streamed operand on the
card raises (no quiet copy); the small coefficients are made contiguous.

:data:`KERNELS` describes each kernel: the TPU kernel it replaces, what
bounds it on the card (bytes: these are streaming passes with one or two
flops per element read — 2r for the block kernels, still far below the
FP64 ridge at the path's r — and no tensor-core work), its source file
and its plain version.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from repro_torch.kernels import _build, ref

SOURCE = "src/repro_torch/kernels/csrc/fused_reductions.cu"
BLOCK_SOURCE = "src/repro_torch/kernels/csrc/block_reductions.cu"
SSTEP_SOURCE = "src/repro_torch/kernels/csrc/sstep_reductions.cu"
MAX_S = 16  # the largest s-step block the s-step kernels take
MAX_OPERANDS = 4
MAX_PRODUCTS = 6

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "fr_tile": (),
    **{f"fr_dots_{t}": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _P, _P, _P)
       for t in ("f32", "f64")},
    **{f"fr_axpy_{t}": (_P, _L, v, _P, _P, _P, _L, _L, _P)
       for t, v in (("f32", ctypes.c_float), ("f64", ctypes.c_double))},
    **{f"fr_axpy2_{t}": (_P, _L, _P, _P, _P, _L, _P, _P, _P, _P, _L, _L, _P)
       for t in ("f32", "f64")},
    **{f"fr_axpy2_dots_{t}": (_P, _L, _P, _P, _P, _L, _P, _P, _P, _P, _L, _L,
                              _P, _P, _P)
       for t in ("f32", "f64")},
}
_BLOCK_SIGNATURES = {
    "br_gram_nblk": (_L, _L, _I, _I, _I),
    **{f"br_gram_{t}": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P, _P, _P)
       for t in ("f32", "f64")},
    **{f"br_update_{t}": (_P, _P, _P, _P, _P, _L, _L, _I, _P)
       for t in ("f32", "f64")},
    **{f"br_update2_{t}": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _P)
       for t in ("f32", "f64")},
}
_SSTEP_SIGNATURES = {
    "ss_gram_nblk": (_L, _L, _I, _I),
    **{f"ss_gram_{t}": (_P, _P, _P, _P, _L, _L, _I, _P, _P, _P) for t in ("f32", "f64")},
    **{f"ss_basis_{t}": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _P)
       for t in ("f32", "f64")},
    **{f"ss_update_{t}": (_P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _P)
       for t in ("f32", "f64")},
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _lib():
    return _build.library("fused_reductions", _SIGNATURES)


def _block_lib():
    return _build.library("block_reductions", _BLOCK_SIGNATURES)


def _sstep_lib():
    return _build.library("sstep_reductions", _SSTEP_SIGNATURES)


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


def _as_block_stack(name: str, ts) -> tuple[int, int, int]:
    """Validate column-block operands; return the ``(S, R, r)`` they share."""
    t0 = ts[0]
    if t0.dim() not in (2, 3):
        raise ValueError(
            f"{name} expects (S, R, r) stacked shard blocks or one (n, r) "
            f"block, got shape {tuple(t0.shape)}"
        )
    for t in ts:
        if t.shape != t0.shape:
            raise ValueError(f"{name}: shape mismatch {tuple(t.shape)} vs {tuple(t0.shape)}")
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"{name}: operands differ in dtype or device")
        if t0.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous operands")
    if t0.device.type == "cuda" and t0.dtype not in _SUFFIX:
        raise TypeError(f"{name}: the kernel takes float32/float64, got {t0.dtype}")
    S, R, r = (1, *t0.shape) if t0.dim() == 2 else tuple(t0.shape)
    return int(S), int(R), int(r)


def _coef_arg(name: str, c, like: torch.Tensor, shape: tuple) -> torch.Tensor:
    """A coefficient block or vector of ``shape`` (``(r, r)``, ``(s, s)``,
    ``(s,)``), shared by every shard, as a contiguous device tensor for the
    kernel."""
    if not isinstance(c, torch.Tensor):
        c = torch.tensor(c, dtype=like.dtype, device=like.device)
    if c.device != like.device:
        raise ValueError(f"{name}: coefficients on {c.device}, blocks on {like.device}")
    if tuple(c.shape) != shape:
        raise ValueError(f"{name}: coefficients must be {shape}, got {tuple(c.shape)}")
    return c.to(like.dtype).contiguous()


def _sstep_stack(name: str, blocks, vecs=()) -> tuple[int, int, int]:
    """Validate s-step operands — ``(S, R, s)`` blocks (or ``(n, s)``) and
    ``(S, R)`` vectors (or ``(n,)``) of the same rows; return ``(S, R, s)``.
    On the card, s is at most :data:`MAX_S`."""
    S, R, s = _as_block_stack(name, blocks)
    if vecs:
        VS, VR = _as_stack(name, vecs)
        if (VS, VR) != (S, R) or vecs[0].dim() != blocks[0].dim() - 1:
            raise ValueError(f"{name}: vectors {tuple(vecs[0].shape)} do not match the "
                             f"rows of the blocks {tuple(blocks[0].shape)}")
        if vecs[0].dtype != blocks[0].dtype or vecs[0].device != blocks[0].device:
            raise ValueError(f"{name}: operands differ in dtype or device")
    if blocks[0].device.type == "cuda" and s > MAX_S:
        raise ValueError(f"{name}: the kernel takes s <= {MAX_S}, got s = {s}")
    return S, R, s


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


def _dedup(pairs, ordered: bool):
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
        key = (idx(x), idx(y))
        if not ordered:
            key = tuple(sorted(key))
        if key not in prod_ids:
            prod_ids[key] = len(prods)
            prods.append(key)
        out_map.append(prod_ids[key])
    return uniq, tuple(prods), tuple(out_map)


def dedup_pairs(pairs):
    """Unique operands (by identity), unique products, and the map from
    output slot to product — ``repro.kernels.fused_reductions._dedup_pairs``."""
    return _dedup(pairs, ordered=False)


def dedup_pairs_ordered(pairs):
    """Like :func:`dedup_pairs` but ORDER-SENSITIVE — XᵀY is the transpose
    of YᵀX, not the same product — as
    ``repro.kernels.fused_reductions._dedup_pairs_ordered``."""
    return _dedup(pairs, ordered=True)


def _check_limits(name: str, uniq, prods):
    if len(uniq) > MAX_OPERANDS or len(prods) > MAX_PRODUCTS:
        raise ValueError(
            f"{name} takes at most {MAX_OPERANDS} distinct operands and "
            f"{MAX_PRODUCTS} distinct products; got {len(uniq)} and {len(prods)}"
        )


def _pack_products(prods) -> int:
    """Products packed 4 bits each: operand indices (left << 2) | right."""
    code = 0
    for j, (a, b) in enumerate(prods):
        code |= ((a << 2) | b) << (4 * j)
    return code


def fused_dots_n(pairs) -> torch.Tensor:
    """Local partial dots for ``pairs = [(x, y), ...]`` in ONE pass.

    Returns ``(S, len(pairs))`` per-shard partials (``(len(pairs),)`` for
    ``(n,)`` vectors). Operands shared between pairs (by identity) are read
    once; identical pairs are multiplied once. At most
    :data:`MAX_OPERANDS` distinct operands and :data:`MAX_PRODUCTS`
    distinct products (``ValueError`` beyond).
    """
    uniq, prods, out_map = dedup_pairs(pairs)
    _check_limits("fused_dots_n", uniq, prods)
    S, R = _as_stack("fused_dots_n", uniq)
    x0 = uniq[0]
    if x0.device.type != "cuda":
        return ref.fused_dots_n_ref(pairs)
    lib = _lib()
    k = len(prods)
    code = _pack_products(prods)
    ptrs = [u.data_ptr() for u in uniq] + [None] * (MAX_OPERANDS - len(uniq))
    partials = torch.empty(S * _tiles(lib, R) * MAX_PRODUCTS, dtype=x0.dtype,
                           device=x0.device)
    out = torch.empty((S, k), dtype=x0.dtype, device=x0.device)
    fn = getattr(lib, f"fr_dots_{_SUFFIX[x0.dtype]}")
    _build.check(fn(*ptrs, len(uniq), k, code, S, R, partials.data_ptr(),
                    out.data_ptr(), _stream(x0)), "fused_dots_n")
    fused_dots_n.launches += 1
    if out_map != tuple(range(k)):
        # columns picked one by one: a list index would be copied from the
        # host, and the host would wait for it
        out = torch.stack([out[:, j] for j in out_map], dim=-1)
    return out if x0.dim() == 2 else out[0]


def fused_axpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a*x + y`` in one pass; ``a`` a Python number (passed to the kernel
    by value) or a 0-d or per-shard ``(S,)`` tensor (read on the device)."""
    S, R = _as_stack("fused_axpy", (x, y))
    if x.device.type != "cuda":
        return ref.fused_axpy_ref(a, x, y)
    lib = _lib()
    if isinstance(a, numbers.Real):
        aptr, astride, aval = None, 0, float(a)
    else:
        av, astride = _scalar_arg("fused_axpy", a, x, S)
        aptr, aval = av.data_ptr(), 0.0
    o = torch.empty_like(x)
    fn = getattr(lib, f"fr_axpy_{_SUFFIX[x.dtype]}")
    _build.check(fn(aptr, astride, aval, x.data_ptr(), y.data_ptr(),
                    o.data_ptr(), S, R, _stream(x)), "fused_axpy")
    fused_axpy.launches += 1
    return o


def fused_axpy2(a1, x1, y1, a2, x2, y2):
    """``(a1*x1 + y1, a2*x2 + y2)`` in ONE pass over the four vectors — the
    fcg/pipecg updates. The two updates are evaluated from the inputs as
    given (neither feeds the other)."""
    S, R = _as_stack("fused_axpy2", (x1, y1, x2, y2))
    if x1.device.type != "cuda":
        return ref.fused_axpy2_ref(a1, x1, y1, a2, x2, y2)
    lib = _lib()
    av1, s1 = _scalar_arg("fused_axpy2", a1, x1, S)
    av2, s2 = _scalar_arg("fused_axpy2", a2, x1, S)
    o1 = torch.empty_like(x1)
    o2 = torch.empty_like(x1)
    fn = getattr(lib, f"fr_axpy2_{_SUFFIX[x1.dtype]}")
    _build.check(fn(av1.data_ptr(), s1, x1.data_ptr(), y1.data_ptr(),
                    av2.data_ptr(), s2, x2.data_ptr(), y2.data_ptr(),
                    o1.data_ptr(), o2.data_ptr(), S, R, _stream(x1)), "fused_axpy2")
    fused_axpy2.launches += 1
    return o1, o2


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


def block_gram(pairs) -> list:
    """Local Gram blocks ``[Xᵀ @ Y for (X, Y) in pairs]`` in ONE pass.

    Returns one ``(S, r, r)`` per-shard partial per pair (``(r, r)`` for
    one ``(n, r)`` block). Operands shared between pairs (by identity) are
    read once; identical ORDERED pairs are multiplied once. At most
    :data:`MAX_OPERANDS` distinct operands and :data:`MAX_PRODUCTS`
    distinct products (``ValueError`` beyond); any ``r``.
    """
    uniq, prods, out_map = dedup_pairs_ordered(pairs)
    _check_limits("block_gram", uniq, prods)
    S, R, r = _as_block_stack("block_gram", uniq)
    x0 = uniq[0]
    if x0.device.type != "cuda":
        return ref.block_gram_ref(pairs)
    lib = _block_lib()
    k = len(prods)
    nblk = lib.br_gram_nblk(S, R, r, len(uniq), x0.element_size())
    ptrs = [u.data_ptr() for u in uniq] + [None] * (MAX_OPERANDS - len(uniq))
    partials = torch.empty(S * nblk * k * r * r, dtype=x0.dtype, device=x0.device)
    out = torch.empty((S, k, r, r), dtype=x0.dtype, device=x0.device)
    fn = getattr(lib, f"br_gram_{_SUFFIX[x0.dtype]}")
    _build.check(fn(*ptrs, len(uniq), k, _pack_products(prods), S, R, r,
                    partials.data_ptr(), out.data_ptr(), _stream(x0)), "block_gram")
    block_gram.launches += 1
    grams = [out[:, m] for m in out_map]
    return grams if x0.dim() == 3 else [g[0] for g in grams]


def block_update(m, x: torch.Tensor, y: torch.Tensor, mask=None) -> torch.Tensor:
    """``y * mask + x @ m`` in ONE pass: ``m`` an ``(r, r)`` coefficient
    block, ``mask`` an optional ``(r,)`` column scale (the block-CG
    deflation mask) folded into the same pass."""
    S, R, r = _as_block_stack("block_update", (x, y))
    if x.device.type != "cuda":
        return ref.block_update_ref(m, x, y, mask)
    lib = _block_lib()
    mv = _coef_arg("block_update", m, x, (r, r))
    kv = None
    if mask is not None:
        kv = torch.as_tensor(mask, device=x.device).to(x.dtype).contiguous()
        if tuple(kv.shape) != (r,):
            raise ValueError(f"block_update: mask must be ({r},), got {tuple(kv.shape)}")
    o = torch.empty_like(x)
    fn = getattr(lib, f"br_update_{_SUFFIX[x.dtype]}")
    _build.check(fn(mv.data_ptr(), None if kv is None else kv.data_ptr(),
                    x.data_ptr(), y.data_ptr(), o.data_ptr(), S, R, r, _stream(x)),
                 "block_update")
    block_update.launches += 1
    return o


def block_update2(a1, x1, y1, a2, x2, y2):
    """``(y1 + x1 @ a1, y2 + x2 @ a2)`` in ONE pass over the four blocks —
    the block-CG X/R update (``a2 = -alpha`` folds the sign in)."""
    S, R, r = _as_block_stack("block_update2", (x1, y1, x2, y2))
    if x1.device.type != "cuda":
        return ref.block_update2_ref(a1, x1, y1, a2, x2, y2)
    lib = _block_lib()
    av1 = _coef_arg("block_update2", a1, x1, (r, r))
    av2 = _coef_arg("block_update2", a2, x1, (r, r))
    o1 = torch.empty_like(x1)
    o2 = torch.empty_like(x1)
    fn = getattr(lib, f"br_update2_{_SUFFIX[x1.dtype]}")
    _build.check(fn(av1.data_ptr(), x1.data_ptr(), y1.data_ptr(), av2.data_ptr(),
                    x2.data_ptr(), y2.data_ptr(), o1.data_ptr(), o2.data_ptr(),
                    S, R, r, _stream(x1)), "block_update2")
    block_update2.launches += 1
    return o1, o2


def sstep_gram(pb, wb, wp, r) -> torch.Tensor:
    """Local s-step reduction ``[PᵀW | WpᵀP | Pᵀr | rᵀr]`` in ONE pass over
    the ``(S, R, s)`` blocks P, W, Wp and the ``(S, R)`` residual.

    Returns ``(S, 2s²+s+1)`` per-shard partials (``(2s²+s+1,)`` for one
    ``(n, s)`` block), summed in a fixed order: the same inputs give the
    same bits on every launch."""
    S, R, s = _sstep_stack("sstep_gram", (pb, wb, wp), (r,))
    if pb.device.type != "cuda":
        return ref.sstep_gram_ref(pb, wb, wp, r)
    lib = _sstep_lib()
    K = 2 * s * s + s + 1
    nblk = lib.ss_gram_nblk(S, R, s, pb.element_size())
    partials = torch.empty(S * nblk * K, dtype=pb.dtype, device=pb.device)
    out = torch.empty((S, K), dtype=pb.dtype, device=pb.device)
    fn = getattr(lib, f"ss_gram_{_SUFFIX[pb.dtype]}")
    _build.check(fn(pb.data_ptr(), wb.data_ptr(), wp.data_ptr(), r.data_ptr(), S, R, s,
                    partials.data_ptr(), out.data_ptr(), _stream(pb)), "sstep_gram")
    sstep_gram.launches += 1
    return out if pb.dim() == 3 else out[0]


def sstep_basis(b, dinv, qp, pb, wp, wb):
    """``(Pb·diag(dinv) − Qp @ b, Wb·diag(dinv) − Wp @ b)`` in ONE pass over
    the four ``(S, R, s)`` blocks: the s-step A-conjugation with the basis
    column normalization folded in. ``b`` is ``(s, s)`` and ``dinv``
    ``(s,)``, shared by every shard."""
    S, R, s = _sstep_stack("sstep_basis", (qp, pb, wp, wb))
    if pb.device.type != "cuda":
        return ref.sstep_basis_ref(b, dinv, qp, pb, wp, wb)
    lib = _sstep_lib()
    bv = _coef_arg("sstep_basis", b, pb, (s, s))
    dv = _coef_arg("sstep_basis", dinv, pb, (s,))
    o1 = torch.empty_like(pb)
    o2 = torch.empty_like(pb)
    fn = getattr(lib, f"ss_basis_{_SUFFIX[pb.dtype]}")
    _build.check(fn(bv.data_ptr(), dv.data_ptr(), qp.data_ptr(), pb.data_ptr(),
                    wp.data_ptr(), wb.data_ptr(), o1.data_ptr(), o2.data_ptr(), S, R, s,
                    _stream(pb)), "sstep_basis")
    sstep_basis.launches += 1
    return o1, o2


def sstep_update(a, q, wq, x, r):
    """``(x + Q @ a, r − WQ @ a)`` in ONE pass over the ``(S, R, s)`` blocks
    and the ``(S, R)`` vectors; ``a`` is the ``(s,)`` step coefficients,
    shared by every shard."""
    S, R, s = _sstep_stack("sstep_update", (q, wq), (x, r))
    if q.device.type != "cuda":
        return ref.sstep_update_ref(a, q, wq, x, r)
    lib = _sstep_lib()
    av = _coef_arg("sstep_update", a, q, (s,))
    ox = torch.empty_like(x)
    orr = torch.empty_like(x)
    fn = getattr(lib, f"ss_update_{_SUFFIX[q.dtype]}")
    _build.check(fn(av.data_ptr(), q.data_ptr(), wq.data_ptr(), x.data_ptr(), r.data_ptr(),
                    ox.data_ptr(), orr.data_ptr(), S, R, s, _stream(q)), "sstep_update")
    sstep_update.launches += 1
    return ox, orr


fused_dots_n.launches = 0
fused_axpy.launches = 0
fused_axpy2.launches = 0
fused_axpy2_dots.launches = 0
block_gram.launches = 0
block_update.launches = 0
block_update2.launches = 0
sstep_gram.launches = 0
sstep_basis.launches = 0
sstep_update.launches = 0

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
    "fused_axpy2": dict(
        wrapper=fused_axpy2, plain=ref.fused_axpy2_ref, source=SOURCE,
        replaces="src/repro/kernels/fused_reductions.py:178",
        bound_by="bytes",  # 4 vectors read, 2 written
    ),
    "fused_axpy2_dots": dict(
        wrapper=fused_axpy2_dots, plain=ref.fused_axpy2_dots_ref, source=SOURCE,
        replaces="src/repro/kernels/fused_reductions.py:196",
        bound_by="bytes",  # 4 vectors read, 2 written
    ),
    "block_gram": dict(
        wrapper=block_gram, plain=ref.block_gram_ref, source=BLOCK_SOURCE,
        replaces="src/repro/kernels/fused_reductions.py:287",
        bound_by="bytes",  # distinct (R, r) operands read once; 2r flops/element
    ),
    "block_update": dict(
        wrapper=block_update, plain=ref.block_update_ref, source=BLOCK_SOURCE,
        replaces="src/repro/kernels/fused_reductions.py:330",
        bound_by="bytes",  # 2 blocks read, 1 written; 2r flops/element
    ),
    "block_update2": dict(
        wrapper=block_update2, plain=ref.block_update2_ref, source=BLOCK_SOURCE,
        replaces="src/repro/kernels/fused_reductions.py:361",
        bound_by="bytes",  # 4 blocks read, 2 written
    ),
    "sstep_gram": dict(
        wrapper=sstep_gram, plain=ref.sstep_gram_ref, source=SSTEP_SOURCE,
        replaces="src/repro/kernels/fused_reductions.py:414",
        bound_by="bytes",  # 3 (R, s) blocks + r read once; about 2s/3 FMAs/element
    ),
    "sstep_basis": dict(
        wrapper=sstep_basis, plain=ref.sstep_basis_ref, source=SSTEP_SOURCE,
        replaces="src/repro/kernels/fused_reductions.py:469",
        bound_by="bytes",  # 4 (R, s) blocks read, 2 written; s FMAs per output
    ),
    "sstep_update": dict(
        wrapper=sstep_update, plain=ref.sstep_update_ref, source=SSTEP_SOURCE,
        replaces="src/repro/kernels/fused_reductions.py:503",
        bound_by="bytes",  # 2 (R, s) blocks + 2 vectors read, 2 vectors written
    ),
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def launches() -> dict[str, int]:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}
