"""Each CUDA kernel of the port against its plain version, on the card.

Marked ``cuda``: they skip where there is no GPU (CUDA kernels have no
CPU mode). This file imports neither JAX nor the JAX package, so it runs
on the card's machine as it is:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: axpy outputs ``|k - p| <= 2 eps (|a x| + |y|)`` (one rounding
of the multiply-add either way); dots, Grams, block updates and the BCSR
SpMV/SpMM ``1e-13`` (float64) or ``1e-5`` (float32) relative to the sum of
the magnitudes each entry adds up (the two sides sum in different orders).
"""

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused_reductions as fr
from repro_torch.kernels import ref
from repro_torch.kernels import spmv_bcsr as sb


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_vecs(dev, k, S=4, R=100_003, dtype=torch.float64):
    g = torch.Generator(device=dev).manual_seed(k)
    return [torch.randn(S, R, dtype=dtype, device=dev, generator=g) for _ in range(k)]


def _card_blocks(dev, k, S=4, R=100_003, r=8, dtype=torch.float64):
    g = torch.Generator(device=dev).manual_seed(100 + k + r)
    return [torch.randn(S, R, r, dtype=dtype, device=dev, generator=g) for _ in range(k)]


def _block_err(k, p, scale) -> float:
    return float(((k - p).abs() / scale.clamp(min=1e-300)).max())


@pytest.mark.cuda
def test_cuda_fused_dots_n_matches_plain(cuda_device):
    p, w = _card_vecs(cuda_device, 2)
    n0 = fr.fused_dots_n.launches
    d = fr.fused_dots_n([(p, w), (w, w), (w, p)])
    torch.cuda.synchronize()
    assert fr.fused_dots_n.launches == n0 + 1
    scale = torch.stack([(p * w).abs().sum(-1), (w * w).sum(-1), (p * w).abs().sum(-1)], -1)
    err = (d - ref.fused_dots_n_ref([(p, w), (w, w), (w, p)])).abs() / scale
    assert float(err.max()) <= 1e-13


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R", [100_003, 4096, 7, 2, 1])
@pytest.mark.parametrize("scalar", ["number", "0-d", "per-shard"])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_cuda_fused_axpy_matches_plain(cuda_device, offset, scalar, R, dtype):
    """16-byte units with a head and a tail per shard, or one element per
    access when the operands are aligned differently: x starts ``offset``
    elements into a buffer, and y as far off a 16-byte boundary as x, but
    for ``offset == 3``, where y is 2 elements further on."""
    S = 3
    g = torch.Generator(device=cuda_device).manual_seed(R + offset)
    L = (S * R + 3) // 4 * 4 + 4  # a whole number of 16-byte units in both types
    buf = torch.randn(2 * L + 8, dtype=dtype, device=cuda_device, generator=g)
    x = buf[offset: offset + S * R].view(S, R)
    yo = offset + L + (2 if offset == 3 else 0)
    y = buf[yo: yo + S * R].view(S, R)
    a = {"number": -0.37,
         "0-d": torch.tensor(0.37, dtype=dtype, device=cuda_device),
         "per-shard": torch.rand(S, dtype=dtype, device=cuda_device, generator=g)}[scalar]
    n0 = fr.fused_axpy.launches
    o = fr.fused_axpy(a, x, y)
    p = ref.fused_axpy_ref(a, x, y)
    torch.cuda.synchronize()
    assert fr.fused_axpy.launches == n0 + 1
    av = ref._scalar(a, x)
    eps = torch.finfo(dtype).eps
    assert bool(((o - p).abs() <= 2 * eps * ((av * x).abs() + y.abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["axpy with a Python number", "dots with a repeated pair"])
def test_cuda_wrappers_make_no_host_copy(cuda_device, call):
    """A Python-number scalar goes to ``fused_axpy``'s kernel by value, and
    ``fused_dots_n`` picks a repeated product's column without a host
    index (fcg's ``[(r, r), (w, r), (r, r)]``): no host-to-device copy and
    no stream synchronisation."""
    from torch.profiler import ProfilerActivity, profile

    x, y = _card_vecs(cuda_device, 2)
    fn, kernel = {
        "axpy with a Python number": (lambda: fr.fused_axpy(-1.0, x, y), "axpy_kernel"),
        "dots with a repeated pair": (lambda: fr.fused_dots_n([(x, x), (y, x), (x, x)]),
                                      "dots_tile_kernel"),
    }[call]
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    # (the profiler's own cudaDeviceSynchronize at its end is not the call's)
    assert not [k for k in names if "emcpy" in k or "cudaStreamSynchronize" in k], names
    assert sum(e.count for e in prof.key_averages() if kernel in e.key) == 5, names


@pytest.mark.cuda
def test_cuda_fused_axpy2_dots_matches_plain(cuda_device):
    x1, y1, x2, y2 = _card_vecs(cuda_device, 4)
    a = torch.rand(4, dtype=x1.dtype, device=cuda_device)
    o1, o2, d = fr.fused_axpy2_dots(a, x1, y1, -a, x2, y2)
    q1, q2, qd = ref.fused_axpy2_dots_ref(a, x1, y1, -a, x2, y2)
    torch.cuda.synchronize()
    eps = torch.finfo(x1.dtype).eps
    a2 = a[:, None]
    assert bool(((o1 - q1).abs() <= 2 * eps * ((a2 * x1).abs() + y1.abs())).all())
    assert bool(((o2 - q2).abs() <= 2 * eps * ((a2 * x2).abs() + y2.abs())).all())
    assert float(((d - qd).abs() / qd).max()) <= 1e-13


@pytest.mark.cuda
def test_cuda_fused_axpy2_matches_plain(cuda_device):
    x1, y1, x2, y2 = _card_vecs(cuda_device, 4)
    a = torch.rand(4, dtype=x1.dtype, device=cuda_device)
    n0 = fr.fused_axpy2.launches
    o1, o2 = fr.fused_axpy2(a, x1, y1, -a, x2, y2)
    q1, q2 = ref.fused_axpy2_ref(a, x1, y1, -a, x2, y2)
    torch.cuda.synchronize()
    assert fr.fused_axpy2.launches == n0 + 1
    eps = torch.finfo(x1.dtype).eps
    a2 = a[:, None]
    assert bool(((o1 - q1).abs() <= 2 * eps * ((a2 * x1).abs() + y1.abs())).all())
    assert bool(((o2 - q2).abs() <= 2 * eps * ((a2 * x2).abs() + y2.abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 3, 8, 17])
def test_cuda_block_gram_matches_plain(cuda_device, r):
    x, y = _card_blocks(cuda_device, 2, r=r)
    n0 = fr.block_gram.launches
    pairs = [(x, y), (y, x), (x, x)]
    got = fr.block_gram(pairs)
    torch.cuda.synchronize()
    assert fr.block_gram.launches == n0 + 1
    for g, (a, b) in zip(got, pairs):
        assert g.shape == (4, r, r)
        assert _block_err(g, a.mT @ b, a.abs().mT @ b.abs()) <= 1e-13


@pytest.mark.cuda
@pytest.mark.parametrize("r", [3, 8, 17])
def test_cuda_block_update_matches_plain(cuda_device, r):
    x, y = _card_blocks(cuda_device, 2, r=r)
    m = torch.randn(r, r, dtype=x.dtype, device=cuda_device)
    mask = (torch.arange(r, device=cuda_device) % 2 == 0).to(x.dtype)
    for k in (None, mask):
        o = fr.block_update(m, x, y, mask=k)
        p = ref.block_update_ref(m, x, y, mask=k)
        ym = y.abs() if k is None else y.abs() * k
        assert _block_err(o, p, ym + x.abs() @ m.abs()) <= 1e-13


@pytest.mark.cuda
@pytest.mark.parametrize("r", [3, 8, 17])
def test_cuda_block_update2_matches_plain(cuda_device, r):
    x1, y1, x2, y2 = _card_blocks(cuda_device, 4, r=r)
    a = torch.randn(r, r, dtype=x1.dtype, device=cuda_device)
    o1, o2 = fr.block_update2(a, x1, y1, -a, x2, y2)
    q1, q2 = ref.block_update2_ref(a, x1, y1, -a, x2, y2)
    assert _block_err(o1, q1, y1.abs() + x1.abs() @ a.abs()) <= 1e-13
    assert _block_err(o2, q2, y2.abs() + x2.abs() @ a.abs()) <= 1e-13


BCSR_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


def _card_bcsr(dev, b, bpr, dtype, S=4, R=50_003, seed=0, layout="scattered"):
    """A stacked uniform-layout BCSR operand on the card with (br, bc) tiles
    (``b`` an int for square ones), a ragged R (not a multiple of br or bc)
    and padding tiles (zero, block column 0) in every block-row past its
    first tile. ``scattered``: block columns drawn anywhere; ``banded``: the
    ascending block columns around the block diagonal, as ``pack_bcsr``
    lays out a banded matrix (the SpMM kernel's shared-memory x window)."""
    br, bc = (b, b) if isinstance(b, int) else b
    g = torch.Generator(device=dev).manual_seed(seed + 31 * br + 7 * bc + bpr)
    NB = -(-R // br)
    n_bcols = -(-R // bc)
    blocks = torch.randn(S, NB * bpr, br, bc, dtype=dtype, device=dev, generator=g)
    if layout == "banded":
        d = torch.arange(NB, device=dev) * br // bc
        start = (d - bpr // 2).clamp(min=0, max=n_bcols - bpr)
        cols = start[:, None] + torch.arange(bpr, device=dev)
        bcol = cols.reshape(1, NB * bpr).repeat(S, 1).to(torch.int32)
    else:
        bcol = torch.randint(0, n_bcols, (S, NB * bpr), device=dev, generator=g,
                             dtype=torch.int32)
    used = torch.randint(1, bpr + 1, (S, NB, 1), device=dev, generator=g)
    pad = (torch.arange(bpr, device=dev) >= used).reshape(S, NB * bpr)
    blocks[pad] = 0
    bcol[pad] = 0
    return blocks, bcol, NB, R


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("b", [2, 4, 16])
@pytest.mark.parametrize("bpr", [1, 13])
def test_cuda_bcsr_spmv_matches_plain(cuda_device, bpr, b, dtype):
    blocks, bcol, NB, R = _card_bcsr(cuda_device, b, bpr, dtype)
    x = torch.randn(4, R, dtype=dtype, device=cuda_device)
    n0 = sb.bcsr_spmv.launches
    y = sb.bcsr_spmv(blocks, bcol, x, n_brows=NB, bpr=bpr)
    torch.cuda.synchronize()
    assert sb.bcsr_spmv.launches == n0 + 1
    assert y.shape == (4, R)
    p = ref.bcsr_spmv_ref(blocks, bcol, x, NB, bpr)
    scale = ref.bcsr_spmv_ref(blocks.abs(), bcol, x.abs(), NB, bpr)
    assert _block_err(y, p, scale) <= BCSR_TOL[dtype]
    # the same bits on every run (no atomics)
    assert torch.equal(y, sb.bcsr_spmv(blocks, bcol, x, n_brows=NB, bpr=bpr))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [1, 3, 8, 2, 5, 16])
@pytest.mark.parametrize("b", [2, 4, 16, 3, 8, (3, 5)])
@pytest.mark.parametrize("bpr", [1, 13])
def test_cuda_bcsr_spmm_matches_plain(cuda_device, bpr, b, r, dtype):
    """Each tile shape (square at compile time, 3 x 5 at run time) and r
    (1: the SpMV's kernel; 2 up: several right-hand sides per thread), on a
    scattered operand (x from global memory) and a banded one (the
    shared-memory x window), ragged R."""
    for layout in ("scattered", "banded"):
        blocks, bcol, NB, R = _card_bcsr(cuda_device, b, bpr, dtype, R=20_011, layout=layout)
        x = torch.randn(4, R, r, dtype=dtype, device=cuda_device)
        n0 = sb.bcsr_spmm.launches
        y = sb.bcsr_spmm(blocks, bcol, x, n_brows=NB, bpr=bpr)
        torch.cuda.synchronize()
        assert sb.bcsr_spmm.launches == n0 + 1
        assert y.shape == (4, R, r)
        p = ref.bcsr_spmm_ref(blocks, bcol, x, NB, bpr)
        scale = ref.bcsr_spmm_ref(blocks.abs(), bcol, x.abs(), NB, bpr)
        assert _block_err(y, p, scale) <= BCSR_TOL[dtype], layout
        assert torch.equal(y, sb.bcsr_spmm(blocks, bcol, x, n_brows=NB, bpr=bpr)), layout


@pytest.mark.cuda
def test_cuda_bcsr_never_takes_the_plain_version(cuda_device, monkeypatch):
    """A CUDA tensor launches the kernel: with the plain versions made to
    fail, both wrappers still run, and the dispatch op counts a launch."""
    from repro_torch.kernels import dispatch as kd

    blocks, bcol, NB, R = _card_bcsr(cuda_device, 4, 3, torch.float64, R=1001)
    x = torch.randn(4, R, dtype=torch.float64, device=cuda_device)

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(ref, "bcsr_spmv_ref", boom)
    monkeypatch.setattr(ref, "bcsr_spmm_ref", boom)
    n0 = (sb.bcsr_spmv.launches, sb.bcsr_spmm.launches)
    kd.ops_for(None).bcsr_spmv(blocks, bcol, x, n_brows=NB, bpr=3)
    sb.bcsr_spmm(blocks, bcol, x[..., None].repeat(1, 1, 2).contiguous(), n_brows=NB, bpr=3)
    torch.cuda.synchronize()
    assert (sb.bcsr_spmv.launches, sb.bcsr_spmm.launches) == (n0[0] + 1, n0[1] + 1)
    with pytest.raises(ValueError, match="backend 'torch'"):
        kd.ops_for("torch").bcsr_spmv(blocks, bcol, x, n_brows=NB, bpr=3)


@pytest.mark.cuda
def test_cuda_bcsr_raises_above_the_block_cap(cuda_device):
    blocks, bcol, NB, R = _card_bcsr(cuda_device, 17, 1, torch.float64, R=170)
    x = torch.randn(4, R, dtype=torch.float64, device=cuda_device)
    n0 = sb.bcsr_spmv.launches
    with pytest.raises(ValueError, match="tiles up to 16x16"):
        sb.bcsr_spmv(blocks, bcol, x, n_brows=NB, bpr=1)
    with pytest.raises(ValueError, match="tiles up to 16x16"):
        sb.bcsr_spmm(blocks, bcol, x[..., None].contiguous(), n_brows=NB, bpr=1)
    assert sb.bcsr_spmv.launches == n0


SSTEP_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
SSTEP_S = [1, 2, 3, 4, 5, 8, 16]  # register Gram up to 4, shared-memory Gram beyond


def _card_sstep(dev, s, dtype, S=4, R=100_003, seed=0):
    """Seeded (S, R, s) blocks and (S, R) vectors on the card, R ragged."""
    g = torch.Generator(device=dev).manual_seed(seed + 17 * s)
    blocks = [torch.randn(S, R, s, dtype=dtype, device=dev, generator=g) for _ in range(4)]
    vecs = [torch.randn(S, R, dtype=dtype, device=dev, generator=g) for _ in range(2)]
    return blocks, vecs, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("s", SSTEP_S)
def test_cuda_sstep_gram_matches_plain(cuda_device, s, dtype):
    (P, W, Wp, _), (r, _), _ = _card_sstep(cuda_device, s, dtype)
    n0 = fr.sstep_gram.launches
    got = fr.sstep_gram(P, W, Wp, r)
    torch.cuda.synchronize()
    assert fr.sstep_gram.launches == n0 + 1
    assert got.shape == (4, 2 * s * s + s + 1)
    p = ref.sstep_gram_ref(P, W, Wp, r)
    scale = ref.sstep_gram_ref(P.abs(), W.abs(), Wp.abs(), r.abs())
    assert _block_err(got, p, scale) <= SSTEP_TOL[dtype]
    # deterministic two-stage sums: the same bits on every launch
    assert torch.equal(got, fr.sstep_gram(P, W, Wp, r))
    # one (n, s) block gives its (2s^2+s+1,) vector
    one = fr.sstep_gram(P[1], W[1], Wp[1], r[1])
    assert one.shape == (2 * s * s + s + 1,)
    assert _block_err(one, p[1], scale[1]) <= SSTEP_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("s", SSTEP_S)
def test_cuda_sstep_basis_matches_plain(cuda_device, s, dtype):
    (Qp, Pb, Wp, Wb), _, g = _card_sstep(cuda_device, s, dtype, seed=1)
    B = torch.randn(s, s, dtype=dtype, device=cuda_device, generator=g)
    dinv = torch.rand(s, dtype=dtype, device=cuda_device, generator=g) + 0.1
    n0 = fr.sstep_basis.launches
    o1, o2 = fr.sstep_basis(B, dinv, Qp, Pb, Wp, Wb)
    torch.cuda.synchronize()
    assert fr.sstep_basis.launches == n0 + 1
    q1, q2 = ref.sstep_basis_ref(B, dinv, Qp, Pb, Wp, Wb)
    assert _block_err(o1, q1, Pb.abs() * dinv + Qp.abs() @ B.abs()) <= SSTEP_TOL[dtype]
    assert _block_err(o2, q2, Wb.abs() * dinv + Wp.abs() @ B.abs()) <= SSTEP_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("s", SSTEP_S)
def test_cuda_sstep_update_matches_plain(cuda_device, s, dtype):
    (Q, WQ, _, _), (x, r), g = _card_sstep(cuda_device, s, dtype, seed=2)
    a = torch.randn(s, dtype=dtype, device=cuda_device, generator=g)
    n0 = fr.sstep_update.launches
    ox, orr = fr.sstep_update(a, Q, WQ, x, r)
    torch.cuda.synchronize()
    assert fr.sstep_update.launches == n0 + 1
    px, pr = ref.sstep_update_ref(a, Q, WQ, x, r)
    assert _block_err(ox, px, x.abs() + Q.abs() @ a.abs()) <= SSTEP_TOL[dtype]
    assert _block_err(orr, pr, r.abs() + WQ.abs() @ a.abs()) <= SSTEP_TOL[dtype]


@pytest.mark.cuda
def test_cuda_sstep_never_takes_the_plain_version(cuda_device, monkeypatch):
    """CUDA tensors launch the s-step kernels through the dispatch ops even
    with the plain versions made to fail; s past the cap raises on the card
    and launches nothing."""
    from repro_torch.kernels import dispatch as kd

    (P, W, Wp, Wb), (x, r), _ = _card_sstep(cuda_device, 3, torch.float64, R=1001)

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor took the plain version")

    for name in ("sstep_gram_ref", "sstep_basis_ref", "sstep_update_ref"):
        monkeypatch.setattr(ref, name, boom)
    ops = kd.ops_for(None)
    n0 = [k.launches for k in (fr.sstep_gram, fr.sstep_basis, fr.sstep_update)]
    ops.sstep_gram(P, W, Wp, r)
    eye = torch.eye(3, dtype=P.dtype, device=cuda_device)
    Q, WQ = ops.sstep_basis(eye, torch.ones(3, dtype=P.dtype, device=cuda_device),
                            P, W, Wp, Wb)
    ops.sstep_update(torch.ones(3, dtype=P.dtype, device=cuda_device), Q, WQ, x, r)
    torch.cuda.synchronize()
    assert [k.launches for k in (fr.sstep_gram, fr.sstep_basis, fr.sstep_update)] == \
        [v + 1 for v in n0]
    with pytest.raises(ValueError, match="backend 'torch'"):
        kd.ops_for("torch").sstep_gram(P, W, Wp, r)
    big = torch.zeros(2, 5, fr.MAX_S + 1, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match=f"s <= {fr.MAX_S}"):
        fr.sstep_gram(big, big, big, big[..., 0].contiguous())
    assert fr.sstep_gram.launches == n0[0] + 1


STENCIL_CASES = [("7pt", (1.0, 1.0, 1.0)), ("7pt", (1.0, 2.5, 7.0)), ("27pt", (1.0, 1.0, 1.0))]
# (S, nz, ny, nx); (2, 67, 40, 70) ragged against the z-march's 128 x 8
# tile and its z-runs (nz = 67 splits into runs that cross the slab edge),
# the next three against the boundary kernel's 128 x 8 edge-plane tiles of
# 4 rows per thread: ny = 7, 33 and 130 leave a last tile of 7, 1 and 2
# rows, which ends a thread's rows part way (nz = 2: both edge planes read
# planes 0 and 1; S = 1); (8, 2, 517, 300) has more tiles than one wave
# holds, so each block takes several edge planes in turn
STENCIL_SHAPES = [(4, 16, 64, 64), (3, 5, 33, 45), (2, 1, 17, 23), (1, 1, 7, 9), (2, 67, 40, 70),
                  (1, 2, 7, 9), (3, 2, 33, 45), (2, 3, 130, 129), (8, 2, 517, 300)]


def _card_stencil(dev, shape, dtype, seed=0):
    """Seeded slabs ``(S, nz, ny, nx)``, halo planes, and a sweep's b/dinv."""
    g = torch.Generator(device=dev).manual_seed(seed + sum(shape))
    x = torch.randn(shape, dtype=dtype, device=dev, generator=g)
    prev, nxt = (torch.randn(shape[:1] + shape[2:], dtype=dtype, device=dev, generator=g)
                 for _ in range(2))
    b = torch.randn(shape, dtype=dtype, device=dev, generator=g)
    dinv = torch.rand(shape, dtype=dtype, device=dev, generator=g) + 0.05
    return x, prev, nxt, b, dinv


def _stencil_err(k, p, scale, dtype) -> float:
    """Largest ``|k - p| / (2 eps |A||x|)``: the kernels repeat the plain
    versions' operations in their order, each rounded once (no FMA), so the
    expected error is 0; 1 is one rounding of the whole product."""
    eps = torch.finfo(dtype).eps
    return float(((k - p).abs() / (2 * eps * scale).clamp(min=torch.finfo(dtype).tiny)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stencil,aniso", STENCIL_CASES)
@pytest.mark.parametrize("shape", STENCIL_SHAPES)
def test_cuda_stencil_kernels_match_plain(cuda_device, shape, stencil, aniso, dtype):
    from repro_torch.kernels import jacobi_stencil as js
    from repro_torch.kernels import spmv_stencil as st

    x, prev, nxt, b, dinv = _card_stencil(cuda_device, shape, dtype)
    S, nz = shape[:2]
    xg = x.view((S * nz,) + shape[2:])
    bg, dg = b.view(xg.shape), dinv.view(xg.shape)
    kw = dict(stencil=stencil, aniso=aniso)
    d = 26.0 if stencil == "27pt" else 2.0 * sum(aniso)
    n0 = st.launches()
    yh = st.stencil_spmv_halo(x, prev, nxt, bz=1, **kw)
    ys = st.stencil_spmv(xg, bz=1, **kw)
    yj = js.jacobi_stencil_sweep(xg, bg, dg, omega=0.8, bz=1, **kw)
    torch.cuda.synchronize()
    assert st.launches()["stencil_spmv_halo"] == n0["stencil_spmv_halo"] + 1
    assert st.launches()["stencil_spmv"] == n0["stencil_spmv"] + 1
    sh = 2 * d * x.abs() - ref.stencil_halo_ref(x.abs(), prev.abs(), nxt.abs(), **kw)
    ph = ref.stencil_halo_ref(x, prev, nxt, **kw)
    assert _stencil_err(yh, ph, sh, dtype) <= 1
    # the z-march repeats the plain version's operations: the same bits,
    # with real halo planes, with null ones (zero planes, through the C
    # entry), and against the single-grid kernel on the stacked slabs
    assert torch.equal(yh, ph)
    yn = torch.empty_like(x)
    lib = st._lib()
    _build.check(getattr(lib, f"st_halo_{st._SUFFIX[dtype]}")(
        x.data_ptr(), None, None, yn.data_ptr(), S, nz, shape[2], shape[3],
        *st.coef_args(stencil, aniso, dtype), st.stream(x)), "st_halo")
    z = torch.zeros_like(prev)
    assert torch.equal(yn, ref.stencil_halo_ref(x, z, z, **kw))
    hp = torch.cat([z[:1], x[:-1, -1]])
    hn = torch.cat([x[1:, 0], z[:1]])
    yr = st.stencil_spmv_halo(x, hp, hn, bz=1, **kw)
    assert torch.equal(yr.view(xg.shape), ys)
    # the single-grid product and the sweep: the plain versions' bits
    assert torch.equal(ys, ref.stencil_spmv_ref(xg, **kw))
    assert torch.equal(yj, ref.jacobi_sweep_ref(xg, bg, dg, omega=0.8, **kw))
    if nz >= 2:
        # the boundary planes: the plain version's bits, with real halo
        # planes, with null ones (through the C entry), and with out=, which
        # leaves planes 1 .. nz-2 as they were
        nb = st.stencil_spmv_boundary.launches
        yb = st.stencil_spmv_boundary(x, prev, nxt, **kw)
        assert yb.shape == (S, 2) + shape[2:]
        pb = ref.stencil_boundary_ref(x, prev, nxt, **kw)
        yz = torch.empty_like(yb)
        _build.check(getattr(lib, f"st_boundary_{st._SUFFIX[dtype]}")(
            x.data_ptr(), None, None, yz.data_ptr(), S, nz, shape[2], shape[3], 2, 1,
            *st.coef_args(stencil, aniso, dtype), st.stream(x)), "st_boundary")
        fill = torch.randn_like(x)
        out = fill.clone()
        assert st.stencil_spmv_boundary(x, prev, nxt, out=out, **kw) is out
        torch.cuda.synchronize()
        assert st.stencil_spmv_boundary.launches == nb + 2
        assert torch.equal(yb, pb)
        assert torch.equal(yz, ref.stencil_boundary_ref(x, z, z, **kw))
        assert torch.equal(out[:, [0, nz - 1]], pb)
        assert torch.equal(out[:, 1:-1], fill[:, 1:-1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stencil,aniso", STENCIL_CASES)
def test_cuda_stencil_boundary_planes_bitwise_equal_slab_kernel(cuda_device, stencil, aniso,
                                                                dtype):
    """The boundary kernel's planes (and its ``out=`` form) equal the halo
    kernel's planes 0 and nz-1 bit for bit — the z-march repeats the
    boundary kernel's point function, operation for operation, with the
    round-to-nearest intrinsics — and one grid equals its slabs with real
    halos."""
    from repro_torch.kernels import spmv_stencil as st

    kw = dict(stencil=stencil, aniso=aniso)
    for shape in ((4, 16, 64, 64), (3, 2, 33, 45), (2, 5, 17, 23), (2, 67, 40, 70),
                  (1, 2, 7, 9), (2, 3, 130, 129), (8, 2, 517, 300)):
        x, prev, nxt, _, _ = _card_stencil(cuda_device, shape, dtype, seed=1)
        nz = shape[1]
        yh = st.stencil_spmv_halo(x, prev, nxt, bz=1, **kw)
        yb = st.stencil_spmv_boundary(x, prev, nxt, **kw)
        out = torch.zeros_like(x)
        assert st.stencil_spmv_boundary(x, prev, nxt, out=out, **kw) is out
        torch.cuda.synchronize()
        assert torch.equal(yb[:, 0], yh[:, 0]) and torch.equal(yb[:, 1], yh[:, -1])
        assert torch.equal(out[:, [0, nz - 1]], yh[:, [0, nz - 1]])
        assert not out[:, 1:-1].any()
    for shape in ((4, 8, 33, 45), (3, 23, 17, 70)):
        x = _card_stencil(cuda_device, shape, dtype, seed=2)[0]
        z = torch.zeros_like(x[:1, 0])
        prev = torch.cat([z, x[:-1, -1]])
        nxt = torch.cat([x[1:, 0], z])
        y4 = st.stencil_spmv_halo(x, prev, nxt, bz=1, **kw)
        grid = (shape[0] * shape[1],) + shape[2:]
        assert torch.equal(y4.view(grid), st.stencil_spmv(x.view(grid), bz=1, **kw))


@pytest.mark.cuda
def test_cuda_stencil_never_takes_the_plain_version(cuda_device, monkeypatch):
    """CUDA tensors launch the stencil kernels through the dispatch ops and
    the wrappers even with the plain versions made to fail; non-contiguous
    operands raise on the card and launch nothing."""
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels import jacobi_stencil as js
    from repro_torch.kernels import spmv_stencil as st

    x, prev, nxt, b, dinv = _card_stencil(cuda_device, (2, 4, 9, 11), torch.float64)

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor took the plain version")

    for name in ("stencil_halo_ref", "stencil_boundary_ref", "stencil_spmv_ref",
                 "jacobi_sweep_ref"):
        monkeypatch.setattr(ref, name, boom)
    n0 = dict(st.launches(), **js.launches())
    ops = kd.ops_for(None)
    y = ops.stencil_matvec(x, prev, nxt)
    ops.stencil_boundary(x, prev, nxt, out=y)
    st.stencil_spmv(x, bz=1)
    js.jacobi_stencil_sweep(x, b, dinv, bz=1)
    torch.cuda.synchronize()
    assert dict(st.launches(), **js.launches()) == {k: v + 1 for k, v in n0.items()}
    with pytest.raises(ValueError, match="backend 'torch'"):
        kd.ops_for("torch").stencil_matvec(x, prev, nxt)
    with pytest.raises(ValueError, match="contiguous"):
        st.stencil_spmv(x.transpose(2, 3), bz=1)
    assert st.stencil_spmv.launches == n0["stencil_spmv"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["hs", "fcg", "pipecg", "sstep"])
def test_cuda_matrix_free_solve_matches_cpu(cuda_device, variant):
    """The matrix-free solve on the card (stencil kernels + fused vector
    kernels) against the same solve on the CPU (plain versions): iterations
    within 1 (the vector kernels sum in another order) and x within 1e-9."""
    from repro_torch.core.stencil_solver import make_stencil_solver_fn
    from repro_torch.matrices.poisson import PoissonProblem

    p = PoissonProblem(24, 20, 32, "7pt")
    b = torch.ones(4, p.n // 4, dtype=torch.float64)
    res = {}
    for dev in ("cpu", "cuda"):
        solve = make_stencil_solver_fn(p, 4, variant=variant, tol=1e-10, maxiter=1000,
                                       device=dev)
        res[dev] = solve(b, torch.zeros_like(b))
    assert abs(res["cuda"].iters - res["cpu"].iters) <= (2 if variant == "sstep" else 1)
    assert float(res["cuda"].rel_residual) <= 1e-10
    xc, xg = res["cpu"].x, res["cuda"].x.cpu()
    assert float((xg - xc).abs().max()) <= 1e-9 * float(xc.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["compatible", "plain", "random"])
def test_cuda_matcher_equals_numpy(cuda_device, graph):
    """The torch locally-dominant matcher on the card gives the numpy
    matcher's ``match`` array."""
    import numpy as np
    import scipy.sparse as sp

    from repro_torch.core.amg import matching as m
    from repro_torch.matrices.poisson import cube, poisson_scipy

    if graph == "random":
        rng = np.random.default_rng(1)
        n, e = 5000, 20000
        w = sp.coo_matrix((rng.random(e) + 0.1, (rng.integers(0, n, e), rng.integers(0, n, e))),
                          shape=(n, n)).tocsr()
        w = w + w.T
        w.setdiag(0)
        w.eliminate_zeros()
    else:
        w = getattr(m, f"{graph}_weights")(poisson_scipy(cube(24, "7pt")))
    wd, wc = m.weights_to_ell(w)
    got = m.locally_dominant_matching(wd, wc, device=cuda_device)
    assert (got == m.locally_dominant_matching_np(wd, wc)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("variant,amgx", [("hs", False), ("fcg", False), ("pipecg", False),
                                          ("hs", True)])
def test_cuda_amg_solve_matches_cpu(cuda_device, variant, amgx):
    """AMG-PCG on the card (the hierarchy built with the matcher there, the
    V-cycle through ``fused_axpy``) against the same solve on the CPU: the
    same hierarchy, iterations within 1 and x within 1e-9."""
    import numpy as np

    from repro_torch.core.amg import make_amg_preconditioner
    from repro_torch.core.cg import make_solver
    from repro_torch.core.partition import pad_vector, partition_csr
    from repro_torch.matrices.poisson import cube, poisson_scipy

    a = poisson_scipy(cube(20, "7pt"))
    m = partition_csr(a, 4)
    b = torch.from_numpy(pad_vector(np.ones(a.shape[0]), m))
    res, infos = {}, {}
    n0 = fr.fused_axpy.launches
    for dev in ("cpu", "cuda"):
        pre, infos[dev] = make_amg_preconditioner(a, 4, amgx_analog=amgx, device=dev)
        solve = make_solver(m, variant=variant, precond=pre, tol=1e-10, maxiter=200, device=dev)
        res[dev] = solve(b, torch.zeros_like(b))
    assert infos["cpu"] == infos["cuda"]
    assert fr.fused_axpy.launches - n0 >= 15 * (infos["cuda"].n_levels - 1) * res["cuda"].iters
    assert abs(res["cuda"].iters - res["cpu"].iters) <= 1
    assert float(res["cuda"].rel_residual) <= 1e-10
    xc, xg = res["cpu"].x, res["cuda"].x.cpu()
    assert float((xg - xc).abs().max()) <= 1e-9 * float(xc.abs().max())


def _grid_matrix(side, grid, stencil, device):
    """The pencil-permuted Poisson cube partitioned on ``grid``, on
    ``device``."""
    from repro_torch.core.partition import partition_csr, pencil_partition
    from repro_torch.matrices.poisson import cube, poisson_scipy

    perm, part = pencil_partition(cube(side, stencil), grid)
    a = poisson_scipy(cube(side, stencil))[perm][:, perm].tocsr()
    return partition_csr(a, grid[0] * grid[1], grid=grid, partition=part, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0, 3])
@pytest.mark.parametrize("grid,stencil", [((2, 2), "7pt"), ((3, 2), "27pt"), ((2, 4), "27pt")])
def test_cuda_grid_halo_exchange_equals_cpu_bitwise(cuda_device, grid, stencil, r):
    """The grid halo exchange (every shard's send selection gathered, then
    shifted in both grid dimensions with zeros off the grid) moves the same
    bits on the card as on the CPU, for a vector and a column block."""
    from repro_torch.core.spmv import halo_exchange

    mc = _grid_matrix(12, grid, stencil, "cpu")
    mg = mc.to(cuda_device)
    assert mc.plan.mode == "grid" and len(mc.plan.shifts) >= 2
    shape = (mc.n_shards, mc.n_own_pad) + ((r,) if r else ())
    x = torch.randn(shape, dtype=torch.float64, generator=torch.Generator().manual_seed(r))
    hc = halo_exchange(x, mc)
    hg = halo_exchange(x.to(cuda_device), mg)
    torch.cuda.synchronize()
    assert hc.shape == (mc.n_shards, sum(mc.plan.widths)) + shape[2:]
    assert torch.equal(hg.cpu(), hc)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["hs", "pipecg"])
def test_cuda_grid_solve_matches_cpu(cuda_device, variant):
    """A 2 x 2 grid solve of poisson7 at side 16 through ``api.solve``: the
    same iterations on the card as on the CPU, the hand kernels launched
    on the card, x within 1e-9."""
    from repro_torch import api

    spec, cfg = api.ProblemSpec(side=16, shards=4), api.SolverConfig(variant=variant, grid="2x2")
    n0 = fr.fused_dots_n.launches
    rep = {dev: api.solve(spec, cfg, device=dev, verbose=False) for dev in ("cpu", "cuda")}
    it = {dev: r.summary["BCMGX-analog"]["iters"] for dev, r in rep.items()}
    # one fused dot pass per loop iteration (pipecg's pre-loop step is
    # iteration 1), in the warm-up and the timed solve
    assert fr.fused_dots_n.launches - n0 == 2 * (it["cuda"] - (variant == "pipecg"))
    assert it["cuda"] == it["cpu"] and rep["cuda"].ledger["grid"] == [2, 2]
    assert rep["cuda"].summary["BCMGX-analog"]["relres"] <= 1e-8
    xc, xg = rep["cpu"].outputs["BCMGX-analog"], rep["cuda"].outputs["BCMGX-analog"]
    assert abs(xg - xc).max() <= 1e-9 * abs(xc).max()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 8])
def test_cuda_autotune_matches_cpu(cuda_device, tmp_path, S):
    """The tuner at side 8 with its trials on the card makes the CPU's
    decision (the executed counts are the same): the chosen candidate, each
    trial's iterations, the candidate counts. Every partition the trials
    made stays on the card, and the trials launch the hand kernels."""
    from repro_torch.autotune import autotune
    from repro_torch.matrices.poisson import cube, poisson_scipy

    a = poisson_scipy(cube(8, "7pt"))
    res, mats = {}, {}
    for dev in ("cpu", "cuda"):
        mats[dev] = {}
        n0 = fr.fused_dots_n.launches
        res[dev] = autotune(a, S, device=dev, objective="energy", budget=2, trial_iters=4,
                            cache_path=str(tmp_path / f"{dev}.json"), mats=mats[dev])
    assert fr.fused_dots_n.launches > n0  # the hs and s-step trials ran on the card
    c, g = res["cpu"], res["cuda"]
    assert g.chosen == c.chosen and not g.cached
    assert (g.candidates_total, g.candidates_pruned, g.candidates_trialed) == (
        c.candidates_total, c.candidates_pruned, c.candidates_trialed)
    assert g.candidates_total == (432 if S == 8 else 108)
    assert [(t.candidate, t.executed, t.iters_trial, t.iters_est) for t in g.trials] == [
        (t.candidate, t.executed, t.iters_trial, t.iters_est) for t in c.trials]
    assert set(mats["cuda"]) == set(mats["cpu"])
    assert all(m.device.type == "cuda" for m in mats["cuda"].values())


@pytest.mark.cuda
def test_cuda_tuned_solve_matches_cpu(cuda_device, tmp_path):
    """``api.solve(autotune=True)`` on poisson7 at side 12 over 2 shards:
    the same decision on the card as on the CPU, one leg, iterations within
    1 and x within 1e-9; the repeat is a cache hit."""
    from repro_torch import api

    spec = api.ProblemSpec(side=12, shards=2)
    rep = {}
    for dev in ("cpu", "cuda"):
        cfg = api.SolverConfig(autotune=True, tune_budget=2,
                               tune_cache=str(tmp_path / f"{dev}.json"))
        rep[dev] = api.solve(spec, cfg, device=dev, verbose=False)
        again = api.solve(spec, cfg, device=dev, verbose=False)
        assert again.ledger["autotune"]["cached"]
    c, g = (rep[d].ledger["autotune"] for d in ("cpu", "cuda"))
    assert g["chosen"] == c["chosen"] and set(rep["cuda"].summary) == {"BCMGX-analog"}
    it = {d: r.summary["BCMGX-analog"]["iters"] for d, r in rep.items()}
    assert abs(it["cuda"] - it["cpu"]) <= 1
    assert rep["cuda"].summary["BCMGX-analog"]["relres"] <= 1e-8
    xc, xg = rep["cpu"].outputs["BCMGX-analog"], rep["cuda"].outputs["BCMGX-analog"]
    assert abs(xg - xc).max() <= 1e-9 * abs(xc).max()
