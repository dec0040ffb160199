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
def test_cuda_fused_axpy_matches_plain(cuda_device):
    x, y = _card_vecs(cuda_device, 2)
    a = torch.tensor(0.37, dtype=x.dtype, device=cuda_device)
    o = fr.fused_axpy(a, x, y)
    p = ref.fused_axpy_ref(a, x, y)
    torch.cuda.synchronize()
    eps = torch.finfo(x.dtype).eps
    assert bool(((o - p).abs() <= 2 * eps * ((a * x).abs() + y.abs())).all())


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


def _card_bcsr(dev, b, bpr, dtype, S=4, R=50_003, seed=0):
    """A stacked uniform-layout BCSR operand on the card with a ragged R
    (not a multiple of b) and padding tiles (zero, block column 0) in
    every block-row past its first tile."""
    g = torch.Generator(device=dev).manual_seed(seed + 31 * b + bpr)
    NB = -(-R // b)
    n_bcols = NB
    blocks = torch.randn(S, NB * bpr, b, b, dtype=dtype, device=dev, generator=g)
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
@pytest.mark.parametrize("r", [1, 3, 8])
@pytest.mark.parametrize("b", [2, 4, 16])
@pytest.mark.parametrize("bpr", [1, 13])
def test_cuda_bcsr_spmm_matches_plain(cuda_device, bpr, b, r, dtype):
    blocks, bcol, NB, R = _card_bcsr(cuda_device, b, bpr, dtype, R=20_011)
    x = torch.randn(4, R, r, dtype=dtype, device=cuda_device)
    n0 = sb.bcsr_spmm.launches
    y = sb.bcsr_spmm(blocks, bcol, x, n_brows=NB, bpr=bpr)
    torch.cuda.synchronize()
    assert sb.bcsr_spmm.launches == n0 + 1
    assert y.shape == (4, R, r)
    p = ref.bcsr_spmm_ref(blocks, bcol, x, NB, bpr)
    scale = ref.bcsr_spmm_ref(blocks.abs(), bcol, x.abs(), NB, bpr)
    assert _block_err(y, p, scale) <= BCSR_TOL[dtype]
    assert torch.equal(y, sb.bcsr_spmm(blocks, bcol, x, n_brows=NB, bpr=bpr))


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
