"""Each CUDA kernel of the port against its plain version, on the card.

Marked ``cuda``: they skip where there is no GPU (CUDA kernels have no
CPU mode). This file imports neither JAX nor the JAX package, so it runs
on the card's machine as it is:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: axpy outputs ``|k - p| <= 2 eps (|a x| + |y|)`` (one rounding
of the multiply-add either way); dots, Grams and block updates ``1e-13``
relative to the sum of the magnitudes each entry adds up, in float64 (the
two sides sum in different orders).
"""

import pytest
import torch

from repro_torch.kernels import fused_reductions as fr
from repro_torch.kernels import ref


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
