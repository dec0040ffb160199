"""The port's fused hs-CG kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions (kernels/ref.py);
those are held here against the JAX package's kernels run in interpret
mode, in float32, on ragged lengths and on the stacked (S, R) layout, with
the tolerances ``chip_smoke.py`` uses on the card:

* axpy outputs: ``|k - p| <= 2 eps (|a x| + |y|)`` — one rounding of the
  multiply-add either way;
* dots: ``<= 1e-5`` relative to ``sum |x_i y_i|`` in float32 — the two
  sides sum in different orders.

The tests marked ``cuda`` compare each CUDA kernel with its plain version
on the card and skip where there is none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_reductions as jfr
from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import fused_reductions as fr
from repro_torch.kernels import ref

EPS32 = float(np.finfo(np.float32).eps)
DOT_TOL = 1e-5
# (n, reference chunk): ragged tails over several grid steps, and one step
LENGTHS = [(1001, 256), (513, 128), (4096, 1024), (77, 65536)]


def _vecs(seed, k, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(dtype) for _ in range(k)]


def _assert_axpy(k, p, a, x, y):
    k, p, x, y = (np.asarray(v, np.float64) for v in (k, p, x, y))
    bound = 2 * EPS32 * (np.abs(a * x) + np.abs(y))
    assert np.all(np.abs(k - p) <= bound)


def _assert_dots(k, p, scale):
    k, p = np.asarray(k, np.float64), np.asarray(p, np.float64)
    assert np.all(np.abs(k - p) <= DOT_TOL * np.asarray(scale, np.float64))


@pytest.mark.parametrize("n,chunk", LENGTHS)
def test_dots_n_matches_pallas_dedup(n, chunk):
    r_np, w_np = _vecs(n, 2, n)
    r_j, w_j = jnp.asarray(r_np), jnp.asarray(w_np)
    u_j = r_j  # identity-preconditioner aliasing: u is r
    d_ref = jfr.fused_dots_n([(r_j, u_j), (w_j, u_j), (r_j, r_j)],
                             chunk=chunk, interpret=True)
    r_t, w_t = torch.from_numpy(r_np), torch.from_numpy(w_np)
    u_t = r_t
    d = fr.fused_dots_n([(r_t, u_t), (w_t, u_t), (r_t, r_t)])
    assert d.shape == (3,)
    scale = [np.abs(r_np * r_np).sum(), np.abs(w_np * r_np).sum(),
             np.abs(r_np * r_np).sum()]
    _assert_dots(d.numpy(), np.asarray(d_ref), scale)
    assert d[0].item() == d[2].item()
    # the dedup the kernel relies on: {r, w} read once, (r, r) formed once
    uniq, prods, out_map = fr.dedup_pairs([(r_t, u_t), (w_t, u_t), (r_t, r_t)])
    assert len(uniq) == 2 and prods == ((0, 0), (0, 1)) and out_map == (0, 1, 0)
    assert fr.dedup_pairs([(r_j, u_j), (w_j, u_j), (r_j, r_j)])[1:] == \
        jfr._dedup_pairs([(r_j, u_j), (w_j, u_j), (r_j, r_j)])[1:]


@pytest.mark.parametrize("n,chunk", LENGTHS)
def test_axpy_matches_pallas(n, chunk):
    x, y = _vecs(n + 1, 2, n)
    a = np.float32(0.37)
    o_ref = np.asarray(jfr.fused_axpy(a, jnp.asarray(x), jnp.asarray(y),
                                      chunk=chunk, interpret=True))
    o = fr.fused_axpy(torch.tensor(a), torch.from_numpy(x), torch.from_numpy(y))
    _assert_axpy(o.numpy(), o_ref, a, x, y)


@pytest.mark.parametrize("n,chunk", LENGTHS)
def test_axpy2_dots_matches_pallas(n, chunk):
    x1, y1, x2, y2 = _vecs(n + 2, 4, n)
    a1, a2 = np.float32(0.37), np.float32(-1.1)
    r1, r2, rd = jfr.fused_axpy2_dots(
        a1, *(jnp.asarray(v) for v in (x1, y1)), a2,
        *(jnp.asarray(v) for v in (x2, y2)), chunk=chunk, interpret=True,
    )
    t = [torch.from_numpy(v) for v in (x1, y1, x2, y2)]
    o1, o2, d = fr.fused_axpy2_dots(torch.tensor(a1), t[0], t[1],
                                    torch.tensor(a2), t[2], t[3])
    assert d.shape == (1,)
    _assert_axpy(o1.numpy(), np.asarray(r1), a1, x1, y1)
    _assert_axpy(o2.numpy(), np.asarray(r2), a2, x2, y2)
    r2n = np.asarray(r2, np.float64)
    _assert_dots(d.numpy(), np.asarray(rd), [np.sum(r2n * r2n)])


@pytest.mark.parametrize("S,R", [(4, 1001), (2, 4096), (3, 77)])
def test_stacked_layout_matches_per_shard_pallas(S, R):
    """(S, R) stacks give per-shard partials equal to the Pallas kernel run
    on each shard's vector, with a per-shard (S,) scalar."""
    rng = np.random.default_rng(S * R)
    p, w, x, r = (rng.standard_normal((S, R)).astype(np.float32) for _ in range(4))
    alpha = rng.uniform(0.5, 1.5, S).astype(np.float32)
    tp, tw, tx, tr = (torch.from_numpy(v) for v in (p, w, x, r))
    ta = torch.from_numpy(alpha)
    d = fr.fused_dots_n([(tp, tw), (tr, tr)])
    o1, o2, nrm = fr.fused_axpy2_dots(ta, tp, tx, -ta, tw, tr)
    ax = fr.fused_axpy(ta, tp, tr)
    assert d.shape == (S, 2) and nrm.shape == (S, 1) and o1.shape == (S, R)
    for s in range(S):
        js = [jnp.asarray(v[s]) for v in (p, w, x, r)]
        d_ref = jfr.fused_dots_n([(js[0], js[1]), (js[3], js[3])], chunk=256,
                                 interpret=True)
        _assert_dots(d[s].numpy(), np.asarray(d_ref),
                     [np.abs(p[s] * w[s]).sum(), np.abs(r[s] * r[s]).sum()])
        r1, r2, rd = jfr.fused_axpy2_dots(alpha[s], js[0], js[2], -alpha[s],
                                          js[1], js[3], chunk=256, interpret=True)
        _assert_axpy(o1[s].numpy(), np.asarray(r1), alpha[s], p[s], x[s])
        _assert_axpy(o2[s].numpy(), np.asarray(r2), -alpha[s], w[s], r[s])
        r2n = np.asarray(r2, np.float64)
        _assert_dots(nrm[s].numpy(), np.asarray(rd), [np.sum(r2n * r2n)])
        ra = jfr.fused_axpy(alpha[s], js[0], js[3], chunk=256, interpret=True)
        _assert_axpy(ax[s].numpy(), np.asarray(ra), alpha[s], p[s], r[s])


def test_cpu_tensors_run_plain_versions_without_launching():
    fr.reset_launches()
    x, y = (torch.from_numpy(v) for v in _vecs(5, 2, 100, np.float64))
    fr.fused_dots_n([(x, y)])
    fr.fused_axpy(2.0, x, y)
    fr.fused_axpy2_dots(1.0, x, y, -1.0, y, x)
    assert fr.launches() == {"fused_dots_n": 0, "fused_axpy": 0,
                             "fused_axpy2_dots": 0}
    torch.testing.assert_close(fr.fused_axpy(2.0, x, y), ref.fused_axpy_ref(2.0, x, y),
                               rtol=0, atol=0)


def test_operand_limits_and_backend_checks():
    vs = [torch.from_numpy(v) for v in _vecs(9, 5, 16)]
    with pytest.raises(ValueError, match="at most 4 distinct operands"):
        fr.fused_dots_n([(vs[0], vs[1]), (vs[2], vs[3]), (vs[4], vs[4])])
    with pytest.raises(ValueError, match="distinct products"):
        fr.fused_dots_n([(vs[i], vs[j]) for i in range(3) for j in range(i, 3)]
                        + [(vs[0], vs[3])])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kd.ops_for("cuda").axpy(1.0, vs[0], vs[1])
    with pytest.raises(ValueError, match="unknown kernel backend"):
        kd.ops_for("pallas")
    with pytest.raises(ValueError, match="stacked shard vectors"):
        kd.ops_for(None).axpy(1.0, vs[0].view(2, 2, 4), vs[1].view(2, 2, 4))
    assert kd.ops_for("auto").backend is None
    assert kd.ops_for("torch").axpy(1.0, vs[0], vs[1]).shape == (16,)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_vecs(dev, k, S=4, R=100_003, dtype=torch.float64):
    g = torch.Generator(device=dev).manual_seed(k)
    return [torch.randn(S, R, dtype=dtype, device=dev, generator=g) for _ in range(k)]


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
