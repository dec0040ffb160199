"""The port's fused CG kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions (kernels/ref.py);
those are held here against the JAX package's kernels run in interpret
mode, in float32, on ragged lengths and on the stacked (S, R) / (S, R, r)
layouts, with the tolerances ``chip_smoke.py`` uses on the card:

* axpy outputs: ``|k - p| <= 2 eps (|a x| + |y|)`` — one rounding of the
  multiply-add either way;
* dots: ``<= 1e-5`` relative to ``sum |x_i y_i|`` in float32 — the two
  sides sum in different orders;
* Grams and block updates: ``<= 1e-5`` relative to ``sum_i |x_ia y_ib|``
  (Gram entry ab) or ``|y| + |x| @ |M|`` (update entry) in float32 — the
  same reordered sums, r products deep per update entry.

``tests/test_torch_cuda.py`` compares each CUDA kernel with its plain
version on the card.
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


@pytest.mark.parametrize("n,chunk", LENGTHS)
def test_axpy2_matches_pallas(n, chunk):
    x1, y1, x2, y2 = _vecs(n + 3, 4, n)
    a1, a2 = np.float32(0.37), np.float32(-1.1)
    r1, r2 = jfr.fused_axpy2(a1, *(jnp.asarray(v) for v in (x1, y1)), a2,
                             *(jnp.asarray(v) for v in (x2, y2)), chunk=chunk,
                             interpret=True)
    t = [torch.from_numpy(v) for v in (x1, y1, x2, y2)]
    o1, o2 = fr.fused_axpy2(torch.tensor(a1), t[0], t[1], torch.tensor(a2), t[2], t[3])
    _assert_axpy(o1.numpy(), np.asarray(r1), a1, x1, y1)
    _assert_axpy(o2.numpy(), np.asarray(r2), a2, x2, y2)


def _blocks(seed, k, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(k)]


def _assert_block(k, p, scale):
    """|k - p| <= 1e-5 * scale, elementwise, in float64."""
    k, p = np.asarray(k, np.float64), np.asarray(p, np.float64)
    assert np.all(np.abs(k - p) <= DOT_TOL * np.asarray(scale, np.float64))


def _gram_scale(x, y):
    return np.abs(np.asarray(x, np.float64)).T @ np.abs(np.asarray(y, np.float64))


def _update_scale(m, x, y, mask=None):
    y = np.abs(np.asarray(y, np.float64))
    ym = y if mask is None else y * np.abs(mask)
    return ym + np.abs(np.asarray(x, np.float64)) @ np.abs(np.asarray(m, np.float64))


# (n, reference chunk) x r: ragged tails, one and several column tiles
BLOCK_CASES = [(n, chunk, r) for n, chunk in ((1001, 256), (77, 1024))
               for r in (1, 3, 8, 17)]


@pytest.mark.parametrize("n,chunk,r", BLOCK_CASES)
def test_block_gram_matches_pallas_ordered_dedup(n, chunk, r):
    x, y = _blocks(n * r, 2, (n, r))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    # aliasing and reversed pairs: (X, Y) and (Y, X) are different products
    ref_g = jfr.block_gram([(jx, jy), (jy, jx), (jx, jx), (jx, jy)], chunk=chunk,
                           interpret=True)
    got = fr.block_gram([(tx, ty), (ty, tx), (tx, tx), (tx, ty)])
    scales = [_gram_scale(x, y), _gram_scale(y, x), _gram_scale(x, x), _gram_scale(x, y)]
    for g, rg, sc in zip(got, ref_g, scales):
        assert g.shape == (r, r)
        _assert_block(g.numpy(), np.asarray(rg), sc)
    uniq, prods, out_map = fr.dedup_pairs_ordered([(tx, ty), (ty, tx), (tx, tx), (tx, ty)])
    assert len(uniq) == 2 and prods == ((0, 1), (1, 0), (0, 0)) and out_map == (0, 1, 2, 0)
    assert (prods, out_map) == jfr._dedup_pairs_ordered(
        [(jx, jy), (jy, jx), (jx, jx), (jx, jy)])[1:]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,chunk,r", BLOCK_CASES)
def test_block_update_matches_pallas(n, chunk, r, masked):
    x, y = _blocks(n + r, 2, (n, r))
    (m,) = _blocks(r, 1, (r, r))
    mask = (np.arange(r) % 2 == 0).astype(np.float32) if masked else None
    ref_o = jfr.block_update(jnp.asarray(m), jnp.asarray(x), jnp.asarray(y),
                             None if mask is None else jnp.asarray(mask),
                             chunk=chunk, interpret=True)
    o = fr.block_update(torch.from_numpy(m), torch.from_numpy(x), torch.from_numpy(y),
                        None if mask is None else torch.from_numpy(mask))
    assert o.shape == (n, r)
    _assert_block(o.numpy(), np.asarray(ref_o), _update_scale(m, x, y, mask))


@pytest.mark.parametrize("n,chunk,r", BLOCK_CASES)
def test_block_update2_matches_pallas(n, chunk, r):
    x1, y1, x2, y2 = _blocks(n * 7 + r, 4, (n, r))
    a1, a2 = _blocks(r + 1, 2, (r, r))
    r1, r2 = jfr.block_update2(*(jnp.asarray(v) for v in (a1, x1, y1, a2, x2, y2)),
                               chunk=chunk, interpret=True)
    o1, o2 = fr.block_update2(*(torch.from_numpy(v) for v in (a1, x1, y1, a2, x2, y2)))
    _assert_block(o1.numpy(), np.asarray(r1), _update_scale(a1, x1, y1))
    _assert_block(o2.numpy(), np.asarray(r2), _update_scale(a2, x2, y2))


@pytest.mark.parametrize("S,R,r", [(4, 1001, 3), (2, 300, 8), (3, 77, 17)])
def test_stacked_blocks_match_per_shard_pallas(S, R, r):
    """(S, R, r) stacks give per-shard Grams and updates equal to the Pallas
    kernels run on each shard's block, through the dispatch OpSet."""
    p, w, x, res = _blocks(S * R * r, 4, (S, R, r))
    a, m = _blocks(r, 2, (r, r))
    mask = (np.arange(r) % 3 != 1).astype(np.float32)
    tp, tw, tx, tres = (torch.from_numpy(v) for v in (p, w, x, res))
    ops = kd.ops_for("torch")
    pw, rr = ops.block_gram([(tp, tw), (tres, tres)])
    o1, o2 = ops.block_update2(torch.from_numpy(a), tp, tx, -torch.from_numpy(a), tw, tres)
    pu = ops.block_update(torch.from_numpy(m), tp, tres, mask=torch.from_numpy(mask))
    assert pw.shape == rr.shape == (S, r, r) and o1.shape == pu.shape == (S, R, r)
    for s in range(S):
        js = [jnp.asarray(v[s]) for v in (p, w, x, res)]
        g_pw, g_rr = jfr.block_gram([(js[0], js[1]), (js[3], js[3])], chunk=256,
                                    interpret=True)
        _assert_block(pw[s].numpy(), np.asarray(g_pw), _gram_scale(p[s], w[s]))
        _assert_block(rr[s].numpy(), np.asarray(g_rr), _gram_scale(res[s], res[s]))
        r1, r2 = jfr.block_update2(jnp.asarray(a), js[0], js[2], -jnp.asarray(a), js[1],
                                   js[3], chunk=256, interpret=True)
        _assert_block(o1[s].numpy(), np.asarray(r1), _update_scale(a, p[s], x[s]))
        _assert_block(o2[s].numpy(), np.asarray(r2), _update_scale(a, w[s], res[s]))
        ru = jfr.block_update(jnp.asarray(m), js[0], js[3], jnp.asarray(mask), chunk=256,
                              interpret=True)
        _assert_block(pu[s].numpy(), np.asarray(ru), _update_scale(m, p[s], res[s], mask))


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
    fr.fused_axpy2(1.0, x, y, -1.0, y, x)
    X, Y = x.view(20, 5), y.view(20, 5)
    M = torch.eye(5, dtype=X.dtype)
    fr.block_gram([(X, Y)])
    fr.block_update(M, X, Y, mask=torch.ones(5, dtype=X.dtype))
    fr.block_update2(M, X, Y, M, Y, X)
    assert fr.launches() == dict.fromkeys(fr.KERNELS, 0)
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
    with pytest.raises(ValueError, match="stacked shard blocks"):
        kd.ops_for(None).block_update(torch.eye(4), vs[0], vs[1])
    bs = [v.view(4, 4) for v in vs]
    with pytest.raises(ValueError, match="at most 4 distinct operands"):
        fr.block_gram([(bs[0], bs[1]), (bs[2], bs[3]), (bs[4], bs[4])])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kd.ops_for("cuda").block_gram([(bs[0], bs[1])])
    assert kd.ops_for("auto").backend is None
    assert kd.ops_for("torch").axpy(1.0, vs[0], vs[1]).shape == (16,)
