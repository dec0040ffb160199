"""The port's AMG-preconditioned CG (BCMG and AmgX analogs) against the JAX
package, in float64, on the CPU.

As in ``tests/test_torch_sstep.py``, ONE module-scoped subprocess with 4
host devices and x64 runs the reference, written to a ``.npz`` + ``.json``
pair. It compiles 8 programs (the JAX matcher at two shapes, four AMG
solves and the two legs of ``api.solve`` with ``amg`` and
``amgx_analog``), so that it stays cheap beside the JAX package's own
multi-device tests; its hierarchies are host setup and compile nothing.
The port must give:

* the matching weights, ``weights_to_ell``, both matchers (the torch one on
  the CPU against the numpy ones and ``locally_dominant_matching_jax``),
  ``decoupled_aggregate`` (P and ``coarse_starts``), ``rap`` and
  ``l1_diagonal``: byte for byte, on poisson7/27 at sides 10 and 12, on 1
  and 4 shards, and on random symmetric graphs (the numpy functions of the
  JAX package run in this process);
* the whole ``build_amg`` hierarchy (every level's arrays and matrix,
  ``dense_inv``, ``AMGInfo``): byte for byte, for the BCMG and the AmgX
  analog, on the same cubes and shard counts;
* AMG-PCG hs, fcg, pipecg and the AmgX analog's hs on poisson7 at side 12
  over 4 shards with a seeded right-hand side: the same ``iters``, ``x``
  within 1e-10 relative, per-region counts (``vcycle`` included) within
  1e-12 when priced with ``TPU_V5E`` — also with the reference's hierarchy
  carried over by ``amg_from_numpy``;
* ``api.solve`` with ``amg`` and ``amgx_analog``: the same single leg,
  iterations, per-region counts and ``amg`` payload; the CLI prints the
  same iterations.
"""

import dataclasses
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tests.conftest import run_multidevice
from tests.test_torch_solve import _assert_close_tree, _tpu_cost

HIER_CASES = [(st, side, S, amgx) for st in ("7pt", "27pt") for side in (10, 12)
              for S in (1, 4) for amgx in (False, True)]
GRAPHS = [(60, 0.2, 0), (97, 0.1, 1)]  # (n, density, seed): the JAX matcher's shapes
SIDE, SHARDS = 12, 4
SOLVE_CASES = [("hs", False), ("fcg", False), ("pipecg", False), ("hs", True)]
LEAVES = ("data", "col", "data_ext", "col_ext", "bnd_rows", "send_sel")
LEVEL_FIELDS = ("p_data", "p_col", "pt_data", "pt_col", "dinv")
API_KEYS = ("iters", "relres", "variant")
AMG_KEYS = ("n_levels", "level_rows", "level_nnz", "operator_complexity")

REF_SNIPPET = r"""
import json
import numpy as np
import scipy.sparse as sp
from repro.matrices.poisson import cube, poisson_scipy
from repro.core.partition import partition_csr, pad_vector, unpad_vector
from repro.core.spmv import shard_matrix, shard_vector
from repro.core.cg import make_solver
from repro.core.amg import make_amg_preconditioner
from repro.core.amg.matching import locally_dominant_matching_jax, weights_to_ell
from repro.energy import trace
from repro.energy.accounting import CostModel
from repro.launch.mesh import make_solver_mesh

out = "OUT"
arrays, meta = {}, {}
cost = CostModel()

def sym_graph(n, density, seed):
    a = sp.random(n, n, density=density, format="csr", random_state=seed)
    a = a + a.T
    a.setdiag(0)
    a.eliminate_zeros()
    a.data = np.abs(a.data) + 0.1
    return a.tocsr()

# --- the JAX matcher (one program per shape) --------------------------------
for n, dens, seed in %(graphs)r:
    wd, wc = weights_to_ell(sym_graph(n, dens, seed))
    arrays[f"jm_{seed}"] = np.asarray(locally_dominant_matching_jax(wd, wc))

# --- hierarchies (host setup: no program) -----------------------------------
pres = {}
for st, side, S, amgx in %(hier_cases)r:
    a = poisson_scipy(cube(side, st))
    pre, info = make_amg_preconditioner(a, S, amgx_analog=amgx)
    tag = f"h_{st}_{side}_{S}_{int(amgx)}"
    if (st, side, S) == ("7pt", %(side)d, %(shards)d):
        pres[amgx] = pre
    levels, dense_inv = pre.data
    arrays[f"{tag}_dense_inv"] = np.asarray(dense_inv)
    mats = []
    for l, lev in enumerate(levels):
        for f in %(level_fields)r:
            arrays[f"{tag}_{l}_{f}"] = np.asarray(getattr(lev, f))
        m = lev.mat
        leaves = dict(data=m.interior.data, col=m.interior.col, data_ext=m.data_ext,
                      col_ext=m.col_ext, bnd_rows=m.bnd_rows, send_sel=m.send_sel)
        for k, v in leaves.items():
            arrays[f"{tag}_{l}_{k}"] = np.asarray(v)
        p = m.plan
        mats.append(dict(plan=[p.mode, list(p.shifts), list(p.widths), p.n_own_pad,
                               p.n_shards],
                         n_bnd=list(m.n_bnd), row_starts=list(m.row_starts),
                         n_global=int(m.n_global)))
    meta[tag] = dict(level_rows=list(info.level_rows), level_nnz=list(info.level_nnz),
                     coarse_rows=info.coarse_rows, n_levels=info.n_levels,
                     opcx=info.operator_complexity, mats=mats)

# --- AMG-PCG solves (one program each) --------------------------------------
a = poisson_scipy(cube(%(side)d, "7pt"))
bs = np.random.default_rng(0).standard_normal(a.shape[0])
mesh = make_solver_mesh(%(shards)d)
m = partition_csr(a, %(shards)d)
mm = shard_matrix(mesh, m)
bp = pad_vector(bs, m)
for variant, amgx in %(solve_cases)r:
    solver = make_solver(mesh, mm, variant=variant, precond=pres[amgx], tol=1e-8,
                         maxiter=200)
    with trace.capture() as tr:
        res = solver(shard_vector(mesh, bp), shard_vector(mesh, np.zeros_like(bp)))
    iters = int(res.iters)
    led = trace.ledger_from_trace(tr, iters=iters, n_shards=%(shards)d, cost=cost,
                                  overlap=True, idle_s=0.01)
    tag = f"solve_{variant}_{int(amgx)}"
    arrays[f"{tag}_x"] = unpad_vector(np.asarray(res.x), m)
    meta[tag] = dict(iters=iters, ledger=dict(regions=led["regions"], totals=led["totals"]))

# --- the driver ---------------------------------------------------------------
from repro import api as japi
for flag in ("amg", "amgx_analog"):
    rep = japi.solve(japi.ProblemSpec(side=%(side)d, shards=%(shards)d),
                     japi.SolverConfig(**{flag: True}), verbose=False)
    meta[f"api_{flag}"] = dict(
        amg=rep.ledger["amg"],
        legs={label: dict({k: e.get(k) for k in %(api_keys)r},
                          regions={r: {c: v[c] for c in ("flops", "hbm_bytes", "ici_bytes")}
                                   for r, v in e["regions"].items()})
              for label, e in rep.solvers.items()},
    )
np.savez(out + ".npz", **arrays)
with open(out + ".json", "w") as f:
    json.dump(meta, f)
print("REF_OK")
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread (its tensors are tiny), so it
    takes no cores from the reference subprocesses beside it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_amg_ref") / "ref")
    code = REF_SNIPPET % {
        "graphs": GRAPHS, "hier_cases": HIER_CASES, "side": SIDE, "shards": SHARDS,
        "level_fields": LEVEL_FIELDS, "solve_cases": SOLVE_CASES, "api_keys": API_KEYS,
    }
    code = code.replace('out = "OUT"', f"out = {out!r}")
    assert "REF_OK" in run_multidevice(code, n_devices=4, x64=True)
    arrays = dict(np.load(out + ".npz"))
    with open(out + ".json") as f:
        meta = json.load(f)
    return arrays, meta


def _sym_graph(n, density, seed):
    a = sp.random(n, n, density=density, format="csr", random_state=seed)
    a = a + a.T
    a.setdiag(0)
    a.eliminate_zeros()
    a.data = np.abs(a.data) + 0.1
    return a.tocsr()


def _cube(stencil, side):
    from repro_torch.matrices.poisson import cube, poisson_scipy

    return poisson_scipy(cube(side, stencil))


def _starts(n, S):
    return tuple(int(v) for v in np.linspace(0, n, S + 1).astype(np.int64))


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    assert got.tobytes() == want.tobytes(), what


def _same_csr(got, want):
    got, want = got.tocsr(), want.tocsr()
    for k in ("indptr", "indices", "data"):
        _same(getattr(got, k), getattr(want, k), k)
    assert got.shape == want.shape


GRAPH_CASES = [("7pt", 10), ("27pt", 10), ("7pt", 12), ("27pt", 12), "g0", "g1", "g2"]


def _graph_matrix(case):
    """A level matrix (a cube) or, for ``"g<seed>"``, a random symmetric
    graph with a dominant diagonal."""
    if isinstance(case, tuple):
        return _cube(*case)
    seed = int(case[1:])
    w = _sym_graph(50 + 17 * seed, 0.15, seed)
    return (w + sp.diags(np.asarray(w.sum(axis=1)).ravel() + 1.0)).tocsr()


# ---------------------------------------------------------------------------
# Host setup against the JAX package's numpy functions (in-process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_weights_ell_and_matchers_match_reference(case):
    from repro.core.amg import matching as jm

    from repro_torch.core.amg import matching as tm

    a = _graph_matrix(case)
    for fn in ("compatible_weights", "plain_weights"):
        w, jw = getattr(tm, fn)(a), getattr(jm, fn)(a)
        _same_csr(w, jw)
        wd, wc = tm.weights_to_ell(w)
        jwd, jwc = jm.weights_to_ell(jw)
        _same(wd, jwd, "wdata")
        _same(wc, jwc, "wcol")
        want = jm.locally_dominant_matching_np(jwd, jwc)
        _same(tm.locally_dominant_matching(wd, wc, device="cpu"), want, "torch locdom")
        _same(tm.locally_dominant_matching_np(wd, wc), want, "numpy locdom")
        _same(tm.greedy_scan_matching_np(wd, wc), jm.greedy_scan_matching_np(jwd, jwc), "scan")


def test_torch_matcher_equals_jax_matcher(reference):
    from repro_torch.core.amg import matching as tm

    arrays, _ = reference
    for n, dens, seed in GRAPHS:
        wd, wc = tm.weights_to_ell(_sym_graph(n, dens, seed))
        got = tm.locally_dominant_matching(wd, wc, device="cpu")
        assert (got == arrays[f"jm_{seed}"]).all()
        assert (got[got] == np.arange(n)).all()  # an involution


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("case", GRAPH_CASES)
def test_aggregation_rap_and_l1_match_reference(case, S):
    from repro.core.amg import aggregation as ja
    from repro.core.amg import galerkin as jg

    from repro_torch.core.amg import aggregation as ta
    from repro_torch.core.amg import galerkin as tg

    a = _graph_matrix(case)
    rs = _starts(a.shape[0], S)
    for weighting, matcher in (("compatible", "locdom"), ("plain", "scan")):
        p, cs = ta.decoupled_aggregate(a, rs, weighting=weighting, matcher=matcher,
                                       device="cpu")
        jp, jcs = ja.decoupled_aggregate(a, rs, weighting=weighting, matcher=matcher)
        assert cs == jcs
        _same_csr(p, jp)
        _same_csr(tg.rap(a, p), jg.rap(a, jp))
    _same(tg.l1_diagonal(a), jg.l1_diagonal(a), "l1")
    agg = ta.match_to_aggregates(np.array([1, 0, 2, 4, 3, 5]))
    assert agg.tolist() == ja.match_to_aggregates(np.array([1, 0, 2, 4, 3, 5])).tolist()


# ---------------------------------------------------------------------------
# Against the reference subprocess
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("st,side,S,amgx", HIER_CASES)
def test_hierarchy_matches_reference_bytes(reference, st, side, S, amgx):
    from repro_torch.core.amg import make_amg_preconditioner

    arrays, meta = reference
    tag = f"h_{st}_{side}_{S}_{int(amgx)}"
    m = meta[tag]
    pre, info = make_amg_preconditioner(_cube(st, side), S, amgx_analog=amgx, device="cpu")
    assert (list(info.level_rows), list(info.level_nnz), info.coarse_rows, info.n_levels) == \
        (m["level_rows"], m["level_nnz"], m["coarse_rows"], m["n_levels"])
    assert info.operator_complexity == m["opcx"]
    levels, dense_inv = pre.data
    assert len(levels) == len(m["mats"])
    _same(dense_inv.numpy(), arrays[f"{tag}_dense_inv"], "dense_inv")
    for l, (lev, mm) in enumerate(zip(levels, m["mats"])):
        for f in LEVEL_FIELDS:
            _same(getattr(lev, f).numpy(), arrays[f"{tag}_{l}_{f}"], f"{l} {f}")
        leaves = dict(data=lev.mat.interior.data, col=lev.mat.interior.col)
        leaves.update({k: getattr(lev.mat, k) for k in LEAVES[2:]})
        for k, v in leaves.items():
            _same(v.numpy(), arrays[f"{tag}_{l}_{k}"], f"{l} {k}")
        p = lev.mat.plan
        assert [p.mode, list(p.shifts), list(p.widths), p.n_own_pad, p.n_shards] == mm["plan"]
        assert list(lev.mat.n_bnd) == mm["n_bnd"]
        assert list(lev.mat.row_starts) == mm["row_starts"]


def _carried(arrays, meta, tag):
    """The reference's hierarchy ``tag`` as ``amg_from_numpy``'s levels."""
    levels = []
    for l, mm in enumerate(meta[tag]["mats"]):
        mode, shifts, widths, R, nS = mm["plan"]
        lev = {f: arrays[f"{tag}_{l}_{f}"] for f in LEVEL_FIELDS}
        lev["mat"] = dict(
            {k: arrays[f"{tag}_{l}_{k}"] for k in LEAVES},
            mode=mode, shifts=shifts, widths=widths, n_own_pad=R, n_shards=nS,
            n_global=mm["n_global"], row_starts=mm["row_starts"], n_bnd=mm["n_bnd"],
        )
        levels.append(lev)
    return levels, arrays[f"{tag}_dense_inv"]


def _solve(pre, variant):
    from repro_torch.core.cg import make_solver
    from repro_torch.core.partition import pad_vector, partition_csr, unpad_vector
    from repro_torch.energy import trace

    a = _cube("7pt", SIDE)
    m = partition_csr(a, SHARDS)
    b = torch.from_numpy(pad_vector(np.random.default_rng(0).standard_normal(a.shape[0]), m))
    solver = make_solver(m, variant=variant, precond=pre, tol=1e-8, maxiter=200, device="cpu")
    with trace.capture() as tr:
        res = solver(b, torch.zeros_like(b))
    led = trace.ledger_from_trace(tr, iters=res.iters, n_shards=SHARDS, cost=_tpu_cost(),
                                  overlap=True, idle_s=0.01)
    return res, unpad_vector(res.x, m), led


def _check_solve(res, x, led, arrays, meta, tag):
    want = meta[tag]
    assert res.iters == want["iters"]
    assert float(res.rel_residual) <= 1e-8
    x_ref = arrays[f"{tag}_x"]
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    assert "vcycle" in led["regions"]
    _assert_close_tree({k: led[k] for k in ("regions", "totals")}, want["ledger"], tag)


@pytest.mark.parametrize("variant,amgx", SOLVE_CASES)
def test_amg_pcg_matches_reference(reference, variant, amgx):
    from repro_torch.core.amg import make_amg_preconditioner

    arrays, meta = reference
    pre, _ = make_amg_preconditioner(_cube("7pt", SIDE), SHARDS, amgx_analog=amgx,
                                     device="cpu")
    res, x, led = _solve(pre, variant)
    _check_solve(res, x, led, arrays, meta, f"solve_{variant}_{int(amgx)}")


@pytest.mark.parametrize("amgx", [False, True])
def test_carried_reference_hierarchy_gives_same_solve(reference, amgx):
    from repro_torch.core.amg import amg_from_numpy

    arrays, meta = reference
    levels, dense_inv = _carried(arrays, meta, f"h_7pt_{SIDE}_{SHARDS}_{int(amgx)}")
    res, x, led = _solve(amg_from_numpy(levels, dense_inv, device="cpu"), "hs")
    _check_solve(res, x, led, arrays, meta, f"solve_hs_{int(amgx)}")


@pytest.mark.parametrize("flag", ["amg", "amgx_analog"])
def test_api_solve_amg_matches_reference(reference, flag):
    from repro_torch import api

    _, meta = reference
    want = meta[f"api_{flag}"]
    spec, config = api.ProblemSpec(side=SIDE, shards=SHARDS), api.SolverConfig(**{flag: True})
    sess = api.SolverSession(spec.load()[0], SHARDS, device="cpu")  # builds the hierarchy
    rep = api.solve(spec, config, session=sess, verbose=False)
    assert {k: rep.ledger["amg"][k] for k in AMG_KEYS} == {k: want["amg"][k] for k in AMG_KEYS}
    assert set(rep.solvers) == set(want["legs"])  # the one PCG leg, no Ginkgo leg
    for label, w in want["legs"].items():
        e = rep.solvers[label]
        assert e["iters"] == w["iters"] and e["variant"] == w["variant"]
        assert abs(e["relres"] - w["relres"]) <= 1e-6 * w["relres"]
        assert e["setup_s"] > 0
        got = {r: {c: v[c] for c in ("flops", "hbm_bytes", "ici_bytes")}
               for r, v in e["regions"].items()}
        _assert_close_tree(got, w["regions"], label)
    # a second solve on the session reuses the hierarchy and reports no setup
    again = api.solve(spec, config, session=sess, verbose=False)
    for label, e in again.solvers.items():
        assert e["setup_s"] == 0.0 and e["iters"] == rep.solvers[label]["iters"]


@pytest.mark.parametrize("flag", ["--amg", "--amgx-analog"])
def test_cli_amg_prints_reference_iters(reference, flag, capsys):
    """The CLI's ``main`` in this process (``tests/test_torch_solve.py``
    runs ``python -m repro_torch.launch.solve`` itself)."""
    from repro_torch.launch.solve import main

    _, meta = reference
    want = meta["api_" + flag[2:].replace("-", "_")]["legs"]
    (label, w), = want.items()
    main(["--device", "cpu", flag, "--side", str(SIDE), "--shards", str(SHARDS)])
    out = capsys.readouterr().out
    assert f"{label:14s} iters={w['iters']} " in out, out
    assert "Ginkgo-analog" not in out and "AMG: " in out


# ---------------------------------------------------------------------------
# Port only
# ---------------------------------------------------------------------------


def test_vcycle_routes_its_updates_through_axpy():
    """Per V-cycle, each non-coarsest level runs 15 ``OpSet.axpy`` updates
    (3 + 4 smoothing sweeps of two each, one residual) and 8 level SpMVs."""
    from repro_torch.core.amg import make_amg_preconditioner
    from repro_torch.core.partition import partition_csr
    from repro_torch.energy import trace
    from repro_torch.kernels import dispatch as kd

    a = _cube("7pt", 10)
    pre, info = make_amg_preconditioner(a, 2, device="cpu")
    n_lv = info.n_levels - 1
    m = partition_csr(a, 2)
    r = torch.ones(2, m.n_own_pad, dtype=torch.float64)
    with trace.capture() as tr, kd.record_sweeps() as sw, kd.ledger_section("iteration"):
        z = pre.apply(pre.data, r)
    assert z.shape == r.shape and bool(torch.isfinite(z).all())
    assert sw.ops["iteration"]["axpy"] == 15 * n_lv
    calls = tr.calls("iteration")["vcycle"]
    assert calls["coarse_solve"] == 1 and calls["prolongation"] == n_lv
    assert dataclasses.asdict(tr.regions("iteration")["vcycle"])["n_collectives"] == 1.0


def test_build_amg_checks_the_finest_level_it_is_given():
    """``level0`` is taken only when it is the finest level's partition:
    the same hierarchy as without it, and ``ValueError`` for other rows,
    another dtype or a deep halo."""
    from repro_torch.core.amg import build_amg
    from repro_torch.core.partition import RowPartition, partition_csr

    a = _cube("7pt", 10)
    n = a.shape[0]
    pre, info = build_amg(a, 2, device="cpu", level0=partition_csr(a, 2))
    pre0, info0 = build_amg(a, 2, device="cpu")
    assert (info.level_rows, info.level_nnz) == (info0.level_rows, info0.level_nnz)
    r = torch.ones(2, pre.data[0][0].mat.n_own_pad, dtype=torch.float64)
    assert torch.equal(pre.apply(pre.data, r), pre0.apply(pre0.data, r))
    for other in (partition_csr(a, 2, partition=RowPartition(n, (0, n // 2 - 7, n))),
                  partition_csr(a, 2, dtype=np.float32),
                  partition_csr(a, 2, halo_depth=2)):
        with pytest.raises(ValueError, match="level0"):
            build_amg(a, 2, device="cpu", level0=other)
