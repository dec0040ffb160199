"""The port's 2-D process grid against the JAX package and its own 1-D path.

In process (the JAX package's partitioner is host numpy; float32 arrays,
exact for the stencil values, as in ``tests/test_torch_partition.py``):

* ``default_grid`` for 1–32 shards and ``pencil_partition`` equal the
  reference's;
* ``partition_csr(grid=)`` on grids (2,2), (3,2), (2,3) and (2,4), 7pt and
  27pt (corner shifts), ELL, HYB and BCSR, ``halo_depth`` 1 and 2, and on
  grids larger than an axis (empty shards): the same arrays, byte for byte,
  and the same ``GridPlan``; ``distmat_from_numpy(mode="grid")`` carries
  the reference's grid partition across as it is;
* ``GridPlan`` accounting, ``pencil_halo_widths``, ``reduce_hops`` and
  ``reduce_launches`` equal the reference's; ``expand_boundary``
  round-trips.

ONE module-scoped subprocess with 6 host devices and x64 runs the
reference's grid solves of the pencil-permuted poisson7 at side 12 on
(2, 2) and (3, 2): hs, fcg, pipecg, block-HS (r = 4) and s-step (s = 2) —
ten compiled solvers, the (2, 2) hs one taken from the ``api.solve`` that
also gives the ledger. The port (on the CPU) must give the same
iterations, ``x`` within 1e-12 relative and the same per-region counts and
op calls (``hier_reduce_stage`` included); its ``api.solve`` and its CLI
the same legs, iterations, ledger grid fields and region counts.

Torch only: the grid SpMV and CG equal the 1-D ones up to the permutation
(1e-12), overlap on and off; ``grid="1x4"`` is the 1-D layout byte for
byte; the grid ``ConfigError``; and a grid solve and a 1-D solve of one
spec, in both orders, share no matrix, partition or handle.
"""

import dataclasses
import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import partition as jp
from repro.matrices.poisson import cube, poisson_scipy
from tests.conftest import REPO, run_multidevice
from tests.test_torch_solve import _assert_close_tree, _env

PART_SIDE = 8
PART_GRIDS = [(2, 2), (3, 2), (2, 3), (2, 4)]
PART_CASES = [(g, st, f, k) for g in PART_GRIDS for st in ("7pt", "27pt")
              for f in ("ell", "hyb", "bcsr") for k in (1, 2)]
EMPTY_CASES = [((2, 4), "7pt"), ((4, 4), "27pt")]  # side 3: shards own no row
LEAF = {"ell": ("data", "col"),
        "hyb": ("data", "col", "tail_data", "tail_col", "tail_row"),
        "bcsr": ("blocks", "bcol")}
OUTER = ("data_ext", "col_ext", "bnd_rows", "send_sel", "ghost_data", "ghost_col",
         "ghost_pos")
SIDE = 12
SOLVE_GRIDS = [(2, 2), (3, 2)]
# leg -> (variant, nrhs, s)
LEGS = {"hs": ("hs", 1, 2), "fcg": ("fcg", 1, 2), "pipecg": ("pipecg", 1, 2),
        "block": ("hs", 4, 2), "sstep": ("sstep", 1, 2)}
TOL, MAXITER = 1e-8, 200
API_KEYS = ("iters", "relres", "variant")

REF_SNIPPET = r"""
import dataclasses, json
import numpy as np
from repro import api as japi
from repro.core.cg import default_rhs_block, make_block_solver, make_solver
from repro.core.partition import pad_block, pad_vector, partition_csr, pencil_partition
from repro.core.partition import unpad_block, unpad_vector
from repro.core.spmv import shard_matrix, shard_vector, matrix_axis
from repro.energy import trace
from repro.launch.mesh import make_grid_mesh
from repro.matrices.poisson import cube, poisson_scipy

out = "OUT"
arrays, meta = {}, {}

def counts(tr):
    return {sec: dict(entries=tr.entries.get(sec, 0),
                      regions={k: dataclasses.asdict(v) for k, v in tr.regions(sec).items()},
                      calls={k: dict(v) for k, v in tr.calls(sec).items()})
            for sec in ("setup", "iteration")}

p = cube(%(side)d, "7pt")
a = poisson_scipy(p)
n = a.shape[0]
bs = np.random.default_rng(0).standard_normal(n)
for grid in %(grids)r:
    grid = tuple(grid)
    perm, part = pencil_partition(p, grid)
    ag = a[perm][:, perm].tocsr()
    S = grid[0] * grid[1]
    mesh = make_grid_mesh(*grid)
    sess = None
    if grid == (2, 2):
        # the driver, on a session of the permuted matrix: its hs handle is
        # the (2, 2) hs leg below (no second compile)
        sess = japi.SolverSession(ag, S)
        rep = japi.solve(japi.ProblemSpec(side=%(side)d, shards=S),
                         japi.SolverConfig(grid="2x2"), session=sess, verbose=False)
        meta["api"] = dict(
            grid=rep.ledger["grid"], rows=rep.ledger["halo_bytes_rows"],
            cols=rep.ledger["halo_bytes_cols"], fmt=rep.ledger["resolved_format"],
            sb=rep.ledger["stored_bytes"],
            legs={label: dict({k: e.get(k) for k in %(api_keys)r},
                              regions={r: {c: v[c] for c in ("flops", "hbm_bytes", "ici_bytes")}
                                       for r, v in e["regions"].items()})
                  for label, e in rep.solvers.items()},
        )
    for leg, (variant, nrhs, s) in %(legs)r.items():
        depth = s if variant == "sstep" else 1
        tag = f"{grid[0]}x{grid[1]}_{leg}"
        if sess is not None and leg == "hs":
            m = sess.matrix("ell", 4, grid=grid, partition=part)
            h = sess.solver(m, nrhs=1, variant="hs", precond=None, tol=%(tol)r,
                            maxiter=%(maxiter)d, overlap=True, s=2, telemetry=False)
            bp = pad_vector(bs, m)
            res = h.fn(shard_vector(mesh, bp, matrix_axis(m)),
                       shard_vector(mesh, np.zeros_like(bp), matrix_axis(m)))
            tr = h.trace
        else:
            m = partition_csr(ag, S, grid=grid, partition=part, halo_depth=depth)
            mm = shard_matrix(mesh, m)
            ax = matrix_axis(m)
            if nrhs > 1:
                solver = make_block_solver(mesh, mm, tol=%(tol)r, maxiter=%(maxiter)d, axis=ax)
                bp = pad_block(default_rhs_block(n, nrhs), m)
            else:
                solver = make_solver(mesh, mm, variant=variant, s=s, tol=%(tol)r,
                                     maxiter=%(maxiter)d, axis=ax)
                bp = pad_vector(bs, m)
            with trace.capture() as tr:
                res = solver(shard_vector(mesh, bp, ax), shard_vector(mesh, np.zeros_like(bp), ax))
        unpad = unpad_block if nrhs > 1 else unpad_vector
        arrays[tag] = unpad(np.asarray(res.x), m)
        meta[tag] = dict(iters=int(res.iters), counts=counts(tr))
np.savez(out + ".npz", **arrays)
with open(out + ".json", "w") as f:
    json.dump(meta, f)
print("REF_OK")
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread: its tensors are tiny, and
    idle worker threads would take cores from the tests beside this file
    (the reference subprocesses among them)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_grid_ref") / "ref")
    code = REF_SNIPPET % {"side": SIDE, "grids": SOLVE_GRIDS, "legs": LEGS, "tol": TOL,
                          "maxiter": MAXITER, "api_keys": API_KEYS}
    code = code.replace('out = "OUT"', f"out = {out!r}")
    assert "REF_OK" in run_multidevice(code, n_devices=6, x64=True)
    arrays = dict(np.load(out + ".npz"))
    with open(out + ".json") as f:
        meta = json.load(f)
    return arrays, meta


_PENCIL = {}


def _pencil(side, grid, stencil="7pt"):
    """``(problem, A, perm, row partition, A[perm][:, perm])``, cached."""
    from repro_torch.core.partition import pencil_partition

    key = (side, tuple(grid), stencil)
    if key not in _PENCIL:
        p = cube(side, stencil)
        a = poisson_scipy(p)
        perm, part = pencil_partition(p, grid)
        _PENCIL[key] = (p, a, perm, part, a[perm][:, perm].tocsr())
    return _PENCIL[key]


def _plan(p):
    return (p.mode, getattr(p, "grid", None), p.shifts, p.widths, p.n_own_pad, p.n_shards)


def _check_same_partition(got, ref):
    assert got.fmt == ref.fmt
    for k in LEAF[ref.fmt]:
        g, r = getattr(got.interior, k).numpy(), np.asarray(getattr(ref.interior, k))
        assert g.dtype == r.dtype and g.shape == r.shape and g.tobytes() == r.tobytes(), k
    for k in OUTER:
        g, r = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        assert g.dtype == r.dtype and g.shape == r.shape and g.tobytes() == r.tobytes(), k
    assert _plan(got.plan) == _plan(ref.plan)
    assert (got.n_bnd, got.row_starts, got.n_global, got.halo_depth) == \
        (ref.n_bnd, ref.row_starts, ref.n_global, ref.halo_depth)
    assert (got.stored_bytes(), got.interior_stored_bytes(), got.nnz_stored) == \
        (ref.stored_bytes(), ref.interior_stored_bytes(), ref.nnz_stored)
    if ref.plan.mode == "grid":
        assert got.plan.n_launches == ref.plan.n_launches
        assert got.plan.dim_bytes_per_shard(8) == ref.plan.dim_bytes_per_shard(8)
        assert got.plan.collective_bytes_per_shard(8) == ref.plan.collective_bytes_per_shard(8)


# ---------------------------------------------------------------------------
# Host side, in process
# ---------------------------------------------------------------------------


def test_default_grid_matches_reference():
    from repro_torch.core.partition import default_grid

    for S in range(1, 33):
        g = default_grid(S)
        assert g == jp.default_grid(S), S
        assert g[0] * g[1] == S and g[0] <= g[1]
    assert [default_grid(S) for S in (4, 8, 16, 32, 7)] == \
        [(2, 2), (2, 4), (4, 4), (4, 8), (1, 7)]


@pytest.mark.parametrize("side,grid", [(8, (2, 2)), (9, (2, 3)), (10, (3, 2)), (3, (4, 4))])
def test_pencil_partition_matches_reference(side, grid):
    from repro_torch.core.partition import pencil_partition

    p = cube(side, "7pt")
    perm, part = pencil_partition(p, grid)
    rperm, rpart = jp.pencil_partition(p, grid)
    assert perm.dtype == rperm.dtype and perm.tobytes() == rperm.tobytes()
    assert part.row_starts == rpart.row_starts and part.n_global == rpart.n_global
    assert np.array_equal(np.sort(perm), np.arange(p.n))


@pytest.mark.parametrize("grid,stencil,fmt,depth", PART_CASES)
def test_grid_partition_matches_reference_bytes(grid, stencil, fmt, depth):
    from repro_torch.core.partition import partition_csr

    _, _, _, part, ag = _pencil(PART_SIDE, grid, stencil)
    S = grid[0] * grid[1]
    kw = dict(grid=grid, fmt=fmt, halo_depth=depth, dtype=np.float32)
    ref = jp.partition_csr(ag, S, partition=jp.RowPartition(part.n_global, part.row_starts), **kw)
    got = partition_csr(ag, S, partition=part, **kw)
    assert got.plan.mode == "grid" and got.plan.grid == grid
    _check_same_partition(got, ref)


@pytest.mark.parametrize("grid,stencil", EMPTY_CASES)
def test_grid_partition_with_empty_shards_matches_reference(grid, stencil):
    """A grid larger than the cube's axes (side 3): some shards own no row;
    every array still equals the reference's, and every entry is kept."""
    from repro_torch.core.partition import partition_csr

    _, _, _, part, ag = _pencil(3, grid, stencil)
    S = grid[0] * grid[1]
    assert 0 in [part.n_own(s) for s in range(S)]
    for depth in (1, 2):
        kw = dict(grid=grid, halo_depth=depth, dtype=np.float32)
        ref = jp.partition_csr(ag, S, partition=jp.RowPartition(part.n_global,
                                                                part.row_starts), **kw)
        got = partition_csr(ag, S, partition=part, **kw)
        _check_same_partition(got, ref)
        kept = np.abs(got.interior.data.numpy()).sum() + np.abs(got.data_ext.numpy()).sum()
        assert kept == np.abs(ag.data).sum()


@pytest.mark.parametrize("fmt,depth", [("ell", 1), ("hyb", 2), ("bcsr", 1)])
def test_carried_reference_grid_partition(fmt, depth):
    """``distmat_from_numpy(mode="grid", grid=)`` carries the reference's
    grid partition across as it is: the same arrays and ``GridPlan`` as
    the port's own build, and the same SpMV."""
    from repro_torch.core.partition import distmat_from_numpy, pad_vector, partition_csr
    from repro_torch.core.spmv import spmv_shard

    grid = (3, 2)
    _, _, _, part, ag = _pencil(PART_SIDE, grid, "27pt")
    kw = dict(grid=grid, fmt=fmt, halo_depth=depth, dtype=np.float32)
    ref = jp.partition_csr(ag, 6, partition=jp.RowPartition(part.n_global, part.row_starts),
                           **kw)
    got = partition_csr(ag, 6, partition=part, **kw)
    leaves = {k: np.asarray(getattr(ref.interior, k)) for k in LEAF[fmt]}
    leaves.update({k: np.asarray(getattr(ref, k)) for k in OUTER})
    extra = {k: getattr(ref.interior, k) for k in ("n_tail", "n_brows", "bpr")
             if hasattr(ref.interior, k)}
    p = ref.plan
    carried = distmat_from_numpy(
        **leaves, **extra, mode=p.mode, grid=p.grid, shifts=p.shifts, widths=p.widths,
        n_own_pad=p.n_own_pad, n_shards=p.n_shards, n_global=ref.n_global,
        row_starts=ref.row_starts, n_bnd=ref.n_bnd, halo_depth=ref.halo_depth,
    )
    _check_same_partition(carried, ref)
    assert carried.plan == got.plan
    x = torch.from_numpy(pad_vector(np.random.default_rng(2).random(ag.shape[0]), got))
    assert torch.equal(spmv_shard(carried, x.float()), spmv_shard(got, x.float()))


@pytest.mark.parametrize("side,grid,stencil", [(10, (3, 2), "7pt"), (8, (2, 4), "27pt"),
                                               (9, (2, 3), "27pt"), (8, (8, 4), "7pt")])
def test_gridplan_accounting_and_halo_widths_match_reference(side, grid, stencil):
    from repro.roofline import analysis as ja
    from repro_torch.core.partition import GridPlan, partition_csr
    from repro_torch.roofline import analysis as ta

    p, _, _, part, ag = _pencil(side, grid, stencil)
    mat = partition_csr(ag, grid[0] * grid[1], grid=grid, partition=part)
    widths = ta.pencil_halo_widths(p, grid)
    assert widths == ja.pencil_halo_widths(p, grid)
    assert dict(zip(mat.plan.shifts, mat.plan.widths)) == widths
    # the reference's synthetic plan: a corner crosses both links
    kw = dict(mode="grid", grid=(3, 4), shifts=((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1)),
              widths=(10, 10, 6, 6, 2), n_own_pad=100, n_shards=12)
    got, ref = GridPlan(**kw), jp.GridPlan(**kw)
    for plan in (got, mat.plan):
        rp = ref if plan is got else jp.GridPlan(**{f: getattr(plan, f) for f in kw})
        assert plan.n_launches == rp.n_launches and plan.ext_len == rp.ext_len
        for k in range(len(plan.shifts)):
            assert (plan.hops(k), plan.buf_offset(k), plan.perm_rows(k), plan.perm_cols(k)) == \
                (rp.hops(k), rp.buf_offset(k), rp.perm_rows(k), rp.perm_cols(k))
        for isz in (4, 8, 64):
            assert plan.dim_bytes_per_shard(isz) == rp.dim_bytes_per_shard(isz)
            assert plan.collective_bytes_per_shard(isz) == rp.collective_bytes_per_shard(isz)
            assert sum(plan.dim_bytes_per_shard(isz)) == plan.collective_bytes_per_shard(isz)
    assert got.n_launches == 6
    for S, g in [(4, None), (4, (1, 4)), (4, (2, 2)), (6, (3, 2)), (32, (4, 8)), (1, None)]:
        assert ta.reduce_hops(S, g) == ja.reduce_hops(S, g)
        assert ta.reduce_launches(g) == ja.reduce_launches(g)


@pytest.mark.parametrize("grid,fmt", [((2, 2), "ell"), ((3, 2), "hyb"), ((2, 4), "bcsr")])
def test_expand_boundary_round_trips(grid, fmt):
    from repro_torch.core.partition import expand_boundary, partition_csr

    _, _, _, part, ag = _pencil(7, grid, "27pt")
    S = grid[0] * grid[1]
    mat = partition_csr(ag, S, grid=grid, partition=part, fmt=fmt, dtype=np.float32)
    de_full, ce_full = expand_boundary(mat)
    ref = jp.partition_csr(ag, S, grid=grid, fmt=fmt, dtype=np.float32,
                           partition=jp.RowPartition(part.n_global, part.row_starts))
    rd, rc = jp.expand_boundary(ref)
    assert de_full.tobytes() == rd.tobytes() and ce_full.tobytes() == rc.tobytes()
    de, ce, rows = mat.data_ext.numpy(), mat.col_ext.numpy(), mat.bnd_rows.numpy()
    for s in range(S):
        nb = mat.n_bnd[s]
        sel = rows[s, :nb]
        assert np.array_equal(de_full[s, sel], de[s, :nb])
        assert np.array_equal(ce_full[s, sel], ce[s, :nb])
        other = np.ones(mat.n_own_pad, bool)
        other[sel] = False
        assert not de_full[s, other].any() and not ce_full[s, other].any()


# ---------------------------------------------------------------------------
# Torch only: the grid against the port's own 1-D path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("grid,stencil", [((2, 2), "7pt"), ((3, 2), "27pt")])
def test_grid_spmv_equals_1d_up_to_the_permutation(grid, stencil, overlap):
    from repro_torch.core.partition import pad_vector, partition_csr, unpad_vector
    from repro_torch.core.spmv import spmv_shard
    from repro_torch.energy import trace

    _, a, perm, part, ag = _pencil(10, grid, stencil)
    S = grid[0] * grid[1]
    m1 = partition_csr(a, S)
    mg = partition_csr(ag, S, grid=grid, partition=part)
    rng = np.random.default_rng(3)
    for X in (rng.standard_normal(a.shape[0]), rng.standard_normal((a.shape[0], 3))):
        y1 = unpad_vector(spmv_shard(m1, torch.from_numpy(pad_vector(X, m1)), overlap=overlap), m1)
        with trace.capture() as tr:
            yg = spmv_shard(mg, torch.from_numpy(pad_vector(X[perm], mg)), overlap=overlap)
        yg = unpad_vector(yg, mg)
        scale = np.abs(a) @ np.abs(X)
        assert (np.abs(yg - y1[perm]) / scale[perm]).max() <= 1e-12
        assert (np.abs(yg - (a @ X)[perm]) / scale[perm]).max() <= 1e-12
        # a corner shift counts two launches, its bytes twice
        halo = "overlap" if overlap else "halo"
        calls = tr.calls("setup")[halo]
        assert calls["halo_exchange"] == 1
        got = tr.regions("setup")[halo]
        r = X.shape[1] if X.ndim == 2 else 1
        assert got.ici_bytes == mg.plan.collective_bytes_per_shard(8 * r)
        assert got.n_collectives == mg.plan.n_launches


@pytest.mark.parametrize("leg,overlap", [("hs", True), ("hs", False), ("fcg", True),
                                         ("pipecg", True), ("pipecg", False),
                                         ("block", True), ("sstep", True)])
def test_grid_cg_equals_1d_up_to_the_permutation(leg, overlap):
    from repro_torch.core.cg import default_rhs_block, solver_handle
    from repro_torch.core.partition import pad_vector, partition_csr, unpad_vector

    grid = (2, 2)
    _, a, perm, part, ag = _pencil(10, grid)
    variant, nrhs, s = LEGS[leg]
    depth = s if variant == "sstep" else 1
    B = (default_rhs_block(a.shape[0], nrhs) if nrhs > 1
         else np.random.default_rng(1).standard_normal(a.shape[0]))
    out = []
    for mat, rhs in ((partition_csr(a, 4, halo_depth=depth), B),
                     (partition_csr(ag, 4, grid=grid, partition=part, halo_depth=depth), B[perm])):
        b = torch.from_numpy(pad_vector(rhs, mat))
        h = solver_handle(mat, nrhs=nrhs, variant=variant, s=s, tol=TOL, maxiter=MAXITER,
                          overlap=overlap, device="cpu", cache={})
        res = h.warm(b, torch.zeros_like(b))
        out.append((res.iters, unpad_vector(res.x, mat)))
    (i1, x1), (ig, xg) = out
    assert ig == i1 and ig > 5
    assert np.abs(xg - x1[perm]).max() <= 1e-12 * np.abs(x1).max()


def test_1xN_grid_is_the_1d_layout_and_grid_errors():
    from repro_torch import api
    from repro_torch.core.partition import partition_csr

    a = poisson_scipy(cube(6, "7pt"))
    plain = partition_csr(a, 4)
    via = partition_csr(a, 4, grid=(1, 4))
    assert via.plan == plain.plan and via.plan.mode == "ring"
    for k in ("data_ext", "col_ext", "bnd_rows", "send_sel", "ghost_data"):
        assert getattr(via, k).numpy().tobytes() == getattr(plain, k).numpy().tobytes()
    assert via.interior.data.numpy().tobytes() == plain.interior.data.numpy().tobytes()
    with pytest.raises(ValueError, match="does not cover"):
        partition_csr(a, 4, grid=(3, 2))
    rep = api.solve(api.ProblemSpec(side=6, shards=4), api.SolverConfig(grid="1x4"),
                    device="cpu", verbose=False)
    ref = api.solve(api.ProblemSpec(side=6, shards=4), api.SolverConfig(),
                    device="cpu", verbose=False)
    from repro.api import _plan_dim_bytes

    rows_b, cols_b = _plan_dim_bytes(jp.partition_csr(a, 4).plan)
    assert (rep.ledger["grid"], rep.ledger["halo_bytes_rows"], rep.ledger["halo_bytes_cols"]) \
        == ([1, 4], rows_b, cols_b)
    assert set(rep.solvers) == {"BCMGX-analog", "Ginkgo-analog"}
    for label in rep.solvers:
        assert rep.outputs[label].tobytes() == ref.outputs[label].tobytes()
    with pytest.raises(api.ConfigError) as te:
        api.solve(api.ProblemSpec(side=6, shards=6), api.SolverConfig(grid="2x2"),
                  device="cpu", verbose=False)
    assert str(te.value) == "--grid 2x2 covers 4 shards; running with 6"


def test_session_key_trap_both_orders():
    """A grid solve and a 1-D solve of one spec get different sessions (the
    grid one holds the pencil-permuted matrix), so neither reuses the
    other's matrix, partitions or handles, whichever runs first; each gives
    what it gives from a fresh start."""
    from repro_torch import api

    spec = api.ProblemSpec(side=8, shards=4)
    cfgs = {"1d": api.SolverConfig(), "grid": api.SolverConfig(grid="2x2")}

    def run(order):
        api.SESSIONS.clear()
        outs = {}
        for k in order:
            rep = api.solve(spec, cfgs[k], device="cpu", verbose=False)
            outs[k] = (rep.summary["BCMGX-analog"]["iters"], rep.outputs["BCMGX-analog"])
        return outs, dict(api.SESSIONS)

    fresh = {k: run([k])[0][k] for k in cfgs}
    for order in (["1d", "grid"], ["grid", "1d"]):
        outs, sessions = run(order)
        assert len(sessions) == 2, order
        s1d, sg = (api.session_for(spec, "cpu"), api.session_for(spec, "cpu", grid=(2, 2)))
        assert s1d is not sg and s1d.pencil is None and sg.pencil[0] == (2, 2)
        perm = sg.pencil[1]
        assert (sg.a != s1d.a[perm][:, perm]).nnz == 0 and (sg.a != s1d.a).nnz > 0
        assert not set(map(id, s1d.mats.values())) & set(map(id, sg.mats.values()))
        assert not set(map(id, s1d.handles.values())) & set(map(id, sg.handles.values()))
        assert all(m.plan.mode == "grid" for m in sg.mats.values())
        assert all(m.plan.mode != "grid" for m in s1d.mats.values())
        for k in cfgs:
            assert outs[k][0] == fresh[k][0], (order, k)
            assert outs[k][1].tobytes() == fresh[k][1].tobytes(), (order, k)
        assert np.abs(outs["grid"][1] - outs["1d"][1][perm]).max() <= \
            1e-12 * np.abs(outs["1d"][1]).max()
    api.SESSIONS.clear()


# ---------------------------------------------------------------------------
# Against the reference subprocess
# ---------------------------------------------------------------------------


def _per_entry(tr, sec):
    ent = max(tr.entries.get(sec, 0), 1)
    regions = {k: dataclasses.asdict(v) for k, v in tr.regions(sec).items()}
    calls = {k: {op: c / ent for op, c in v.items()} for k, v in tr.calls(sec).items()}
    return regions, calls


@pytest.mark.parametrize("leg", list(LEGS))
@pytest.mark.parametrize("grid", SOLVE_GRIDS)
def test_grid_solve_matches_reference(reference, grid, leg):
    from repro_torch.core.cg import default_rhs_block, solver_handle
    from repro_torch.core.partition import pad_vector, partition_csr, unpad_vector

    arrays, meta = reference
    tag = f"{grid[0]}x{grid[1]}_{leg}"
    variant, nrhs, s = LEGS[leg]
    _, a, _, part, ag = _pencil(SIDE, grid)
    n = a.shape[0]
    mat = partition_csr(ag, grid[0] * grid[1], grid=grid, partition=part,
                        halo_depth=s if variant == "sstep" else 1)
    B = (default_rhs_block(n, nrhs) if nrhs > 1
         else np.random.default_rng(0).standard_normal(n))
    b = torch.from_numpy(pad_vector(B, mat))
    h = solver_handle(mat, nrhs=nrhs, variant=variant, s=s, tol=TOL, maxiter=MAXITER,
                      device="cpu", cache={})
    res = h.warm(b, torch.zeros_like(b))
    want = meta[tag]
    assert res.iters == want["iters"]
    x, x_ref = unpad_vector(res.x, mat), arrays[tag]
    assert x.shape == x_ref.shape
    assert np.abs(x - x_ref).max() <= 1e-12 * np.abs(x_ref).max()
    for sec in ("setup", "iteration"):
        regions, calls = _per_entry(h.trace, sec)
        _assert_close_tree(regions, want["counts"][sec]["regions"], f"{tag}.{sec}")
        ref_ent = max(want["counts"][sec]["entries"], 1)
        ref_calls = {k: {op: c / ref_ent for op, c in v.items()}
                     for k, v in want["counts"][sec]["calls"].items()}
        assert calls == ref_calls, (tag, sec)
    # every all-reduce of the body is staged: one hier_reduce_stage each
    it_calls = h.trace.calls("iteration")
    assert sum(c.get("hier_reduce_stage", 0) for c in it_calls.values()) > 0


def test_api_grid_solve_matches_reference_api(reference):
    from repro_torch import api

    _, meta = reference
    ref = meta["api"]
    rep = api.solve(api.ProblemSpec(side=SIDE, shards=4), api.SolverConfig(grid="2x2"),
                    device="cpu", verbose=False)
    led = rep.ledger
    assert (led["grid"], led["halo_bytes_rows"], led["halo_bytes_cols"]) == \
        (ref["grid"], ref["rows"], ref["cols"])
    assert (led["resolved_format"], led["stored_bytes"]) == (ref["fmt"], ref["sb"])
    assert set(rep.solvers) == set(ref["legs"]) == {"BCMGX-analog"}
    for label, want in ref["legs"].items():
        e = rep.solvers[label]
        assert e["iters"] == want["iters"] and e["variant"] == want["variant"]
        assert e["relres"] == pytest.approx(want["relres"], rel=1e-6)
        regions = {r: {c: v[c] for c in ("flops", "hbm_bytes", "ici_bytes")}
                   for r, v in e["regions"].items()}
        _assert_close_tree(regions, want["regions"], label)


def test_cli_grid_prints_reference_counts(reference):
    """``python -m repro_torch.launch.solve --device cpu --grid 2x2 --side 12
    --shards 4`` prints the iterations and per-region flops/hbm/ici that
    the JAX package's driver (which its CLI prints) gives."""
    _, meta = reference
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--device", "cpu",
         "--grid", "2x2", "--side", str(SIDE), "--shards", "4"],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    text = r.stdout + r.stderr
    want = meta["api"]["legs"]["BCMGX-analog"]
    assert f"BCMGX-analog   iters={want['iters']} " in text
    assert "Ginkgo-analog" not in text
    got = dict(re.findall(r"\[BCMGX-analog\] region (\S+)\s+t=\S+ DE=\S+ (flops=\S+ hbm=\S+ "
                          r"ici=\S+)", text))
    assert got == {name: f"flops={v['flops']:.3e} hbm={v['hbm_bytes']:.3e}B "
                         f"ici={v['ici_bytes']:.3e}B"
                   for name, v in want["regions"].items()}
