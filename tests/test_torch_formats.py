"""The port's interior formats (HYB, BCSR, ``fmt="auto"``) and SuiteSparse
analogs against the JAX package.

As in ``tests/test_torch_variants.py``, ONE module-scoped subprocess with 4
host devices and x64 runs the reference, written to a ``.npz`` + ``.json``
pair:

* ``partition_csr`` with ``hyb``, ``bcsr`` (block 2, 4 and 8) and ``auto``
  on 1, 2 and 4 shards for ``boneS10``, ``af_shell8``, ``G3_circuit``,
  ``powerlaw`` and ``poisson7``: the port's arrays must be the same bytes,
  in float64, with the same resolved format;
* the Pallas ``bcsr_spmv``/``bcsr_spmm`` kernels in interpret mode on
  seeded inputs with a ragged R and padding tiles: the port's plain
  versions must agree within 1e-12 (float64) and 1e-5 (float32) relative
  to ``|A| @ |x|`` (the two sum in different orders);
* ``make_spmv`` per format on 4 shards, as SpMV and SpMM: the port's
  ``spmv_shard`` within 1e-12 relative of it and of scipy, with the same
  region counts;
* hs (seeded right-hand side) and block-HS (r = 3) solves per format on 4
  shards: the same ``iters``/``iters_cols``, ``x`` within 1e-10 relative,
  ledgers within 1e-12 field for field when priced with the reference's
  chip spec (``TPU_V5E``), the same sweep counts — also when the port is
  fed the reference's HYB and BCSR partitions (``distmat_from_numpy``);
* ``api.solve`` with ``--format hyb|bcsr|auto`` on SuiteSparse analogs and
  poisson7: the same legs, resolved format, stored bytes, ``iters`` and
  per-region counts.

Plus numpy-only checks in this process: ``generate`` byte for byte for all
six analogs, the cost model and block statistics, ``core/sparse`` packing
and matvecs, and the HYB tail reduction.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tests.conftest import run_multidevice
from tests.test_torch_solve import _assert_close_tree, _tpu_cost

# problem -> scale (SuiteSparse analogs; poisson7 is the side-10 cube)
SCALES = {"boneS10": 0.002, "af_shell8": 0.004, "G3_circuit": 0.002,
          "powerlaw": 0.05, "poisson7": None}
PART_FMTS = [("hyb", 4), ("bcsr", 2), ("bcsr", 4), ("bcsr", 8), ("auto", 4)]
PART_CASES = [(p, S, f, b) for p in SCALES for S in (1, 2, 4) for f, b in PART_FMTS]
LEAF = {"ell": ("data", "col"),
        "hyb": ("data", "col", "tail_data", "tail_col", "tail_row"),
        "bcsr": ("blocks", "bcol")}
BOUNDARY = ("data_ext", "col_ext", "bnd_rows", "send_sel")
# kernel cases: (block, dtype)
KERNEL_CASES = [(b, dt) for b in (2, 4) for dt in ("float64", "float32")]
KS, KR, KBPR, KNRHS = 2, 37, 3, 3  # shards, ragged R, tiles per block-row, r
SPMV_MATS = ("boneS10", "G3_circuit", "powerlaw", "poisson7")
SOLVE_MATS = ("boneS10", "G3_circuit", "poisson7")
FMTS = ("hyb", "bcsr", "auto")
NRHS = 3
API_CASES = {
    "bone_auto": (dict(problem="boneS10", scale=0.002, shards=2), dict(fmt="auto")),
    "g3_auto": (dict(problem="G3_circuit", scale=0.002, shards=4), dict(fmt="auto")),
    "p7_bcsr": (dict(side=10, shards=2), dict(fmt="bcsr", block=2)),
    "p7_hyb_block": (dict(side=10, shards=4), dict(fmt="hyb", nrhs=NRHS)),
    "bone_spmv": (dict(problem="boneS10", scale=0.002, shards=4), dict(op="spmv", fmt="auto")),
    "p7_spmv_hyb": (dict(side=10, shards=2), dict(op="spmv", fmt="hyb")),
}
API_KEYS = ("iters", "relres", "variant", "nrhs", "iters_cols")

REF_SNIPPET = r"""
import json, sys
import numpy as np
from repro.matrices.poisson import cube, poisson_scipy
from repro.matrices.suitesparse import generate
from repro.core.partition import partition_csr, pad_vector, unpad_vector, pad_block, unpad_block
from repro.core.spmv import shard_matrix, shard_vector, make_spmv
from repro.core.cg import make_solver, make_block_solver, default_rhs_block
from repro.energy import trace
from repro.energy.accounting import CostModel
from repro.kernels import dispatch as kd
from repro.kernels import spmv_bcsr as jsb
from repro.launch.mesh import make_solver_mesh

out = sys.argv[1]
arrays, meta = {}, {}
cost = CostModel()
SCALES = %(scales)r
LEAF = %(leaf)r

def matrix(name):
    if SCALES[name] is None:
        return poisson_scipy(cube(10, "7pt"))
    return generate(name, SCALES[name])

def save_part(tag, m):
    for k in LEAF[m.fmt]:
        arrays[f"{tag}_{k}"] = np.asarray(getattr(m.interior, k))
    for k in %(boundary)r:
        arrays[f"{tag}_{k}"] = np.asarray(getattr(m, k))
    p = m.plan
    meta[tag] = dict(
        fmt=m.fmt, isb=int(m.interior_stored_bytes()), sb=int(m.stored_bytes()),
        plan=[p.mode, list(p.shifts), list(p.widths), p.n_own_pad, p.n_shards],
        n_bnd=list(m.n_bnd), row_starts=list(m.row_starts),
        n_tail=list(getattr(m.interior, "n_tail", ())),
        bcsr=[getattr(m.interior, k, 0) for k in ("n_brows", "bpr", "br", "bc")],
    )

# --- partitions -----------------------------------------------------------
for name, S, fmt, b in %(part_cases)r:
    save_part(f"part_{name}_{S}_{fmt}{b}", partition_csr(matrix(name), S, fmt=fmt, block=(b, b)))

# --- the Pallas BCSR kernels in interpret mode ----------------------------
for b, dt in %(kernel_cases)r:
    rng = np.random.default_rng(b)
    S, R, bpr, r = %(ks)d, %(kr)d, %(kbpr)d, %(knrhs)d
    NB = -(-R // b)
    blocks = rng.standard_normal((S, NB * bpr, b, b))
    bcol = rng.integers(0, NB, (S, NB * bpr)).astype(np.int32)
    pad = (np.arange(bpr)[None, None, :] >= rng.integers(1, bpr + 1, (S, NB, 1))).reshape(S, -1)
    blocks[pad] = 0.0
    bcol[pad] = 0
    x = rng.standard_normal((S, R))
    X = rng.standard_normal((S, R, r))
    blocks, x, X = blocks.astype(dt), x.astype(dt), X.astype(dt)
    ys, Ys = [], []
    for s in range(S):
        x2, flat, n_out = jsb.bcsr_prepare_x(blocks[s], x[s], n_brows=NB, bpr=bpr, n_out=None)
        y = jsb.bcsr_spmv(blocks[s], bcol[s], x2, n_brows=NB, bpr=bpr, interpret=True)
        ys.append(np.asarray(jsb.bcsr_finish_y(y, flat, n_out)))
        X2, flat, n_out = jsb.bcsr_prepare_xb(blocks[s], X[s], n_brows=NB, bpr=bpr, n_out=None)
        Y = jsb.bcsr_spmm(blocks[s], bcol[s], X2, n_brows=NB, bpr=bpr, interpret=True)
        Ys.append(np.asarray(jsb.bcsr_finish_yb(Y, flat, n_out)))
    tag = f"kern_{b}_{dt}"
    arrays.update({f"{tag}_blocks": blocks, f"{tag}_bcol": bcol, f"{tag}_x": x,
                   f"{tag}_X": X, f"{tag}_y": np.stack(ys), f"{tag}_Y": np.stack(Ys)})
    meta[tag] = dict(NB=NB, bpr=bpr)

# --- SpMV/SpMM and solves per format on 4 shards --------------------------
mesh = make_solver_mesh(4)
for name in %(spmv_mats)r:
    a = matrix(name)
    n = a.shape[0]
    for fmt in %(fmts)r:
        m = partition_csr(a, 4, fmt=fmt)
        tag = f"{name}_{fmt}"
        save_part(tag, m)
        mm = shard_matrix(mesh, m)
        xs = np.random.default_rng(1).standard_normal(n)
        X = np.random.default_rng(2).standard_normal((n, %(nrhs)d))
        for kind, v, pad, unpad in (("spmv", xs, pad_vector, unpad_vector),
                                    ("spmm", X, pad_block, unpad_block)):
            with trace.capture() as tr:
                y = make_spmv(mesh, mm)(mm, shard_vector(mesh, pad(v, m)))
            led = trace.ledger_from_trace(tr, iters=0, n_shards=4, cost=cost, overlap=True,
                                          idle_s=0.01, setup_repeats=100)
            arrays[f"{tag}_{kind}_y"] = unpad(np.asarray(y), m)
            meta[f"{tag}_{kind}"] = dict(ledger=dict(regions=led["regions"], totals=led["totals"]))
        if name not in %(solve_mats)r:
            continue
        for leg in ("hs", "block"):
            if leg == "block":
                solver = make_block_solver(mesh, mm, tol=1e-8, maxiter=1000)
                bp = pad_block(default_rhs_block(n, %(nrhs)d), m)
            else:
                solver = make_solver(mesh, mm, tol=1e-8, maxiter=1000)
                bp = pad_vector(np.random.default_rng(0).standard_normal(n), m)
            with trace.capture() as tr, kd.record_sweeps() as sw:
                res = solver(shard_vector(mesh, bp), shard_vector(mesh, np.zeros_like(bp)))
            iters = int(res.iters)
            led = trace.ledger_from_trace(tr, iters=iters, n_shards=4, cost=cost,
                                          overlap=True, idle_s=0.01)
            unpad = unpad_block if leg == "block" else unpad_vector
            arrays[f"{tag}_{leg}_x"] = unpad(np.asarray(res.x), m)
            ent = max(sw.entries.get("iteration", 1), 1)
            meta[f"{tag}_{leg}"] = dict(
                iters=iters, ledger=dict(regions=led["regions"], totals=led["totals"]),
                sweeps={k: v / ent for k, v in sw.ops.get("iteration", {}).items()},
            )
            if leg == "block":
                meta[f"{tag}_{leg}"]["iters_cols"] = [int(v) for v in np.asarray(res.iters_cols)]

# --- the driver ----------------------------------------------------------
from repro import api as japi
for key, (spec, cfg) in %(api_cases)r.items():
    rep = japi.solve(japi.ProblemSpec(**spec), japi.SolverConfig(**cfg), verbose=False)
    meta[f"api_{key}"] = dict(
        fmt=rep.ledger["resolved_format"], isb=rep.ledger["interior_stored_bytes"],
        sb=rep.ledger["stored_bytes"], problem=rep.ledger["problem"],
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


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_formats_ref") / "ref")
    code = REF_SNIPPET % {
        "scales": SCALES, "leaf": LEAF, "boundary": BOUNDARY, "part_cases": PART_CASES,
        "kernel_cases": KERNEL_CASES, "ks": KS, "kr": KR, "kbpr": KBPR, "knrhs": KNRHS,
        "spmv_mats": SPMV_MATS, "solve_mats": SOLVE_MATS, "fmts": FMTS, "nrhs": NRHS,
        "api_cases": API_CASES, "api_keys": API_KEYS,
    }
    code = code.replace("out = sys.argv[1]", f"out = {out!r}")
    assert "REF_OK" in run_multidevice(code, n_devices=4, x64=True)
    arrays = dict(np.load(out + ".npz"))
    with open(out + ".json") as f:
        meta = json.load(f)
    return arrays, meta


def _matrix(name):
    from repro_torch.matrices.poisson import cube, poisson_scipy
    from repro_torch.matrices.suitesparse import generate

    if SCALES[name] is None:
        return poisson_scipy(cube(10, "7pt"))
    return generate(name, SCALES[name])


def _check_partition(mat, arrays, meta, tag):
    m = meta[tag]
    assert mat.fmt == m["fmt"]
    for k in LEAF[mat.fmt]:
        got, want = getattr(mat.interior, k).numpy(), arrays[f"{tag}_{k}"]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k
    for k in BOUNDARY:
        assert getattr(mat, k).numpy().tobytes() == arrays[f"{tag}_{k}"].tobytes(), k
    assert mat.interior_stored_bytes() == m["isb"]
    assert mat.stored_bytes() == m["sb"]
    p = mat.plan
    assert [p.mode, list(p.shifts), list(p.widths), p.n_own_pad, p.n_shards] == m["plan"]
    if mat.fmt == "hyb":
        assert list(mat.interior.n_tail) == m["n_tail"]
    if mat.fmt == "bcsr":
        it = mat.interior
        assert [it.n_brows, it.bpr, it.br, it.bc] == m["bcsr"]


def _carried(arrays, meta, tag, n):
    from repro_torch.core.partition import distmat_from_numpy

    m = meta[tag]
    mode, shifts, widths, R, S = m["plan"]
    leaves = {k: arrays[f"{tag}_{k}"] for k in LEAF[m["fmt"]] + BOUNDARY}
    if m["fmt"] == "bcsr":
        leaves.update(n_brows=m["bcsr"][0], bpr=m["bcsr"][1])
    if m["fmt"] == "hyb":
        leaves.update(n_tail=m["n_tail"])
    return distmat_from_numpy(
        **leaves, mode=mode, shifts=shifts, widths=widths, n_own_pad=R, n_shards=S,
        n_global=n, row_starts=m["row_starts"], n_bnd=m["n_bnd"],
    )


# ---------------------------------------------------------------------------
# Host matrices, cost model, packing (numpy; this process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["G3_circuit", "af_shell8", "boneS10", "ecology2",
                                  "parabolic_fem", "powerlaw"])
def test_generate_matches_reference_bytes(name):
    from repro.matrices import suitesparse as jss
    from repro_torch.matrices import suitesparse as tss

    for scale in (0.001, 0.003):
        a, b = jss.generate(name, scale), tss.generate(name, scale)
        for k in ("indptr", "indices", "data"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (name, k)
    table = lambda m: {k: dataclasses.astuple(v) for k, v in m.TABLE1.items()}
    assert table(tss) == table(jss)
    assert dataclasses.astuple(tss.POWERLAW) == dataclasses.astuple(jss.POWERLAW)


@pytest.mark.parametrize("seed", range(4))
def test_format_model_matches_reference(seed):
    from repro.roofline import format_model as jfm
    from repro_torch.roofline import format_model as tfm

    rng = np.random.default_rng(seed)
    S, R = 1 + seed, 50 + 7 * seed
    lens = [list(rng.zipf(1.6, R - s).clip(max=40)) for s in range(S)]
    blocks = [(int(rng.integers(1, 200)), int(rng.integers(1, 20))) for _ in range(S)]
    for vb in (4, 8):
        kw = dict(n_rows=R, shard_blocks=blocks, br=4, bc=4, value_bytes=vb)
        got, want = tfm.format_costs(lens, **kw), jfm.format_costs(lens, **kw)
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
            {k: dataclasses.asdict(v) for k, v in want.items()}
        (f1, c1), (f2, c2) = tfm.choose_format(lens, **kw), jfm.choose_format(lens, **kw)
        assert f1 == f2 and dataclasses.asdict(c1) == dataclasses.asdict(c2)
    pooled = np.concatenate(lens)
    assert tfm.hyb_split(pooled, n_rows=R * S) == jfm.hyb_split(pooled, n_rows=R * S)


def test_block_stats_and_packing_match_reference():
    from repro.core import partition as jp
    from repro.core import sparse as jsp
    from repro_torch.core import partition as tp
    from repro_torch.core import sparse as tsp

    a = _matrix("af_shell8")
    coo = a.tocoo()
    for br, bc in ((2, 2), (4, 4), (3, 5)):
        assert tp.block_stats_from_arrays(coo.row, coo.col, a.shape[0], br, bc) == \
            jp.block_stats_from_arrays(coo.row, coo.col, a.shape[0], br, bc)
        for got, want in zip(tsp.pack_bcsr(a, br, bc, np.float64),
                             jsp.pack_bcsr(a, br, bc, np.float64)):
            assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    assert tp.block_stats_from_arrays([], [], 10, 4, 4) == (0, 0)


def test_single_shard_formats_match_scipy():
    """The ``core/sparse`` containers' matvecs (BCSR through the dispatch op
    ``bcsr_spmv``) against scipy, on the CPU."""
    from repro_torch.core import sparse as tsp
    from repro_torch.kernels import dispatch as kd

    a = _matrix("boneS10")
    x = np.random.default_rng(0).standard_normal(a.shape[1])
    want = a @ x
    scale = np.abs(a) @ np.abs(x)
    xt = torch.from_numpy(x)
    mats = [tsp.csr_from_scipy(a, pad_nnz_to=a.nnz + 5, dtype=np.float64),
            tsp.ell_from_scipy(a, dtype=np.float64)]
    for m in mats:
        assert (np.abs(m.matvec(xt).numpy() - want) / scale).max() <= 1e-14
    with kd.record_sweeps() as sw:
        for b in (3, 4, 8):
            m = tsp.bcsr_from_scipy(a, b, b, np.float64)
            y = m.matvec(xt).numpy()
            assert y.shape == (m.n_brows * b,)
            assert (np.abs(y[: a.shape[0]] - want) / scale).max() <= 1e-14
    assert sw.ops["default"]["bcsr_spmv"] == 3


def test_hyb_tail_is_a_fixed_tree_of_sums():
    """Rows whose tail spans several levels of the reduction tree (a hub
    row 300 entries past ``k_typ``) give scipy's product, SpMV and SpMM, and
    every call the same bits."""
    import scipy.sparse as sp

    from repro_torch.core import partition as tp
    from repro_torch.core.spmv import spmv_shard

    rng = np.random.default_rng(3)
    n = 400
    rows = np.concatenate([np.repeat([7, 133, 390], [600, 40, 9]), rng.integers(0, n, 900)])
    cols = rng.integers(0, n, len(rows))
    a = sp.coo_matrix((rng.standard_normal(len(rows)), (rows, cols)), shape=(n, n)).tocsr()
    a = (a + a.T + sp.eye(n) * 50).tocsr()
    m = tp.partition_csr(a, 2, fmt="hyb")
    plan = m.interior.tail_plan
    assert len(plan.levels) >= 3
    assert len(set(plan.rows.tolist())) == len(plan.rows)
    X = np.random.default_rng(4).standard_normal((n, 2))
    for v, pad, unpad in ((X[:, 0], tp.pad_vector, tp.unpad_vector),
                          (X, tp.pad_block, tp.unpad_block)):
        xp = torch.from_numpy(pad(v, m))
        y1, y2 = spmv_shard(m, xp), spmv_shard(m, xp)
        assert torch.equal(y1, y2)
        err = np.abs(unpad(y1, m) - a @ v) / (np.abs(a) @ np.abs(v))
        assert err.max() <= 1e-13


def test_unknown_format_raises():
    from repro_torch.core import partition as tp

    with pytest.raises(ValueError, match="unknown interior format 'csr'"):
        tp.partition_csr(_matrix("poisson7"), 2, fmt="csr")


# ---------------------------------------------------------------------------
# Against the reference subprocess
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,S,fmt,b", PART_CASES)
def test_partition_matches_reference_bytes(reference, name, S, fmt, b):
    from repro_torch.core.partition import partition_csr

    arrays, meta = reference
    mat = partition_csr(_matrix(name), S, fmt=fmt, block=(b, b))
    _check_partition(mat, arrays, meta, f"part_{name}_{S}_{fmt}{b}")


@pytest.mark.parametrize("b,dt", KERNEL_CASES)
def test_plain_bcsr_matches_pallas_interpret(reference, b, dt):
    from repro_torch.kernels import ref

    arrays, meta = reference
    tag = f"kern_{b}_{dt}"
    NB, bpr = meta[tag]["NB"], meta[tag]["bpr"]
    t = {k: torch.from_numpy(arrays[f"{tag}_{k}"]) for k in ("blocks", "bcol", "x", "X")}
    tol = 1e-12 if dt == "float64" else 1e-5
    y = ref.bcsr_spmv_ref(t["blocks"], t["bcol"], t["x"], NB, bpr)
    Y = ref.bcsr_spmm_ref(t["blocks"], t["bcol"], t["X"], NB, bpr)
    ab = t["blocks"].abs()
    for got, want, scale in (
        (y, arrays[f"{tag}_y"], ref.bcsr_spmv_ref(ab, t["bcol"], t["x"].abs(), NB, bpr)),
        (Y, arrays[f"{tag}_Y"], ref.bcsr_spmm_ref(ab, t["bcol"], t["X"].abs(), NB, bpr)),
    ):
        assert got.dtype == t["x"].dtype and tuple(got.shape) == want.shape
        assert (np.abs(got.numpy() - want) / scale.numpy()).max() <= tol


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("name", SPMV_MATS)
def test_spmv_shard_matches_scipy_and_reference(reference, name, fmt):
    from repro_torch.core.partition import (pad_block, pad_vector, partition_csr,
                                            unpad_block, unpad_vector)
    from repro_torch.core.spmv import spmv_shard
    from repro_torch.energy import trace

    arrays, meta = reference
    a = _matrix(name)
    n = a.shape[0]
    mat = partition_csr(a, 4, fmt=fmt)
    tag = f"{name}_{fmt}"
    _check_partition(mat, arrays, meta, tag)
    xs = np.random.default_rng(1).standard_normal(n)
    X = np.random.default_rng(2).standard_normal((n, NRHS))
    for kind, v, pad, unpad in (("spmv", xs, pad_vector, unpad_vector),
                                ("spmm", X, pad_block, unpad_block)):
        with trace.capture() as tr:
            y = unpad(spmv_shard(mat, torch.from_numpy(pad(v, mat))), mat)
        scale = np.abs(a) @ np.abs(v)
        assert (np.abs(y - a @ v) / scale).max() <= 1e-12
        assert (np.abs(y - arrays[f"{tag}_{kind}_y"]) / scale).max() <= 1e-12
        led = trace.ledger_from_trace(tr, iters=0, n_shards=4, cost=_tpu_cost(),
                                      overlap=True, idle_s=0.01, setup_repeats=100)
        _assert_close_tree({k: led[k] for k in ("regions", "totals")},
                           meta[f"{tag}_{kind}"]["ledger"], kind)


def _solve_port(mat, leg):
    from repro_torch.core.cg import default_rhs_block, solver_handle
    from repro_torch.core.partition import pad_block, pad_vector, unpad_block, unpad_vector
    from repro_torch.energy import trace
    from repro_torch.kernels import dispatch as kd

    n = mat.n_global
    if leg == "block":
        b = torch.from_numpy(pad_block(default_rhs_block(n, NRHS), mat))
    else:
        b = torch.from_numpy(pad_vector(np.random.default_rng(0).standard_normal(n), mat))
    h = solver_handle(mat, nrhs=NRHS if leg == "block" else 1, tol=1e-8, maxiter=1000,
                      device="cpu", cache={})
    with kd.record_sweeps() as sw:
        res = h.warm(b, torch.zeros_like(b))
    led = trace.ledger_from_trace(h.trace, iters=res.iters, n_shards=mat.n_shards,
                                  cost=_tpu_cost(), overlap=True, idle_s=0.01)
    ent = max(sw.entries.get("iteration", 1), 1)
    unpad = unpad_block if leg == "block" else unpad_vector
    return dict(res=res, x=unpad(res.x, mat), ledger=led,
                sweeps={k: v / ent for k, v in sw.ops.get("iteration", {}).items()})


def _check_solve(out, arrays, meta, tag):
    m = meta[tag]
    assert out["res"].iters == m["iters"]
    if "iters_cols" in m:
        assert out["res"].iters_cols.tolist() == m["iters_cols"]
    x_ref = arrays[f"{tag}_x"]
    assert out["x"].shape == x_ref.shape
    assert np.abs(out["x"] - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    _assert_close_tree({k: out["ledger"][k] for k in ("regions", "totals")},
                       m["ledger"], "ledger")
    assert out["sweeps"] == m["sweeps"]


@pytest.mark.parametrize("leg", ["hs", "block"])
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("name", SOLVE_MATS)
def test_solve_matches_reference(reference, name, fmt, leg):
    from repro_torch.core.partition import partition_csr

    arrays, meta = reference
    mat = partition_csr(_matrix(name), 4, fmt=fmt)
    out = _solve_port(mat, leg)
    assert out["res"].iters > 3  # a real loop, not the b = A 1 shortcut
    _check_solve(out, arrays, meta, f"{name}_{fmt}_{leg}")


@pytest.mark.parametrize("name,fmt", [("boneS10", "bcsr"), ("G3_circuit", "hyb"),
                                      ("poisson7", "bcsr"), ("poisson7", "hyb")])
def test_carried_reference_partition_gives_same_results(reference, name, fmt):
    arrays, meta = reference
    tag = f"{name}_{fmt}"
    mat = _carried(arrays, meta, tag, _matrix(name).shape[0])
    assert mat.fmt == fmt
    _check_partition(mat, arrays, meta, tag)
    for leg in ("hs", "block"):
        _check_solve(_solve_port(mat, leg), arrays, meta, f"{tag}_{leg}")


@pytest.mark.parametrize("key", list(API_CASES))
def test_api_solve_matches_reference_api(reference, key):
    """``api.solve`` with ``--format hyb|bcsr|auto``: the same legs (the
    Ginkgo-analog leg beside a single-RHS solve whatever the format, beside
    an SpMV only on ELL), resolved format, stored bytes, iterations and
    executed counts per region as the JAX package's driver."""
    from repro_torch import api

    _, meta = reference
    spec_kw, cfg_kw = API_CASES[key]
    rep = api.solve(api.ProblemSpec(**spec_kw), api.SolverConfig(**cfg_kw),
                    device="cpu", verbose=False)
    ref = meta[f"api_{key}"]
    led = rep.ledger
    assert (led["resolved_format"], led["interior_stored_bytes"], led["stored_bytes"],
            led["problem"]) == (ref["fmt"], ref["isb"], ref["sb"], ref["problem"])
    assert set(rep.solvers) == set(ref["legs"])
    for label, want in ref["legs"].items():
        e = rep.solvers[label]
        for k in API_KEYS:
            if k == "relres" and want[k] is not None:
                assert e[k] == pytest.approx(want[k], rel=1e-6, abs=1e-14)
            else:
                assert e.get(k) == want[k], (label, k)
        regions = {r: {c: v[c] for c in ("flops", "hbm_bytes", "ici_bytes")}
                   for r, v in e["regions"].items()}
        _assert_close_tree(regions, want["regions"], label)
        assert np.isfinite(rep.outputs[label]).all()


def test_suitesparse_spec_loads_and_solves_in_one_iteration():
    """The analogs' right-hand side ``b = ones`` is ``A @ 1`` (the diagonal
    is the off-diagonal row sum + 1 and the off-diagonals are negative), so
    CG stops after one iteration, in the port as in the JAX package."""
    from repro_torch import api

    spec = api.ProblemSpec(problem="G3_circuit", scale=0.002, shards=2)
    a, name = spec.load()
    assert name == spec.label == "G3_circuit" and spec.stencil is None
    assert np.allclose(a @ np.ones(a.shape[0]), 1.0)
    rep = api.solve(spec, api.SolverConfig(fmt="auto"), device="cpu", verbose=False)
    assert {e["iters"] for e in rep.solvers.values()} == {1}
    assert rep.ledger["resolved_format"] == "hyb"
    assert np.allclose(rep.outputs["BCMGX-analog"], 1.0)
