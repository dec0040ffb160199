"""The port's s-step CG slice against the JAX package: deep-halo partitions,
the matrix-powers SpMV, the plain s-step kernels and the s-step solves.

As in ``tests/test_torch_formats.py``, ONE module-scoped subprocess with 4
host devices and x64 runs the reference, written to a ``.npz`` + ``.json``
pair. It compiles few programs (three matrix-powers SpMVs, five solvers and
the two legs of one ``api.solve``) so that it stays cheap beside the JAX
package's own multi-device tests. The port (on the CPU) must give:

* ``partition_csr(halo_depth=2|3)`` with ``ell``, ``hyb`` and ``bcsr`` on 1,
  2 and 4 shards of a Poisson cube and a banded matrix: the same arrays,
  ghost-row block included, byte for byte in float64;
* ``matrix_powers`` at s = 2 and 3 on 4 shards (overlap on, and off at
  s = 3): outputs within 1e-12 relative and the same counts per region;
* the plain ``sstep_gram``/``sstep_basis``/``sstep_update`` against the
  Pallas kernels in interpret mode on a ragged n (2500 rows, chunk 1024),
  s = 2, 3, 4: within 1e-12 relative to the magnitudes each entry adds up
  (the two sum in different orders);
* s-step solves of poisson7 at side 12 on 1 and 4 shards, s = 2 and 3, a
  seeded right-hand side: the same ``iters``, ``x`` within 1e-10 relative,
  ledgers within 1e-12 field for field when priced with the reference's
  chip spec (``TPU_V5E``), the same sweep counts — also for a partition
  carried over from the reference (``distmat_from_numpy``) and for the
  sequential fallback (a depth-1 halo with s = 2);
* ``api.solve`` with ``variant="sstep"``: the same legs, iterations,
  per-region counts and ``halo_depth``/``s`` payload fields, and the CLI
  prints the same iteration count.

Plus torch-only checks: s-step agrees with the port's hs to 1e-10 at 1 and
4 shards, the ill-conditioned 1-D Laplacian of ``tests/test_sstep.py``
keeps finite iterates at s = 2 and 4 (its convergence there is set by
rounding: ``tests/sstep_rounding_study.py``), and a zero right-hand side
runs no block but records one.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tests.conftest import REPO, run_multidevice
from tests.test_torch_solve import _assert_close_tree, _env, _tpu_cost

SIDE = 12
PART_MATS = ("poisson7", "banded")
PART_CASES = [(m, S, f, k) for m in PART_MATS for S in (1, 2, 4)
              for f in ("ell", "hyb", "bcsr") for k in (2, 3)]
LEAF = {"ell": ("data", "col"),
        "hyb": ("data", "col", "tail_data", "tail_col", "tail_row"),
        "bcsr": ("blocks", "bcol")}
OUTER = ("data_ext", "col_ext", "bnd_rows", "send_sel", "ghost_data", "ghost_col",
         "ghost_pos")
MP_CASES = [(2, True), (3, True), (3, False)]  # (s, overlap), 4 shards, ELL
KERNEL_S = (2, 3, 4)
KN, KCHUNK, KS = 2500, 1024, 2  # ragged rows, reference chunk, shards
# (tag, shards, s, halo depth of the partition): depth < s is the fallback
SOLVE_CASES = [("s1_2", 1, 2, 2), ("s1_3", 1, 3, 3), ("s4_2", 4, 2, 2),
               ("s4_3", 4, 3, 3), ("fallback", 4, 2, 1)]
API_SPEC, API_CFG = dict(side=SIDE, shards=4), dict(variant="sstep")
API_KEYS = ("iters", "relres", "variant")

REF_SNIPPET = r"""
import dataclasses, json
import numpy as np
import scipy.sparse as sp
import jax
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.matrices.poisson import cube, poisson_scipy
from repro.core.partition import partition_csr, pad_vector, unpad_vector
from repro.core.spmv import dist_specs, local_block, matrix_powers, shard_matrix, shard_vector
from repro.core.cg import make_solver
from repro.energy import trace
from repro.energy.accounting import CostModel
from repro.kernels import dispatch as kd
from repro.kernels import fused_reductions as jfr
from repro.launch.mesh import make_solver_mesh

out = "OUT"
arrays, meta = {}, {}
cost = CostModel()
LEAF = %(leaf)r

def banded():
    rng = np.random.default_rng(5)
    n, bw = 300, 3
    diags = [rng.standard_normal(n - d) * 0.3 for d in range(1, bw + 1)]
    a = sp.diags(diags, range(1, bw + 1), shape=(n, n))
    return (a + a.T + sp.eye(n) * (2.0 * bw + 1.0)).tocsr()

MATS = {"poisson7": poisson_scipy(cube(%(side)d, "7pt")), "banded": banded()}

def save_part(tag, m):
    for k in LEAF[m.fmt]:
        arrays[f"{tag}_{k}"] = np.asarray(getattr(m.interior, k))
    for k in %(outer)r:
        arrays[f"{tag}_{k}"] = np.asarray(getattr(m, k))
    p = m.plan
    meta[tag] = dict(
        fmt=m.fmt, isb=int(m.interior_stored_bytes()), sb=int(m.stored_bytes()),
        plan=[p.mode, list(p.shifts), list(p.widths), p.n_own_pad, p.n_shards],
        n_bnd=list(m.n_bnd), row_starts=list(m.row_starts), depth=int(m.halo_depth),
        n_ghost_rows=int(m.n_ghost_rows), ghost_slots=int(m.ghost_slots),
        n_tail=list(getattr(m.interior, "n_tail", ())),
        bcsr=[getattr(m.interior, k, 0) for k in ("n_brows", "bpr", "br", "bc")],
    )

def regions(tr, section):
    return {k: dataclasses.asdict(v) for k, v in tr.regions(section).items()}

# --- deep-halo partitions (host only: no program) -------------------------
for name, S, fmt, k in %(part_cases)r:
    save_part(f"part_{name}_{S}_{fmt}_{k}", partition_csr(MATS[name], S, fmt=fmt, halo_depth=k))

# --- the Pallas s-step kernels in interpret mode --------------------------
for s in %(kernel_s)r:
    rng = np.random.default_rng(s)
    blk = rng.standard_normal((6, %(ks)d, %(kn)d, s))
    vec = rng.standard_normal((2, %(ks)d, %(kn)d))
    Bm, dinv, av = rng.standard_normal((s, s)), rng.random(s) + 0.1, rng.standard_normal(s)
    outs = {"gram": [], "b1": [], "b2": [], "ux": [], "ur": []}
    for sh in range(%(ks)d):
        b = [blk[j, sh] for j in range(6)]
        outs["gram"].append(jfr.sstep_gram(b[0], b[1], b[2], vec[0, sh], chunk=%(kchunk)d,
                                           interpret=True))
        o1, o2 = jfr.sstep_basis(Bm, dinv, b[3], b[0], b[2], b[1], chunk=%(kchunk)d,
                                 interpret=True)
        ux, ur = jfr.sstep_update(av, b[4], b[5], vec[0, sh], vec[1, sh], chunk=%(kchunk)d,
                                  interpret=True)
        for key, v in (("b1", o1), ("b2", o2), ("ux", ux), ("ur", ur)):
            outs[key].append(v)
    tag = f"kern_{s}"
    arrays.update({f"{tag}_blk": blk, f"{tag}_vec": vec, f"{tag}_B": Bm,
                   f"{tag}_dinv": dinv, f"{tag}_a": av})
    for key, v in outs.items():
        arrays[f"{tag}_{key}"] = np.stack([np.asarray(x) for x in v])

# --- matrix powers on 4 shards ---------------------------------------------
a = MATS["poisson7"]
n = a.shape[0]
mesh = make_solver_mesh(4)
xs = np.random.default_rng(7).standard_normal(n)
for s, ov in %(mp_cases)r:
    m = partition_csr(a, 4, halo_depth=s)
    mm = shard_matrix(mesh, m)
    specs = dist_specs(mm, "shards")

    def fn(mb, x, s=s, ov=ov):
        return matrix_powers(local_block(mb), x[0], s, "shards", overlap=ov)[None]

    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=(specs, P("shards", None)),
                          out_specs=P("shards", None, None), check_rep=False))
    with trace.capture() as tr:
        y = np.asarray(f(mm, shard_vector(mesh, pad_vector(xs, m))))
    tag = f"mp_{s}_{int(ov)}"
    arrays[tag] = np.stack([unpad_vector(y[:, j], m) for j in range(s)])
    meta[tag] = dict(regions=regions(tr, "setup"))

# --- s-step solves ----------------------------------------------------------
bs = np.random.default_rng(0).standard_normal(n)
for tag, S, s, depth in %(solve_cases)r:
    m = partition_csr(a, S, halo_depth=depth)
    if tag == "s4_2":
        save_part("carried", m)
    mesh = make_solver_mesh(S)
    solver = make_solver(mesh, shard_matrix(mesh, m), variant="sstep", s=s, tol=1e-8,
                         maxiter=1000)
    bp = pad_vector(bs, m)
    with trace.capture() as tr, kd.record_sweeps() as sw:
        res = solver(shard_vector(mesh, bp), shard_vector(mesh, np.zeros_like(bp)))
    iters = int(res.iters)
    led = trace.ledger_from_trace(tr, iters=iters, n_shards=S, cost=cost, overlap=True,
                                  idle_s=0.01)
    arrays[f"solve_{tag}_x"] = unpad_vector(np.asarray(res.x), m)
    ent = max(sw.entries.get("iteration", 1), 1)
    meta[f"solve_{tag}"] = dict(
        iters=iters, relres=float(res.rel_residual),
        ledger=dict(regions=led["regions"], totals=led["totals"]),
        sweeps={k: v / ent for k, v in sw.ops.get("iteration", {}).items()},
    )

# --- the driver ---------------------------------------------------------------
from repro import api as japi
rep = japi.solve(japi.ProblemSpec(**%(api_spec)r), japi.SolverConfig(**%(api_cfg)r),
                 verbose=False)
meta["api"] = dict(
    halo_depth=rep.ledger.get("halo_depth"), s=rep.ledger.get("s"),
    fmt=rep.ledger["resolved_format"], sb=rep.ledger["stored_bytes"],
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
    """The port's side runs on one CPU thread: its tensors are tiny, and
    idle worker threads spinning for work would take cores from the tests
    that run beside this file (the reference subprocesses among them)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_sstep_ref") / "ref")
    code = REF_SNIPPET % {
        "leaf": LEAF, "outer": OUTER, "side": SIDE, "part_cases": PART_CASES,
        "kernel_s": KERNEL_S, "ks": KS, "kn": KN, "kchunk": KCHUNK, "mp_cases": MP_CASES,
        "solve_cases": SOLVE_CASES, "api_spec": API_SPEC, "api_cfg": API_CFG,
        "api_keys": API_KEYS,
    }
    code = code.replace('out = "OUT"', f"out = {out!r}")
    assert "REF_OK" in run_multidevice(code, n_devices=4, x64=True)
    arrays = dict(np.load(out + ".npz"))
    with open(out + ".json") as f:
        meta = json.load(f)
    return arrays, meta


def _banded():
    rng = np.random.default_rng(5)
    n, bw = 300, 3
    diags = [rng.standard_normal(n - d) * 0.3 for d in range(1, bw + 1)]
    a = sp.diags(diags, range(1, bw + 1), shape=(n, n))
    return (a + a.T + sp.eye(n) * (2.0 * bw + 1.0)).tocsr()


def _matrix(name="poisson7"):
    from repro_torch.matrices.poisson import cube, poisson_scipy

    return poisson_scipy(cube(SIDE, "7pt")) if name == "poisson7" else _banded()


def _check_partition(mat, arrays, meta, tag):
    m = meta[tag]
    assert mat.fmt == m["fmt"]
    for k in LEAF[mat.fmt]:
        got, want = getattr(mat.interior, k).numpy(), arrays[f"{tag}_{k}"]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k
    for k in OUTER:
        got, want = getattr(mat, k).numpy(), arrays[f"{tag}_{k}"]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k
    p = mat.plan
    assert [p.mode, list(p.shifts), list(p.widths), p.n_own_pad, p.n_shards] == m["plan"]
    assert (mat.halo_depth, mat.n_ghost_rows, mat.ghost_slots) == \
        (m["depth"], m["n_ghost_rows"], m["ghost_slots"])
    assert (mat.interior_stored_bytes(), mat.stored_bytes()) == (m["isb"], m["sb"])
    assert list(mat.n_bnd) == m["n_bnd"] and list(mat.row_starts) == m["row_starts"]


# ---------------------------------------------------------------------------
# Against the reference subprocess
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,S,fmt,k", PART_CASES)
def test_deep_halo_partition_matches_reference_bytes(reference, name, S, fmt, k):
    from repro_torch.core.partition import partition_csr

    arrays, meta = reference
    mat = partition_csr(_matrix(name), S, fmt=fmt, halo_depth=k)
    _check_partition(mat, arrays, meta, f"part_{name}_{S}_{fmt}_{k}")


@pytest.mark.parametrize("s,overlap", MP_CASES)
def test_matrix_powers_matches_reference(reference, s, overlap):
    from repro_torch.core.partition import pad_vector, partition_csr, unpad_vector
    from repro_torch.core.spmv import matrix_powers
    from repro_torch.energy import trace

    arrays, meta = reference
    a = _matrix()
    x = np.random.default_rng(7).standard_normal(a.shape[0])
    mat = partition_csr(a, 4, halo_depth=s)
    with trace.capture() as tr:
        ys = matrix_powers(mat, torch.from_numpy(pad_vector(x, mat)), s, overlap=overlap)
    want = arrays[f"mp_{s}_{int(overlap)}"]
    acc = x
    for j, y in enumerate(ys):
        acc = a @ acc
        scale = np.abs(acc).max()
        got = unpad_vector(y, mat)
        assert np.abs(got - want[j]).max() <= 1e-12 * scale
        assert np.abs(got - acc).max() <= 1e-12 * scale
    regions = {k: dataclasses.asdict(v) for k, v in tr.regions("setup").items()}
    _assert_close_tree(regions, meta[f"mp_{s}_{int(overlap)}"]["regions"], "regions")


@pytest.mark.parametrize("s", KERNEL_S)
def test_plain_sstep_kernels_match_pallas_interpret(reference, s):
    from repro_torch.kernels import fused_reductions as fr
    from repro_torch.kernels import ref

    arrays, _ = reference
    tag = f"kern_{s}"
    t = lambda k: torch.from_numpy(arrays[f"{tag}_{k}"])
    blk, vec, B, dinv, a = t("blk"), t("vec"), t("B"), t("dinv"), t("a")
    P, W, Wp, Qp, Q, WQ = blk
    x, r = vec

    def close(got, want, scale):
        assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
        assert (np.abs(got.numpy() - want) / scale.numpy()).max() <= 1e-12

    # the wrappers take their plain versions on CPU tensors
    close(fr.sstep_gram(P, W, Wp, x), arrays[f"{tag}_gram"],
          ref.sstep_gram_ref(P.abs(), W.abs(), Wp.abs(), x.abs()))
    o1, o2 = fr.sstep_basis(B, dinv, Qp, P, Wp, W)
    close(o1, arrays[f"{tag}_b1"], P.abs() * dinv + Qp.abs() @ B.abs())
    close(o2, arrays[f"{tag}_b2"], W.abs() * dinv + Wp.abs() @ B.abs())
    ux, ur = fr.sstep_update(a, Q, WQ, x, r)
    close(ux, arrays[f"{tag}_ux"], x.abs() + Q.abs() @ a.abs())
    close(ur, arrays[f"{tag}_ur"], r.abs() + WQ.abs() @ a.abs())
    # one (n, s) block gives the reference kernel's own layout
    close(ref.sstep_gram_ref(P[0], W[0], Wp[0], x[0]), arrays[f"{tag}_gram"][0],
          ref.sstep_gram_ref(P[0].abs(), W[0].abs(), Wp[0].abs(), x[0].abs()))


def _solve_port(mat, s):
    from repro_torch.core.cg import solver_handle
    from repro_torch.core.partition import pad_vector, unpad_vector
    from repro_torch.energy import trace
    from repro_torch.kernels import dispatch as kd

    b = torch.from_numpy(pad_vector(np.random.default_rng(0).standard_normal(mat.n_global),
                                    mat))
    h = solver_handle(mat, variant="sstep", s=s, tol=1e-8, maxiter=1000, device="cpu",
                      cache={})
    with kd.record_sweeps() as sw:
        res = h.warm(b, torch.zeros_like(b))
    led = trace.ledger_from_trace(h.trace, iters=res.iters, n_shards=mat.n_shards,
                                  cost=_tpu_cost(), overlap=True, idle_s=0.01)
    ent = max(sw.entries.get("iteration", 1), 1)
    return dict(res=res, x=unpad_vector(res.x, mat), ledger=led,
                sweeps={k: v / ent for k, v in sw.ops.get("iteration", {}).items()})


def _check_solve(out, arrays, meta, tag):
    m = meta[f"solve_{tag}"]
    assert out["res"].iters == m["iters"]
    x_ref = arrays[f"solve_{tag}_x"]
    assert np.abs(out["x"] - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    _assert_close_tree({k: out["ledger"][k] for k in ("regions", "totals")},
                       m["ledger"], "ledger")
    assert out["sweeps"] == m["sweeps"]


@pytest.mark.parametrize("tag,S,s,depth", SOLVE_CASES)
def test_sstep_solve_matches_reference(reference, tag, S, s, depth):
    from repro_torch.core.partition import partition_csr

    arrays, meta = reference
    mat = partition_csr(_matrix(), S, halo_depth=depth)
    out = _solve_port(mat, s)
    assert out["res"].iters % s == 0 and out["res"].iters > 3 * s
    # one sstep_gram, sstep_basis and sstep_update per s-iteration block
    assert out["sweeps"] == {"sstep_gram": 1, "sstep_basis": 1, "sstep_update": 1}
    _check_solve(out, arrays, meta, tag)


def test_carried_reference_partition_gives_same_results(reference):
    from repro_torch.core.partition import distmat_from_numpy

    arrays, meta = reference
    m = meta["carried"]
    mode, shifts, widths, R, S = m["plan"]
    mat = distmat_from_numpy(
        **{k: arrays[f"carried_{k}"] for k in LEAF["ell"] + OUTER},
        mode=mode, shifts=shifts, widths=widths, n_own_pad=R, n_shards=S,
        n_global=SIDE ** 3, row_starts=m["row_starts"], n_bnd=m["n_bnd"],
        halo_depth=m["depth"],
    )
    _check_partition(mat, arrays, meta, "carried")
    _check_solve(_solve_port(mat, 2), arrays, meta, "s4_2")


def test_api_solve_matches_reference_api(reference):
    """``api.solve`` with ``variant="sstep"`` (default s = 2): the s-step leg
    on a ``halo_depth = 2`` partition beside the Ginkgo-analog leg, the
    payload's ``halo_depth``/``s``, iterations and per-region counts as the
    JAX package's driver; the CLI prints the same iteration count."""
    from repro_torch import api

    _, meta = reference
    ref = meta["api"]
    rep = api.solve(api.ProblemSpec(**API_SPEC), api.SolverConfig(**API_CFG), device="cpu",
                    verbose=False)
    led = rep.ledger
    assert (led["halo_depth"], led["s"], led["resolved_format"], led["stored_bytes"]) == \
        (ref["halo_depth"], ref["s"], ref["fmt"], ref["sb"])
    assert set(rep.solvers) == set(ref["legs"])
    for label, want in ref["legs"].items():
        e = rep.solvers[label]
        assert e["iters"] == want["iters"] and e["variant"] == want["variant"], label
        # the s-step relres is the Gram's r'r of the last block's entry, a
        # recurrence residual near 1e-8: the two sides' (s, s) solves round
        # differently, and its floor is about eps * cond(A) ~ 1e-14
        assert e["relres"] == pytest.approx(want["relres"], rel=1e-6, abs=1e-13)
        regions = {r: {c: v[c] for c in ("flops", "hbm_bytes", "ici_bytes")}
                   for r, v in e["regions"].items()}
        _assert_close_tree(regions, want["regions"], label)
        assert np.isfinite(rep.outputs[label]).all()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--device", "cpu",
         "--variant", "sstep", "--s", "2", "--side", str(SIDE), "--shards", "4"],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    iters = ref["legs"]["BCMGX-analog"]["iters"]
    assert f"BCMGX-analog   iters={iters} " in r.stdout + r.stderr


# ---------------------------------------------------------------------------
# Torch only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("s", [2, 4])
def test_sstep_agrees_with_hs(S, s):
    """ROADMAP queue 1, item 9: the s-step solution agrees with hs to 1e-10.

    Both run to tol 1e-12; the monomial basis' attainable accuracy at s = 4
    sits near 1e-10 (one shard stalls at relres 7.2e-11 on one CPU thread,
    reaches 4.6e-13 with eight threads' sums), so the s-step residual is
    held to 1e-10."""
    from repro_torch.core.cg import solve_cg
    from repro_torch.core.partition import partition_csr, unpad_vector

    a = _matrix()
    b = np.random.default_rng(1).standard_normal(a.shape[0])
    m1 = partition_csr(a, S)
    ms = partition_csr(a, S, halo_depth=s)
    rh = solve_cg(m1, b, variant="hs", tol=1e-12, maxiter=2000, device="cpu")
    rs = solve_cg(ms, b, variant="sstep", s=s, tol=1e-12, maxiter=2000, device="cpu")
    assert float(rs.rel_residual) <= 1e-10 and rs.iters % s == 0
    xh, xs = unpad_vector(rh.x, m1), unpad_vector(rs.x, ms)
    assert np.abs(xs - xh).max() <= 1e-10 * np.abs(xh).max()


def test_sstep_ill_conditioned_stays_finite():
    """The ~4e5 condition 1-D Laplacian of ``tests/test_sstep.py``: hs
    converges (relres < 1e-9); s-step at s = 2 and 4, with the A-norm basis
    scaling and the breakdown guard, keeps finite iterates and a finite
    residual through its 8000 iterations and stops on a block boundary.

    Whether s-step reaches 1e-9 here is set by rounding, not by the method:
    ``tests/sstep_rounding_study.py`` perturbs ``b`` at 1e-14 and 1e-12 and
    flips convergence either way in the JAX package and in the port alike,
    so convergence is not asserted."""
    from repro_torch.core.cg import solve_cg
    from repro_torch.core.partition import partition_csr, unpad_vector

    S, n = 4, 256
    lap = sp.diags([-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
    D = sp.diags(np.logspace(0, 1, n))
    a = (D @ lap @ D).tocsr()
    b = np.ones(n)
    rh = solve_cg(partition_csr(a, S), b, variant="hs", tol=1e-10, maxiter=8000, device="cpu")
    assert float(rh.rel_residual) < 1e-9
    for s in (2, 4):
        ms = partition_csr(a, S, halo_depth=s)
        rs = solve_cg(ms, b, variant="sstep", s=s, tol=1e-10, maxiter=8000, device="cpu")
        assert np.isfinite(unpad_vector(rs.x, ms)).all(), s
        assert np.isfinite(float(rs.rel_residual)), s
        assert rs.iters % s == 0 and rs.iters <= 8000 + s - 1


def test_zero_rhs_runs_no_block_but_records_one():
    """b = 0 converges before the first block: iters 0 and x = x0, while the
    ledger still holds one block's per-iteration counts (the JAX package
    charges its once-traced body ``max(iters, 1)`` times)."""
    from repro_torch.core.cg import solver_handle
    from repro_torch.core.partition import partition_csr
    from repro_torch.energy import trace

    mat = partition_csr(_matrix(), 4, halo_depth=3)
    b = torch.zeros((4, mat.n_own_pad), dtype=torch.float64)
    h = solver_handle(mat, variant="sstep", s=3, device="cpu", cache={})
    res = h.warm(b, b)
    assert res.iters == 0 and torch.equal(res.x, b)
    assert h.trace.entries[trace.ITERATION] == 1
    assert h.trace.total(trace.ITERATION).flops > 0
