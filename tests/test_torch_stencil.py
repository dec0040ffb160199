"""The port's matrix-free stencil slice against the JAX package: the stencil
oracles, the plain versions of the four stencil kernels, ``partition_stencil``,
the stacked matrix-free SpMV and the matrix-free CG solves.

As in ``tests/test_torch_sstep.py``, ONE module-scoped subprocess with 4
host devices and x64 runs the reference, written to a ``.npz`` + ``.json``
pair. It compiles 10 programs (the four Pallas stencil kernels in
interpret mode, all stencils in one program per shape, and eight solvers);
the SpMV counts come from lowering alone. The port (on the CPU) must give:

* the stencil oracles (``stencil7_ref``, ``stencil27_ref``,
  ``stencil_halo_ref``, ``stencil_boundary_ref``, ``jacobi_stencil_ref``) on
  ``(8, 5, 9)`` and ``(16, 12, 16)`` grids, 7pt, anisotropic 7pt and 27pt:
  within 1e-14 of the reference's jnp oracles, relative to ``|A| |x|``;
* the plain versions of ``stencil_spmv``, ``stencil_spmv_halo``,
  ``stencil_spmv_boundary`` and ``jacobi_stencil_sweep`` (the wrappers on
  CPU tensors) against the Pallas kernels in interpret mode on the same
  grids: within 1e-12 relative to ``|A| |x|``;
* ``partition_stencil`` on 1, 2 and 4 shards, ring and all-gather,
  ell/hyb/bcsr, 7pt and 27pt: the same arrays, byte for byte;
* ``make_matvec`` on 1, 2 and 4 shards, overlap on and off: within 1e-13
  of scipy's product (relative to ``|A| |x|``) and the same counts per
  region as the reference's;
* solves of ``PoissonProblem(10, 9, 16)`` — hs, fcg, pipecg (overlap on
  and off) and s-step (s = 2) on 4 shards, hs on 1 shard, hs and s-step on
  27pt — the same ``iters``, ``x`` within 1e-10 relative, ledgers within
  1e-12 when priced with the reference's chip spec, and the same sweep
  counts (s-step's eager sequential basis counts s SpMV calls per block
  where the reference's once-traced scan counts one; ROADMAP §3).

The reference's ``make_stencil_solver_fn`` passes no ``ops`` to its s-step
body, so its s-step solves are mapped here by hand the same way, with the
dispatch ``OpSet`` given. Plus torch-only checks: the plain boundary planes
are bitwise the plain slab planes, one grid is bitwise four slabs with real
halos, the overlapped SpMV is bitwise the single-call one, and the wrappers
and entry points check their arguments.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tests.conftest import run_multidevice
from tests.test_torch_solve import _assert_close_tree, _tpu_cost

ISO, ANISO = (1.0, 1.0, 1.0), (1.0, 2.5, 7.0)
STENCILS = [("7pt", ISO), ("7pt", ANISO), ("27pt", ISO)]
KSHAPES = [(8, 5, 9), (16, 12, 16)]
KCASES = [(shape, i) for shape in KSHAPES for i in range(len(STENCILS))]
OMEGA = 0.8
PROB = (10, 9, 16)  # (nx, ny, nz) of the partitions, SpMVs and solves
PART_CASES = [(st, S, mode, fmt) for st in ("7pt", "27pt") for S in (1, 2, 4)
              for mode in ("ring", "allgather") for fmt in ("ell", "hyb", "bcsr")]
MV_CASES = [(st, S, ov) for st in ("7pt", "27pt") for S in (1, 2, 4) for ov in (True, False)]
# (tag, stencil, shards, variant, overlap)
SOLVE_CASES = [("hs_4", "7pt", 4, "hs", True), ("fcg_4", "7pt", 4, "fcg", True),
               ("pipecg_4", "7pt", 4, "pipecg", True),
               ("pipecg_4_serial", "7pt", 4, "pipecg", False),
               ("sstep_4", "7pt", 4, "sstep", True), ("hs_1", "7pt", 1, "hs", True),
               ("hs27_4", "27pt", 4, "hs", True), ("sstep27_4", "27pt", 4, "sstep", True)]
TOL, MAXITER, SSTEP_S = 1e-8, 500, 2
LEAF = {"ell": ("data", "col"),
        "hyb": ("data", "col", "tail_data", "tail_col", "tail_row"),
        "bcsr": ("blocks", "bcol")}
OUTER = ("data_ext", "col_ext", "bnd_rows", "send_sel")

REF_SNIPPET = r"""
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.matrices.poisson import PoissonProblem
from repro.core.partition import partition_stencil
from repro.core.stencil_solver import make_matvec, make_stencil_solver_fn
from repro.core.cg import _BODIES, SolveResult, identity_precond
from repro.energy import trace
from repro.energy.accounting import CostModel
from repro.kernels import dispatch as kd
from repro.kernels import ref as jref
from repro.kernels.jacobi_stencil import jacobi_stencil_sweep
from repro.kernels.spmv_stencil import (pick_bz, stencil_spmv, stencil_spmv_boundary,
                                        stencil_spmv_halo)

out = "OUT"
arrays, meta = {}, {}
cost = CostModel()
STENCILS = %(stencils)r
LEAF = %(leaf)r
NX, NY, NZ = %(prob)r

def mesh_of(S):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:S]), ("shards",))

def regions(tr, section):
    return {k: dataclasses.asdict(v) for k, v in tr.regions(section).items()}

# --- oracles (eager jnp) and the Pallas kernels in interpret mode -------------
for shape in %(kshapes)r:
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape)
    prev, nxt = rng.standard_normal(shape[1:]), rng.standard_normal(shape[1:])
    b, dinv = rng.standard_normal(shape), rng.random(shape) + 0.05
    tag = "x".join(map(str, shape))
    for k, v in dict(x=x, prev=prev, nxt=nxt, b=b, dinv=dinv).items():
        arrays[f"in_{tag}_{k}"] = v
    bz = pick_bz(shape[0])

    def kern(x, prev, nxt, b, dinv):
        outs = []
        for st, an in STENCILS:
            kw = dict(stencil=st, aniso=an)
            outs += [stencil_spmv(x, bz=bz, interpret=True, **kw),
                     stencil_spmv_halo(x, prev, nxt, bz=bz, interpret=True, **kw),
                     stencil_spmv_boundary(x, prev, nxt, interpret=True, **kw),
                     jacobi_stencil_sweep(x, b, dinv, omega=%(omega)r, bz=bz,
                                          interpret=True, **kw)]
        return outs

    kouts = jax.jit(kern)(x, prev, nxt, b, dinv)  # one program per shape
    for i, (st, an) in enumerate(STENCILS):
        kw = dict(stencil=st, aniso=an)
        t = f"{tag}_{i}"
        ora = dict(
            s=jref.stencil7_ref(x, an) if st == "7pt" else jref.stencil27_ref(x),
            h=jref.stencil_halo_ref(x, prev, nxt, **kw),
            bd=jref.stencil_boundary_ref(x, prev, nxt, **kw),
            j=jref.jacobi_stencil_ref(x, b, dinv, omega=%(omega)r, **kw),
        )
        for k, v in ora.items():
            arrays[f"or_{t}_{k}"] = np.asarray(v)
        for k, v in zip(("s", "h", "bd", "j"), kouts[4 * i: 4 * i + 4]):
            arrays[f"kn_{t}_{k}"] = np.asarray(v)

# --- partitions (host only: no program) ----------------------------------------
for st, S, mode, fmt in %(part_cases)r:
    m = partition_stencil(PoissonProblem(NX, NY, NZ, st), S, mode=mode, fmt=fmt)
    tag = f"part_{st}_{S}_{mode}_{fmt}"
    for k in LEAF[m.fmt]:
        arrays[f"{tag}_{k}"] = np.asarray(getattr(m.interior, k))
    for k in %(outer)r:
        arrays[f"{tag}_{k}"] = np.asarray(getattr(m, k))
    p = m.plan
    meta[tag] = dict(
        fmt=m.fmt, isb=int(m.interior_stored_bytes()), sb=int(m.stored_bytes()),
        plan=[p.mode, list(p.shifts), list(p.widths), p.n_own_pad, p.n_shards],
        n_bnd=list(m.n_bnd), row_starts=list(m.row_starts),
        n_tail=list(getattr(m.interior, "n_tail", ())),
        bcsr=[getattr(m.interior, k, 0) for k in ("n_brows", "bpr", "br", "bc")],
    )

# --- SpMV counts per region (lowering only: no program) ------------------------
for st, S, ov in %(mv_cases)r:
    p = PoissonProblem(NX, NY, NZ, st)
    A = make_matvec(p, S, "shards", overlap=ov)
    f = jax.jit(shard_map(lambda v: A(v[0])[None], mesh=mesh_of(S),
                          in_specs=P("shards", None), out_specs=P("shards", None),
                          check_rep=False))
    with trace.capture() as tr:
        f.lower(jax.ShapeDtypeStruct((S, p.n // S), jnp.float64))
    meta[f"mv_{st}_{S}_{int(ov)}"] = regions(tr, "setup")

# --- matrix-free solves ------------------------------------------------------------
def sstep_solver(p, S, overlap):
    # make_stencil_solver_fn gives the s-step body no ops: map it by hand
    A = make_matvec(p, S, "shards", overlap=overlap)
    pre, ops = identity_precond(), kd.ops_for(None)

    def fn(b, x0):
        x, iters, rr, bb = _BODIES["sstep"](A, pre, (), b[0], x0[0], tol=%(tol)r,
                                           maxiter=%(maxiter)r, s=%(s)r, axis="shards",
                                           ops=ops)
        return x[None], iters, rr, bb

    mapped = shard_map(fn, mesh=mesh_of(S), in_specs=(P("shards", None), P("shards", None)),
                       out_specs=(P("shards", None), P(), P(), P()), check_rep=False)

    @jax.jit
    def solve(b, x0):
        x, iters, rr, bb = mapped(b, x0)
        return SolveResult(x=x, iters=iters, rr=rr, bb=bb)

    return solve

for tag, st, S, variant, ov in %(solve_cases)r:
    p = PoissonProblem(NX, NY, NZ, st)
    if variant == "sstep":
        solve = sstep_solver(p, S, ov)
    else:
        solve = make_stencil_solver_fn(mesh_of(S), p, S, variant=variant, tol=%(tol)r,
                                       maxiter=%(maxiter)r, overlap=ov)
    b = np.random.default_rng(3).standard_normal(p.n).reshape(S, -1)
    with trace.capture() as tr, kd.record_sweeps() as sw:
        res = solve(jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)))
    iters = int(res.iters)
    led = trace.ledger_from_trace(tr, iters=iters, n_shards=S, cost=cost, overlap=True,
                                  idle_s=0.01)
    arrays[f"solve_{tag}_x"] = np.asarray(res.x).reshape(-1)
    ent = max(sw.entries.get("iteration", 1), 1)
    meta[f"solve_{tag}"] = dict(
        iters=iters, relres=float(res.rel_residual),
        ledger=dict(regions=led["regions"], totals=led["totals"]),
        sweeps={k: v / ent for k, v in sw.ops.get("iteration", {}).items()},
    )

np.savez(out + ".npz", **arrays)
with open(out + ".json", "w") as f:
    json.dump(meta, f)
print("REF_OK")
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread: its tensors are tiny, and
    idle worker threads would take cores from the tests beside this file."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_stencil_ref") / "ref")
    code = REF_SNIPPET % {
        "stencils": STENCILS, "leaf": LEAF, "prob": PROB, "kshapes": KSHAPES,
        "omega": OMEGA, "part_cases": PART_CASES, "outer": OUTER, "mv_cases": MV_CASES,
        "solve_cases": SOLVE_CASES, "tol": TOL, "maxiter": MAXITER, "s": SSTEP_S,
    }
    code = code.replace('out = "OUT"', f"out = {out!r}")
    assert "REF_OK" in run_multidevice(code, n_devices=4, x64=True)
    arrays = dict(np.load(out + ".npz"))
    with open(out + ".json") as f:
        meta = json.load(f)
    return arrays, meta


def _problem(stencil):
    from repro_torch.matrices.poisson import PoissonProblem

    return PoissonProblem(*PROB, stencil)


def _abs_product(plain, args, stencil, aniso):
    """``|A| |x|`` (halo planes included) from the plain product of the
    absolute inputs: ``2 d |x| - A |x|``, d the matrix diagonal."""
    d = 26.0 if stencil == "27pt" else 2.0 * sum(aniso)
    return 2 * d * args[0].abs() - plain(*[a.abs() for a in args])


def _rel(got, want, scale) -> float:
    """Largest ``|got - want|`` relative to ``scale`` elementwise."""
    got = torch.as_tensor(got)
    want = torch.as_tensor(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    return float(((got - want).abs() / scale.clamp(min=1e-300)).max())


def _inputs(arrays, shape):
    tag = "x".join(map(str, shape))
    return [torch.from_numpy(arrays[f"in_{tag}_{k}"]) for k in ("x", "prev", "nxt", "b",
                                                                 "dinv")], tag


def _scales(x, prev, nxt, b, dinv, stencil, aniso):
    """``|A| |x|`` of the single grid, of the slab with halos, of its edge
    planes, and of the sweep ``|x| + omega |dinv| (|b| + |A||x|)``."""
    from repro_torch.kernels import ref

    kw = dict(stencil=stencil, aniso=aniso)
    s = _abs_product(lambda a: ref.stencil_spmv_ref(a, **kw), (x,), stencil, aniso)
    h = _abs_product(lambda *a: ref.stencil_halo_ref(*a, **kw), (x, prev, nxt),
                     stencil, aniso)
    return dict(s=s, h=h, bd=h[[0, -1]], j=x.abs() + OMEGA * dinv * (b.abs() + s))


# ---------------------------------------------------------------------------
# Against the reference subprocess
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,i", KCASES)
def test_stencil_oracles_match_reference(reference, shape, i):
    from repro_torch.kernels import ref

    arrays, _ = reference
    (x, prev, nxt, b, dinv), tag = _inputs(arrays, shape)
    stencil, aniso = STENCILS[i]
    kw = dict(stencil=stencil, aniso=aniso)
    got = dict(
        s=ref.stencil7_ref(x, aniso) if stencil == "7pt" else ref.stencil27_ref(x),
        h=ref.stencil_halo_ref(x, prev, nxt, **kw),
        bd=ref.stencil_boundary_ref(x, prev, nxt, **kw),
        j=ref.jacobi_stencil_ref(x, b, dinv, omega=OMEGA, **kw),
    )
    scales = _scales(x, prev, nxt, b, dinv, stencil, aniso)
    for k, v in got.items():
        assert _rel(v, arrays[f"or_{tag}_{i}_{k}"], scales[k]) <= 1e-14, k
    # the stacked form: each of S slabs as the single-slab oracle, bitwise
    xs = torch.stack([x, x.flip(-1)])
    hp, hn = torch.stack([prev, nxt]), torch.stack([nxt, prev])
    ys = ref.stencil_halo_ref(xs, hp, hn, **kw)
    assert torch.equal(ys[1], ref.stencil_halo_ref(xs[1], hp[1], hn[1], **kw))
    assert torch.equal(ref.stencil_boundary_ref(xs, hp, hn, **kw)[1],
                       ref.stencil_boundary_ref(xs[1], hp[1], hn[1], **kw))
    if stencil == "27pt":
        assert torch.equal(ref.stencil27_ref(xs)[1], ref.stencil27_ref(xs[1]))
    else:
        assert torch.equal(ref.stencil7_ref(xs, aniso)[1], ref.stencil7_ref(xs[1], aniso))


@pytest.mark.parametrize("shape,i", KCASES)
def test_plain_stencil_kernels_match_pallas_interpret(reference, shape, i):
    from repro_torch.kernels import jacobi_stencil as js
    from repro_torch.kernels import spmv_stencil as st

    arrays, _ = reference
    (x, prev, nxt, b, dinv), tag = _inputs(arrays, shape)
    stencil, aniso = STENCILS[i]
    kw = dict(stencil=stencil, aniso=aniso)
    bz = st.pick_bz(shape[0])
    # the wrappers take their plain versions on CPU tensors
    got = dict(
        s=st.stencil_spmv(x, bz=bz, **kw),
        h=st.stencil_spmv_halo(x, prev, nxt, bz=bz, **kw),
        bd=st.stencil_spmv_boundary(x, prev, nxt, **kw),
        j=js.jacobi_stencil_sweep(x, b, dinv, omega=OMEGA, bz=bz, **kw),
    )
    scales = _scales(x, prev, nxt, b, dinv, stencil, aniso)
    for k, v in got.items():
        assert _rel(v, arrays[f"kn_{tag}_{i}_{k}"], scales[k]) <= 1e-12, k


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
    assert (mat.interior_stored_bytes(), mat.stored_bytes()) == (m["isb"], m["sb"])
    assert list(mat.n_bnd) == m["n_bnd"] and list(mat.row_starts) == m["row_starts"]
    assert list(getattr(mat.interior, "n_tail", ())) == m["n_tail"]
    assert [getattr(mat.interior, k, 0) for k in ("n_brows", "bpr", "br", "bc")] == m["bcsr"]


@pytest.mark.parametrize("stencil,S,mode,fmt", PART_CASES)
def test_partition_stencil_matches_reference_bytes(reference, stencil, S, mode, fmt):
    from repro_torch.core.partition import partition_stencil

    arrays, meta = reference
    mat = partition_stencil(_problem(stencil), S, mode=mode, fmt=fmt)
    _check_partition(mat, arrays, meta, f"part_{stencil}_{S}_{mode}_{fmt}")
    if fmt == "ell":  # stencil rows are uniform: "auto" resolves to ELL
        auto = partition_stencil(_problem(stencil), S, mode=mode, fmt="auto")
        _check_partition(auto, arrays, meta, f"part_{stencil}_{S}_{mode}_{fmt}")


@pytest.mark.parametrize("stencil,S,overlap", MV_CASES)
def test_matvec_matches_scipy_and_reference_counts(reference, stencil, S, overlap):
    from repro_torch.core.stencil_solver import make_matvec
    from repro_torch.energy import trace
    from repro_torch.matrices.poisson import poisson_scipy

    _, meta = reference
    p = _problem(stencil)
    a = poisson_scipy(p)
    x = np.random.default_rng(11).standard_normal(p.n)
    A = make_matvec(p, S, overlap=overlap)
    with trace.capture() as tr:
        y = A(torch.from_numpy(x).reshape(S, -1))
    assert y.shape == (S, p.n // S)
    scale = abs(a) @ np.abs(x)
    assert (np.abs(y.reshape(-1).numpy() - a @ x) / scale).max() <= 1e-13
    regions = {k: dataclasses.asdict(v) for k, v in tr.regions("setup").items()}
    _assert_close_tree(regions, meta[f"mv_{stencil}_{S}_{int(overlap)}"], "regions")


@pytest.mark.parametrize("tag,stencil,S,variant,overlap", SOLVE_CASES)
def test_stencil_solve_matches_reference(reference, tag, stencil, S, variant, overlap):
    from repro_torch.core.stencil_solver import make_stencil_solver_fn
    from repro_torch.energy import trace
    from repro_torch.kernels import dispatch as kd

    arrays, meta = reference
    m = meta[f"solve_{tag}"]
    p = _problem(stencil)
    solve = make_stencil_solver_fn(p, S, variant=variant, tol=TOL, maxiter=MAXITER,
                                   s=SSTEP_S, overlap=overlap, device="cpu")
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(p.n).reshape(S, -1))
    with trace.capture() as tr, kd.record_sweeps() as sw:
        res = solve(b, torch.zeros_like(b))
    assert res.iters == m["iters"]
    x_ref = arrays[f"solve_{tag}_x"]
    assert np.abs(res.x.reshape(-1).numpy() - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    assert float(res.rel_residual) <= TOL
    led = trace.ledger_from_trace(tr, iters=res.iters, n_shards=S, cost=_tpu_cost(),
                                  overlap=True, idle_s=0.01)
    _assert_close_tree({k: led[k] for k in ("regions", "totals")}, m["ledger"], "ledger")
    ent = max(sw.entries.get("iteration", 1), 1)
    sweeps = {k: v / ent for k, v in sw.ops.get("iteration", {}).items()}
    want = dict(m["sweeps"])
    if variant == "sstep":  # s eager SpMVs per block against one traced scan body
        want = {k: v * (SSTEP_S if k in kd.SPMV_OPS else 1) for k, v in want.items()}
    assert sweeps == want
    split = overlap and S > 1
    per_spmv = SSTEP_S if variant == "sstep" else 1
    assert sw.spmv_calls() == per_spmv * (2 if split else 1)


# ---------------------------------------------------------------------------
# Torch only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stencil,aniso", STENCILS)
@pytest.mark.parametrize("shape", [(8, 6, 10), (2, 5, 9), (3, 4, 6, 10)])
def test_plain_boundary_planes_bitwise_equal_slab_planes(shape, stencil, aniso, dtype):
    """The check the JAX package's interpret-mode kernels fail
    (``tests/test_overlap.py``): the port's plain boundary planes, and its
    boundary wrapper with ``out=``, give the plain slab planes bit for bit."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import spmv_stencil as st

    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, dtype=dtype)
    prev, nxt = (torch.randn(shape[:-3] + shape[-2:], generator=g, dtype=dtype)
                 for _ in range(2))
    kw = dict(stencil=stencil, aniso=aniso)
    full = ref.stencil_halo_ref(x, prev, nxt, **kw)
    bd = st.stencil_spmv_boundary(x, prev, nxt, **kw)
    assert torch.equal(bd[..., 0, :, :], full[..., 0, :, :])
    assert torch.equal(bd[..., 1, :, :], full[..., -1, :, :])
    out = torch.zeros_like(x)
    assert st.stencil_spmv_boundary(x, prev, nxt, out=out, **kw) is out
    assert torch.equal(out[..., [0, -1], :, :], full[..., [0, -1], :, :])
    assert not out[..., 1:-1, :, :].any()


@pytest.mark.parametrize("stencil,aniso", STENCILS)
def test_single_grid_is_bitwise_four_slabs_with_real_halos(stencil, aniso):
    """``stencil_spmv`` on one grid equals the halo form on 4 stacked slabs
    whose halo planes are their neighbours' edge planes — the equality
    ``chip_smoke.py`` holds the kernels to on the card."""
    from repro_torch.kernels import spmv_stencil as st

    x = torch.randn((16, 7, 9), generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    kw = dict(stencil=stencil, aniso=aniso)
    x3 = x.view(4, 4, 7, 9)
    prev = torch.cat([torch.zeros(1, 7, 9, dtype=x.dtype), x3[:-1, -1]])
    nxt = torch.cat([x3[1:, 0], torch.zeros(1, 7, 9, dtype=x.dtype)])
    y = st.stencil_spmv(x, **kw)
    assert torch.equal(st.stencil_spmv_halo(x3, prev, nxt, bz=4, **kw).view(16, 7, 9), y)


@pytest.mark.parametrize("stencil", ["7pt", "27pt"])
def test_overlapped_matvec_is_bitwise_the_single_call(stencil):
    """The split schedule (zero-halo slabs, then the edge planes patched)
    gives the serialized schedule's bits, and the anisotropic 7pt operator
    agrees with scipy."""
    from repro_torch.core.stencil_solver import make_matvec
    from repro_torch.matrices.poisson import PoissonProblem, poisson_scipy

    p = PoissonProblem(6, 5, 12, stencil, ANISO if stencil == "7pt" else ISO)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(p.n)).reshape(4, -1)
    y_on = make_matvec(p, 4, overlap=True)(x)
    y_off = make_matvec(p, 4, overlap=False)(x)
    assert torch.equal(y_on, y_off)
    a = poisson_scipy(p)
    xv = x.reshape(-1).numpy()
    assert (np.abs(y_on.reshape(-1).numpy() - a @ xv) / (abs(a) @ np.abs(xv))).max() <= 1e-13


def test_cpu_tensors_launch_nothing_and_wrappers_check_arguments():
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels import jacobi_stencil as js
    from repro_torch.kernels import spmv_stencil as st

    st.reset_launches()
    js.reset_launches()
    x = torch.ones(4, 3, 5)
    z = torch.zeros(3, 5)
    st.stencil_spmv(x, bz=4)
    st.stencil_spmv_halo(x, z, z, bz=2)
    st.stencil_spmv_boundary(x, z, z)
    js.jacobi_stencil_sweep(x, x, x, bz=1)
    assert st.launches() == dict.fromkeys(st.KERNELS, 0)
    assert js.launches() == {"jacobi_stencil_sweep": 0}
    with pytest.raises(ValueError, match="multiple of bz"):
        st.stencil_spmv(x, bz=3)
    with pytest.raises(ValueError, match="at least 2 local z-planes"):
        st.stencil_spmv_boundary(x[:1], z, z)
    with pytest.raises(ValueError, match="operand of shape"):
        st.stencil_spmv_halo(x, z[:2], z, bz=4)
    with pytest.raises(ValueError, match="differ in dtype"):
        js.jacobi_stencil_sweep(x, x.double(), x, bz=4)
    with pytest.raises(ValueError, match="grid or"):
        st.stencil_spmv(x[0], bz=1)
    with pytest.raises(ValueError, match="unknown stencil"):
        st.stencil_spmv(x, stencil="9pt", bz=4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kd.ops_for("cuda").stencil_matvec(x, z, z)
    assert st.pick_bz(12) == 6 and st.pick_bz(7) == 7 and st.pick_bz(11, 8) == 1


def test_stencil_entry_points_need_cuda_unless_cpu_and_uniform_slabs(monkeypatch):
    from repro_torch.core.stencil_solver import make_matvec, make_stencil_solver_fn
    from repro_torch.kernels import ops

    p = _problem("7pt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_stencil_solver_fn(p, 4)
    with pytest.raises(ValueError, match="uniform slabs"):
        make_matvec(p, 3)
    with pytest.raises(ValueError, match="unknown CG variant"):
        make_stencil_solver_fn(p, 4, variant="cgs", device="cpu")
    from repro_torch.core.partition import partition_stencil, plane_partition

    with pytest.raises(ValueError, match="unknown halo mode"):
        partition_stencil(p, 2, mode="mesh")
    with pytest.raises(ValueError, match="cannot slab-partition"):
        plane_partition(p.n, p.plane, p.nz + 1)
    # the public kernel entry points: the stencil kernels and the re-exports
    for name in ("stencil_spmv", "stencil_spmv_halo", "stencil_spmv_boundary",
                 "jacobi_stencil_sweep", "pick_bz", "fused_dots_n", "fused_axpy",
                 "fused_axpy2", "fused_axpy2_dots", "bcsr_spmv", "pack_bcsr", "ref"):
        assert hasattr(ops, name), name


def test_every_tpu_kernel_has_a_counterpart():
    """The 16 functions of the JAX package that reach ``pl.pallas_call``
    each have one port kernel naming them, from the five kernel modules."""
    import re
    from pathlib import Path

    from repro_torch.kernels import fused_reductions, jacobi_stencil, spmv_bcsr, spmv_stencil

    ks = {}
    for m in (fused_reductions, spmv_bcsr, spmv_stencil, jacobi_stencil):
        ks.update(m.KERNELS)
    assert len(ks) == 16
    root = Path(__file__).resolve().parents[1]
    for name, k in ks.items():
        path, line = k["replaces"].rsplit(":", 1)
        text = (root / path).read_text().splitlines()
        assert re.match(rf"def {name}\(", text[int(line) - 1]), (name, k["replaces"])
        assert (root / k["source"]).exists()
