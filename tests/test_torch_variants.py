"""The port's fcg, pipecg and block-HS paths against the JAX package, in f64.

As in ``tests/test_torch_solve.py``, ONE module-scoped subprocess with 4
host devices and x64 runs the reference: fcg, pipecg (overlap on and off)
and block-HS (r = 3, ``default_rhs_block``) on poisson7 at side 12 on 1, 2
and 4 shards and at side 16 on 4 shards, plus the block SpMM with overlap
on and off, written to a ``.npz`` + ``.json`` pair. The port (on the CPU)
must give:

* the same ``iters`` (and ``iters_cols`` for the block path);
* ``x`` within 1e-10 relative (the two sum in different orders);
* ledger ``regions`` and ``totals`` within 1e-12 relative when its counts
  are priced with the reference's own chip spec (``TPU_V5E``);
* the reference's ``SweepLedger`` counts per iteration;
* the same results when fed the reference's partition arrays through
  ``distmat_from_numpy``;
* the SpMM within 1e-12 relative to ``|A| @ |X|`` of scipy's and the
  reference's, with the reference's region counts.

Plus ``pad_block``/``unpad_block`` byte for byte against the reference.
"""

import json

import numpy as np
import pytest
import torch

from tests.conftest import run_multidevice
from tests.test_torch_solve import LEAVES, _assert_close_tree, _tpu_cost

CASES = [(12, 1), (12, 2), (12, 4), (16, 4)]
# leg -> (variant, nrhs, overlap)
LEGS = {
    "fcg": ("fcg", 1, True),
    "pipecg": ("pipecg", 1, True),
    "pipecg_serial": ("pipecg", 1, False),
    "block": ("hs", 3, True),
}
NRHS = 3
# api.solve configurations, side 12 on 2 shards
API_CASES = {"block": dict(nrhs=NRHS), "fcg": dict(variant="fcg"),
             "pipecg_serial": dict(variant="pipecg", overlap=False)}
API_KEYS = ("iters", "relres", "variant", "nrhs", "iters_cols", "n_shards")

REF_SNIPPET = r"""
import json, sys
import numpy as np
from repro.matrices.poisson import cube, poisson_scipy
from repro.core.partition import partition_csr, pad_vector, unpad_vector, pad_block, unpad_block
from repro.core.spmv import shard_matrix, shard_vector, make_spmv
from repro.core.cg import make_solver, make_block_solver, default_rhs_block
from repro.energy import trace
from repro.energy.accounting import CostModel
from repro.kernels import dispatch as kd
from repro.launch.mesh import make_solver_mesh

out = sys.argv[1]
arrays, meta = {}, {}
cost = CostModel()
for side, S in %(cases)r:
    a = poisson_scipy(cube(side, "7pt"))
    n = a.shape[0]
    mesh = make_solver_mesh(S)
    m = partition_csr(a, S)
    tag0 = f"{side}_{S}"
    leaves = dict(data=m.interior.data, col=m.interior.col, data_ext=m.data_ext,
                  col_ext=m.col_ext, bnd_rows=m.bnd_rows, send_sel=m.send_sel)
    for k, v in leaves.items():
        arrays[f"{tag0}_{k}"] = np.asarray(v)
    p = m.plan
    meta[tag0] = dict(plan=[p.mode, list(p.shifts), list(p.widths), p.n_own_pad, p.n_shards],
                      n_bnd=list(m.n_bnd), row_starts=list(m.row_starts))
    mm = shard_matrix(mesh, m)
    for leg, (variant, nrhs, overlap) in %(legs)r.items():
        tag = f"{tag0}_{leg}"
        if nrhs > 1:
            B = default_rhs_block(n, nrhs)
            solver = make_block_solver(mesh, mm, tol=1e-8, maxiter=1000, overlap=overlap)
            bp = pad_block(B, m)
        else:
            solver = make_solver(mesh, mm, variant=variant, tol=1e-8, maxiter=1000,
                                 overlap=overlap)
            bp = pad_vector(np.ones(n), m)
        with trace.capture() as tr, kd.record_sweeps() as sw:
            res = solver(shard_vector(mesh, bp), shard_vector(mesh, np.zeros_like(bp)))
        iters = int(res.iters)
        led = trace.ledger_from_trace(tr, iters=iters, n_shards=S, cost=cost,
                                      overlap=overlap, idle_s=0.01)
        unpad = unpad_block if nrhs > 1 else unpad_vector
        arrays[f"{tag}_x"] = unpad(np.asarray(res.x), m)
        ent = max(sw.entries.get("iteration", 1), 1)
        meta[tag] = dict(
            iters=iters, ledger=dict(regions=led["regions"], totals=led["totals"]),
            sweeps={k: v / ent for k, v in sw.ops.get("iteration", {}).items()},
        )
        if nrhs > 1:
            meta[tag]["iters_cols"] = [int(v) for v in np.asarray(res.iters_cols)]
    X = np.random.default_rng(side + S).standard_normal((n, %(nrhs)d))
    for overlap in (True, False):
        with trace.capture() as trs:
            Y = make_spmv(mesh, mm, overlap=overlap)(mm, shard_vector(mesh, pad_block(X, m)))
        led = trace.ledger_from_trace(trs, iters=0, n_shards=S, cost=cost, overlap=overlap,
                                      idle_s=0.01, setup_repeats=100)
        tag = f"{tag0}_spmm_{int(overlap)}"
        arrays[f"{tag}_y"] = unpad_block(np.asarray(Y), m)
        meta[tag] = dict(ledger=dict(regions=led["regions"], totals=led["totals"]))
    arrays[f"{tag0}_X"] = X
    arrays[f"{tag0}_Xpad"] = pad_block(X, m)
from repro import api as japi
for key, kw in %(api_cases)r.items():
    rep = japi.solve(japi.ProblemSpec(side=12, shards=2), japi.SolverConfig(**kw),
                     verbose=False)
    meta[f"api_{key}"] = {
        label: {k: e.get(k) for k in %(api_keys)r} for label, e in rep.solvers.items()
    }
np.savez(out + ".npz", **arrays)
with open(out + ".json", "w") as f:
    json.dump(meta, f)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_variants_ref") / "ref")
    code = REF_SNIPPET % {"cases": CASES, "legs": LEGS, "nrhs": NRHS,
                          "api_cases": API_CASES, "api_keys": API_KEYS}
    code = code.replace("out = sys.argv[1]", f"out = {out!r}")
    assert "REF_OK" in run_multidevice(code, n_devices=4, x64=True)
    arrays = dict(np.load(out + ".npz"))
    with open(out + ".json") as f:
        meta = json.load(f)
    return arrays, meta


def _port_matrix(side, S):
    from repro_torch.core.partition import partition_csr
    from repro_torch.matrices.poisson import cube, poisson_scipy

    return partition_csr(poisson_scipy(cube(side, "7pt")), S)


def _carried_matrix(arrays, meta, side, S):
    from repro_torch.core.partition import distmat_from_numpy

    tag = f"{side}_{S}"
    mode, shifts, widths, R, nS = meta[tag]["plan"]
    return distmat_from_numpy(
        **{k: arrays[f"{tag}_{k}"] for k in LEAVES},
        mode=mode, shifts=shifts, widths=widths, n_own_pad=R, n_shards=nS,
        n_global=side ** 3, row_starts=meta[tag]["row_starts"],
        n_bnd=meta[tag]["n_bnd"],
    )


def _run_port(mat, leg):
    """One solve of ``leg`` through the port's handles, on the CPU."""
    from repro_torch.core.cg import default_rhs_block, solver_handle
    from repro_torch.core.partition import pad_block, pad_vector, unpad_vector
    from repro_torch.energy import trace
    from repro_torch.kernels import dispatch as kd

    variant, nrhs, overlap = LEGS[leg]
    n = mat.n_global
    if nrhs > 1:
        b = torch.from_numpy(pad_block(default_rhs_block(n, nrhs), mat))
    else:
        b = torch.from_numpy(pad_vector(np.ones(n), mat))
    h = solver_handle(mat, nrhs=nrhs, variant=variant, tol=1e-8, maxiter=1000,
                      overlap=overlap, device="cpu", cache={})
    with kd.record_sweeps() as sw:
        res = h.warm(b, torch.zeros_like(b))
    led = trace.ledger_from_trace(h.trace, iters=res.iters, n_shards=mat.n_shards,
                                  cost=_tpu_cost(), overlap=overlap, idle_s=0.01)
    ent = max(sw.entries.get("iteration", 1), 1)
    return dict(res=res, x=unpad_vector(res.x, mat), ledger=led,
                sweeps={k: v / ent for k, v in sw.ops.get("iteration", {}).items()})


def _check_against(out, arrays, meta, tag):
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


@pytest.mark.parametrize("leg", list(LEGS))
@pytest.mark.parametrize("side,S", CASES)
def test_variant_matches_reference(reference, side, S, leg):
    arrays, meta = reference
    _check_against(_run_port(_port_matrix(side, S), leg), arrays, meta,
                   f"{side}_{S}_{leg}")


@pytest.mark.parametrize("side,S", CASES)
def test_carried_reference_partition_gives_same_results(reference, side, S):
    arrays, meta = reference
    mat = _carried_matrix(arrays, meta, side, S)
    for leg in LEGS:
        _check_against(_run_port(mat, leg), arrays, meta, f"{side}_{S}_{leg}")


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("side,S", CASES)
def test_spmm_matches_scipy_and_reference(reference, side, S, overlap):
    from repro_torch.core.partition import pad_block, unpad_block
    from repro_torch.core.spmv import spmv_shard
    from repro_torch.energy import trace
    from repro_torch.matrices.poisson import cube, poisson_scipy

    arrays, meta = reference
    tag0 = f"{side}_{S}"
    a = poisson_scipy(cube(side, "7pt"))
    X = arrays[f"{tag0}_X"]
    mat = _port_matrix(side, S)
    Xp = pad_block(X, mat)
    assert Xp.dtype == arrays[f"{tag0}_Xpad"].dtype
    assert np.array_equal(Xp, arrays[f"{tag0}_Xpad"])  # pad_block: same bytes
    with trace.capture() as tr:
        Yp = spmv_shard(mat, torch.from_numpy(Xp), overlap=overlap)
    assert Yp.shape == Xp.shape
    Y = unpad_block(Yp, mat)
    assert np.array_equal(unpad_block(Xp, mat), X)  # unpad_block inverts it
    scale = np.abs(a) @ np.abs(X)
    assert (np.abs(Y - a @ X) / scale).max() <= 1e-12
    tag = f"{tag0}_spmm_{int(overlap)}"
    assert (np.abs(Y - arrays[f"{tag}_y"]) / scale).max() <= 1e-12
    led = trace.ledger_from_trace(tr, iters=0, n_shards=S, cost=_tpu_cost(),
                                  overlap=overlap, idle_s=0.01, setup_repeats=100)
    _assert_close_tree({k: led[k] for k in ("regions", "totals")},
                       meta[tag]["ledger"], "spmm_ledger")


def test_variant_sweeps_per_iteration():
    """Kernel launches per iteration on the CPU's op ledger: fcg 3 sweeps
    (dots + 2 fused_axpy2), pipecg 4 (dots + 3 fused_axpy2), block-HS 4
    (2 block_gram, block_update2, block_update)."""
    from repro_torch.kernels import dispatch as kd

    mat = _port_matrix(12, 2)
    want = {"fcg": {"fused_dots_n": 1, "fused_axpy2": 2},
            "pipecg": {"fused_dots_n": 1, "fused_axpy2": 3},
            "block": {"block_gram": 2, "block_update2": 1, "block_update": 1}}
    for leg, ops in want.items():
        out = _run_port(mat, leg)
        assert out["res"].iters > 10
        assert out["sweeps"] == ops
        assert kd.SweepLedger(ops={"iteration": ops}).vector_sweeps() == sum(ops.values())


@pytest.mark.parametrize("key", list(API_CASES))
def test_api_solve_matches_reference_api(reference, key):
    """``api.solve`` runs the new paths like the JAX package's
    ``api.solve``: the same legs (no Ginkgo-analog leg beside a block
    solve), iteration counts, ``iters_cols`` and the batch's worst-column
    relres; per-solve fields of a block leg are divided by ``nrhs``."""
    from repro_torch import api

    _, meta = reference
    rep = api.solve(api.ProblemSpec(side=12, shards=2), api.SolverConfig(**API_CASES[key]),
                    device="cpu", verbose=False)
    ref = meta[f"api_{key}"]
    assert set(rep.solvers) == set(ref)
    for label, want in ref.items():
        e = rep.solvers[label]
        for k in API_KEYS:
            if k == "relres":
                assert e[k] == pytest.approx(want[k], rel=1e-6)
            else:
                assert e.get(k) == want[k], (label, k)
        nrhs = e["nrhs"]
        assert e["per_solve_wall_s"] == pytest.approx(e["wall_s"] / nrhs)
        assert e["per_solve_de_j"] == pytest.approx(e["totals"]["de_total"] / nrhs)
        x = rep.outputs[label]
        assert x.shape == ((12 ** 3, nrhs) if nrhs > 1 else (12 ** 3,))
        assert np.isfinite(x).all()


@pytest.mark.parametrize("flags", [["--variant", "fcg"],
                                   ["--variant", "pipecg", "--no-overlap"],
                                   ["--nrhs", "4"]])
def test_cli_runs_new_paths_on_cpu(flags):
    import subprocess
    import sys

    from tests.conftest import REPO
    from tests.test_torch_solve import _env

    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--device", "cpu",
         "--side", "8", "--shards", "2", *flags],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BCMGX-analog" in r.stdout and "relres=" in r.stdout
    assert ("Ginkgo-analog" in r.stdout) == ("--nrhs" not in flags)
