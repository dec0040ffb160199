"""The port's main path against the JAX package, in float64.

``repro.api.solve`` and x64 must stay out of the pytest process (x64 is
process-wide), so ONE module-scoped subprocess with 4 host devices and x64
runs the reference: partitions, hs and naive solves, SpMVs and their
ledgers for poisson7 at sides 12 and 16 on 1, 2 and 4 shards, written to a
``.npz`` + ``.json`` pair. The port (on the CPU) must give:

* the same partitions, byte for byte, in float64;
* the same hs and naive iteration counts; ``x`` within 1e-10 relative;
* the SpMV within 1e-12 relative;
* ledger ``regions`` and ``totals`` within 1e-12 relative when its counts
  are priced with the reference's own chip spec (``TPU_V5E``);
* the same results when fed the reference's partition arrays through
  ``distmat_from_numpy``.

Plus the import boundary (no ``jax``/``repro`` in the port), the device
rule of the entry points, the CLI, and the config surface.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import REPO, SRC, run_multidevice

SIDES = (12, 16)
SHARDS = (1, 2, 4)
LEGS = ("hs", "naive")
CASES = [(side, S) for side in SIDES for S in SHARDS]
LEAVES = ("data", "col", "data_ext", "col_ext", "bnd_rows", "send_sel")

REF_SNIPPET = r"""
import json, sys
import numpy as np
from repro.matrices.poisson import cube, poisson_scipy
from repro.core.partition import partition_csr, pad_vector, unpad_vector
from repro.core.spmv import shard_matrix, shard_vector, make_spmv
from repro.core.cg import make_solver
from repro.core.baselines import make_naive_solver, make_naive_spmv
from repro.energy import trace
from repro.energy.accounting import CostModel
from repro.launch.mesh import make_solver_mesh

out = sys.argv[1]
arrays, meta = {}, {}
cost = CostModel()
for side in %(sides)r:
    a = poisson_scipy(cube(side, "7pt"))
    n = a.shape[0]
    b = np.ones(n)
    xs = np.random.default_rng(side).standard_normal(n)
    for S in %(shards)r:
        mesh = make_solver_mesh(S)
        for leg in ("hs", "naive"):
            tag = f"{side}_{S}_{leg}"
            m = partition_csr(a, S, force_allgather=(leg == "naive"))
            leaves = dict(data=m.interior.data, col=m.interior.col,
                          data_ext=m.data_ext, col_ext=m.col_ext,
                          bnd_rows=m.bnd_rows, send_sel=m.send_sel)
            for k, v in leaves.items():
                arrays[f"{tag}_{k}"] = np.asarray(v)
            mm = shard_matrix(mesh, m)
            if leg == "hs":
                solver = make_solver(mesh, mm, tol=1e-8, maxiter=1000)
                spmv = make_spmv(mesh, mm)
            else:
                solver = make_naive_solver(mesh, mm, tol=1e-8, maxiter=1000)
                spmv = make_naive_spmv(mesh, mm)
            bp = pad_vector(b, m)
            with trace.capture() as tr:
                res = solver(shard_vector(mesh, bp),
                             shard_vector(mesh, np.zeros_like(bp)))
            iters = int(res.iters)
            led = trace.ledger_from_trace(tr, iters=iters, n_shards=S, cost=cost,
                                          overlap=(leg == "hs"), idle_s=0.01)
            with trace.capture() as trs:
                y = spmv(mm, shard_vector(mesh, pad_vector(xs, m)))
            led_s = trace.ledger_from_trace(trs, iters=0, n_shards=S, cost=cost,
                                            overlap=(leg == "hs"), idle_s=0.01,
                                            setup_repeats=100)
            arrays[f"{tag}_x"] = unpad_vector(np.asarray(res.x), m)
            arrays[f"{tag}_y"] = unpad_vector(np.asarray(y), m)
            p = m.plan
            meta[tag] = dict(
                iters=iters, rr=float(res.rr),
                ledger=dict(regions=led["regions"], totals=led["totals"]),
                spmv_ledger=dict(regions=led_s["regions"], totals=led_s["totals"]),
                plan=[p.mode, list(p.shifts), list(p.widths), p.n_own_pad, p.n_shards],
                n_bnd=list(m.n_bnd), row_starts=list(m.row_starts),
            )
np.savez(out + ".npz", **arrays)
with open(out + ".json", "w") as f:
    json.dump(meta, f)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_solve_ref") / "ref")
    code = REF_SNIPPET % {"sides": SIDES, "shards": SHARDS}
    code = code.replace("out = sys.argv[1]", f"out = {out!r}")
    assert "REF_OK" in run_multidevice(code, n_devices=4, x64=True)
    arrays = dict(np.load(out + ".npz"))
    with open(out + ".json") as f:
        meta = json.load(f)
    return arrays, meta


def _tpu_cost():
    """The port's cost model priced with the reference's chip spec."""
    from repro.roofline.hw import TPU_V5E
    from repro_torch.energy.accounting import CostModel
    from repro_torch.energy.model import PowerModel
    from repro_torch.roofline.hw import ChipSpec

    return CostModel(power=PowerModel(chip=ChipSpec(**dataclasses.asdict(TPU_V5E))))


def _assert_close_tree(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, sorted(got), sorted(ref))
        for k in ref:
            _assert_close_tree(got[k], ref[k], f"{path}.{k}")
        return
    g, r = float(got), float(ref)
    assert abs(g - r) <= 1e-12 * max(abs(g), abs(r)) + 1e-300, (path, g, r)


def _port_matrix(side, S, leg):
    from repro_torch.core.partition import partition_csr
    from repro_torch.matrices.poisson import cube, poisson_scipy

    a = poisson_scipy(cube(side, "7pt"))
    return a, partition_csr(a, S, force_allgather=(leg == "naive"))


def _carried_matrix(arrays, meta, side, S, leg):
    from repro_torch.core.partition import distmat_from_numpy

    tag = f"{side}_{S}_{leg}"
    mode, shifts, widths, R, nS = meta[tag]["plan"]
    return distmat_from_numpy(
        **{k: arrays[f"{tag}_{k}"] for k in LEAVES},
        mode=mode, shifts=shifts, widths=widths, n_own_pad=R, n_shards=nS,
        n_global=side ** 3, row_starts=meta[tag]["row_starts"],
        n_bnd=meta[tag]["n_bnd"],
    )


def _run_port(mat, leg):
    """One solve + one SpMV through the port's handles, on the CPU."""
    from repro_torch.core.cg import solver_handle
    from repro_torch.core.partition import pad_vector, unpad_vector
    from repro_torch.energy import trace

    n = mat.n_global
    b = torch.from_numpy(pad_vector(np.ones(n), mat))
    variant = "naive" if leg == "naive" else "hs"
    h = solver_handle(mat, variant=variant, tol=1e-8, maxiter=1000,
                      device="cpu", cache={})
    res = h.warm(b, torch.zeros_like(b))
    cost = _tpu_cost()
    S = mat.n_shards
    led = trace.ledger_from_trace(h.trace, iters=res.iters, n_shards=S, cost=cost,
                                  overlap=(leg == "hs"), idle_s=0.01)
    side = round(n ** (1 / 3))
    xs = np.random.default_rng(side).standard_normal(n)
    hs = solver_handle(mat, op="spmv", variant=variant, device="cpu", cache={})
    y = hs.warm(torch.from_numpy(pad_vector(xs, mat)))
    led_s = trace.ledger_from_trace(hs.trace, iters=0, n_shards=S, cost=cost,
                                    overlap=(leg == "hs"), idle_s=0.01,
                                    setup_repeats=100)
    return dict(res=res, x=unpad_vector(res.x, mat), y=unpad_vector(y, mat),
                ledger=led, spmv_ledger=led_s)


def _check_against(out, arrays, meta, tag):
    m = meta[tag]
    assert out["res"].iters == m["iters"]
    x_ref = arrays[f"{tag}_x"]
    assert np.abs(out["x"] - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    y_ref = arrays[f"{tag}_y"]
    assert np.abs(out["y"] - y_ref).max() <= 1e-12 * np.abs(y_ref).max()
    for key in ("ledger", "spmv_ledger"):
        _assert_close_tree(
            {k: out[key][k] for k in ("regions", "totals")}, m[key], key
        )


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("side,S", CASES)
def test_port_matches_reference(reference, side, S, leg):
    arrays, meta = reference
    tag = f"{side}_{S}_{leg}"
    _, mat = _port_matrix(side, S, leg)
    for k in LEAVES:
        got = getattr(mat.interior, k) if k in ("data", "col") else getattr(mat, k)
        r = arrays[f"{tag}_{k}"]
        assert got.numpy().dtype == r.dtype and np.array_equal(got.numpy(), r), k
    p = mat.plan
    assert [p.mode, list(p.shifts), list(p.widths), p.n_own_pad, p.n_shards] == \
        meta[tag]["plan"]
    _check_against(_run_port(mat, leg), arrays, meta, tag)


@pytest.mark.parametrize("side,S", CASES)
def test_carried_reference_partition_gives_same_results(reference, side, S):
    arrays, meta = reference
    for leg in LEGS:
        mat = _carried_matrix(arrays, meta, side, S, leg)
        _check_against(_run_port(mat, leg), arrays, meta, f"{side}_{S}_{leg}")


def test_hs_iteration_is_three_vector_sweeps():
    from repro_torch.core.cg import make_solver
    from repro_torch.core.partition import pad_vector
    from repro_torch.kernels import dispatch as kd

    _, mat = _port_matrix(12, 4, "hs")
    b = torch.from_numpy(pad_vector(np.ones(mat.n_global), mat))
    with kd.record_sweeps() as sw:
        res = make_solver(mat, device="cpu", maxiter=1000)(b, torch.zeros_like(b))
    assert res.iters > 10
    assert sw.entries["iteration"] == res.iters
    assert sw.vector_sweeps("iteration") == 3
    assert sw.ops["iteration"] == {"fused_dots_n": res.iters, "fused_axpy2_dots": res.iters,
                                   "axpy": res.iters}


# ---------------------------------------------------------------------------
# Import boundary, devices, CLI, config surface
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'repro' or k.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 20, mods\n"
        "print('IMPORTS_OK', len(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=_env(), timeout=300, cwd=REPO)
    assert r.returncode == 0 and "IMPORTS_OK" in r.stdout, r.stderr[-3000:]


def test_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch):
    from repro_torch import api
    from repro_torch.core.cg import make_solver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = api.ProblemSpec(side=6, shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.solve(spec, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.SolverSession(spec.load()[0], 2)
    _, mat = _port_matrix(12, 2, "hs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_solver(mat)
    rep = api.solve(spec, device="cpu", verbose=False)
    assert rep.summary["BCMGX-analog"]["iters"] == rep.summary["Ginkgo-analog"]["iters"]
    assert rep.ledger["meta"]["backend"] == "cpu"


def test_cli_runs_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--device", "cpu",
         "--side", "8", "--shards", "2"],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BCMGX-analog" in r.stdout and "Ginkgo-analog" in r.stdout
    assert "relres=" in r.stdout


def test_config_surface_matches_reference():
    from repro import api as japi
    from repro_torch import api

    bad = [dict(nrhs=2, variant="fcg"), dict(autotune=True, op="spmv"),
           dict(grid="2x2", amg=True), dict(s=2), dict(tol=0.0),
           dict(variant="nope"), dict(grid="2by2")]
    for kw in bad:
        with pytest.raises(japi.ConfigError) as je:
            japi.SolverConfig(**kw)
        with pytest.raises(api.ConfigError) as te:
            api.SolverConfig(**kw)
        assert str(te.value) == str(je.value)
    cfg = api.SolverConfig(maxiter=77, overlap=False, repeats=3)
    assert cfg.to_argv() == japi.SolverConfig(maxiter=77, overlap=False,
                                              repeats=3).to_argv()
    from repro_torch.launch.solve import parse_args

    args = parse_args(cfg.to_argv() + ["--side", "9"])
    assert api.SolverConfig.from_args(args) == cfg
    assert api.ProblemSpec.from_args(args) == api.ProblemSpec(side=9)
    for kw, item in ((dict(variant="sstep"), "item 9"),
                     (dict(grid="2x2"), "item 10"), (dict(amg=True), "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            api.solve(api.ProblemSpec(side=6), api.SolverConfig(**kw), device="cpu",
                      verbose=False)
    # SuiteSparse problems are ported: the spec loads the reference's matrix
    kw = dict(problem="af_shell8", scale=0.002)
    (a, name), (ja, jname) = api.ProblemSpec(**kw).load(), japi.ProblemSpec(**kw).load()
    assert name == jname == "af_shell8"
    assert (a != ja).nnz == 0 and a.shape == ja.shape


def test_zero_iteration_ledger_equals_reference():
    """A right-hand side of zero converges before the first iteration. The
    JAX package still charges its once-traced loop body one time
    (``max(iters, 1)`` in ``ledger_from_trace``); the port runs the body
    once with its outputs thrown away, so the two ledgers are equal — for
    hs, fcg, pipecg and block-HS — while ``iters`` and ``x`` are those of a
    loop that never ran. In-process, so both run in float32."""
    from repro.core.cg import make_block_solver as jmake_block_solver
    from repro.core.cg import make_solver as jmake_solver
    from repro.core.partition import pad_block as jpad_block
    from repro.core.partition import pad_vector as jpad, partition_csr as jpartition
    from repro.core.spmv import shard_matrix, shard_vector
    from repro.energy import trace as jtrace
    from repro.energy.accounting import CostModel as JCostModel
    from repro.launch.mesh import make_solver_mesh
    from repro.matrices.poisson import cube, poisson_scipy
    from repro_torch.core.cg import solver_handle
    from repro_torch.core.partition import pad_block, pad_vector, partition_csr
    from repro_torch.energy import trace

    a = poisson_scipy(cube(6))
    n = a.shape[0]
    mesh = make_solver_mesh(1)
    jm = shard_matrix(mesh, jpartition(a, 1, dtype=np.float32))
    m = partition_csr(a, 1, dtype=np.float32)
    for variant, nrhs in (("hs", 1), ("fcg", 1), ("pipecg", 1), ("hs", 3)):
        if nrhs > 1:
            b = np.zeros((n, nrhs), np.float32)
            jb, bp = jpad_block(b, jm), pad_block(b, m)
            jsolve = jmake_block_solver(mesh, jm)
        else:
            b = np.zeros(n, np.float32)
            jb, bp = jpad(b, jm), pad_vector(b, m)
            jsolve = jmake_solver(mesh, jm, variant=variant)
        with jtrace.capture() as jtr:
            jres = jsolve(shard_vector(mesh, jb), shard_vector(mesh, jb))
        jiters = int(jres.iters)
        assert jiters == (0 if variant == "hs" else 1)  # fcg/pipecg count from 1
        assert jtr.total(jtrace.ITERATION).flops > 0  # one traced body, charged once
        jled = jtrace.ledger_from_trace(jtr, iters=jiters, n_shards=1, cost=JCostModel(),
                                        idle_s=0.01)

        bt = torch.from_numpy(bp)
        x0 = torch.zeros_like(bt)
        h = solver_handle(m, nrhs=nrhs, variant=variant, device="cpu", cache={})
        res = h.warm(bt, x0)
        assert res.iters == jiters
        assert torch.equal(res.x, x0)
        led = trace.ledger_from_trace(h.trace, iters=res.iters, n_shards=1,
                                      cost=_tpu_cost(), idle_s=0.01)
        _assert_close_tree({k: led[k] for k in ("regions", "totals")},
                           {k: jled[k] for k in ("regions", "totals")},
                           f"{variant}/{nrhs}")
