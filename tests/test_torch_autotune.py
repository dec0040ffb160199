"""The port's energy-aware autotuner against the JAX package's, in float64.

Both packages price with the same chip where their decisions are compared:
the port's ``CostModel`` is built from the fields of the reference's
``TPU_V5E`` (``_tpu_cost``), which also gives the reference's model hash.

In process (host numpy on both sides; the reference's solves under
``jax.enable_x64``):

* ``CG_HOTPATH``/``CG_COMM`` and the ``cg_*`` models over a grid of
  variant, n, nrhs, s and fused;
* ``spmv_counts``, ``cg_iteration_counts`` (hs, fcg, naive, amgx, and
  s-step on ``halo_depth = 2`` partitions) and ``vcycle_counts`` on port and
  reference ``DistMat`` s of one CSR (1, 3, 4 shards, ELL/HYB/BCSR, a 2 x 2
  grid), relative 1e-12;
* ``enumerate_space`` (labels and dicts) for 4 or 8 shards, 1 or several
  right-hand sides; ``sort_key``, the dict round trip and ``score``;
* ``interior_stats``, ``format_stored_bytes``, every ``Prediction`` and the
  survivors; ``extrapolate_iters``; the cache (round trip, frequency grid,
  schema gate, corrupt files, ``nrhs``, chips hashing apart);
* ``autotune`` end to end on poisson7 at side 6 (1 shard, budget 2, 4 trial
  iterations): the same decision, candidate counts, trial iterations and
  ledger section (floats relative 1e-9), and with the H100 model the
  reference test's invariants (a downclocked winner, a cache hit, ``force``);
* ``api.solve(autotune=True)`` against the reference's: the chosen label,
  iterations, per-region counts, one leg, a hit on the repeat; the CLI.

ONE module-scoped subprocess with 8 host devices and x64 runs the
reference's tuner on poisson7 at side 8 over 8 shards (objectives ``time``
and ``energy``), where the grid (2, 4) and s-step axes open, and its
``api.solve`` on cached grid and s-step winners; the port must give the
same decisions, trials and ledgers, and solve a tuned grid winner on the
un-permuted matrix with the grid ledger fields and the staged tree depth.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.autotune import cache as jcache
from repro.autotune import space as jspace
from repro.autotune import trial as jtrial
from repro.core import partition as jp
from repro.energy import accounting as jacc
from repro.matrices.poisson import cube, poisson_scipy
from repro.roofline import analysis as jan
from repro_torch.autotune import cache as tcache
from repro_torch.autotune import space as tspace
from repro_torch.autotune import trial as ttrial
from repro_torch.core import partition as tp
from repro_torch.energy import accounting as tacc
from repro_torch.roofline import analysis as tan
from tests.conftest import REPO, run_multidevice
from tests.test_torch_solve import _env, _tpu_cost

# the packages' ``prune`` functions shadow their ``prune`` modules
jprune = importlib.import_module("repro.autotune.prune")
tprune = importlib.import_module("repro_torch.autotune.prune")

REL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are tiny: one CPU thread, so idle workers do
    not take cores from the files that run beside this one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(g, r, rel=REL, path=""):
    g, r = float(g), float(r)
    assert abs(g - r) <= rel * max(abs(g), abs(r)) + 1e-300, (path, g, r)


def _close_tree(got, ref, rel=REL, path=""):
    """Dicts, lists and scalars equal, floats to ``rel``."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, sorted(got), sorted(ref))
        for k in ref:
            _close_tree(got[k], ref[k], rel, f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), (path, got, ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            _close_tree(g, r, rel, f"{path}[{i}]")
    elif isinstance(ref, float):
        _close(got, ref, rel, path)
    else:
        assert got == ref, (path, got, ref)


def _counts_close(got, ref, path=""):
    for f in dataclasses.fields(ref):
        _close(getattr(got, f.name), getattr(ref, f.name), REL, f"{path}.{f.name}")


def _poisson(side=6, stencil="7pt"):
    return poisson_scipy(cube(side, stencil))


# ---------------------------------------------------------------------------
# roofline CG models
# ---------------------------------------------------------------------------


def test_cg_tables_match_reference():
    assert tan.CG_HOTPATH == jan.CG_HOTPATH
    assert tan.CG_COMM == jan.CG_COMM
    for s in (1, 2, 3, 6):
        for fused in (True, False):
            assert tan.cg_sstep_hotpath(s, fused=fused) == jan.cg_sstep_hotpath(s, fused=fused)


@pytest.mark.parametrize("variant", ["hs", "fcg", "pipecg", "block_hs", "sstep"])
def test_cg_models_match_reference(variant):
    from repro.roofline.hw import TPU_V5E

    chip = _tpu_cost().power.chip
    for n in (1, 1000, 4194304):
        for fused in (True, False):
            for s in (None, 1, 2, 4):
                for nrhs in (1, 3, 8):
                    kw = dict(variant=variant, fused=fused, nrhs=nrhs, s=s)
                    assert tan.cg_vector_traffic(n, **kw) == jan.cg_vector_traffic(n, **kw)
                    assert tan.cg_vector_flops(n, **kw) == jan.cg_vector_flops(n, **kw)
                assert (tan.cg_vector_sweeps(variant, fused=fused, s=s)
                        == jan.cg_vector_sweeps(variant, fused=fused, s=s))
            if variant != "block_hs" and variant != "sstep":
                for k in (7, 27):
                    kw = dict(variant=variant, fused=fused)
                    assert (tan.cg_iteration_memory_s(n, k, chip=chip, **kw)
                            == jan.cg_iteration_memory_s(n, k, chip=TPU_V5E, **kw))
        for k in (7, 27):
            for matfree in (True, False):
                for nrhs in (1, 8):
                    kw = dict(matfree=matfree, nrhs=nrhs)
                    assert tan.spmv_traffic(n, k, **kw) == jan.spmv_traffic(n, k, **kw)
    for nrhs in (1, 4):
        for s in (1, 2, 5):
            assert tan.cg_reduce_scalars(variant, nrhs, s=s) == jan.cg_reduce_scalars(
                variant, nrhs, s=s)
    for S in (1, 2, 8, 64):
        for grid in (None, (1, S), (2, max(S // 2, 1)), (8, 8)):
            for budget in (float("inf"), 0.0, 3e-6):
                for s in (2, 4):
                    kw = dict(grid=grid, hide_budget_s=budget, s=s)
                    assert (tan.cg_exposed_latency_s(variant, S, **kw)
                            == jan.cg_exposed_latency_s(variant, S, **kw))


# ---------------------------------------------------------------------------
# declared counts
# ---------------------------------------------------------------------------

COUNT_CASES = [(S, fmt, None) for S in (1, 3, 4) for fmt in ("ell", "hyb", "bcsr")] + [
    (4, fmt, (2, 2)) for fmt in ("ell", "hyb", "bcsr")]


@pytest.mark.parametrize("S,fmt,grid", COUNT_CASES)
def test_declared_counts_match_reference(S, fmt, grid):
    a = _poisson(8, "27pt" if fmt == "hyb" else "7pt")
    for depth in (1, 2):
        kw = dict(fmt=fmt, block=(2, 2), grid=grid, halo_depth=depth)
        jm = jp.partition_csr(a, S, **kw)
        tm = tp.partition_csr(a, S, **kw)
        tag = f"S={S} {fmt} grid={grid} depth={depth}"
        assert tm.halo_depth == jm.halo_depth and tm.ghost_slots == int(np.size(jm.ghost_data))
        for overlap in (True, False):
            for nrhs in (1, 4):
                _counts_close(tacc.spmv_counts(tm, overlap, nrhs),
                              jacc.spmv_counts(jm, overlap, nrhs), f"{tag} spmv")
        variants = ("sstep",) if depth > 1 else ("hs", "fcg", "sstep", "naive", "amgx")
        for v in variants:
            for s in (2, 3):
                _counts_close(tacc.cg_iteration_counts(tm, v, s=s),
                              jacc.cg_iteration_counts(jm, v, s=s), f"{tag} {v} s={s}")
        with pytest.raises(ValueError):
            tacc.cg_iteration_counts(tm, "nope")
    info = dict(level_rows=(a.shape[0], 97, 12), level_nnz=(a.nnz, 2000, 100), coarse_rows=12)
    from repro.core.amg.hierarchy import AMGInfo as JInfo
    from repro_torch.core.amg.hierarchy import AMGInfo as TInfo

    for n_smooth in (1, 4):
        _counts_close(tacc.vcycle_counts(TInfo(**info), tm, n_smooth),
                      jacc.vcycle_counts(JInfo(**info), jm, n_smooth), "vcycle")
    assert tacc.dot_counts(10, 3) == tacc.OpCounts(*dataclasses.astuple(jacc.dot_counts(10, 3)))
    assert tacc.axpy_counts(10) == tacc.OpCounts(*dataclasses.astuple(jacc.axpy_counts(10)))


# ---------------------------------------------------------------------------
# space, objective
# ---------------------------------------------------------------------------

# (shards, nrhs) -> the reference tuner's space size (autotune/__init__.py)
SPACES = {(4, 1): 108, (4, 8): 36, (8, 1): 432, (8, 8): 72}


def _space(mod, S, nrhs):
    grids, sstep = (None,), ()
    if S >= 8:
        grids = (None, jp.default_grid(S))
        sstep = mod.SSTEP_S
    if nrhs > 1:
        return mod.enumerate_space(variants=("hs",), grids=grids)
    return mod.enumerate_space(grids=grids, sstep_s=sstep)


@pytest.mark.parametrize("S,nrhs", list(SPACES))
def test_enumerate_space_matches_reference(S, nrhs):
    got, want = _space(tspace, S, nrhs), _space(jspace, S, nrhs)
    assert len(got) == len(want) == SPACES[(S, nrhs)]
    assert [c.label for c in got] == [c.label for c in want]
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want]
    assert [c.exec_key for c in got] == [c.exec_key for c in want]
    assert [tspace.sort_key(c) for c in got] == [jspace.sort_key(c) for c in want]
    assert tspace.DEFAULT in got and len(set(got)) == len(got)
    for c in got:
        assert tspace.Candidate.from_dict(json.loads(json.dumps(c.to_dict()))) == c
        d = c.to_dict()
        assert ("grid" in d) == (c.grid is not None) and ("s" in d) == (c.s != 1)
    # a shuffled space sorts back to the reference's order
    shuffled = [got[i] for i in np.random.default_rng(S * nrhs).permutation(len(got))]
    assert sorted(shuffled, key=tspace.sort_key) == got


def test_candidate_label_and_objective_scores():
    from repro.autotune.objective import score as jscore
    from repro_torch.autotune.objective import OBJECTIVES, score, total_energy_j

    c = tspace.Candidate("bcsr", "sstep", False, 8, 0.8, grid=(2, 4), s=4)
    assert c.label == jspace.Candidate("bcsr", "sstep", False, 8, 0.8, (2, 4), 4).label
    assert c.label == "bcsr8/sstep/ser/f0.8/g2x4/s4"
    assert tspace.DEFAULT.label == "ell/hs/ov/f1"
    for totals in (dict(te_gpu=3.0, te_cpu=1.0, runtime=2.0),
                   dict(te_gpu=0.125, te_cpu=7.5, runtime=1e-3)):
        for obj in OBJECTIVES:
            assert score(obj, totals) == jscore(obj, totals)
        assert total_energy_j(totals) == totals["te_gpu"] + totals["te_cpu"]
    with pytest.raises(ValueError, match="unknown objective"):
        score("joules", dict(te_gpu=1.0, te_cpu=1.0, runtime=1.0))


# ---------------------------------------------------------------------------
# prune
# ---------------------------------------------------------------------------

PRUNE_CASES = [(1, 1, "energy", 2), (4, 1, "time", 3), (4, 4, "edp", 2), (8, 1, "energy", 3),
               (8, 2, "time", 1)]


@pytest.mark.parametrize("S,nrhs,objective,keep", PRUNE_CASES)
def test_prune_matches_reference(S, nrhs, objective, keep):
    from repro.energy.accounting import CostModel as JCost

    a = _poisson(8)
    jm, tm = jp.partition_csr(a, S), tp.partition_csr(a, S)
    js, ts = jprune.interior_stats(a, jm.row_starts), tprune.interior_stats(a, tm.row_starts)
    assert ts.n_rows == js.n_rows and ts.shard_blocks == js.shard_blocks
    assert all(np.array_equal(g, r) for g, r in zip(ts.shard_row_lens, js.shard_row_lens))
    stored = tprune.format_stored_bytes(ts)
    assert stored == jprune.format_stored_bytes(js)
    for b in (2, 4, 8):
        assert tprune.resolve_auto(ts, b) == jprune.resolve_auto(js, b)
    cost, jcost = _tpu_cost(), JCost()
    assert tcache.model_hash(cost) == jcache.model_hash(jcost)
    tcands, jcands = _space(tspace, S, nrhs), _space(jspace, S, nrhs)
    for tc, jc in zip(tcands, jcands):
        if tc.fmt == "auto":  # resolved by the model stage, as prune does
            fmt, _ = tprune.resolve_auto(ts, tc.block)
            tc, jc = (dataclasses.replace(c, fmt=fmt) for c in (tc, jc))
        tp_ = tprune.predict(tm, tc, stored, cost=cost, objective=objective, nrhs=nrhs)
        jp_ = jprune.predict(jm, jc, stored, cost=jcost, objective=objective, nrhs=nrhs)
        for f in ("time_s", "energy_j", "score"):
            _close(getattr(tp_, f), getattr(jp_, f), REL, f"{tc.label} {f}")
        _counts_close(tprune.iteration_counts(tm, tc, stored, nrhs=nrhs),
                      jprune.iteration_counts(jm, jc, stored, nrhs=nrhs), tc.label)
    got, _ = tprune.prune(tcands, a, tm, cost=cost, objective=objective, keep=keep, nrhs=nrhs)
    want, _ = jprune.prune(jcands, a, jm, cost=jcost, objective=objective, keep=keep,
                           nrhs=nrhs)
    assert [p.candidate.label for p in got] == [p.candidate.label for p in want]
    for g, w in zip(got, want):
        _close(g.score, w.score, REL, g.candidate.label)
    execs = {p.candidate.exec_key for p in got}
    assert tspace.DEFAULT.exec_key in execs and len(execs) <= keep + 1
    # every kept execution carries its whole frequency column
    for e in execs:
        assert {p.candidate.freq for p in got if p.candidate.exec_key == e} == set(
            cost.power.chip.freq_points)


def test_pareto_front_strict_dominance_keeps_time_ties():
    mk = lambda f, t, e: tprune.Prediction(tspace.Candidate("ell", "hs", True, 4, f), t, e, e)
    a, b, c = mk(1.0, 1.0, 10.0), mk(0.6, 1.0, 5.0), mk(0.8, 2.0, 20.0)
    front = tprune.pareto_front([a, b, c])
    assert a in front and b in front and c not in front
    jmk = lambda f, t, e: jprune.Prediction(jspace.Candidate("ell", "hs", True, 4, f), t, e, e)
    jfront = jprune.pareto_front([jmk(1.0, 1.0, 10.0), jmk(0.6, 1.0, 5.0), jmk(0.8, 2.0, 20.0)])
    assert [p.candidate.label for p in front] == [p.candidate.label for p in jfront]


def test_extrapolate_iters_matches_reference():
    cases = [(5, 1e-12, 1e-8), (4, 1e-4, 1e-8), (8, 0.99999999999999, 1e-8), (0, 1.0, 1e-8),
             (10, 1e-4, 1e-3), (8, 0.3, 1e-8), (8, 0.9, 1e-10), (3, 2.0, 1e-8), (7, 1e-8, 1e-8),
             (1, 0.5, 1e-6), (16, 0.05, 1e-12)]
    for it, rr, tol in cases:
        for cap in (123, 100000):
            assert ttrial.extrapolate_iters(it, rr, tol, cap) == jtrial.extrapolate_iters(
                it, rr, tol, cap), (it, rr, tol, cap)
    assert ttrial.extrapolate_iters(8, 0.99999999999999, 1e-8, cap=123) == 123
    assert ttrial.extrapolate_iters(10, 1e-4, 1e-3) == 10


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def _h100_cost():
    return tacc.CostModel()


def _cache_case(case, path):
    from repro_torch.energy.model import PowerModel
    from repro_torch.roofline.hw import H100_SXM

    cache = tcache.TuneCache(path)
    a = _poisson(6)
    cost = _h100_cost()
    fp = tcache.fingerprint(a, 2, "energy")
    if case == "roundtrip":
        chosen = tspace.Candidate("hyb", "pipecg", True, 4, 0.6, grid=(2, 4), s=1)
        assert cache.get(fp, cost) is None
        cache.put(fp, cost, chosen)
        assert cache.get(fp, cost) == chosen
        assert cache.get(tcache.fingerprint(a, 4, "energy"), cost) is None
        assert cache.get(tcache.fingerprint(a, 2, "time"), cost) is None
        with open(path) as f:
            d = json.load(f)
        assert d["schema"] == tcache.SCHEMA == jcache.SCHEMA
        assert not os.path.exists(path + ".tmp")  # written through a renamed temporary
    elif case == "freq_grid":
        other = tacc.CostModel(power=PowerModel(
            chip=dataclasses.replace(H100_SXM, freq_points=(0.5, 1.0))))
        assert tcache.model_hash(cost) != tcache.model_hash(other)
        cache.put(fp, cost, tspace.Candidate("ell", "hs", True, 4, 0.6))
        assert cache.get(fp, other) is None and cache.get(fp, cost) is not None
        assert cache.get(fp, tacc.CostModel(power=PowerModel(hbm_fraction=0.7))) is None
    elif case == "schema":
        key = cache.put(fp, cost, tspace.DEFAULT)
        with open(path) as f:
            d = json.load(f)
        d["entries"][key]["schema"] = tcache.SCHEMA - 1
        with open(path, "w") as f:
            json.dump(d, f)
        assert cache.get(fp, cost) is None
    elif case.startswith("corrupt"):
        with open(path, "w") as f:
            f.write({"corrupt-text": "{not json", "corrupt-list": '{"entries": []}',
                     "corrupt-array": "[1]"}[case])
        assert cache.get(fp, cost) is None
        cache.put(fp, cost, tspace.DEFAULT)  # overwrites the corrupt file
        assert cache.get(fp, cost) == tspace.DEFAULT
    elif case == "nrhs":
        fp32 = tcache.fingerprint(a, 2, "energy", nrhs=32)
        assert fp["nrhs"] == 1 and fp32["nrhs"] == 32
        assert cache.key(fp, cost) != cache.key(fp32, cost)
        cache.put(fp, cost, tspace.Candidate("ell", "hs", True, 4, 1.0))
        assert cache.get(fp32, cost) is None
        cache.put(fp32, cost, tspace.Candidate("hyb", "hs", True, 4, 0.6))
        assert cache.get(fp, cost) == tspace.Candidate("ell", "hs", True, 4, 1.0)
        assert cache.get(fp32, cost) == tspace.Candidate("hyb", "hs", True, 4, 0.6)
    elif case == "chip":
        # the chip is in the key through the model hash: H100 and TPU entries
        # of one problem live side by side in one file
        tpu = _tpu_cost()
        assert tcache.model_hash(tpu) == jcache.model_hash(jacc.CostModel())
        assert tcache.model_hash(cost) != tcache.model_hash(tpu)
        assert cache.key(fp, cost) != cache.key(fp, tpu)
        cache.put(fp, cost, tspace.Candidate("bcsr", "fcg", False, 2, 0.8))
        assert cache.get(fp, tpu) is None
        cache.put(fp, tpu, tspace.DEFAULT)
        assert cache.get(fp, cost) == tspace.Candidate("bcsr", "fcg", False, 2, 0.8)
        assert cache.get(fp, tpu) == tspace.DEFAULT
        # the reference's cache reads the entry the port wrote with its chip
        assert jcache.TuneCache(path).get(jcache.fingerprint(a, 2, "energy"),
                                          jacc.CostModel()) == jspace.DEFAULT


@pytest.mark.parametrize("case", ["roundtrip", "freq_grid", "schema", "corrupt-text",
                                  "corrupt-list", "corrupt-array", "nrhs", "chip"])
def test_cache(tmp_path, case):
    _cache_case(case, os.path.join(tmp_path, "cache.json"))


def test_fingerprint_matches_reference():
    for a in (_poisson(6), _poisson(5, "27pt")):
        for S, obj, nrhs in ((1, "energy", 1), (2, "edp", 1), (8, "time", 32)):
            fp = tcache.fingerprint(a, S, obj, nrhs=nrhs)
            assert fp == jcache.fingerprint(a, S, obj, nrhs=nrhs)
            assert len(fp["row_nnz_q"]) == 5 and fp["bandwidth"] > 0


# ---------------------------------------------------------------------------
# autotune end to end, in process (1 shard)
# ---------------------------------------------------------------------------


def _ref_autotune(a, mesh, S, path, **kw):
    import jax

    from repro.autotune import autotune as jtune

    with jax.enable_x64(True):
        return jtune(a, mesh, S, cache_path=path, **kw)


def test_autotune_matches_reference(tmp_path, single_mesh):
    from repro_torch.autotune import autotune

    a = _poisson(6)
    kw = dict(objective="energy", budget=2, trial_iters=4)
    want = _ref_autotune(a, single_mesh, 1, os.path.join(tmp_path, "ref.json"), **kw)
    mats = {}
    got = autotune(a, 1, device="cpu", cost=_tpu_cost(),
                   cache_path=os.path.join(tmp_path, "port.json"), mats=mats, **kw)
    assert got.chosen.label == want.chosen.label
    assert (got.candidates_total, got.candidates_pruned, got.candidates_trialed) == (
        want.candidates_total, want.candidates_pruned, want.candidates_trialed)
    assert [(t.candidate.label, t.executed, t.iters_trial, t.iters_est) for t in got.trials] == [
        (t.candidate.label, t.executed, t.iters_trial, t.iters_est) for t in want.trials]
    _close_tree(got.ledger_section(), want.ledger_section(), rel=1e-9)
    assert got.prune_s > 0 and got.trial_s > 0
    # every partition the trials ran on is in mats, on the tuning device
    assert ("ell", 4) in mats and all(m.device.type == "cpu" for m in mats.values())


def test_autotune_h100_invariants_and_cache(tmp_path):
    from repro_torch.autotune import DEFAULT, autotune

    a = _poisson(6)
    path = os.path.join(tmp_path, "cache.json")
    res = autotune(a, 1, device="cpu", objective="energy", budget=2, cache_path=path,
                   trial_iters=4)
    assert not res.cached and res.candidates_total == 108
    assert res.candidates_trialed >= 1
    assert res.candidates_pruned + len(res.trials) == res.candidates_total
    # the energy objective downclocks a memory-bound solve ...
    assert res.chosen != DEFAULT and res.chosen.freq < 1.0
    by_cand = {t.candidate: t for t in res.trials}
    # ... and never scores worse than the default, which always trials along
    assert DEFAULT in by_cand
    assert by_cand[res.chosen].score <= by_cand[DEFAULT].score
    assert by_cand[res.chosen].measured_energy_j <= by_cand[DEFAULT].measured_energy_j
    assert res.trials[0].candidate == res.chosen
    for t in res.trials:
        assert t.predicted_energy_j > 0 and t.measured_energy_j > 0
        assert t.iters_est >= t.iters_trial
    res2 = autotune(a, 1, device="cpu", objective="energy", budget=2, cache_path=path)
    assert res2.cached and res2.candidates_trialed == 0 and res2.chosen == res.chosen
    assert res2.ledger_section()["trials"] == []
    res3 = autotune(a, 1, device="cpu", objective="energy", budget=2, cache_path=path,
                    trial_iters=4, force=True)
    assert not res3.cached and res3.chosen == res.chosen
    with pytest.raises(ValueError, match="objective must be one of"):
        autotune(a, 1, device="cpu", objective="watts", cache_path=path)


# ---------------------------------------------------------------------------
# api.solve and the CLI
# ---------------------------------------------------------------------------


def _regions(ledger_entry):
    return {r: {c: v[c] for c in ("flops", "hbm_bytes", "ici_bytes")}
            for r, v in ledger_entry["regions"].items()}


def test_api_solve_autotune_matches_reference(tmp_path, monkeypatch, single_mesh):
    import jax

    from repro import api as japi
    from repro_torch import api
    from repro_torch.energy import accounting

    spec_kw = dict(side=6, shards=1)
    cfg_kw = dict(autotune=True, tune_budget=2, objective="edp")
    with jax.enable_x64(True):
        want = japi.solve(japi.ProblemSpec(**spec_kw),
                          japi.SolverConfig(tune_cache=str(tmp_path / "ref.json"), **cfg_kw),
                          x64=False, verbose=False)
    # price the port's solve with the reference's chip: the same decision
    tpu = _tpu_cost()
    monkeypatch.setattr(accounting, "CostModel", lambda: tpu)
    sess = api.SolverSession(api.ProblemSpec(**spec_kw).load()[0], 1, device="cpu")
    cfg = api.SolverConfig(tune_cache=str(tmp_path / "port.json"), **cfg_kw)
    got = api.solve(api.ProblemSpec(**spec_kw), cfg, session=sess, verbose=False)
    assert set(got.summary) == set(want.summary) == {"BCMGX-analog"}  # no Ginkgo leg
    ga, wa = got.ledger["autotune"], want.ledger["autotune"]
    assert ga["chosen_label"] == wa["chosen_label"] and not ga["cached"]
    _close_tree(ga, wa, rel=1e-9)
    for k in ("format", "overlap", "resolved_format", "stored_bytes"):
        assert got.ledger[k] == want.ledger[k], k
    g, w = got.solvers["BCMGX-analog"], want.solvers["BCMGX-analog"]
    assert g["variant"] == w["variant"] and g["relres"] <= 1e-8
    assert got.summary["BCMGX-analog"]["iters"] == want.summary["BCMGX-analog"]["iters"]
    _close_tree(_regions(g), _regions(w))
    _close_tree(g["totals"]["runtime"], w["totals"]["runtime"], rel=1e-9)
    assert sess.tune is not None and sess.stats()["tune_trials"] == ga["candidates_trialed"]
    parts = sess.partitions
    again = api.solve(api.ProblemSpec(**spec_kw), cfg, session=sess, verbose=False)
    assert again.ledger["autotune"]["cached"] and again.ledger["autotune"]["trials"] == []
    assert again.ledger["autotune"]["chosen"] == ga["chosen"] and sess.partitions == parts
    sess.close()
    assert sess.tune is None and sess.stats()["mats"] == 0


def test_cli_autotune_runs_on_cpu(tmp_path):
    cache = str(tmp_path / "cache.json")
    argv = [sys.executable, "-m", "repro_torch.launch.solve", "--device", "cpu",
            "--autotune", "--tune-budget", "2", "--side", "6", "--shards", "2",
            "--tune-cache", cache, "--ledger", str(tmp_path / "ledger.json")]
    r = subprocess.run(argv, capture_output=True, text=True, env=_env(), timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout + r.stderr
    assert "autotune: objective=energy chosen=" in out and "cached=False" in out
    assert "Ginkgo-analog" not in out and "relres=" in out
    with open(tmp_path / "ledger.json") as f:
        led = json.load(f)
    assert led["autotune"]["candidates_total"] == 108 and "BCMGX-analog" in led["solvers"]
    with open(cache) as f:
        assert len(json.load(f)["entries"]) == 1
    r = subprocess.run(argv, capture_output=True, text=True, env=_env(), timeout=300, cwd=REPO)
    assert r.returncode == 0 and "cached=True trialed=0" in r.stdout + r.stderr


# ---------------------------------------------------------------------------
# 8 shards: the grid and s-step axes, against an 8-device reference
# ---------------------------------------------------------------------------

WIDE_SIDE = 8
WIDE_S = 8
OBJECTIVES = ("time", "energy")
# cached winners whose api.solve both packages run: a grid and an s-step one
CACHED = {"grid": dict(fmt="ell", variant="hs", overlap=True, block=4, freq=0.8, grid=[2, 4]),
          "sstep": dict(fmt="hyb", variant="sstep", overlap=False, block=4, freq=1.0, s=2)}

REF_SNIPPET = r"""
import json
import numpy as np
from repro import api as japi
from repro.autotune import Candidate, TuneCache, autotune, fingerprint
from repro.energy.accounting import CostModel
from repro.launch.mesh import make_solver_mesh
from repro.matrices.poisson import cube, poisson_scipy

out = "OUT"
meta = {}
a = poisson_scipy(cube(%(side)d, "7pt"))
mesh = make_solver_mesh(%(S)d)
mats = {}
for obj in %(objectives)r:
    res = autotune(a, mesh, %(S)d, objective=obj, budget=2, trial_iters=4,
                   cache_path=out + f"_{obj}.json", mats=mats)
    meta[obj] = res.ledger_section()
for name, d in %(cached)r.items():
    path = out + f"_{name}.json"
    TuneCache(path).put(fingerprint(a, %(S)d, "edp"), CostModel(), Candidate.from_dict(d))
    rep = japi.solve(japi.ProblemSpec(side=%(side)d, shards=%(S)d),
                     japi.SolverConfig(autotune=True, objective="edp", tune_cache=path),
                     verbose=False)
    e = rep.solvers["BCMGX-analog"]
    meta[name] = dict(
        autotune=rep.ledger["autotune"], legs=sorted(rep.solvers),
        ledger={k: rep.ledger.get(k) for k in ("grid", "halo_bytes_rows", "halo_bytes_cols",
                                               "resolved_format", "halo_depth", "s",
                                               "format", "overlap")},
        iters=rep.summary["BCMGX-analog"]["iters"], variant=e["variant"],
        regions={r: {c: v[c] for c in ("flops", "hbm_bytes", "ici_bytes", "time_s")}
                 for r, v in e["regions"].items()},
        totals={k: e["totals"][k] for k in ("runtime", "te_gpu", "te_cpu")})
with open(out + ".json", "w") as f:
    json.dump(meta, f)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def wide_reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_autotune_ref") / "ref")
    code = REF_SNIPPET % {"side": WIDE_SIDE, "S": WIDE_S, "objectives": OBJECTIVES,
                          "cached": CACHED}
    code = code.replace('out = "OUT"', f"out = {out!r}")
    assert "REF_OK" in run_multidevice(code, n_devices=WIDE_S, x64=True)
    with open(out + ".json") as f:
        return out, json.load(f)


@pytest.fixture(scope="module")
def wide_mats():
    return {}  # the port's partitions, shared across objectives as the reference shares


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_autotune_8_shards_matches_reference(wide_reference, wide_mats, tmp_path, objective):
    from repro_torch.autotune import autotune

    _, meta = wide_reference
    a = _poisson(WIDE_SIDE)
    got = autotune(a, WIDE_S, device="cpu", objective=objective, budget=2, trial_iters=4,
                   cost=_tpu_cost(), cache_path=str(tmp_path / "c.json"), mats=wide_mats)
    want = meta[objective]
    assert got.candidates_total == want["candidates_total"] == SPACES[(WIDE_S, 1)]
    sec = got.ledger_section()
    assert [t["label"] for t in sec["trials"]] == [t["label"] for t in want["trials"]]
    _close_tree(sec, want, rel=1e-9)
    # the grid and s-step axes were priced: the model stage saw both
    labels = {c.label for c in _space(tspace, WIDE_S, 1)}
    assert any("/g2x4" in lb for lb in labels) and any("/s6" in lb for lb in labels)


@pytest.mark.parametrize("name", list(CACHED))
def test_api_solve_cached_winner_matches_reference(wide_reference, monkeypatch, name):
    from repro_torch import api
    from repro_torch.autotune import Candidate, TuneCache, fingerprint
    from repro_torch.energy import accounting

    out, meta = wide_reference
    want = meta[name]
    a = _poisson(WIDE_SIDE)
    path = out + f"_{name}.json"  # the reference's cache file: the same key
    assert TuneCache(path).get(fingerprint(a, WIDE_S, "edp"), _tpu_cost()) == (
        Candidate.from_dict(CACHED[name]))
    tpu = _tpu_cost()
    monkeypatch.setattr(accounting, "CostModel", lambda: tpu)
    sess = api.SolverSession(a, WIDE_S, device="cpu")
    rep = api.solve(api.ProblemSpec(side=WIDE_SIDE, shards=WIDE_S),
                    api.SolverConfig(autotune=True, objective="edp", tune_cache=path),
                    session=sess, verbose=False)
    assert sorted(rep.solvers) == want["legs"] == ["BCMGX-analog"]
    _close_tree(rep.ledger["autotune"], want["autotune"], rel=1e-9)
    assert rep.ledger["autotune"]["cached"]
    led = {k: rep.ledger.get(k) for k in want["ledger"]}
    _close_tree(led, want["ledger"])
    s = rep.summary["BCMGX-analog"]
    assert s["iters"] == want["iters"] and s["relres"] <= 1e-8
    e = rep.solvers["BCMGX-analog"]
    assert e["variant"] == want["variant"]
    # per-region counts, and times: the staged tree depth of the grid
    # (coll_hops) and the chosen modeled frequency price both alike
    _close_tree({r: {c: v[c] for c in ("flops", "hbm_bytes", "ici_bytes", "time_s")}
                 for r, v in e["regions"].items()}, want["regions"], rel=1e-9)
    _close_tree({k: e["totals"][k] for k in ("runtime", "te_gpu", "te_cpu")}, want["totals"],
                rel=1e-9)
    # the session's own matrix, in its given order: x solves A x = 1
    x = rep.outputs["BCMGX-analog"]
    assert np.linalg.norm(np.ones(a.shape[0]) - a @ x) <= 1e-7 * np.sqrt(a.shape[0])
    if name == "grid":
        mat = sess.mats[("ell", 4, (2, 4))]
        assert mat.plan.mode == "grid" and sess.pencil is None
        assert (led["halo_bytes_rows"], led["halo_bytes_cols"]) == tuple(
            float(v) for v in mat.plan.dim_bytes_per_shard(8))
