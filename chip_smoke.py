"""Smoke run of the PyTorch/CUDA port on one GPU: kernels, main path, SpMV.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (any
CUDA card with sm_90a). It

1. prints the card (``nvidia-smi`` name and power limit), its idle power
   draw, the torch and CUDA versions, and builds every CUDA kernel of the
   port from the sources in the checkout (one ``nvcc`` per source, all
   started together), printing the build time;
2. holds each kernel against its plain PyTorch version on the card, in
   float64 and float32: the vector kernels at the main path's shape and at
   a ragged one, the block kernels at the block path's (r = 8) and at
   ragged ones (R - 3 with r = 3 and r = 17);
3. times each kernel (median of CUDA-event timings), its plain version and,
   where one PyTorch call computes the same function, that call; the bound
   is the larger of the bytes the function must move over the card's
   memory rate and its flops over the card's peak rate (NVIDIA's data
   sheet), the least time the card could take;
4. drives the main path — ``repro_torch.api.solve`` on poisson7 at side 256
   (16.8 M unknowns) over 4 stacked shards in float64, both legs — checks
   the relative residual, an independent scipy residual of the returned
   solution, and that every kernel was launched (1 + repeats) x iterations
   times by the hs leg;
5. runs the ``op="spmv"`` path at the same size against scipy's ``A @ x``
   (``api.solve``'s ones vector and a seeded random one);
6. drives the later slices' paths on the same session — ``variant="fcg"``
   and ``variant="pipecg"`` (both legs) and block-HS with ``nrhs=8`` —
   with the same checks per column, each kernel's launch count against
   the count its iterations imply (the formula is printed), and the block
   path's ``per_solve_wall_s`` beside hs's wall;
7. profiles 20 iterations of hs, fcg, pipecg and block-HS with
   ``torch.profiler``: device time per kernel and the device's busy share
   of the wall time;
8. prints one JSON line describing every kernel (``launches`` summed over
   the solve paths), then, last, ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line. It needs the repository (``src/repro_torch``) next to it and a GPU:
it refuses to run on the CPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SIDE = 256
SHARDS = 4
NRHS = 8  # the block path's right-hand sides (benchmarks/multirhs_scaling.py)
MAXITER = 1000
R_MAIN = SIDE ** 3 // SHARDS  # per-shard length on the main path
R_RAGGED = R_MAIN - 3
# NVIDIA H100 SXM data sheet (dense, no sparsity).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}  # outside the tensor cores
DOT_TOL = {"float64": 1e-13, "float32": 1e-5}


def smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, rounds: int = 7, calls: int = 20) -> float:
    """Device time of one call: CUDA events around ``calls`` back-to-back
    calls (the card stays busy, so host launch overhead hides behind the
    work), divided by ``calls``; the median over ``rounds``."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def axpy_ok(k, p, a, x, y, eps) -> float:
    """Largest |k - p| / (2 eps (|a x| + |y|)); must stay <= 1."""
    import torch

    scale = 2 * eps * ((a * x).abs() + y.abs())
    return float(((k - p).abs() / torch.clamp(scale, min=1e-300)).max())


def kernel_phase(dev):
    """Parity at the main-path and a ragged shape; timings at the main one."""
    import torch

    from repro_torch.kernels import fused_reductions as fr
    from repro_torch.kernels import ref

    rows = {}
    g = torch.Generator(device=dev).manual_seed(0)
    for dt in (torch.float64, torch.float32):
        tname = str(dt).split(".")[1]
        eps = torch.finfo(dt).eps
        for R in (R_MAIN, R_RAGGED):
            p, w, x, r = (torch.randn(SHARDS, R, dtype=dt, device=dev, generator=g)
                          for _ in range(4))
            alpha = torch.rand((), dtype=dt, device=dev, generator=g) + 0.5
            beta = torch.rand((), dtype=dt, device=dev, generator=g)

            d_k = fr.fused_dots_n([(p, w), (r, r), (p, r)])
            d_p = ref.fused_dots_n_ref([(p, w), (r, r), (p, r)])
            a_k = fr.fused_axpy(beta, p, r)
            a_p = ref.fused_axpy_ref(beta, p, r)
            o1k, o2k, nk = fr.fused_axpy2_dots(alpha, p, x, -alpha, w, r)
            o1p, o2p, np_ = ref.fused_axpy2_dots_ref(alpha, p, x, -alpha, w, r)
            q1k, q2k = fr.fused_axpy2(beta, p, r, -alpha, w, x)
            q1p, q2p = ref.fused_axpy2_ref(beta, p, r, -alpha, w, x)
            torch.cuda.synchronize()
            scale = torch.stack([(p * w).abs().sum(-1), (r * r).sum(-1),
                                 (p * r).abs().sum(-1)], dim=-1)
            # axpy outputs: |k - p| <= 2 eps (|a x| + |y|), i.e. ratio <= 1
            # (FMA vs separate multiply and add); dots: relative to sum |x_i y_i|
            checks = [
                ("fused_dots_n", "dots",
                 float(((d_k - d_p).abs() / scale).max()), DOT_TOL[tname]),
                ("fused_axpy", "a*x+y", axpy_ok(a_k, a_p, beta, p, r, eps), 1.0),
                ("fused_axpy2_dots", "o1", axpy_ok(o1k, o1p, alpha, p, x, eps), 1.0),
                ("fused_axpy2_dots", "o2", axpy_ok(o2k, o2p, -alpha, w, r, eps), 1.0),
                ("fused_axpy2_dots", "o2.o2",
                 float(((nk - np_).abs() / (o2p * o2p).sum(-1, keepdim=True)).max()),
                 DOT_TOL[tname]),
                ("fused_axpy2", "o1", axpy_ok(q1k, q1p, beta, p, r, eps), 1.0),
                ("fused_axpy2", "o2", axpy_ok(q2k, q2p, -alpha, w, x, eps), 1.0),
            ]
            for name, what, e, limit in checks:
                print(f"parity {name:16s} {what:6s} {tname} S={SHARDS} R={R}: "
                      f"{e:.3e} (limit {limit:g})", flush=True)
                check(e <= limit, f"{name} ({what}) disagrees with its plain version")
            if R != R_MAIN or dt != torch.float64:
                continue
            abs_err = {
                "fused_dots_n": float((d_k - d_p).abs().max()),
                "fused_axpy": float((a_k - a_p).abs().max()),
                "fused_axpy2_dots": max(float((o1k - o1p).abs().max()),
                                        float((o2k - o2p).abs().max()),
                                        float((nk - np_).abs().max())),
                "fused_axpy2": max(float((q1k - q1p).abs().max()),
                                   float((q2k - q2p).abs().max())),
            }
            b = p.element_size()
            N = SHARDS * R
            # bytes: each input read once, each output written once
            work = {
                "fused_dots_n": ((2 * N + SHARDS) * b, 2 * N),
                "fused_axpy": ((3 * N + 1) * b, 2 * N),
                "fused_axpy2_dots": ((6 * N + 2 + SHARDS) * b, 6 * N),
                "fused_axpy2": ((6 * N + 2) * b, 4 * N),
            }
            calls = {
                "fused_dots_n": (lambda: fr.fused_dots_n([(p, w)]),
                                 lambda: ref.fused_dots_n_ref([(p, w)]),
                                 lambda: torch.linalg.vecdot(p, w)),
                "fused_axpy": (lambda: fr.fused_axpy(beta, p, r),
                               lambda: ref.fused_axpy_ref(beta, p, r),
                               lambda: torch.addcmul(r, beta, p)),
                "fused_axpy2_dots": (
                    lambda: fr.fused_axpy2_dots(alpha, p, x, -alpha, w, r),
                    lambda: ref.fused_axpy2_dots_ref(alpha, p, x, -alpha, w, r),
                    None),
                # no single PyTorch call writes both outputs
                "fused_axpy2": (
                    lambda: fr.fused_axpy2(beta, p, r, -alpha, w, x),
                    lambda: ref.fused_axpy2_ref(beta, p, r, -alpha, w, x),
                    None),
            }
            for name, (kern, plain, lib) in calls.items():
                rows[name] = time_row(name, work[name], kern, plain, lib, abs_err[name],
                                      tname)
            del p, w, x, r
    return rows


def time_row(name, work, kern, plain, lib, abs_err, tname):
    """Time a kernel, its plain version and the library call; the bound is
    the larger of its bytes over the memory rate and its flops over the
    peak rate."""
    from repro_torch.kernels import fused_reductions as fr

    nbytes, flops = work
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tname]) * 1e3
    row = dict(
        name=name, route="cuda", source=fr.KERNELS[name]["source"],
        replaces=fr.KERNELS[name]["replaces"], max_abs_err=abs_err,
        ms=time_ms(kern), plain_ms=time_ms(plain),
        bound_ms=bound, bound_by=fr.KERNELS[name]["bound_by"],
        library_ms=time_ms(lib) if lib is not None else None,
    )
    print(f"time {name:16s} kernel {row['ms']:.4f} ms  bound {bound:.4f} ms "
          f"({100 * bound / row['ms']:.0f}%)  plain {row['plain_ms']:.4f} ms  "
          f"library {row['library_ms']}", flush=True)
    return row


def block_kernel_phase(dev):
    """The block-HS kernels: parity at the block path's shape (r = 8) and at
    ragged ones (R - 3 with r = 3 and r = 17), in float64 and float32;
    timings at the main shape in float64."""
    import torch

    from repro_torch.kernels import fused_reductions as fr
    from repro_torch.kernels import ref

    rows = {}
    g = torch.Generator(device=dev).manual_seed(1)
    for dt in (torch.float64, torch.float32):
        tname = str(dt).split(".")[1]
        for R, r in ((R_MAIN, NRHS), (R_RAGGED, 3), (R_RAGGED, 17)):
            P, W, X, Rs = (torch.randn(SHARDS, R, r, dtype=dt, device=dev, generator=g)
                           for _ in range(4))
            A = torch.randn(r, r, dtype=dt, device=dev, generator=g)
            mask = (torch.arange(r, device=dev) % 3 != 1).to(dt)  # a deflated column
            gk = fr.block_gram([(P, W), (Rs, Rs), (W, P)])
            gp = ref.block_gram_ref([(P, W), (Rs, Rs), (W, P)])
            uk = fr.block_update(A, P, Rs, mask=mask)
            up = ref.block_update_ref(A, P, Rs, mask=mask)
            u0k = fr.block_update(A, P, Rs)
            u0p = ref.block_update_ref(A, P, Rs)
            v1k, v2k = fr.block_update2(A, P, X, -A, W, Rs)
            v1p, v2p = ref.block_update2_ref(A, P, X, -A, W, Rs)
            torch.cuda.synchronize()
            absA = A.abs()
            # |k - p| relative to the sum of the magnitudes each entry adds up
            checks = [
                ("block_gram", "PtW", gk[0], gp[0], P.abs().mT @ W.abs()),
                ("block_gram", "RtR", gk[1], gp[1], Rs.abs().mT @ Rs.abs()),
                ("block_gram", "WtP", gk[2], gp[2], W.abs().mT @ P.abs()),
                ("block_update", "masked", uk, up, Rs.abs() * mask + P.abs() @ absA),
                ("block_update", "plain", u0k, u0p, Rs.abs() + P.abs() @ absA),
                ("block_update2", "o1", v1k, v1p, X.abs() + P.abs() @ absA),
                ("block_update2", "o2", v2k, v2p, Rs.abs() + W.abs() @ absA),
            ]
            errs = {}
            for name, what, k, p, scale in checks:
                e = float(((k - p).abs() / scale.clamp(min=1e-300)).max())
                print(f"parity {name:16s} {what:6s} {tname} S={SHARDS} R={R} r={r}: "
                      f"{e:.3e} (limit {DOT_TOL[tname]:g})", flush=True)
                check(e <= DOT_TOL[tname], f"{name} ({what}) disagrees with its plain version")
                errs[name] = max(errs.get(name, 0.0), float((k - p).abs().max()))
            del gk, gp, uk, up, u0k, u0p, v1k, v1p, v2k, v2p, checks
            if R == R_MAIN and dt == torch.float64:
                b = P.element_size()
                N = SHARDS * R * r  # elements of one (S, R, r) block
                Am = A.expand(SHARDS, r, r)
                work = {
                    "block_gram": ((2 * N + SHARDS * r * r) * b, 2 * N * r),
                    "block_update": ((3 * N + r * r + r) * b, 2 * N * r + N),
                    "block_update2": ((6 * N + 2 * r * r) * b, 4 * N * r + 2 * N),
                }
                calls = {
                    "block_gram": (lambda: fr.block_gram([(P, W)]),
                                   lambda: ref.block_gram_ref([(P, W)]),
                                   lambda: torch.bmm(P.mT, W)),
                    # the masked update has no single-call counterpart: the
                    # library time is that of the unmasked y + x @ m
                    "block_update": (lambda: fr.block_update(A, P, Rs, mask=mask),
                                     lambda: ref.block_update_ref(A, P, Rs, mask=mask),
                                     lambda: torch.baddbmm(Rs, P, Am)),
                    # no single PyTorch call writes both outputs
                    "block_update2": (lambda: fr.block_update2(A, P, X, -A, W, Rs),
                                      lambda: ref.block_update2_ref(A, P, X, -A, W, Rs),
                                      None),
                }
                for name, (kern, plain, lib) in calls.items():
                    rows[name] = time_row(name, work[name], kern, plain, lib, errs[name],
                                          tname)
            del P, W, X, Rs
            torch.cuda.empty_cache()
    return rows


def later_paths(api):
    """``(tag, config, expected launches)`` of the paths after hs. fcg and
    pipecg run their loop iters - 1 times (the pre-loop step is iteration
    1); block-HS launches 1 setup Gram plus 2 Grams, 1 update2 and 1 update
    per iteration. Each solve runs 1 + repeats times."""
    def loop(per_iter):
        return lambda it, rep: {
            name: (f"(1 + {rep}) x {k} x ({it} - 1)", (1 + rep) * k * (it - 1))
            for name, k in per_iter.items()}

    return [
        ("fcg", api.SolverConfig(variant="fcg", maxiter=MAXITER),
         loop({"fused_dots_n": 1, "fused_axpy2": 2})),
        ("pipecg", api.SolverConfig(variant="pipecg", maxiter=MAXITER),
         loop({"fused_dots_n": 1, "fused_axpy2": 3})),
        ("block", api.SolverConfig(nrhs=NRHS, maxiter=MAXITER), lambda it, rep: {
            "block_gram": (f"(1 + {rep}) x (1 + 2 x {it})", (1 + rep) * (1 + 2 * it)),
            "block_update2": (f"(1 + {rep}) x {it}", (1 + rep) * it),
            "block_update": (f"(1 + {rep}) x {it}", (1 + rep) * it)}),
    ]


def solve_path(tag, api, spec, config, sess, launches, expected):
    """Drive ``api.solve`` once with every launch count set to 0 just before
    and read just after; check every leg's solution (relres and an
    independent scipy residual per column) and that each kernel launched
    exactly ``expected(iters, repeats)[name]`` times (0 if not listed).
    Adds the counts to ``launches`` and returns the report."""
    import numpy as np

    from repro_torch.kernels import fused_reductions as fr

    fr.reset_launches()
    rep = api.solve(spec, config, session=sess)
    got = fr.launches()
    a = sess.a
    for label, s in rep.summary.items():
        entry = rep.solvers[label]
        x = rep.outputs[label]
        if config.nrhs > 1:
            from repro_torch.core.cg import default_rhs_block

            b = default_rhs_block(sess.n, config.nrhs)
            check(x.shape == b.shape, f"{tag} {label}: solution shape {x.shape}")
        else:
            b = np.ones(sess.n)
            check(x.shape == (sess.n,), f"{tag} {label}: solution shape {x.shape}")
        check(bool(np.isfinite(x).all()), f"{tag} {label}: non-finite solution")
        res = np.linalg.norm(b - a @ x, axis=0) / np.linalg.norm(b, axis=0)
        res_max = float(np.max(res))
        cols = f" iters_cols={entry['iters_cols']}" if "iters_cols" in entry else ""
        print(f"{tag} {label}: variant={entry['variant']} nrhs={entry['nrhs']} "
              f"iters={s['iters']}{cols} relres={s['relres']:.3e} "
              f"scipy_relres={res_max:.3e} wall={s['wall_s']:.4f} s "
              f"per_solve_wall={entry['per_solve_wall_s']:.4f} s "
              f"per_iter={1e3 * s['wall_s'] / max(s['iters'], 1):.3f} ms "
              f"partition={entry['partition_s']:.3f} s "
              f"peak_mem={entry['peak_mem_bytes'] / 2**30:.3f} GiB", flush=True)
        check(s["relres"] <= 1e-8, f"{tag} {label}: relres {s['relres']} > 1e-8")
        check(res_max <= 1e-7, f"{tag} {label}: scipy residual {res_max} > 1e-7")
    want = expected(rep.summary["BCMGX-analog"]["iters"], config.repeats)
    for name, n in got.items():
        formula, value = want.get(name, ("0", 0))
        print(f"launches {tag} {name:16s} {n} = {formula} -> {value}", flush=True)
        check(n == value, f"{tag}: {name} launched {n} times, expected {value}")
        launches[name] += n
    return rep


def profile_phase(sess, dev, variant: str = "hs", nrhs: int = 1, iters: int = 20):
    """Where an iteration's time goes: ``iters`` iterations of a path's
    solver under ``torch.profiler``; prints device time per kernel name
    (per iteration) and the device's busy share of the wall time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cg import default_rhs_block, make_block_solver, make_solver
    from repro_torch.core.partition import pad_block, pad_vector

    mat = sess.matrix()
    # a tolerance far below reach: exactly `iters` iterations run
    if nrhs > 1:
        solve = make_block_solver(mat, tol=1e-200, maxiter=iters, device=dev)
        b = torch.from_numpy(pad_block(default_rhs_block(sess.n, nrhs), mat)).to(dev)
    else:
        solve = make_solver(mat, variant=variant, tol=1e-200, maxiter=iters, device=dev)
        b = torch.from_numpy(pad_vector(np.ones(sess.n), mat)).to(dev)
    x0 = torch.zeros_like(b)
    solve(b, x0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve(b, x0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(res.iters == iters, "profile run stopped early")
    # fcg and pipecg count their pre-loop step as iteration 1
    iters -= variant in ("fcg", "pipecg")
    # device-side events only (kernels, memcpy/memset): the CPU ops that
    # launched them carry the same device time again
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in rows)
    label = f"{variant} r={nrhs}" if nrhs > 1 else variant
    print(f"profile: {iters} {label} loop iterations, wall {wall * 1e3 / iters:.3f} ms/iter, "
          f"device busy {busy_us / 1e3 / iters:.3f} ms/iter "
          f"({100 * busy_us / 1e6 / wall:.1f}% of wall)", flush=True)
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {t / 1e3 / iters:8.4f} ms/iter  {count / iters:5.1f} calls/iter  "
              f"{key[:90]}", flush=True)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    dev = torch.device("cuda")
    idle_w = smi("power.draw")
    print(smi("name,power.limit"), flush=True)
    print(f"idle power.draw: {idle_w}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_reductions as fr

    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(built) or 'cached'})", flush=True)
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "Used" in line:
                print(f"  {name}: {line.strip()}")

    rows = kernel_phase(dev)
    torch.cuda.empty_cache()
    rows.update(block_kernel_phase(dev))
    torch.cuda.empty_cache()

    # --- the main path: hs CG + the Ginkgo-analog leg, float64 ------------
    spec = api.ProblemSpec("poisson7", side=SIDE, shards=SHARDS)
    config = api.SolverConfig(maxiter=MAXITER)
    t0 = time.perf_counter()
    sess = api.session_for(spec, dev)
    print(f"matrix build: {time.perf_counter() - t0:.2f} s "
          f"(n={sess.n} nnz={sess.a.nnz})", flush=True)
    launches = dict.fromkeys(fr.KERNELS, 0)  # summed over the solve paths
    rep = solve_path("main", api, spec, config, sess, launches, lambda it, rep: {
        k: (f"(1 + {rep}) x {it}", (1 + rep) * it)
        for k in ("fused_dots_n", "fused_axpy2_dots", "fused_axpy")})
    hs_wall = rep.summary["BCMGX-analog"]["wall_s"]
    a = sess.a
    b = np.ones(sess.n)
    # --- the SpMV path -----------------------------------------------------
    rep_s = api.solve(spec, api.SolverConfig(op="spmv"), session=sess)
    # api.solve multiplies the ones vector; check a seeded random vector
    # too, through the same session handles
    from repro_torch.core.partition import pad_vector, unpad_vector

    xr = np.random.default_rng(0).standard_normal(sess.n)
    scale_r = np.abs(a) @ np.abs(xr)
    y_r = a @ xr
    mats = {"BCMGX-analog": sess.matrix(), "Ginkgo-analog": sess.naive_matrix()}
    for label, y in rep_s.outputs.items():
        err = float(np.abs(y - a @ b).max() / (np.abs(a) @ b).max())
        m = mats[label]
        h = sess.solver(m, op="spmv", variant="naive" if label == "Ginkgo-analog" else "hs")
        yr = unpad_vector(h.fn(torch.from_numpy(pad_vector(xr, m)).to(dev)), m)
        err_r = float((np.abs(yr - y_r) / scale_r).max())
        print(f"spmv {label}: wall={rep_s.summary[label]['wall_s'] * 1e3:.3f} ms "
              f"max|y - A@1|/max|A|@1 = {err:.3e}, random x: "
              f"max|y - A@x|/(|A|@|x|) = {err_r:.3e}", flush=True)
        check(err <= 1e-12 and err_r <= 1e-12, f"spmv {label} disagrees with scipy")

    # --- the later slices' paths on the same session --------------------
    reps = {}
    for tag, cfg, expected in later_paths(api):
        torch.cuda.empty_cache()
        reps[tag] = solve_path(tag, api, spec, cfg, sess, launches, expected)
    e_b = reps["block"].solvers["BCMGX-analog"]
    print(f"per_solve_wall_s: block-HS r={NRHS} {e_b['per_solve_wall_s']:.4f} s, "
          f"hs r=1 {hs_wall:.4f} s", flush=True)
    for name, n in launches.items():
        rows[name]["launches"] = n

    for variant, nrhs in (("hs", 1), ("fcg", 1), ("pipecg", 1), ("hs", NRHS)):
        profile_phase(sess, dev, variant, nrhs)

    keys =("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
