"""Smoke run of the PyTorch/CUDA port on one GPU: kernels, main path, SpMV.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (any
CUDA card with sm_90a). It

1. prints the card (``nvidia-smi`` name and power limit), its idle power
   draw, the torch and CUDA versions, and builds every CUDA kernel of the
   port from the sources in the checkout (one ``nvcc`` per source, all
   started together), printing the build time;
2. holds each kernel against its plain PyTorch version on the card, at the
   main path's shape and at a ragged one, in float64 and float32;
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
6. profiles 20 hs iterations with ``torch.profiler``: device time per
   kernel and the device's busy share of the wall time;
7. prints one JSON line describing every kernel, then, last,
   ``{"ok": true, "device": {...}}``.

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
            }
            b = p.element_size()
            N = SHARDS * R
            # bytes: each input read once, each output written once
            work = {
                "fused_dots_n": ((2 * N + SHARDS) * b, 2 * N),
                "fused_axpy": ((3 * N + 1) * b, 2 * N),
                "fused_axpy2_dots": ((6 * N + 2 + SHARDS) * b, 6 * N),
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
            }
            for name, (kern, plain, lib) in calls.items():
                nbytes, flops = work[name]
                bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tname]) * 1e3
                rows[name] = dict(
                    name=name, route="cuda", source=fr.KERNELS[name]["source"],
                    replaces=fr.KERNELS[name]["replaces"],
                    max_abs_err=abs_err[name],
                    ms=time_ms(kern), plain_ms=time_ms(plain),
                    bound_ms=bound, bound_by=fr.KERNELS[name]["bound_by"],
                    library_ms=time_ms(lib) if lib is not None else None,
                )
                print(f"time {name:16s} kernel {rows[name]['ms']:.4f} ms  bound "
                      f"{bound:.4f} ms  plain {rows[name]['plain_ms']:.4f} ms  "
                      f"library {rows[name]['library_ms']}", flush=True)
            del p, w, x, r
    return rows


def profile_phase(sess, dev, iters: int = 20):
    """Where an hs iteration's time goes: ``iters`` iterations of the main
    path's solver under ``torch.profiler``; prints device time per kernel
    name (per iteration) and the device's busy share of the wall time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cg import make_solver
    from repro_torch.core.partition import pad_vector

    mat = sess.matrix()
    # a tolerance far below reach: exactly `iters` iterations run
    solve = make_solver(mat, tol=1e-200, maxiter=iters, device=dev)
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
    # device-side events only (kernels, memcpy/memset): the CPU ops that
    # launched them carry the same device time again
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in rows)
    print(f"profile: {iters} hs iterations, wall {wall * 1e3 / iters:.3f} ms/iter, "
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

    # --- the main path: hs CG + the Ginkgo-analog leg, float64 ------------
    spec = api.ProblemSpec("poisson7", side=SIDE, shards=SHARDS)
    config = api.SolverConfig(maxiter=MAXITER)
    t0 = time.perf_counter()
    sess = api.session_for(spec, dev)
    print(f"matrix build: {time.perf_counter() - t0:.2f} s "
          f"(n={sess.n} nnz={sess.a.nnz})", flush=True)
    fr.reset_launches()
    rep = api.solve(spec, config, session=sess)
    launches = fr.launches()
    a = sess.a
    b = np.ones(sess.n)
    bn = np.linalg.norm(b)
    for label, s in rep.summary.items():
        entry = rep.solvers[label]
        x = rep.outputs[label]
        check(x.shape == (sess.n,) and np.isfinite(x).all(), f"{label}: bad solution")
        res = float(np.linalg.norm(b - a @ x) / bn)
        print(f"main {label}: iters={s['iters']} relres={s['relres']:.3e} "
              f"scipy_relres={res:.3e} wall={s['wall_s']:.4f} s "
              f"partition={entry['partition_s']:.3f} s "
              f"peak_mem={entry['peak_mem_bytes'] / 2**30:.3f} GiB", flush=True)
        check(s["relres"] <= 1e-8, f"{label}: relres {s['relres']} > 1e-8")
        check(res <= 1e-7, f"{label}: scipy residual {res} > 1e-7")
    hs_iters = rep.summary["BCMGX-analog"]["iters"]
    expect = (1 + config.repeats) * hs_iters
    print(f"launches on the main path: {launches} (expected {expect} each)", flush=True)
    for name, n in launches.items():
        check(n == expect, f"{name}: {n} launches, expected {expect}")
        rows[name]["launches"] = n

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

    profile_phase(sess, dev)

    keys =("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
