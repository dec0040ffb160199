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
7. the interior formats, on the SuiteSparse analogs at the paper's row
   counts (``scale=1.0``) over 4 stacked shards in float64:

   * ``boneS10`` with ``--format auto``, which must resolve BCSR: the two
     BCSR kernels held against their plain versions at its shape (r = 1
     and r = 8) and at ragged ones, and timed, with cuSPARSE's BSR product
     as the library yardstick; ``op="spmv"`` against scipy; hs through
     ``api.solve`` (``b = ones = A @ 1``: one iteration on both legs); hs
     with a seeded right-hand side through the session's solver handle;
     block-HS with ``nrhs=8`` — each with its launch counts;
   * ``G3_circuit`` with ``--format auto``, which must resolve HYB: hs
     with a seeded right-hand side, and two SpMVs that must give the same
     bits (the HYB tail is added without atomics);
   * poisson7 at side 256 with ``--format bcsr --block 4``: hs within one
     iteration of the ELL count of step 4;
8. profiles 20 iterations of hs, fcg, pipecg and block-HS with
   ``torch.profiler`` — and hs on BCSR (poisson7, boneS10), block-HS on
   BCSR (boneS10) and hs on HYB (G3_circuit): device time per kernel and
   the device's busy share of the wall time;
9. prints one JSON line describing every kernel (``launches`` summed over
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
BLOCK = 4  # the BCSR tile of the format paths (the CLI's default --block)
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


def kernel_modules():
    from repro_torch.kernels import fused_reductions as fr
    from repro_torch.kernels import spmv_bcsr as sb

    return fr, sb


def all_kernels() -> dict:
    """Every hand-written kernel of the port: name -> its description."""
    out = {}
    for m in kernel_modules():
        out.update(m.KERNELS)
    return out


def reset_launches():
    for m in kernel_modules():
        m.reset_launches()


def launch_counts() -> dict:
    out = {}
    for m in kernel_modules():
        out.update(m.launches())
    return out


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
    desc = all_kernels()[name]
    nbytes, flops = work
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tname]) * 1e3
    row = dict(
        name=name, route="cuda", source=desc["source"],
        replaces=desc["replaces"], max_abs_err=abs_err,
        ms=time_ms(kern), plain_ms=time_ms(plain),
        bound_ms=bound, bound_by=desc["bound_by"],
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

    reset_launches()
    rep = api.solve(spec, config, session=sess)
    got = launch_counts()
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


def profile_phase(sess, dev, variant: str = "hs", nrhs: int = 1, iters: int = 20,
                  fmt: str = "ell", seeded: bool = False):
    """Where an iteration's time goes: ``iters`` iterations of a path's
    solver on the ``fmt`` partition under ``torch.profiler``; prints device
    time per kernel name (per iteration) and the device's busy share of the
    wall time. ``seeded`` solves for a seeded random right-hand side (the
    SuiteSparse analogs' ``b = ones`` is ``A @ 1``, solved in one step)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cg import default_rhs_block, make_block_solver, make_solver
    from repro_torch.core.partition import pad_block, pad_vector

    mat = sess.matrix(fmt, BLOCK)
    rng = np.random.default_rng(0)
    # a tolerance far below reach: exactly `iters` iterations run
    if nrhs > 1:
        solve = make_block_solver(mat, tol=1e-200, maxiter=iters, device=dev)
        B = (rng.standard_normal((sess.n, nrhs)) if seeded
             else default_rhs_block(sess.n, nrhs))
        b = torch.from_numpy(pad_block(B, mat)).to(dev)
    else:
        solve = make_solver(mat, variant=variant, tol=1e-200, maxiter=iters, device=dev)
        bv = rng.standard_normal(sess.n) if seeded else np.ones(sess.n)
        b = torch.from_numpy(pad_vector(bv, mat)).to(dev)
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
    label += f" [{sess.key[0]}, {mat.fmt}]"
    print(f"profile: {iters} {label} loop iterations, wall {wall * 1e3 / iters:.3f} ms/iter, "
          f"device busy {busy_us / 1e3 / iters:.3f} ms/iter "
          f"({100 * busy_us / 1e6 / wall:.1f}% of wall)", flush=True)
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {t / 1e3 / iters:8.4f} ms/iter  {count / iters:5.1f} calls/iter  "
              f"{key[:90]}", flush=True)


def random_bcsr(dev, b, bpr, R, dtype, seed, S=SHARDS):
    """Seeded uniform-layout BCSR tiles with a ragged R and padding tiles
    (zero, block column 0) past a random count of each block-row."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    NB = -(-R // b)
    blocks = torch.randn(S, NB * bpr, b, b, dtype=dtype, device=dev, generator=g)
    bcol = torch.randint(0, NB, (S, NB * bpr), device=dev, generator=g, dtype=torch.int32)
    used = torch.randint(1, bpr + 1, (S, NB, 1), device=dev, generator=g)
    pad = (torch.arange(bpr, device=dev) >= used).reshape(S, NB * bpr)
    blocks[pad] = 0
    bcol[pad] = 0
    return blocks, bcol, NB


def bsr_library(blocks, bcol, n_brows, bpr, x):
    """The library yardstick of the BCSR kernels, never on the port's path:
    one ``torch.sparse_bsr_tensor`` (cuSPARSE) product over the S shards'
    tiles held block-diagonally (all-zero tiles dropped), times ``x``
    zero-padded to whole tiles. Returns ``(call, note)``; ``call`` is None,
    and the note holds the error, where the card's torch refuses it."""
    import torch

    S, _, br, bc = blocks.shape
    R = x.shape[1]
    n_bcols = -(-R // bc)
    try:
        keep = blocks.reshape(S * n_brows * bpr, -1).ne(0).any(-1)
        crow = torch.zeros(S * n_brows + 1, dtype=torch.int64, device=blocks.device)
        crow[1:] = keep.view(S * n_brows, bpr).sum(1).cumsum(0)
        offs = torch.arange(S, device=blocks.device)[:, None] * n_bcols
        cols = (bcol.long() + offs).reshape(-1)[keep]
        A = torch.sparse_bsr_tensor(crow, cols, blocks.reshape(-1, br, bc)[keep],
                                    size=(S * n_brows * br, S * n_bcols * bc))
        xl = x.new_zeros((S, n_bcols * bc) + tuple(x.shape[2:]))
        xl[:, :R] = x
        xl = xl.reshape((S * n_bcols * bc,) + tuple(x.shape[2:]))
        call = lambda: A @ xl
        call()
        torch.cuda.synchronize()
        return call, "torch.sparse_bsr_tensor @ x (cuSPARSE)"
    except Exception as e:  # the yardstick only; the port never calls it
        return None, f"none ({type(e).__name__}: {str(e).splitlines()[0][:160]})"


def bcsr_kernel_phase(dev, mat):
    """The BCSR kernels against their plain versions, in float64 and
    float32: at the path's shape (the tiles of ``mat``, the boneS10 BCSR
    interior; r = 1 and r = NRHS) and at ragged ones (random tiles with R
    not a multiple of the tile, r = 1 and 3); timings at the path's shape
    in float64."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import spmv_bcsr as sb

    it = mat.interior
    S, R = mat.n_shards, mat.n_own_pad
    rows = {}
    g = torch.Generator(device=dev).manual_seed(2)
    for dt in (torch.float64, torch.float32):
        tname = str(dt).split(".")[1]
        cases = [("path", it.blocks.to(dt), it.bcol, it.n_brows, it.bpr, R, (1, NRHS))]
        for seed, (b, bpr, Rr) in enumerate(((4, 13, 1001), (3, 5, 997))):
            blocks, bcol, NB = random_bcsr(dev, b, bpr, Rr, dt, seed)
            cases.append(("ragged", blocks, bcol, NB, bpr, Rr, (1, 3)))
        for label, blocks, bcol, NB, bpr, Rc, rs in cases:
            br = blocks.shape[2]
            for r in rs:
                name = "bcsr_spmv" if r == 1 else "bcsr_spmm"
                shape = (S, Rc) if r == 1 else (S, Rc, r)
                x = torch.randn(shape, dtype=dt, device=dev, generator=g)
                kern = sb.bcsr_spmv if r == 1 else sb.bcsr_spmm
                plain = ref.bcsr_spmv_ref if r == 1 else ref.bcsr_spmm_ref
                k = kern(blocks, bcol, x, n_brows=NB, bpr=bpr)
                p = plain(blocks, bcol, x, NB, bpr)
                scale = plain(blocks.abs(), bcol, x.abs(), NB, bpr)
                torch.cuda.synchronize()
                check(k.shape == p.shape == shape, f"{name}: shape {tuple(k.shape)}")
                # rows of zeros (the shards' padding rows) have scale 0 and k == p
                e = float(((k - p).abs() / scale.clamp(min=torch.finfo(dt).tiny)).max())
                print(f"parity {name:16s} {label:6s} {tname} S={S} R={Rc} "
                      f"tile={br}x{blocks.shape[3]} bpr={bpr} r={r}: {e:.3e} "
                      f"(limit {DOT_TOL[tname]:g}, relative to |A| @ |x|)", flush=True)
                check(e <= DOT_TOL[tname], f"{name} disagrees with its plain version")
                check(torch.equal(k, kern(blocks, bcol, x, n_brows=NB, bpr=bpr)),
                      f"{name}: two launches on the same inputs differ")
                if label != "path" or dt != torch.float64:
                    continue
                b_ = x.element_size()
                ntiles = S * NB * bpr
                nr = max(r, 1)
                # the JAX package's OpCounts: tiles + ids, x read, y written
                nbytes = ntiles * (br * br * b_ + 4) + S * Rc * nr * b_ + S * NB * br * nr * b_
                flops = 2 * ntiles * br * br * nr
                lib, note = bsr_library(blocks, bcol, NB, bpr, x)
                print(f"library {name}: {note}", flush=True)
                rows[name] = time_row(
                    name, (nbytes, flops),
                    lambda: kern(blocks, bcol, x, n_brows=NB, bpr=bpr),
                    lambda: plain(blocks, bcol, x, NB, bpr), lib,
                    float((k - p).abs().max()), tname)
                rows[name]["library_note"] = note
                del lib
            del blocks, bcol
        torch.cuda.empty_cache()
    return rows


def handle_solve(tag, sess, mat, b_np, dev, launches):
    """hs through the session's solver handle for ``b_np`` (the path a
    caller with their own right-hand side takes): one warm-up solve, then a
    timed one with every launch count set to 0 just before and read just
    after: relres and an independent
    scipy residual, and each kernel's launches against the count the
    iterations imply. Returns the iteration count."""
    import numpy as np
    import torch

    from repro_torch.core.partition import pad_vector, unpad_vector

    h = sess.solver(mat, tol=1e-8, maxiter=MAXITER)
    bp = torch.from_numpy(pad_vector(b_np, mat)).to(dev)
    x0 = torch.zeros_like(bp)
    h.fn(bp, x0)  # warm-up: the first HYB SpMV derives its tail plan on the host
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = h.fn(bp, x0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts()
    it = res.iters
    x = unpad_vector(res.x, mat)
    check(bool(np.isfinite(x).all()), f"{tag}: non-finite solution")
    relres = float(res.rel_residual)
    a = sess.a
    sres = float(np.linalg.norm(b_np - a @ x) / np.linalg.norm(b_np))
    print(f"{tag}: format={mat.fmt} iters={it} relres={relres:.3e} scipy_relres={sres:.3e} "
          f"wall={wall:.4f} s per_iter={1e3 * wall / max(it, 1):.3f} ms", flush=True)
    check(relres <= 1e-8, f"{tag}: relres {relres} > 1e-8")
    check(sres <= 1e-7, f"{tag}: scipy residual {sres} > 1e-7")
    want = {k: (f"{it}", it) for k in ("fused_dots_n", "fused_axpy2_dots", "fused_axpy")}
    if mat.fmt == "bcsr":  # one SpMV before the loop, one per iteration
        want["bcsr_spmv"] = (f"1 + {it}", 1 + it)
    for name, n in got.items():
        formula, value = want.get(name, ("0", 0))
        print(f"launches {tag} {name:16s} {n} = {formula} -> {value}", flush=True)
        check(n == value, f"{tag}: {name} launched {n} times, expected {value}")
        launches[name] += n
    return it


def hs_expected(fmt):
    """Launches of one hs ``api.solve`` (1 warm-up + ``rep`` timed solves):
    3 reduction kernels per iteration, and on BCSR one ``bcsr_spmv`` per
    iteration plus one before the loop."""
    def expected(it, rep):
        want = {k: (f"(1 + {rep}) x {it}", (1 + rep) * it)
                for k in ("fused_dots_n", "fused_axpy2_dots", "fused_axpy")}
        if fmt == "bcsr":
            want["bcsr_spmv"] = (f"(1 + {rep}) x (1 + {it})", (1 + rep) * (1 + it))
        return want
    return expected


def block_expected(fmt):
    """Launches of one block-HS ``api.solve``: 1 setup Gram plus 2 Grams,
    1 update2 and 1 update per iteration; on BCSR one ``bcsr_spmm`` per
    iteration plus one before the loop."""
    def expected(it, rep):
        want = {
            "block_gram": (f"(1 + {rep}) x (1 + 2 x {it})", (1 + rep) * (1 + 2 * it)),
            "block_update2": (f"(1 + {rep}) x {it}", (1 + rep) * it),
            "block_update": (f"(1 + {rep}) x {it}", (1 + rep) * it)}
        if fmt == "bcsr":
            want["bcsr_spmm"] = (f"(1 + {rep}) x (1 + {it})", (1 + rep) * (1 + it))
        return want
    return expected


def suitesparse_session(api, name, dev):
    """The session of SuiteSparse analog ``name`` at the paper's row count
    on SHARDS stacked shards, and its ``--format auto`` partition."""
    spec = api.ProblemSpec(name, scale=1.0, shards=SHARDS)
    t0 = time.perf_counter()
    sess = api.session_for(spec, dev)
    t1 = time.perf_counter()
    mat = sess.matrix("auto", BLOCK)
    it = mat.interior
    shape = (f"tiles {tuple(it.blocks.shape)} bpr={it.bpr}" if mat.fmt == "bcsr" else
             f"k_typ={it.k_typ} tail={list(it.n_tail)}" if mat.fmt == "hyb" else "")
    print(f"{name}: n={sess.n} nnz={sess.a.nnz} matrix build {t1 - t0:.2f} s, "
          f"partition {sess.partition_s[('auto', BLOCK)]:.2f} s: format=auto -> {mat.fmt} "
          f"({mat.plan.mode}, R={mat.n_own_pad}) {shape} "
          f"interior_bytes={mat.interior_stored_bytes()} stored_bytes={mat.stored_bytes()}",
          flush=True)
    return spec, sess, mat


def bone_paths(api, dev, spec, sess, mat, launches):
    """boneS10 on its BCSR interior: the SpMV against scipy, hs through
    api.solve (b = A @ 1: one iteration), hs for a seeded right-hand side
    through the solver handle, block-HS r = NRHS through api.solve."""
    import numpy as np

    cfg = dict(fmt="auto", block=BLOCK, maxiter=MAXITER)
    reset_launches()
    rep = api.solve(spec, api.SolverConfig(op="spmv", **cfg), session=sess)
    got = launch_counts()
    check(rep.ledger["resolved_format"] == "bcsr", "boneS10: auto did not resolve bcsr")
    check(set(rep.outputs) == {"BCMGX-analog"}, f"boneS10 spmv legs {set(rep.outputs)}")
    a = sess.a
    ones = np.ones(sess.n)
    err = float(np.abs(rep.outputs["BCMGX-analog"] - a @ ones).max() / (np.abs(a) @ ones).max())
    print(f"boneS10 spmv: wall={rep.summary['BCMGX-analog']['wall_s'] * 1e3:.3f} ms "
          f"max|y - A@1|/max|A|@1 = {err:.3e}; launches bcsr_spmv "
          f"{got['bcsr_spmv']} = 1 + 100", flush=True)
    check(err <= 1e-12, "boneS10 spmv disagrees with scipy")
    check(got == dict(dict.fromkeys(got, 0), bcsr_spmv=101), f"boneS10 spmv launches {got}")
    launches["bcsr_spmv"] += got["bcsr_spmv"]

    rep = solve_path("boneS10-hs", api, spec, api.SolverConfig(**cfg), sess, launches,
                     hs_expected("bcsr"))
    iters = {label: s["iters"] for label, s in rep.summary.items()}
    print(f"boneS10-hs with b = ones = A @ 1: iters {iters} (expected 1 on both legs)",
          flush=True)
    check(set(iters.values()) == {1} and len(iters) == 2, f"boneS10 b = ones: {iters}")
    handle_solve("boneS10-hs-seeded", sess, mat,
                 np.random.default_rng(0).standard_normal(sess.n), dev, launches)
    solve_path("boneS10-block", api, spec, api.SolverConfig(nrhs=NRHS, **cfg), sess,
               launches, block_expected("bcsr"))


def g3_paths(dev, sess, mat, launches):
    """G3_circuit on its HYB interior: hs for a seeded right-hand side, and
    two SpMVs that must give the same bits and scipy's product."""
    import numpy as np
    import torch

    from repro_torch.core.partition import pad_vector, unpad_vector

    check(mat.fmt == "hyb", f"G3_circuit: auto resolved {mat.fmt}, not hyb")
    rng = np.random.default_rng(0)
    handle_solve("G3_circuit-hs-seeded", sess, mat, rng.standard_normal(sess.n), dev,
                 launches)
    h = sess.solver(mat, op="spmv")
    xr = rng.standard_normal(sess.n)
    xp = torch.from_numpy(pad_vector(xr, mat)).to(dev)
    y1 = h.fn(xp)
    y2 = h.fn(xp)
    torch.cuda.synchronize()
    same = bool(torch.equal(y1, y2))
    a = sess.a
    err = float((np.abs(unpad_vector(y1, mat) - a @ xr) / (np.abs(a) @ np.abs(xr))).max())
    print(f"G3_circuit spmv (hyb): two runs bitwise equal: {same}; "
          f"max|y - A@x|/(|A|@|x|) = {err:.3e}", flush=True)
    check(same, "G3_circuit: the HYB SpMV is not bitwise repeatable")
    check(err <= 1e-12, "G3_circuit spmv disagrees with scipy")



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
    launches = dict.fromkeys(all_kernels(), 0)  # summed over the solve paths
    rep = solve_path("main", api, spec, config, sess, launches, hs_expected("ell"))
    hs_iters = rep.summary["BCMGX-analog"]["iters"]
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

    # --- the interior formats -------------------------------------------
    torch.cuda.empty_cache()
    rep_b = solve_path("p7-bcsr", api, spec,
                       api.SolverConfig(fmt="bcsr", block=BLOCK, maxiter=MAXITER),
                       sess, launches, hs_expected("bcsr"))
    mb = sess.matrix("bcsr", BLOCK)
    it_b = rep_b.summary["BCMGX-analog"]["iters"]
    print(f"p7-bcsr: tiles {tuple(mb.interior.blocks.shape)} bpr={mb.interior.bpr} "
          f"interior_bytes={mb.interior_stored_bytes()} partition "
          f"{sess.partition_s[('bcsr', BLOCK)]:.2f} s; hs iters {it_b} on BCSR against "
          f"{hs_iters} on ELL (difference {it_b - hs_iters})", flush=True)
    check(abs(it_b - hs_iters) <= 1, "poisson7 BCSR hs iterations differ from ELL by > 1")
    spec_bone, sess_bone, mat_bone = suitesparse_session(api, "boneS10", dev)
    check(mat_bone.fmt == "bcsr", f"boneS10: auto resolved {mat_bone.fmt}, not bcsr")
    rows.update(bcsr_kernel_phase(dev, mat_bone))
    bone_paths(api, dev, spec_bone, sess_bone, mat_bone, launches)
    torch.cuda.empty_cache()
    _, sess_g3, mat_g3 = suitesparse_session(api, "G3_circuit", dev)
    g3_paths(dev, sess_g3, mat_g3, launches)
    for name, n in launches.items():
        rows[name]["launches"] = n

    for variant, nrhs in (("hs", 1), ("fcg", 1), ("pipecg", 1), ("hs", NRHS)):
        profile_phase(sess, dev, variant, nrhs)
    profile_phase(sess, dev, "hs", 1, fmt="bcsr")
    profile_phase(sess_bone, dev, "hs", 1, fmt="auto", seeded=True)
    profile_phase(sess_bone, dev, "hs", NRHS, fmt="auto", seeded=True)
    profile_phase(sess_g3, dev, "hs", 1, fmt="auto", seeded=True)

    keys =("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
