"""Smoke run of the PyTorch/CUDA port on one GPU: kernels, main path, SpMV.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (any
CUDA card with sm_90a). It

1. prints the card (``nvidia-smi`` name and power limit), its idle power
   draw, the torch and CUDA versions, and builds every CUDA kernel of the
   port from the sources in the checkout (one ``nvcc`` per source, all
   started together), printing the build time and ``nvcc -Xptxas -v``'s
   registers, shared memory and spills of the redesigned kernels;
2. holds each kernel against its plain PyTorch version on the card, in
   float64 and float32: the vector kernels at the main path's shape and at
   a ragged one (``fused_axpy`` also with a Python-number scalar and, bit
   for bit, on a view 1 element off a 16-byte boundary), the block kernels
   at the block path's (r = 8) and at ragged ones (R - 3 with r = 3 and
   r = 17);
3. times each kernel (median of CUDA-event timings), its plain version and,
   where one PyTorch call computes the same function, that call; the bound
   is the larger of the bytes the function must move over the card's
   memory rate and its flops over the card's peak rate (NVIDIA's data
   sheet), the least time the card could take; ``fused_axpy`` and
   ``torch.addcmul`` also in 12 alternating pairs of L2-flushed device
   times (the median ratio and its spread printed);
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
6a. the 2-D process grid at the same size: ``api.solve`` with
   ``grid="2x2"`` (the pencil-permuted matrix, per-dimension halos, staged
   all-reduces, no Ginkgo leg), hs then pipecg on the same partition —
   the pencil-reorder and partition seconds, each variant's iterations
   within 1 of its 1-D count, relres and the scipy residual of the
   un-permuted ``x``, the ledger's ``halo_bytes_rows``/``halo_bytes_cols``
   against ``pencil_halo_widths`` (their sum the 1-D ring's bytes), ms per
   iteration beside the 1-D hs, launches, and a 20-iteration profile of
   grid hs with its device-busy share;
7. the interior formats, on the SuiteSparse analogs at the paper's row
   counts (``scale=1.0``) over 4 stacked shards in float64:

   * ``boneS10`` with ``--format auto``, which must resolve BCSR: the two
     BCSR kernels held against their plain versions at its shape (r = 1,
     4 and 8) and at ragged ones, and timed, with cuSPARSE's BSR product
     as the library yardstick (the kernel-to-cuSPARSE ratio printed);
     ``op="spmv"`` against scipy; hs through ``api.solve`` (``b = ones =
     A @ 1``: one iteration on both legs); hs with a seeded right-hand
     side through the session's solver handle;
     block-HS with ``nrhs=8`` — each with its launch counts;
   * ``G3_circuit`` with ``--format auto``, which must resolve HYB: hs
     with a seeded right-hand side, and two SpMVs that must give the same
     bits (the HYB tail is added without atomics);
   * poisson7 at side 256 with ``--format bcsr --block 4``: hs within one
     iteration of the ELL count of step 4;
7a. the energy-aware tuner, ``api.solve`` with ``autotune=True`` on the main
   path's session, its cache in a directory made under ``build/`` and
   removed after: (a) objective energy, budget 3 — not cached, 108
   candidates, DEFAULT among the trials and never scoring below the
   winner, each executed trial 8 iterations unless it converged, the
   winner within 1 iteration of its variant's ELL count, every trial's
   label, iterations and predicted and modeled time and energy, the prune
   and trial seconds and the partitions made, and the winner's card wall
   per iteration beside the 1-D hs's and the tuner's modeled one; (b) the
   same call, a cache hit with no trial and no partition; (c) ``nrhs=8``,
   budget 2 — 36 candidates, block-HS, the block path's iterations; (d)
   poisson7 at side 128 on 8 shards, objective time — 432 candidates, the
   best-predicted grid (2 x 4) and s-step candidates printed, the winner's
   solve (a grid winner's ledger carries the grid and its halo bytes).
   Each with relres, the scipy residual and the launches of the trials
   plus the winner's solves against their formulas;
8. s-step CG (communication-avoiding): the three s-step kernels held
   against their plain versions at the path's shape (s = 2 and 4) and at
   ragged ones, in float64 and float32, and timed; the matrix-powers SpMV
   on ``halo_depth = s`` partitions of the poisson7 side-256 matrix against
   s serial SpMVs on the flat partition (s = 2 and 4); ``api.solve`` with
   ``variant="sstep"`` at the default s = 2 (both legs) and a seeded
   right-hand side through the session's solver handle at s = 4 — relres,
   scipy residual, iterations beside hs's, and each s-step kernel launched
   once per s-iteration block;
9. the matrix-free stencil path (``core/stencil_solver.py``), float64 on
   4 stacked slabs of 64 planes at side 256 unless noted:

   * the four stencil kernels held against their plain versions in float64
     and float32, 7pt, anisotropic 7pt (1, 2.5, 7) and 27pt, at the path's
     shape (the global 256³ grid for ``stencil_spmv`` and the sweep) and at
     ragged ones ((4, 5, 33, 45); nz = 1 for the slab kernel, nz = 2 for
     the boundary kernel; (1, 1, 7, 9), (2, 67, 40, 70) and (2, 3, 130,
     129)); each kernel bitwise its plain version, the boundary planes
     bitwise the halo kernel's, and ``stencil_spmv`` on the stacked grid
     bitwise the halo kernel with real halos; each kernel, its plain
     version and ``conv3d`` (the SpMVs' library yardstick) timed, and the
     device times of the boundary kernel and ``stencil_spmv`` at 7pt and
     27pt with L2 flushed, from profiler windows (a window whose launch
     count is off is taken again, at most twice; each phase prints how many
     windows it took and retried);
   * ``make_matvec`` against scipy's ``A @ x`` (poisson7 at side 256, and
     poisson27 at side 64), overlap on and off, ones and a seeded x;
   * ``make_stencil_solver_fn`` with hs, fcg, pipecg and s-step (s = 2) on
     poisson7 (b = ones, tol 1e-8): relres, scipy residual, iterations
     within 2 of the same variant's ELL count in this run (s-step within
     s), ms per iteration beside ELL's, each stencil kernel's launches
     against the formula; hs on poisson27 at side 256, its residual from
     the plain ``stencil27_ref`` on the card;
   * ten fused Jacobi sweeps (``ops.jacobi_stencil_sweep``) on the global
     grid with the residual from ``ops.stencil_spmv``: monotone, each sweep
     bitwise the plain version;
10. AMG-PCG, float64, tol 1e-8:

   * the torch locally-dominant matcher on the card against the numpy one
     (poisson7 at side 64, compatible and plain weights, and a seeded
     random graph): the same ``match`` arrays;
   * the BCMG analog on poisson7 at side 256 (the main path's session):
     ``api.solve(amg=True)`` with hs, fcg and pipecg, the hierarchy built
     once (setup seconds split into aggregation, RAP, partition and
     transfer; level rows; operator complexity; the solves after it
     report no setup), each leg's relres, scipy residual and launches
     against the formula (15 ``fused_axpy`` per level per V-cycle), each
     within half of hs's iterations;
   * ``fused_axpy`` with a Python-number scalar at the AMG levels'
     per-shard lengths: within 2 eps of its plain version, and against
     ``torch.addcmul`` (6 pairs of L2-flushed event times each);
   * the AmgX analog (``amgx_analog=True``: plain weights, the host scan
     matcher) at side 128, within half of hs's iterations on the same
     matrix;
11. profiles 20 iterations of hs, fcg, pipecg, block-HS and s-step (s = 2)
   with ``torch.profiler`` — and hs on BCSR (poisson7, boneS10), block-HS
   on BCSR (boneS10), hs on HYB (G3_circuit), matrix-free hs (poisson7),
   and AMG hs (side 256): device time per kernel (and per torch op for
   AMG), the device's busy share of the wall time, and the host's syncs
   and copies per iteration (AMG: one sync, the loop test, and no
   host-to-device copy). The AmgX analog's profile (side 128) was cut
   when the tuner phase came in, to keep the run near half of the chip
   tool's limit;
12. prints one JSON line describing every kernel (``launches`` summed over
   the solve paths, the tuner's trials and the Jacobi sweeps), then, last, ``{"ok": true,
   "device": {...}}``.

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
SSTEP_S = (2, 4)  # the s-step path's block sizes: the default, and the handle solve's
BLOCK = 4  # the BCSR tile of the format paths (the CLI's default --block)
R_MAIN = SIDE ** 3 // SHARDS  # per-shard length on the main path
R_RAGGED = R_MAIN - 3
# NVIDIA H100 SXM data sheet (dense, no sparsity).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}  # outside the tensor cores
DOT_TOL = {"float64": 1e-13, "float32": 1e-5}
ANISO = (1.0, 2.5, 7.0)  # the anisotropic 7pt stencil of the stencil kernel phase
TUNE_BUDGET = (3, 2)  # the tuner's trial budget: single right-hand side, nrhs = NRHS
TUNE_WIDE = (128, 8)  # side and shards of the tuner's 8-shard step (grid, s-step axes)
TUNE_ITERS = 8  # iterations of each trial (the tuner's default trial_iters)


T_START = time.perf_counter()


def stamp(phase: str):
    """Print the seconds since the script started, after ``phase``."""
    print(f"elapsed {time.perf_counter() - T_START:.1f} s after {phase}", flush=True)


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
    from repro_torch.kernels import jacobi_stencil as js
    from repro_torch.kernels import spmv_bcsr as sb
    from repro_torch.kernels import spmv_stencil as st

    return fr, sb, st, js


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


# the float64 instantiations of the redesigned kernels that the paths run
PTXAS_KERNELS = ("halo_march_kernel<double", "boundary_tile_kernel<double",
                 "bcsr_rhs_kernel<double, (int)4, (int)4>")


def ptxas_report(log: str, names=PTXAS_KERNELS) -> list[str]:
    """``nvcc -Xptxas -v``'s registers, shared memory and spills of every
    entry whose name (demangled by the toolkit's ``cu++filt``, else bare)
    holds one of ``names``, one line each."""
    import re
    import shutil

    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": m.group(1), "spill": ""}
            entries.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spill"] = line.strip()
        elif cur is not None and "Used" in line:
            cur["used"] = line.split(":", 1)[1].strip()
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if entries and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(e["name"] for e in entries),
                             capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(out) == len(entries):
            for e, d in zip(entries, out):
                e["name"] = d.split("(const")[0].replace("(anonymous namespace)::", "")
    else:
        names = tuple(n.split("<")[0] for n in names)
    return [f"{e['name']}: {e.get('used', '?')}; {e['spill']}" for e in entries
            if any(n in e["name"] for n in names)]


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
            # a Python number goes by value; a view 1 element off a 16-byte
            # boundary takes one element per access: the same bits
            n_k = fr.fused_axpy(-0.37, p, r)
            n_p = ref.fused_axpy_ref(-0.37, p, r)
            buf = torch.empty(SHARDS * R + 1, dtype=dt, device=dev)
            pm = buf[1:].view(SHARDS, R)
            pm.copy_(p)
            same_m = bool(torch.equal(fr.fused_axpy(beta, pm, r), a_k))
            del buf, pm
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
                ("fused_axpy", "number", axpy_ok(n_k, n_p, -0.37, p, r, eps), 1.0),
                ("fused_axpy", "offset", 0.0 if same_m else float("inf"), 0.0),
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
            axpy_vs_addcmul(*calls["fused_axpy"][::2])
            del p, w, x, r
    return rows


def axpy_vs_addcmul(kern, lib, pairs: int = 12, calls: int = 10):
    """``fused_axpy`` against ``torch.addcmul`` on the same inputs, in turns
    (the kernel first in even pairs, the library call first in odd ones):
    each side's device time per call with L2 flushed before every call
    (``profiled_ms``); prints the kernel-to-library ratio's median, quartiles
    and range over the pairs."""
    tk, tl = [], []
    for i in range(pairs):
        for side in ((0, 1) if i % 2 == 0 else (1, 0)):
            if side == 0:
                tk.append(profiled_ms(kern, "axpy_kernel", calls))
            else:
                tl.append(profiled_ms(lib, None, calls))
    ratios = [a / b for a, b in zip(tk, tl)]
    q = statistics.quantiles(ratios, n=4)
    print(f"paired fused_axpy / torch.addcmul, float64 S={SHARDS} R={R_MAIN}, L2 flushed, "
          f"{pairs} pairs of {calls} calls: median ratio {statistics.median(ratios):.4f}, "
          f"quartiles {q[0]:.4f}-{q[2]:.4f}, range {min(ratios):.4f}-{max(ratios):.4f}; "
          f"medians {statistics.median(tk):.4f} ms (kernel), {statistics.median(tl):.4f} ms "
          f"(addcmul)", flush=True)
    profiler_tally("the fused_axpy / addcmul pairs")


def time_row(name, work, kern, plain, lib, abs_err, tname, tag="", lib_calls=20):
    """Time a kernel, its plain version and the library call (``lib_calls``
    calls per timing round); the bound is the larger of its bytes over the
    memory rate and its flops over the peak rate."""
    desc = all_kernels()[name]
    nbytes, flops = work
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tname]) * 1e3
    row = dict(
        name=name, route="cuda", source=desc["source"],
        replaces=desc["replaces"], max_abs_err=abs_err,
        ms=time_ms(kern), plain_ms=time_ms(plain),
        bound_ms=bound, bound_by=desc["bound_by"],
        library_ms=time_ms(lib, calls=lib_calls) if lib is not None else None,
    )
    print(f"time {name:16s} {tag}kernel {row['ms']:.4f} ms  bound {bound:.4f} ms "
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


def sstep_kernel_phase(dev):
    """The s-step kernels: parity at the path's shape (S = 4, R = side³/4,
    s = 2 and 4) and at ragged ones (R - 3 with s = 3 and 8), in float64
    and float32; timings at the path's shape in float64 (the JSON row at
    the default s = 2, s = 4 printed beside it)."""
    import torch

    from repro_torch.kernels import fused_reductions as fr
    from repro_torch.kernels import ref

    rows = {}
    g = torch.Generator(device=dev).manual_seed(3)
    for dt in (torch.float64, torch.float32):
        tname = str(dt).split(".")[1]
        for R, s in ((R_MAIN, 2), (R_MAIN, 4), (R_RAGGED, 3), (R_RAGGED, 8)):
            P, W, Wp, Qp = (torch.randn(SHARDS, R, s, dtype=dt, device=dev, generator=g)
                            for _ in range(4))
            x, r = (torch.randn(SHARDS, R, dtype=dt, device=dev, generator=g)
                    for _ in range(2))
            B = torch.randn(s, s, dtype=dt, device=dev, generator=g)
            dinv = torch.rand(s, dtype=dt, device=dev, generator=g) + 0.1
            a = torch.randn(s, dtype=dt, device=dev, generator=g)
            gk = fr.sstep_gram(P, W, Wp, r)
            gp = ref.sstep_gram_ref(P, W, Wp, r)
            gk2 = fr.sstep_gram(P, W, Wp, r)
            b1k, b2k = fr.sstep_basis(B, dinv, Qp, P, Wp, W)
            b1p, b2p = ref.sstep_basis_ref(B, dinv, Qp, P, Wp, W)
            uxk, urk = fr.sstep_update(a, P, W, x, r)
            uxp, urp = ref.sstep_update_ref(a, P, W, x, r)
            torch.cuda.synchronize()
            check(torch.equal(gk, gk2), "sstep_gram: two launches on the same inputs differ")
            # |k - p| relative to the sum of the magnitudes each entry adds up
            checks = [
                ("sstep_gram", "flat", gk, gp,
                 ref.sstep_gram_ref(P.abs(), W.abs(), Wp.abs(), r.abs())),
                ("sstep_basis", "o1", b1k, b1p, P.abs() * dinv + Qp.abs() @ B.abs()),
                ("sstep_basis", "o2", b2k, b2p, W.abs() * dinv + Wp.abs() @ B.abs()),
                ("sstep_update", "x", uxk, uxp, x.abs() + P.abs() @ a.abs()),
                ("sstep_update", "r", urk, urp, r.abs() + W.abs() @ a.abs()),
            ]
            errs = {}
            for name, what, k, p, scale in checks:
                e = float(((k - p).abs() / scale.clamp(min=torch.finfo(dt).tiny)).max())
                print(f"parity {name:16s} {what:6s} {tname} S={SHARDS} R={R} s={s}: "
                      f"{e:.3e} (limit {DOT_TOL[tname]:g})", flush=True)
                check(e <= DOT_TOL[tname], f"{name} ({what}) disagrees with its plain version")
                errs[name] = max(errs.get(name, 0.0), float((k - p).abs().max()))
            del gk, gk2, gp, b1k, b2k, b1p, b2p, uxk, urk, uxp, urp, checks
            if R == R_MAIN and dt == torch.float64:
                b = P.element_size()
                N = SHARDS * R
                K = 2 * s * s + s + 1
                # bytes: each input read once, each output written once
                work = {
                    "sstep_gram": (((3 * s + 1) * N + SHARDS * K) * b,
                                   4 * N * s * s + 2 * N * s + 2 * N),
                    "sstep_basis": ((6 * N * s + s * s + s) * b, 4 * N * s * s + 4 * N * s),
                    "sstep_update": ((2 * N * s + 4 * N + s) * b, 4 * N * s + 2 * N),
                }
                # no single PyTorch call computes the fused results: the Gram's
                # four, the basis' and the update's two outputs
                calls = {
                    "sstep_gram": (lambda: fr.sstep_gram(P, W, Wp, r),
                                   lambda: ref.sstep_gram_ref(P, W, Wp, r), None),
                    "sstep_basis": (lambda: fr.sstep_basis(B, dinv, Qp, P, Wp, W),
                                    lambda: ref.sstep_basis_ref(B, dinv, Qp, P, Wp, W),
                                    None),
                    "sstep_update": (lambda: fr.sstep_update(a, P, W, x, r),
                                     lambda: ref.sstep_update_ref(a, P, W, x, r), None),
                }
                for name, (kern, plain, lib) in calls.items():
                    row = time_row(name, work[name], kern, plain, lib, errs[name], tname,
                                   tag=f"s={s} ")
                    if s == SSTEP_S[0]:
                        rows[name] = row
            del P, W, Wp, Qp, x, r
            torch.cuda.empty_cache()
    return rows


STENCILS = (("7pt", (1.0, 1.0, 1.0)), ("7pt", ANISO), ("27pt", (1.0, 1.0, 1.0)))


_FLUSH_KEYS: set = set()
# profiler windows taken and taken again, per phase (profiler_tally)
_WINDOWS = {"taken": 0, "retried": 0}


def profiled_ms(fn, kernel: str | None, calls: int = 50) -> float:
    """Device time per call of the kernels whose name holds ``kernel`` (None:
    every kernel ``fn`` launches), from a ``torch.profiler`` window of
    ``calls`` calls (after a warm-up), each after a 64 MB write that flushes
    the 50 MB L2: the inputs come from HBM, as on the solver's path."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if not _FLUSH_KEYS:  # the flush's own kernels, left out where kernel is None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            flush.zero_()
            torch.cuda.synchronize()
        _FLUSH_KEYS.update(e.key for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA)
    fn()
    torch.cuda.synchronize()
    # the profiler now and then drops a kernel record (2 of 50 in about one
    # window of 40 on the H100): such a window is taken again
    for attempt in range(3):
        _WINDOWS["taken"] += 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and (e.key not in _FLUSH_KEYS if kernel is None else kernel in e.key)]
        seen = sum(e.count for e in evs)
        if seen == calls:
            return sum(e.self_device_time_total for e in evs) / 1e3 / calls
        _WINDOWS["retried"] += 1
        print(f"profiler window {attempt + 1}: {seen} {kernel} launches seen, not {calls}",
              flush=True)
    check(False, f"profiler saw {seen} {kernel} launches, not {calls}, in 3 windows")


def profiler_tally(phase: str):
    """Print how many profiler windows ``phase`` took and how many of them
    were taken again for a launch count other than their calls, then reset
    the tally."""
    print(f"profiler windows in {phase}: {_WINDOWS['taken']} taken, {_WINDOWS['retried']} "
          "retried for a wrong launch count", flush=True)
    _WINDOWS.update(taken=0, retried=0)


def halo_planes(x3):
    """The stacked halo exchange of ``(S, nz, ny, nx)`` slabs: ``prev[s] =
    x3[s - 1, -1]``, ``next[s] = x3[s + 1, 0]``, zero planes at the ends."""
    import torch.nn.functional as F

    return (F.pad(x3[:-1, -1], (0, 0, 0, 0, 1, 0)),
            F.pad(x3[1:, 0], (0, 0, 0, 0, 0, 1)))


def abs_product(plain, args, stencil, aniso, x):
    """``|A| |x|`` (with |halo| planes) from the plain product of the
    absolute inputs: ``2 d |x| - A |x|``, d the matrix diagonal."""
    d = 26.0 if stencil == "27pt" else 2.0 * sum(aniso)
    return 2 * d * x.abs() - plain(*[a.abs() for a in args])


def conv3d_library(stencil, aniso, x5, pad, like):
    """The library yardstick of the stencil SpMV, never on the port's path:
    ``torch.nn.functional.conv3d`` with the 3x3x3 stencil weights on the
    ``(N, 1, nz, ny, nx)`` input ``x5()`` (of ``like``'s dtype and device).
    Returns ``(call, note)``; ``call`` is None, and the note holds the
    error, where the card's torch refuses."""
    import torch
    import torch.nn.functional as F

    try:
        w = torch.zeros((1, 1, 3, 3, 3), dtype=like.dtype, device=like.device)
        if stencil == "27pt":
            w.fill_(-1.0)
            w[0, 0, 1, 1, 1] = 26.0
        else:
            ax, ay, az = aniso
            w[0, 0, 1, 1, 1] = 2.0 * (ax + ay + az)
            w[0, 0, 1, 1, 0] = w[0, 0, 1, 1, 2] = -ax
            w[0, 0, 1, 0, 1] = w[0, 0, 1, 2, 1] = -ay
            w[0, 0, 0, 1, 1] = w[0, 0, 2, 1, 1] = -az
        call = lambda: F.conv3d(x5(), w, padding=pad)
        call()
        torch.cuda.synchronize()
        return call, "torch.nn.functional.conv3d, 3x3x3 stencil weights"
    except Exception as e:  # the yardstick only; the port never calls it
        return None, f"none ({type(e).__name__}: {str(e).splitlines()[0][:160]})"


def stencil_kernel_phase(dev):
    """The four stencil kernels against their plain versions, in float64
    and float32, for 7pt, anisotropic 7pt ``ANISO`` and 27pt: at the path's
    shape (S = 4 slabs of side/4 planes, the global side³ grid for the
    single-grid kernels) and at ragged ones ((S, 5, 33, 45); nz = 1 for
    the slab kernel, nz = 2 for the boundary kernel; (1, 1, 7, 9), (2, 67,
    40, 70), ragged against the z-march's tile and runs, and (2, 3, 130,
    129), against the boundary kernel's edge-plane tiles). Each kernel
    must equal its plain version bit for bit (the same operations in the
    same order; ``|k - p| <= 2 eps (|A| |x|)`` is printed beside), the
    boundary planes the halo kernel's, and ``stencil_spmv`` on the stacked
    grid the halo kernel on its slabs with real halos. Timings at the
    path's shape, 7pt, float64 (27pt printed beside), with ``conv3d`` as
    the library yardstick of the two SpMVs; the device times of the
    boundary kernel and ``stencil_spmv`` with L2 flushed before each call,
    from profiler windows."""
    import torch

    from repro_torch.kernels import jacobi_stencil as js
    from repro_torch.kernels import ref
    from repro_torch.kernels import spmv_stencil as st

    rows = {}
    g = torch.Generator(device=dev).manual_seed(6)
    nzl = SIDE // SHARDS
    shapes = (("path", (SHARDS, nzl, SIDE, SIDE)), ("ragged", (SHARDS, 5, 33, 45)),
              ("nz=1", (SHARDS, 1, 33, 45)), ("nz=2", (SHARDS, 2, 33, 45)),
              ("S=1", (1, 1, 7, 9)), ("runs", (2, 67, 40, 70)), ("tiles", (2, 3, 130, 129)))
    for dt in (torch.float64, torch.float32):
        tname = str(dt).split(".")[1]
        eps = torch.finfo(dt).eps
        for label, shape in shapes:
            S, nz, ny, nx = shape
            x3 = torch.randn(shape, dtype=dt, device=dev, generator=g)
            prev, nxt = (torch.randn((S, ny, nx), dtype=dt, device=dev, generator=g)
                         for _ in range(2))
            xg = x3.reshape(S * nz, ny, nx)  # the stacked slabs as one grid
            b = torch.randn(xg.shape, dtype=dt, device=dev, generator=g)
            dinv = torch.rand(xg.shape, dtype=dt, device=dev, generator=g) + 0.05
            for stencil, aniso in STENCILS:
                kw = dict(stencil=stencil, aniso=aniso)
                tag = f"{stencil}{'' if aniso == (1.0, 1.0, 1.0) else ' aniso'}"
                halo = lambda *a: ref.stencil_halo_ref(*a, **kw)
                spmv = lambda a: ref.stencil_spmv_ref(a, **kw)
                yh = st.stencil_spmv_halo(x3, prev, nxt, bz=st.pick_bz(nz), **kw)
                ys = st.stencil_spmv(xg, bz=st.pick_bz(S * nz), **kw)
                yj = js.jacobi_stencil_sweep(xg, b, dinv, omega=0.8, bz=st.pick_bz(S * nz), **kw)
                ph = halo(x3, prev, nxt)
                ps = spmv(xg)
                pj = ref.jacobi_sweep_ref(xg, b, dinv, omega=0.8, **kw)
                sh = abs_product(halo, (x3, prev, nxt), stencil, aniso, x3)
                ss = abs_product(spmv, (xg,), stencil, aniso, xg)
                sj = xg.abs() + 0.8 * dinv * (b.abs() + ss)
                checks = [("stencil_spmv_halo", yh, ph, sh), ("stencil_spmv", ys, ps, ss),
                          ("jacobi_stencil_sweep", yj, pj, sj)]
                if nz >= 2:
                    yb = st.stencil_spmv_boundary(x3, prev, nxt, **kw)
                    out = torch.zeros_like(x3)
                    st.stencil_spmv_boundary(x3, prev, nxt, out=out, **kw)
                    pb = ref.stencil_boundary_ref(x3, prev, nxt, **kw)
                    checks.append(("stencil_spmv_boundary", yb, pb,
                                   sh[:, [0, nz - 1]].contiguous()))
                    torch.cuda.synchronize()
                    same = (torch.equal(yb[:, 0], yh[:, 0]) and torch.equal(yb[:, 1], yh[:, -1])
                            and torch.equal(out[:, [0, nz - 1]], yh[:, [0, nz - 1]])
                            and (nz == 2 or not bool(out[:, 1:-1].any())))
                    print(f"bitwise stencil_spmv_boundary {label:6s} {tname} {tag}: planes 0 "
                          f"and {nz - 1} (and out=) equal to stencil_spmv_halo's: {same}",
                          flush=True)
                    check(same, "stencil_spmv_boundary planes differ from the slab kernel's")
                torch.cuda.synchronize()
                for name, k, p, scale in checks:
                    e = float(((k - p).abs() / (2 * eps * scale).clamp(min=torch.finfo(dt).tiny)
                               ).max())
                    print(f"parity {name:21s} {label:6s} {tname} {tag:9s} {tuple(k.shape)}: "
                          f"{e:.3e} (limit 1, |k - p| / (2 eps |A||x|)); bitwise "
                          f"{torch.equal(k, p)}", flush=True)
                    check(e <= 1.0, f"{name} ({label}, {tag}, {tname}) disagrees with its "
                                    "plain version")
                    # every kernel repeats its plain version's operations
                    check(torch.equal(k, p), f"{name} ({label}, {tag}, {tname}) is not "
                                             "bitwise its plain version")
                # one grid, or its slabs with real halos: the same bits
                hp, hn = halo_planes(x3)
                yr = st.stencil_spmv_halo(x3, hp, hn, bz=st.pick_bz(nz), **kw)
                torch.cuda.synchronize()
                same = torch.equal(yr.reshape(xg.shape), ys)
                print(f"bitwise stencil_spmv ({S * nz}, {ny}, {nx}) {tname} {tag}: equal to "
                      f"stencil_spmv_halo on {S} slabs with real halos: {same}", flush=True)
                check(same, "stencil_spmv differs from the halo kernel with real halos")
                if label != "path" or dt != torch.float64 or aniso != (1.0, 1.0, 1.0):
                    continue
                by = x3.element_size()
                N, pl = xg.numel(), ny * nx
                k2 = 2 * (27 if stencil == "27pt" else 7)  # the JAX package's 2k flops
                kb = dict(kw, bz=st.pick_bz(nz))  # the kernels' z-block check
                errs = {n: float((k - p).abs().max()) for n, k, p, _ in checks}
                hx = lambda: torch.cat([prev[:, None], x3, nxt[:, None]], 1)[:, None]
                lib_h, _ = conv3d_library(stencil, aniso, hx, (0, 1, 1), x3)
                lib_s, note_s = conv3d_library(stencil, aniso, lambda: xg[None, None], 1, x3)
                print(f"library stencil SpMV: {note_s}", flush=True)
                cases = {
                    # bytes: each input read once, each output written once
                    "stencil_spmv_halo": (((2 * N + 2 * S * pl) * by, k2 * N),
                                          lambda: st.stencil_spmv_halo(x3, prev, nxt, **kb),
                                          lambda: halo(x3, prev, nxt), lib_h),
                    "stencil_spmv_boundary": ((8 * S * pl * by, k2 * 2 * S * pl),
                                              lambda: st.stencil_spmv_boundary(x3, prev, nxt,
                                                                               **kw),
                                              lambda: ref.stencil_boundary_ref(x3, prev, nxt,
                                                                               **kw),
                                              None),
                    "stencil_spmv": ((2 * N * by, k2 * N),
                                     lambda: st.stencil_spmv(xg, **kb),
                                     lambda: spmv(xg), lib_s),
                    "jacobi_stencil_sweep": ((4 * N * by, (k2 + 4) * N),
                                             lambda: js.jacobi_stencil_sweep(xg, b, dinv,
                                                                             omega=0.8, **kb),
                                             lambda: ref.jacobi_sweep_ref(xg, b, dinv,
                                                                          omega=0.8, **kw),
                                             None),
                }
                timed = {}
                for name, (work, kern, plain, lib) in cases.items():
                    timed[name] = time_row(name, work, kern, plain, lib, errs[name], tname,
                                           tag=f"{stencil} ", lib_calls=3)
                    if stencil == "7pt":
                        rows[name] = timed[name]
                # device times with L2 cold before each call, as the solver
                # finds its inputs (back-to-back event timing shows the host's
                # launch cadence for the short boundary kernel)
                for name, kname, n in (("stencil_spmv_boundary", "boundary_tile_kernel", 50),
                                       ("stencil_spmv", "halo_march_kernel", 20)):
                    dev_ms = profiled_ms(cases[name][1], kname, calls=n)
                    bb = timed[name]["bound_ms"]
                    print(f"profiled {name} {stencil} f64, L2 flushed: device {dev_ms:.4f} ms "
                          f"per call, bound {bb:.4f} ms ({100 * bb / dev_ms:.0f}%)", flush=True)
                if stencil == "7pt":
                    # a yardstick the port never calls: a plain device copy that
                    # moves the boundary kernel's bytes, under the same flush
                    half = torch.empty(4 * S * pl, dtype=dt, device=dev)
                    dst = torch.empty_like(half)
                    cp = profiled_ms(lambda: dst.copy_(half), None)
                    mb = half.numel() * by / 1e6
                    print(f"profiled copy_ of {mb:.1f} MB ({2 * mb:.1f} MB moved, the boundary "
                          f"kernel's bytes), L2 flushed: device {cp:.4f} ms", flush=True)
                    del half, dst
                del lib_h, lib_s, cases
            del x3, prev, nxt, xg, b, dinv
            torch.cuda.empty_cache()
    profiler_tally("the stencil kernel phase")
    return rows


def matrix_powers_phase(sess, dev):
    """``matrix_powers`` on the ``halo_depth = s`` ELL partition against s
    serial ``spmv_shard`` calls on the flat partition, for a seeded x:
    max |difference| over max |A^j x| <= 1e-12 for every power."""
    import numpy as np
    import torch

    from repro_torch.core.partition import pad_vector
    from repro_torch.core.spmv import matrix_powers, spmv_shard

    flat = sess.matrix()
    x = np.random.default_rng(4).standard_normal(sess.n)
    for s in SSTEP_S:
        deep = sess.matrix(halo_depth=s)
        key = sess.matrix_key("ell", BLOCK, s)
        t0 = time.perf_counter()
        got = matrix_powers(deep, torch.from_numpy(pad_vector(x, deep)).to(dev), s)
        torch.cuda.synchronize()
        t_mp = time.perf_counter() - t0
        v = torch.from_numpy(pad_vector(x, flat)).to(dev)
        errs = []
        for j in range(s):
            v = spmv_shard(flat, v, overlap=False)
            errs.append(float((got[j] - v).abs().max() / v.abs().max()))
        print(f"matrix_powers s={s}: halo_depth={deep.halo_depth} widths={deep.plan.widths} "
              f"ghost rows {deep.n_ghost_rows}/shard, partition "
              f"{sess.partition_s[key]:.2f} s, stored_bytes={deep.stored_bytes()} "
              f"(flat {flat.stored_bytes()}); first call {t_mp * 1e3:.1f} ms; "
              f"max|MP - serial|/max|A^j x| = {[f'{e:.2e}' for e in errs]}", flush=True)
        check(max(errs) <= 1e-12, f"matrix_powers s={s} disagrees with serial SpMVs")
        del got, v


def sstep_expected(s):
    """Launches of one s-step solve with ``it`` iterations, run ``1 + rep``
    times: each kernel once per s-iteration block (a solve that runs no
    block still runs its body once, as the JAX package charges it)."""
    def expected(it, rep):
        blocks = max(it // s, 1)
        return {k: (f"(1 + {rep}) x max({it} / {s}, 1)", (1 + rep) * blocks)
                for k in ("sstep_gram", "sstep_basis", "sstep_update")}
    return expected


# the kernels fcg and pipecg launch per loop iteration
LOOP_KERNELS = {"fcg": {"fused_dots_n": 1, "fused_axpy2": 2},
                "pipecg": {"fused_dots_n": 1, "fused_axpy2": 3}}


def loop_expected(variant):
    """Launches of one fcg or pipecg solve, run 1 + rep times: the loop
    runs iters - 1 times (the pre-loop step is iteration 1)."""
    return lambda it, rep: {
        name: (f"(1 + {rep}) x {k} x ({it} - 1)", (1 + rep) * k * (it - 1))
        for name, k in LOOP_KERNELS[variant].items()}


def later_paths(api):
    """``(tag, config, expected launches)`` of the paths after hs. fcg and
    pipecg run their loop iters - 1 times (the pre-loop step is iteration
    1); block-HS launches 1 setup Gram plus 2 Grams, 1 update2 and 1 update
    per iteration. Each solve runs 1 + repeats times."""
    return [
        ("fcg", api.SolverConfig(variant="fcg", maxiter=MAXITER), loop_expected("fcg")),
        ("pipecg", api.SolverConfig(variant="pipecg", maxiter=MAXITER),
         loop_expected("pipecg")),
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
    lead = next(iter(rep.summary))  # BCMGX-analog, or AmgX-analog
    want = expected(rep.summary[lead]["iters"], config.repeats)
    for name, n in got.items():
        formula, value = want.get(name, ("0", 0))
        print(f"launches {tag} {name:16s} {n} = {formula} -> {value}", flush=True)
        check(n == value, f"{tag}: {name} launched {n} times, expected {value}")
        launches[name] += n
    return rep


def profile_phase(sess, dev, variant: str = "hs", nrhs: int = 1, iters: int = 20,
                  fmt: str = "ell", seeded: bool = False, s: int = 2, grid=None):
    """Where an iteration's time goes: ``iters`` iterations of a path's
    solver on the ``fmt`` partition under ``torch.profiler``; prints device
    time per kernel name (per iteration) and the device's busy share of the
    wall time. ``seeded`` solves for a seeded random right-hand side (the
    SuiteSparse analogs' ``b = ones`` is ``A @ 1``, solved in one step).
    ``grid`` takes the session's 2-D grid partition (a pencil session's
    row blocks)."""
    import numpy as np
    import torch

    from repro_torch.core.cg import default_rhs_block, make_block_solver, make_solver
    from repro_torch.core.partition import pad_block, pad_vector

    mat = sess.matrix(fmt, BLOCK, halo_depth=s if variant == "sstep" else 1, grid=grid,
                      partition=sess.pencil[2] if grid else None)
    rng = np.random.default_rng(0)
    # a tolerance far below reach: exactly `iters` iterations run
    if nrhs > 1:
        solve = make_block_solver(mat, tol=1e-200, maxiter=iters, device=dev)
        B = (rng.standard_normal((sess.n, nrhs)) if seeded
             else default_rhs_block(sess.n, nrhs))
        b = torch.from_numpy(pad_block(B, mat)).to(dev)
    else:
        solve = make_solver(mat, variant=variant, s=s, tol=1e-200, maxiter=iters,
                            device=dev)
        bv = rng.standard_normal(sess.n) if seeded else np.ones(sess.n)
        b = torch.from_numpy(pad_vector(bv, mat)).to(dev)
    label = f"{variant} r={nrhs}" if nrhs > 1 else variant
    label += f" s={s}" if variant == "sstep" else ""
    label += f" grid {grid[0]}x{grid[1]}" if grid else ""
    profile_solve(f"{label} [{sess.key[0]}, {mat.fmt}]", solve, b, iters, variant)


def profile_solve(label, solve, b, iters: int, variant: str, torch_ops: bool = False):
    """Profile one ``solve(b, 0)`` that runs exactly ``iters`` iterations
    (after one warm-up solve): device time per kernel name per loop
    iteration, the device's busy share of the wall time, and the host's
    stream synchronisations and copies per iteration; ``torch_ops`` also
    prints device time by torch op. Returns the per-iteration counts of
    ``cudaStreamSynchronize``, ``cudaMemcpyAsync`` and host-to-device
    copies."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    evs = prof.key_averages()  # aggregated once: an AMG window holds ~10^5 events
    # device-side events only (kernels, memcpy/memset): the CPU ops that
    # launched them carry the same device time again
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in evs
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in rows)
    print(f"profile: {iters} {label} loop iterations, wall {wall * 1e3 / iters:.3f} ms/iter, "
          f"device busy {busy_us / 1e3 / iters:.3f} ms/iter "
          f"({100 * busy_us / 1e6 / wall:.1f}% of wall)", flush=True)
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {t / 1e3 / iters:8.4f} ms/iter  {count / iters:5.1f} calls/iter  "
              f"{key[:90]}", flush=True)
    host = {k: sum(e.count for e in evs if e.key == k) / iters
            for k in ("cudaStreamSynchronize", "cudaMemcpyAsync")}
    host["htod"] = sum(e.count for e in evs if e.device_type == DeviceType.CUDA
                       and "HtoD" in e.key) / iters
    print(f"  host per iteration: {host['cudaStreamSynchronize']:.2f} cudaStreamSynchronize, "
          f"{host['cudaMemcpyAsync']:.2f} cudaMemcpyAsync, {host['htod']:.2f} host-to-device "
          f"copies", flush=True)
    if torch_ops:
        ops = [(e.key, e.self_device_time_total, e.count) for e in evs
               if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
               and e.self_device_time_total > 0]
        for key, t, count in sorted(ops, key=lambda r: -r[1])[:10]:
            print(f"  torch op {t / 1e3 / iters:8.4f} ms/iter  {count / iters:6.1f} calls/iter  "
                  f"{key}", flush=True)
    return host


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
    interior; r = 1, 4 and NRHS) and at ragged ones (random tiles with R
    not a multiple of the tile, r = 1 and 3); timings at the path's shape
    in float64, each beside cuSPARSE's in the same run (the r = NRHS row
    goes into the JSON line, r = 4 is printed)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import spmv_bcsr as sb

    it = mat.interior
    S, R = mat.n_shards, mat.n_own_pad
    rows = {}
    g = torch.Generator(device=dev).manual_seed(2)
    for dt in (torch.float64, torch.float32):
        tname = str(dt).split(".")[1]
        cases = [("path", it.blocks.to(dt), it.bcol, it.n_brows, it.bpr, R, (1, 4, NRHS))]
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
                print(f"library {name} r={r}: {note}", flush=True)
                row = time_row(
                    name, (nbytes, flops),
                    lambda: kern(blocks, bcol, x, n_brows=NB, bpr=bpr),
                    lambda: plain(blocks, bcol, x, NB, bpr), lib,
                    float((k - p).abs().max()), tname, tag=f"r={r} ")
                if row["library_ms"] is not None:
                    print(f"same-run {name} r={r}: kernel / library = "
                          f"{row['ms'] / row['library_ms']:.3f}", flush=True)
                if r in (1, NRHS):  # r = 4 is printed only
                    rows[name] = row
                del lib
            del blocks, bcol
        torch.cuda.empty_cache()
    return rows


def handle_solve(tag, sess, mat, b_np, dev, launches, variant="hs", s=2):
    """hs (or ``variant``, with block size ``s`` for s-step) through the
    session's solver handle for ``b_np`` (the path a caller with their own
    right-hand side takes): one warm-up solve, then a timed one with every
    launch count set to 0 just before and read just after: relres and an
    independent scipy residual, and each kernel's launches against the
    count the iterations imply. Returns the iteration count."""
    import numpy as np
    import torch

    from repro_torch.core.partition import pad_vector, unpad_vector

    h = sess.solver(mat, variant=variant, s=s, tol=1e-8, maxiter=MAXITER)
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
    print(f"{tag}: format={mat.fmt} variant={variant} iters={it} relres={relres:.3e} "
          f"scipy_relres={sres:.3e} wall={wall:.4f} s per_iter={1e3 * wall / max(it, 1):.3f} ms",
          flush=True)
    check(relres <= 1e-8, f"{tag}: relres {relres} > 1e-8")
    check(sres <= 1e-7, f"{tag}: scipy residual {sres} > 1e-7")
    if variant == "sstep":
        want = sstep_expected(s)(it, 0)
    else:
        want = {k: (f"{it}", it) for k in ("fused_dots_n", "fused_axpy2_dots", "fused_axpy")}
    if mat.fmt == "bcsr":  # one SpMV before the loop, one per iteration
        want["bcsr_spmv"] = (f"1 + {it}", 1 + it)
    for name, n in got.items():
        formula, value = want.get(name, ("0", 0))
        print(f"launches {tag} {name:16s} {n} = {formula} -> {value}", flush=True)
        check(n == value, f"{tag}: {name} launched {n} times, expected {value}")
        launches[name] += n
    return it


def grid_paths(api, dev, spec, sess_1d, ref_1d, launches):
    """The 2-D process grid at full width: ``spec`` on a 2 x 2 grid through
    ``api.solve`` — the pencil-permuted matrix (its session built from the
    1-D session's matrix), hs then pipecg on one grid partition. Checks
    each variant's iterations within 1 of ``iters_1d[variant]``, relres,
    the scipy residual of the un-permuted ``x`` against the original
    matrix, the ledger's per-dimension halo bytes against the pencil
    model (their sum the 1-D ring's bytes) and the launches; prints ms per
    iteration beside the 1-D solve's (``ref_1d[variant] = (iters,
    wall_s)``); profiles 20 iterations of grid hs; then releases the grid
    session."""
    import numpy as np

    from repro_torch.matrices.poisson import cube
    from repro_torch.roofline.analysis import pencil_halo_widths

    grid = (2, 2)
    t0 = time.perf_counter()
    sess = api.session_for(spec, dev, grid=grid)
    _, perm, part = sess.pencil
    print(f"grid {grid[0]}x{grid[1]}: session {time.perf_counter() - t0:.2f} s, pencil reorder "
          f"{sess.reorder_s:.2f} s, row blocks {part.row_starts}", flush=True)
    widths = pencil_halo_widths(cube(spec.side, spec.stencil), grid)
    want_rows = 8.0 * sum(w for (di, _), w in widths.items() if di)
    want_cols = 8.0 * sum(w for (_, dj), w in widths.items() if dj)
    ring_b = sess_1d.matrix().plan.collective_bytes_per_shard(8)
    expect = {"hs": hs_expected("ell"), "pipecg": dict(
        (t, e) for t, _, e in later_paths(api))["pipecg"]}
    a1 = sess_1d.a
    ones = np.ones(sess.n)
    out = {}
    for variant in ("hs", "pipecg"):
        tag = f"grid-{variant}"
        cfg = api.SolverConfig(variant=variant, grid=f"{grid[0]}x{grid[1]}", maxiter=MAXITER)
        rep = solve_path(tag, api, spec, cfg, sess, launches, expect[variant])
        check(set(rep.summary) == {"BCMGX-analog"}, f"{tag}: legs {sorted(rep.summary)}")
        s = rep.summary["BCMGX-analog"]
        led = rep.ledger
        x = np.empty(sess.n)
        x[perm] = rep.outputs["BCMGX-analog"]  # back to the original order
        res = float(np.linalg.norm(ones - a1 @ x) / np.linalg.norm(ones))
        it, (it1, wall1) = s["iters"], ref_1d[variant]
        print(f"{tag}: iters {it} (1-D {it1}), relres {s['relres']:.3e}, scipy residual of "
              f"the un-permuted x {res:.3e}, halo_bytes_rows {led['halo_bytes_rows']:.0f} "
              f"halo_bytes_cols {led['halo_bytes_cols']:.0f} (pencil model {want_rows:.0f}, "
              f"{want_cols:.0f}; 1-D ring {ring_b}), partition "
              f"{rep.solvers['BCMGX-analog']['partition_s']:.2f} s, "
              f"{1e3 * s['wall_s'] / it:.3f} ms/iter against 1-D {variant} "
              f"{1e3 * wall1 / it1:.3f}", flush=True)
        check(abs(it - it1) <= 1, f"{tag}: {it} iterations, 1-D {it1}")
        check(res <= 1e-7, f"{tag}: scipy residual of the un-permuted x {res}")
        check(led["grid"] == list(grid), f"{tag}: ledger grid {led.get('grid')}")
        check((led["halo_bytes_rows"], led["halo_bytes_cols"]) == (want_rows, want_cols),
              f"{tag}: halo bytes {led['halo_bytes_rows']}, {led['halo_bytes_cols']}")
        check(want_rows + want_cols == ring_b, f"{tag}: rows + cols != the 1-D ring's bytes")
        out[variant] = it
    profile_phase(sess, dev, "hs", 1, grid=grid)
    api.SESSIONS.pop(sess.key).close()  # frees the card's copy before the next paths
    return out


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



def matfree_spmv_phase(sess, dev):
    """The stacked matrix-free SpMV (``make_matvec``) against scipy's
    ``A @ x``: poisson7 at side SIDE over SHARDS slabs (``sess.a``) and
    poisson27 at side 64, overlap on and off, for the ones vector and a
    seeded x: ``max |y - A x| / (|A| |x|) <= 1e-12``. Prints the time of
    one matrix-free SpMV beside the ELL ``spmv_shard`` on the same x."""
    import numpy as np
    import torch

    from repro_torch.core.partition import pad_vector
    from repro_torch.core.spmv import spmv_shard
    from repro_torch.core.stencil_solver import make_matvec
    from repro_torch.matrices.poisson import cube, poisson_scipy

    rng = np.random.default_rng(0)
    for p, a in ((cube(SIDE, "7pt"), sess.a), (cube(64, "27pt"), None)):
        a = poisson_scipy(p) if a is None else a
        absa = abs(a)
        xr = rng.standard_normal(p.n)
        for xname, xv in (("ones", np.ones(p.n)), ("random", xr)):
            want, scale = a @ xv, absa @ np.abs(xv)
            xd = torch.from_numpy(xv).to(dev).view(SHARDS, -1)
            for ov in (True, False):
                A = make_matvec(p, SHARDS, overlap=ov)
                y = A(xd).reshape(-1).cpu().numpy()
                err = float((np.abs(y - want) / scale).max())
                ms = time_ms(lambda: A(xd), rounds=5)
                print(f"matfree spmv {p.stencil} side {p.nx} overlap={ov} x={xname}: "
                      f"max|y - A@x|/(|A|@|x|) = {err:.3e}; {ms:.4f} ms per SpMV", flush=True)
                check(err <= 1e-12, f"matrix-free {p.stencil} SpMV disagrees with scipy")
            if p.stencil == "7pt" and xname == "random":
                m = sess.matrix()
                xe = torch.from_numpy(pad_vector(xv, m)).to(dev)
                print(f"ELL spmv_shard, same x: {time_ms(lambda: spmv_shard(m, xe), rounds=5):.4f}"
                      " ms per SpMV", flush=True)
        del absa


def matfree_expected(variant, s=2):
    """Launches of one matrix-free solve with ``it`` iterations on the split
    schedule (4 slabs, nz_loc >= 2): every SpMV launches one
    ``stencil_spmv_halo`` and one ``stencil_spmv_boundary``; hs runs 1 SpMV
    before its loop, fcg 2 and pipecg 3 before theirs (whose iteration count
    starts at 1), s-step 1 before and s per block; the vector kernels as on
    ELL."""
    def expected(it):
        if variant == "sstep":
            blocks = max(it // s, 1)
            n_a = (f"1 + {s} x max({it} / {s}, 1)", 1 + s * blocks)
            want = {k: (f"max({it} / {s}, 1)", blocks)
                    for k in ("sstep_gram", "sstep_basis", "sstep_update")}
        elif variant == "hs":
            n_a = (f"1 + {it}", 1 + it)
            want = {k: (f"{it}", it) for k in ("fused_dots_n", "fused_axpy2_dots", "fused_axpy")}
        else:
            pre, k2 = (2, 2) if variant == "fcg" else (3, 3)
            n_a = (f"{pre} + ({it} - 1)", pre + it - 1)
            want = {"fused_dots_n": (f"{it} - 1", it - 1),
                    "fused_axpy2": (f"{k2} x ({it} - 1)", k2 * (it - 1))}
        want.update(stencil_spmv_halo=n_a, stencil_spmv_boundary=n_a)
        return want
    return expected


def matfree_solve(tag, p, variant, dev, launches, s=2):
    """One matrix-free solve (``make_stencil_solver_fn``, b = ones, tol 1e-8)
    after a warm-up, with every launch count set to 0 just before and read
    just after: relres and each kernel's launches against the formula.
    Returns ``(result, wall seconds)``."""
    import torch

    from repro_torch.core.stencil_solver import make_stencil_solver_fn

    solve = make_stencil_solver_fn(p, SHARDS, variant=variant, tol=1e-8, maxiter=MAXITER, s=s,
                                   device=dev)
    b = torch.ones(SHARDS, p.n // SHARDS, dtype=torch.float64, device=dev)
    x0 = torch.zeros_like(b)
    solve(b, x0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = solve(b, x0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts()
    relres = float(res.rel_residual)
    check(relres <= 1e-8, f"{tag}: relres {relres} > 1e-8")
    check(bool(torch.isfinite(res.x).all()), f"{tag}: non-finite solution")
    want = matfree_expected(variant, s)(res.iters)
    for name, n in got.items():
        formula, value = want.get(name, ("0", 0))
        print(f"launches {tag} {name:21s} {n} = {formula} -> {value}", flush=True)
        check(n == value, f"{tag}: {name} launched {n} times, expected {value}")
        launches[name] += n
    return res, wall


def matfree_paths(sess, dev, ell, launches):
    """The matrix-free stencil CG on poisson7 at side SIDE over SHARDS slabs,
    float64, b = ones (the main path's), tol 1e-8: hs, fcg, pipecg and
    s-step (s = 2) — relres, an independent scipy residual, iterations
    within 2 of the same variant's ELL count ``ell[variant] = (iters,
    wall)`` in this run (s-step: a multiple of s, within s), ms per
    iteration beside ELL's; then hs on poisson27 at side SIDE, its residual
    from the plain ``stencil27_ref`` on the card (the scipy matrix would
    hold 453 M entries)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.matrices.poisson import cube

    s = SSTEP_S[0]
    ones = np.ones(sess.n)
    for variant in ("hs", "fcg", "pipecg", "sstep"):
        tag = f"matfree-{variant}"
        res, wall = matfree_solve(tag, cube(SIDE, "7pt"), variant, dev, launches, s)
        x = res.x.reshape(-1).cpu().numpy()
        sres = float(np.linalg.norm(ones - sess.a @ x) / np.linalg.norm(ones))
        it, (it_ell, wall_ell) = res.iters, ell[variant]
        print(f"{tag}: iters={it} (ELL {it_ell}) relres={float(res.rel_residual):.3e} "
              f"scipy_relres={sres:.3e} wall={wall:.4f} s per_iter={1e3 * wall / it:.3f} ms "
              f"(ELL {1e3 * wall_ell / it_ell:.3f} ms)", flush=True)
        check(sres <= 1e-7, f"{tag}: scipy residual {sres} > 1e-7")
        if variant == "sstep":
            check(it % s == 0 and abs(it - it_ell) <= s,
                  f"{tag}: {it} iterations against ELL's {it_ell}")
        else:
            check(abs(it - it_ell) <= 2, f"{tag}: {it} iterations against ELL's {it_ell}")
    p27 = cube(SIDE, "27pt")
    res, wall = matfree_solve("matfree-hs-27pt", p27, "hs", dev, launches)
    bg = torch.ones((SIDE,) * 3, dtype=torch.float64, device=dev)
    r = bg - ref.stencil27_ref(res.x.view((SIDE,) * 3))
    tres = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(bg))
    print(f"matfree-hs-27pt: iters={res.iters} relres={float(res.rel_residual):.3e} "
          f"stencil27_ref_relres={tres:.3e} wall={wall:.4f} s "
          f"per_iter={1e3 * wall / res.iters:.3f} ms", flush=True)
    check(tres <= 1e-7, f"matfree-hs-27pt: residual {tres} > 1e-7")


def jacobi_path(dev, launches):
    """Ten fused l1-Jacobi sweeps (``ops.jacobi_stencil_sweep``, omega 1) on
    poisson7's global side³ grid, b = ones, ``dinv`` the inverse l1 row sums
    ``1 / (2 d - A 1)`` (d = 6), the residual after each sweep from
    ``ops.stencil_spmv``: it must fall monotonically, each sweep must equal
    the plain version bit for bit (``|k - p| / (2 eps (|x| + |dinv| (|b| +
    |A||x|)))`` printed beside), and the last residual the plain
    ``stencil7_ref``'s.
    Launch counts: 10 sweeps, 11 SpMVs."""
    import torch

    from repro_torch.kernels import ops, ref

    shape = (SIDE,) * 3
    b = torch.ones(shape, dtype=torch.float64, device=dev)
    dinv = 1.0 / (12.0 - ref.stencil7_ref(torch.ones_like(b)))
    x = torch.zeros_like(b)
    eps = torch.finfo(b.dtype).eps
    reset_launches()
    res = [float(torch.linalg.vector_norm(b - ops.stencil_spmv(x)))]
    worst, bitwise = 0.0, True
    for _ in range(10):
        xn = ops.jacobi_stencil_sweep(x, b, dinv)
        xp = ref.jacobi_sweep_ref(x, b, dinv)
        scale = x.abs() + dinv * (b + 12.0 * x.abs() - ref.stencil7_ref(x.abs()))
        worst = max(worst, float(((xn - xp).abs() / (2 * eps * scale)).max()))
        bitwise = bitwise and torch.equal(xn, xp)
        x = xn
        res.append(float(torch.linalg.vector_norm(b - ops.stencil_spmv(x))))
    got = launch_counts()
    plain = float(torch.linalg.vector_norm(b - ref.stencil7_ref(x)))
    print(f"jacobi: residual {res[0]:.6e} -> {res[-1]:.6e} over 10 sweeps "
          f"(plain stencil7_ref: {plain:.6e}); worst sweep |k - p| / (2 eps scale) = "
          f"{worst:.3e}; every sweep bitwise the plain version: {bitwise}", flush=True)
    check(all(r1 < r0 for r0, r1 in zip(res, res[1:])), f"jacobi residuals not falling: {res}")
    check(bitwise, "jacobi_stencil_sweep is not bitwise its plain version")
    check(abs(plain - res[-1]) <= 1e-12 * res[-1], "jacobi residual disagrees with the plain one")
    want = {"jacobi_stencil_sweep": ("10", 10), "stencil_spmv": ("1 + 10", 11)}
    for name, n in got.items():
        formula, value = want.get(name, ("0", 0))
        print(f"launches jacobi {name:21s} {n} = {formula} -> {value}", flush=True)
        check(n == value, f"jacobi: {name} launched {n} times, expected {value}")
        launches[name] += n


AMG_SIDE_AMGX = 128  # the AmgX analog's side: its scan matcher is a host loop


def amg_expected(variant, n_lv):
    """Launches of one AMG-PCG ``api.solve`` (1 warm-up + ``rep`` timed
    solves) with ``n_lv`` V-cycle levels above the coarse solve: each
    V-cycle runs 15 ``fused_axpy`` per level (3 + 4 smoothing sweeps of two
    updates, one residual). hs applies it once before the loop and once per
    iteration, beside 2 dots, 1 ``fused_axpy2_dots`` and 1 ``fused_axpy``;
    fcg once before the loop and once per loop iteration (iters - 1), beside
    1 dots and 2 ``fused_axpy2``; pipecg twice before the loop and once per
    loop iteration, beside 1 dots and 4 ``fused_axpy2``."""
    v = 15 * n_lv

    def expected(it, rep):
        k = 1 + rep
        if variant == "hs":
            return {"fused_dots_n": (f"{k} x 2 x {it}", k * 2 * it),
                    "fused_axpy2_dots": (f"{k} x {it}", k * it),
                    "fused_axpy": (f"{k} x ({it} + {v} x (1 + {it}))", k * (it + v * (1 + it)))}
        pre = 1 if variant == "fcg" else 2
        per = 2 if variant == "fcg" else 4
        return {"fused_dots_n": (f"{k} x ({it} - 1)", k * (it - 1)),
                "fused_axpy2": (f"{k} x {per} x ({it} - 1)", k * per * (it - 1)),
                "fused_axpy": (f"{k} x {v} x ({pre} + {it} - 1)", k * v * (pre + it - 1))}
    return expected


def amg_setup(tag, sess, amgx_analog=False):
    """The session's AMG preconditioner, built here (the solves after it
    report no setup): prints the setup seconds and their split, the level
    rows and the operator complexity; returns ``(precond, info)``."""
    check(bool(amgx_analog) not in sess.amgs, f"{tag}: the session already holds its AMG")
    pre, info, setup_s = sess.amg(amgx_analog)
    split = ", ".join(f"{k} {v:.2f} s" for k, v in info.setup_s.items())
    print(f"{tag} setup: {setup_s:.2f} s ({split}); {info.n_levels} levels, rows "
          f"{list(info.level_rows)}, nnz {list(info.level_nnz)}, operator complexity "
          f"{info.operator_complexity:.4f}", flush=True)
    return pre, info


def amg_paths(api, spec, sess, dev, launches, hs_iters):
    """AMG-PCG (the BCMG analog) on the main path's matrix: hs, fcg and
    pipecg through ``api.solve(amg=True)`` on the session, which builds the
    hierarchy once; each within half of hs's iterations. Returns the
    preconditioner and the iterations per variant."""
    import torch

    pre, info = amg_setup("amg", sess)
    n_lv = info.n_levels - 1
    its = {}
    for variant in ("hs", "fcg", "pipecg"):
        torch.cuda.empty_cache()
        rep = solve_path(f"amg-{variant}", api, spec,
                         api.SolverConfig(amg=True, variant=variant, maxiter=MAXITER),
                         sess, launches, amg_expected(variant, n_lv))
        check(set(rep.summary) == {"BCMGX-analog"}, f"amg legs {set(rep.summary)}")
        check(rep.ledger["amg"]["level_rows"] == list(info.level_rows), "amg payload")
        check(rep.solvers["BCMGX-analog"]["setup_s"] == 0.0, f"amg-{variant}: setup reported "
              "by a solve that reused the session's hierarchy")
        its[variant] = rep.summary["BCMGX-analog"]["iters"]
        print(f"amg-{variant}: iters {its[variant]} against hs {hs_iters} without AMG", flush=True)
        check(its[variant] < hs_iters / 2, f"amg-{variant}: {its[variant]} iterations, "
              f"not fewer than half of hs's {hs_iters}")
    return pre, its


def amgx_paths(api, dev, launches):
    """The AmgX analog (plain weights, scan matcher) and, for the same
    matrix, hs without AMG (the half-the-iterations mark): poisson7 at
    side AMG_SIDE_AMGX over SHARDS shards."""
    import numpy as np

    spec = api.ProblemSpec("poisson7", side=AMG_SIDE_AMGX, shards=SHARDS)
    sess = api.session_for(spec, dev)
    it_hs = handle_solve(f"hs-{AMG_SIDE_AMGX}", sess, sess.matrix(), np.ones(sess.n), dev,
                         launches)
    tag = f"amgx_analog-{AMG_SIDE_AMGX}"
    pre, info = amg_setup(tag, sess, amgx_analog=True)
    rep = solve_path(tag, api, spec, api.SolverConfig(maxiter=MAXITER, amgx_analog=True), sess,
                     launches, amg_expected("hs", info.n_levels - 1))
    check(set(rep.summary) == {"AmgX-analog"}, f"{tag} legs {set(rep.summary)}")
    it = rep.summary["AmgX-analog"]["iters"]
    print(f"side {AMG_SIDE_AMGX}: hs {it_hs}, AmgX analog {it} iterations", flush=True)
    check(it < it_hs / 2, f"{tag}: {it} iterations, not fewer than half of hs's {it_hs}")
    api.SESSIONS.pop(sess.key, None)
    sess.close()  # frees the card's copy before the profiles


def matcher_phase(dev, a_main):
    """The torch locally-dominant matcher on the card against the numpy
    matcher, on poisson7 at side 64 (compatible and plain weights) and a
    seeded random symmetric graph: the same ``match`` array; both timed.
    Then the torch matcher alone on the compatible weights of the main
    path's first shard (``a_main``'s first quarter of rows), timed with
    the host's weights and ELL padding."""
    import numpy as np
    import scipy.sparse as sp

    from repro_torch.core.amg import matching as m
    from repro_torch.matrices.poisson import cube, poisson_scipy

    a = poisson_scipy(cube(64, "7pt"))
    rng = np.random.default_rng(3)
    n, e = 100_000, 500_000
    g = sp.coo_matrix((rng.random(e) + 0.1, (rng.integers(0, n, e), rng.integers(0, n, e))),
                      shape=(n, n)).tocsr()
    g = g + g.T
    g.setdiag(0)
    g.eliminate_zeros()
    cases = {"poisson7-64 compatible": m.compatible_weights(a),
             "poisson7-64 plain": m.plain_weights(a), "random graph": g.tocsr()}
    for name, w in cases.items():
        wd, wc = m.weights_to_ell(w)
        m.locally_dominant_matching(wd, wc, device=dev)  # warm-up
        t0 = time.perf_counter()
        got = m.locally_dominant_matching(wd, wc, device=dev)
        t1 = time.perf_counter()
        want = m.locally_dominant_matching_np(wd, wc)
        t2 = time.perf_counter()
        same = bool((got == want).all())
        print(f"matcher {name}: n={len(got)} k={wd.shape[1]} torch on the card equal to numpy: "
              f"{same}; {(got != np.arange(len(got))).sum()} matched; torch {1e3 * (t1 - t0):.1f} "
              f"ms, numpy {1e3 * (t2 - t1):.1f} ms", flush=True)
        check(same, f"matcher {name}: the torch matcher on the card differs from numpy")
    R = a_main.shape[0] // SHARDS
    t0 = time.perf_counter()
    w = m.compatible_weights(a_main[:R, :R])
    t1 = time.perf_counter()
    wd, wc = m.weights_to_ell(w)
    t2 = time.perf_counter()
    got = m.locally_dominant_matching(wd, wc, device=dev)
    t3 = time.perf_counter()
    print(f"matcher main path shard 0 (n={R}): weights {t1 - t0:.2f} s, ELL {t2 - t1:.2f} s, "
          f"torch matcher on the card {t3 - t2:.2f} s ({(got != np.arange(R)).sum()} matched)",
          flush=True)


def flushed_event_ms(fn, calls: int = 10) -> float:
    """Median device time of one ``fn()`` call, each after a 64 MB write
    that flushes L2, from CUDA events around the call alone. A spin kernel
    queued first lets the host enqueue every call before the card reaches
    it, so no host gap falls between a call's events (without it a call of
    a few microseconds times the host's launch path)."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # about 10 ms of the card's clock
    ev = []
    for _ in range(calls):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush.zero_()
        e0.record()
        fn()
        e1.record()
        ev.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in ev)


def axpy_levels_phase(pre):
    """``fused_axpy`` with a Python-number scalar (as the V-cycle calls it)
    at the AMG levels' per-shard lengths: held against its plain version
    within 2 eps (the odd lengths run the per-shard head and tail), then
    timed against ``torch.addcmul`` in 6 alternating pairs of L2-flushed
    event times (``flushed_event_ms``)."""
    import torch

    from repro_torch.kernels import fused_reductions as fr
    from repro_torch.kernels import ref

    levels, _ = pre.data
    g = torch.Generator(device="cuda").manual_seed(9)
    a = torch.tensor(-1.0, dtype=torch.float64, device="cuda")
    eps = torch.finfo(torch.float64).eps
    for lev in levels:
        R = lev.p_data.shape[-1]
        x, y = (torch.randn(SHARDS, R, dtype=torch.float64, device="cuda", generator=g)
                for _ in range(2))
        err = axpy_ok(fr.fused_axpy(-1.0, x, y), ref.fused_axpy_ref(-1.0, x, y), -1.0, x, y, eps)
        print(f"fused_axpy at an AMG level, S={SHARDS} R={R}: max |kernel - plain| / "
              f"(2 eps (|a x| + |y|)) = {err:.3e}", flush=True)
        check(err <= 1.0, f"fused_axpy at R={R} disagrees with its plain version: {err}")
        tk, tl = [], []
        for i in range(6):
            for side in ((0, 1) if i % 2 == 0 else (1, 0)):
                if side == 0:
                    tk.append(flushed_event_ms(lambda: fr.fused_axpy(-1.0, x, y)))
                else:
                    tl.append(flushed_event_ms(lambda: torch.addcmul(y, a, x)))
        ratios = [p / q for p, q in zip(tk, tl)]
        bound = 3 * SHARDS * R * 8 / HBM_BYTES_PER_S * 1e3
        print(f"fused_axpy at an AMG level, S={SHARDS} R={R}: kernel {statistics.median(tk):.5f} "
              f"ms, addcmul {statistics.median(tl):.5f} ms, median ratio "
              f"{statistics.median(ratios):.4f} (range {min(ratios):.4f}-{max(ratios):.4f}), "
              f"bound {bound:.5f} ms", flush=True)


def profile_amg(sess, dev, pre, variant, iters=20):
    """20 iterations of AMG-PCG ``variant`` under the profiler: device time
    by kernel and by torch op, the busy share, and host syncs per
    iteration: one (the loop test) and no host-to-device copy."""
    import numpy as np
    import torch

    from repro_torch.core.cg import make_solver
    from repro_torch.core.partition import pad_vector

    mat = sess.matrix()
    solve = make_solver(mat, variant=variant, precond=pre, tol=1e-200, maxiter=iters,
                        device=dev)
    b = torch.from_numpy(pad_vector(np.ones(sess.n), mat)).to(dev)
    host = profile_solve(f"amg {variant} [{sess.key[0]} side {sess.key[1]}, ell]", solve, b,
                         iters, variant, torch_ops=True)
    check(host["cudaStreamSynchronize"] <= 1.0 and host["htod"] == 0,
          f"amg {variant}: {host} per iteration, not one sync and no host-to-device copy")


def solve_expected(variant, fmt, nrhs=1, s=2):
    """Launches of one solve of ``variant`` (block-HS when ``nrhs > 1``) on a
    ``fmt`` interior with ``it`` iterations, run ``1 + rep`` times: its
    vector kernels as :func:`hs_expected`, :func:`loop_expected`,
    :func:`sstep_expected` and :func:`block_expected` say, and on BCSR one
    product per SpMV: hs and fcg 1 + it (fcg's pre-loop step has two),
    pipecg it + 2 (three before its loop), s-step 1 + s per block."""
    if nrhs > 1:
        return block_expected(fmt)
    if variant == "hs":
        return hs_expected(fmt)
    vec = sstep_expected(s) if variant == "sstep" else loop_expected(variant)
    if fmt != "bcsr":
        return vec

    def expected(it, rep):
        want = vec(it, rep)
        if variant == "sstep":
            f, v = f"1 + {s} x max({it} / {s}, 1)", 1 + s * max(it // s, 1)
        else:
            k = 1 if variant == "fcg" else 2
            f, v = f"{it} + {k}", it + k
        want["bcsr_spmv"] = (f"(1 + {rep}) x ({f})", (1 + rep) * v)
        return want
    return expected


def tuned_expected(sess, nrhs=1):
    """Launches of one tuned ``api.solve`` through ``sess``: each executed
    trial of ``sess.tune`` (one solve of its candidate at its iterations),
    then the winner's solve, run 1 + rep times, or rep times when the
    session's handle for it was warm already (an earlier path of the
    session solved the same configuration). Made before the solve, read
    after it."""
    warm = {k for k, h in sess.handles.items() if h.warmed}

    def expected(it, rep):
        if not {k for k, h in sess.handles.items() if h.warmed} - warm:
            rep -= 1  # no warm-up solve ran: "1 + (rep - 1)"
        tune = sess.tune
        trials = {}
        for t in tune.trials:
            if t.executed:
                c = t.candidate
                for name, (_, v) in solve_expected(c.variant, c.fmt, nrhs, c.s)(
                        t.iters_trial, 0).items():
                    trials[name] = trials.get(name, 0) + v
        ch = tune.chosen
        want = solve_expected(ch.variant, ch.fmt, nrhs, ch.s)(it, rep)
        for name in set(want) | set(trials):
            f, v = want.get(name, ("0", 0))
            want[name] = (f"trials {trials.get(name, 0)} + {f}", trials.get(name, 0) + v)
        return want
    return expected


def trial_iters_expected(c, iters=TUNE_ITERS) -> int:
    """Iterations a trial that does not converge runs: ``iters``, or for
    s-step the whole blocks that reach it."""
    return -(-iters // c.s) * c.s if c.variant == "sstep" else iters


def tune_report(tag, sess, rep, t_phase, parts0):
    """Print and check one tuned ``api.solve``'s decision: each trial's
    label, iterations and predicted and modeled time and energy; the prune
    and trial seconds, the phase's, the partitions made; DEFAULT among the
    trials and never scoring better than the winner; every executed trial
    ran its iterations unless it converged. Returns the TuneResult."""
    from repro_torch.autotune import DEFAULT

    tune = sess.tune
    led = rep.ledger["autotune"]
    check(led == tune.ledger_section(), f"{tag}: ledger autotune section")
    for t in tune.trials:
        c = t.candidate
        print(f"{tag} trial {c.label:28s} executed={t.executed!s:5} iters_trial={t.iters_trial} "
              f"relres={t.relres_trial:.3e} iters_est={t.iters_est} predicted "
              f"{t.predicted_time_s:.6e} s {t.predicted_energy_j:.6e} J, modeled "
              f"{t.measured_time_s:.6e} s {t.measured_energy_j:.6e} J, score {t.score:.6e}",
              flush=True)
        if t.executed and t.relres_trial > 1e-8:
            want = trial_iters_expected(c)
            check(t.iters_trial == want, f"{tag}: trial {c.label} ran {t.iters_trial}, not {want}")
    print(f"{tag}: objective={tune.objective} chosen={tune.chosen.label} cached={tune.cached} "
          f"space={tune.candidates_total} pruned={tune.candidates_pruned} "
          f"trialed={tune.candidates_trialed}; prune {tune.prune_s:.2f} s, trials "
          f"{tune.trial_s:.2f} s, phase {time.perf_counter() - t_phase:.2f} s, partitions made "
          f"{sess.partitions - parts0} (session {sess.stats()})", flush=True)
    if not tune.cached:
        by_cand = {t.candidate: t for t in tune.trials}
        check(DEFAULT in by_cand, f"{tag}: DEFAULT not among the trials")
        check(by_cand[tune.chosen].score <= by_cand[DEFAULT].score,
              f"{tag}: the winner scores above DEFAULT")
        check(tune.trials[0].candidate == tune.chosen, f"{tag}: trials not best first")
    return tune


def autotune_phase(api, spec, sess, dev, launches, ell, block_iters, wide=TUNE_WIDE):
    """The energy-aware tuner through ``api.solve(autotune=True)`` on the
    main path's session, with a cache file in a directory made here and
    removed after (a stale cache cannot turn the first call into a hit):

    a. objective energy, budget TUNE_BUDGET[0]: not cached, 108 candidates;
       the winner within 1 iteration of its variant's 1-D ELL count
       (``ell[variant] = (iters, wall_s)``), its wall per iteration beside
       the 1-D hs's and the tuner's modeled time per iteration;
    b. the same call: cached, no trial, no new partition, the same winner;
    c. ``nrhs = NRHS``, budget TUNE_BUDGET[1]: 36 candidates, block-HS, the
       winner within 1 iteration of the block path's ``block_iters``;
    d. poisson7 at side ``wide[0]`` on ``wide[1]`` shards, objective time:
       432 candidates, the grid and s-step candidates priced (the best of
       each printed), the winner's solve (a grid winner's ledger carries
       the grid and its halo bytes); the session is closed after.

    Each solve goes through :func:`solve_path` (relres, scipy residual,
    launches of the trials plus the winner's solves)."""
    import math
    import shutil
    import tempfile

    from repro_torch.autotune import enumerate_space, interior_stats
    from repro_torch.autotune.prune import format_stored_bytes, predict
    from repro_torch.core.partition import default_grid
    from repro_torch.energy.accounting import CostModel

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="autotune-", dir=os.path.join(ROOT, "build"))
    try:
        cache = os.path.join(tmp, "cache.json")
        cfg = api.SolverConfig(autotune=True, tune_budget=TUNE_BUDGET[0], tune_cache=cache,
                               maxiter=MAXITER)
        chosen = None
        for step in ("a", "b"):
            tag = f"tune-{step}"
            t0, parts0 = time.perf_counter(), sess.partitions
            rep = solve_path(tag, api, spec, cfg, sess, launches, tuned_expected(sess))
            tune = tune_report(tag, sess, rep, t0, parts0)
            ch = tune.chosen
            s = rep.summary["BCMGX-analog"]
            it1, wall1 = ell[ch.variant]
            t_win = next((t for t in tune.trials if t.candidate == ch), None)
            modeled = (f"{1e3 * t_win.measured_time_s / t_win.iters_est:.6f} ms/iter"
                       if t_win else "no trial (cached)")
            print(f"{tag}: winner {ch.label} iters {s['iters']} (1-D ELL {ch.variant} {it1}), "
                  f"card {1e3 * s['wall_s'] / s['iters']:.3f} ms/iter against 1-D hs "
                  f"{1e3 * ell['hs'][1] / ell['hs'][0]:.3f}; tuner's modeled {modeled}; the "
                  f"solve's modeled {1e3 * s['modeled_s'] / s['iters']:.6f} ms/iter", flush=True)
            check(abs(s["iters"] - it1) <= 1, f"{tag}: {s['iters']} iterations, 1-D {it1}")
            check(set(rep.summary) == {"BCMGX-analog"}, f"{tag}: legs {sorted(rep.summary)}")
            if step == "a":
                check(not tune.cached and tune.candidates_total == 108,
                      f"{tag}: cached={tune.cached} space {tune.candidates_total}")
                chosen = ch
            else:
                check(tune.cached and tune.candidates_trialed == 0 and ch == chosen
                      and sess.partitions == parts0,
                      f"{tag}: not a clean cache hit ({tune.cached}, {ch.label})")

        tag = "tune-c"
        t0, parts0 = time.perf_counter(), sess.partitions
        cfg = api.SolverConfig(autotune=True, tune_budget=TUNE_BUDGET[1], tune_cache=cache,
                               nrhs=NRHS, maxiter=MAXITER)
        rep = solve_path(tag, api, spec, cfg, sess, launches, tuned_expected(sess, NRHS))
        tune = tune_report(tag, sess, rep, t0, parts0)
        it = rep.summary["BCMGX-analog"]["iters"]
        print(f"{tag}: winner {tune.chosen.label} block iters {it} (ELL block path "
              f"{block_iters}), per_solve_wall "
              f"{rep.solvers['BCMGX-analog']['per_solve_wall_s']:.4f} s", flush=True)
        check(not tune.cached and tune.candidates_total == 36 and tune.chosen.variant == "hs",
              f"{tag}: cached={tune.cached} space {tune.candidates_total} {tune.chosen.label}")
        check(abs(it - block_iters) <= 1, f"{tag}: {it} iterations, ELL block {block_iters}")

        tag = "tune-d"
        t0 = time.perf_counter()
        wspec = api.ProblemSpec("poisson7", side=wide[0], shards=wide[1])
        wsess = api.session_for(wspec, dev)
        print(f"{tag}: poisson7 side {wide[0]} on {wide[1]} shards, n={wsess.n}, session "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        parts0 = wsess.partitions
        cfg = api.SolverConfig(autotune=True, objective="time", tune_budget=TUNE_BUDGET[0],
                               tune_cache=cache, maxiter=MAXITER)
        rep = solve_path(tag, api, wspec, cfg, wsess, launches, tuned_expected(wsess))
        tune = tune_report(tag, wsess, rep, t0, parts0)
        check(not tune.cached and tune.candidates_total == 432,
              f"{tag}: cached={tune.cached} space {tune.candidates_total}")
        # the model stage's price of the grid and s-step candidates, beside 1-D hs
        g = default_grid(wide[1])
        mat = wsess.matrix()
        stored = format_stored_bytes(interior_stats(wsess.a, mat.row_starts))
        cost = CostModel()
        preds = [predict(mat, c, stored, cost=cost, objective="time")
                 for c in enumerate_space(grids=(None, g), sstep_s=(2, 4, 6)) if c.fmt != "auto"]
        for what, keep in (("1-D hs", lambda c: c.grid is None and c.variant == "hs"),
                           (f"grid {g[0]}x{g[1]}", lambda c: c.grid == g),
                           ("s-step", lambda c: c.variant == "sstep")):
            best = min((p for p in preds if keep(p.candidate)), key=lambda p: p.time_s)
            check(math.isfinite(best.time_s) and best.time_s > 0, f"{tag}: {what} not priced")
            print(f"{tag}: best predicted {what}: {best.candidate.label} "
                  f"{1e3 * best.time_s:.6f} ms/iter", flush=True)
        ch = tune.chosen
        led = rep.ledger
        if ch.grid is not None:
            plan = wsess.mats[wsess.matrix_key(ch.fmt, ch.block, ch.s if ch.variant == "sstep"
                                               else 1, ch.grid)].plan
            rows_b, cols_b = plan.dim_bytes_per_shard(8)
            check(led["grid"] == list(ch.grid) and (led["halo_bytes_rows"],
                  led["halo_bytes_cols"]) == (float(rows_b), float(cols_b)),
                  f"{tag}: grid ledger {led.get('grid')}")
            print(f"{tag}: grid winner, halo_bytes_rows {led['halo_bytes_rows']:.0f} "
                  f"halo_bytes_cols {led['halo_bytes_cols']:.0f}", flush=True)
        api.SESSIONS.pop(wsess.key, None)
        wsess.close()  # frees the card's copy before the next paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
        used = [line for line in log.splitlines() if "Used" in line]
        regs = sorted(int(line.split("Used")[1].split()[0]) for line in used) or [0]
        print(f"  {name}: {len(used)} kernels, {regs[0]}-{regs[-1]} registers", flush=True)
        for line in ptxas_report(log):
            print(f"  ptxas {line}", flush=True)

    stamp("the kernel build")
    rows = kernel_phase(dev)
    torch.cuda.empty_cache()
    rows.update(block_kernel_phase(dev))
    torch.cuda.empty_cache()
    rows.update(sstep_kernel_phase(dev))
    torch.cuda.empty_cache()
    rows.update(stencil_kernel_phase(dev))
    torch.cuda.empty_cache()
    stamp("the kernel phases")

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

    stamp("the main path and the SpMV path")
    # --- the later slices' paths on the same session --------------------
    reps = {}
    for tag, cfg, expected in later_paths(api):
        torch.cuda.empty_cache()
        reps[tag] = solve_path(tag, api, spec, cfg, sess, launches, expected)
    e_b = reps["block"].solvers["BCMGX-analog"]
    print(f"per_solve_wall_s: block-HS r={NRHS} {e_b['per_solve_wall_s']:.4f} s, "
          f"hs r=1 {hs_wall:.4f} s", flush=True)

    stamp("fcg, pipecg and block-HS")
    # --- the 2-D process grid: hs and pipecg on a 2 x 2 pencil grid --------
    torch.cuda.empty_cache()
    s_pipe = reps["pipecg"].summary["BCMGX-analog"]
    grid_paths(api, dev, spec, sess, dict(hs=(hs_iters, hs_wall),
                                          pipecg=(s_pipe["iters"], s_pipe["wall_s"])), launches)
    torch.cuda.empty_cache()
    stamp("the 2-D grid")
    # --- s-step CG: matrix powers, api.solve (s = 2), the handle (s = 4) --
    torch.cuda.empty_cache()
    matrix_powers_phase(sess, dev)
    s0 = SSTEP_S[0]
    rep_ss = solve_path("sstep", api, spec, api.SolverConfig(variant="sstep", maxiter=MAXITER),
                        sess, launches, sstep_expected(s0))
    led = rep_ss.ledger
    check((led["halo_depth"], led["s"]) == (s0, s0), f"sstep payload {led.get('halo_depth')}")
    it_ss = rep_ss.summary["BCMGX-analog"]["iters"]
    w_ss = rep_ss.summary["BCMGX-analog"]["wall_s"]
    print(f"sstep s={s0}: iters {it_ss} (hs {hs_iters}), per_solve {w_ss:.4f} s "
          f"({1e3 * w_ss / it_ss:.3f} ms/iter) against hs {hs_wall:.4f} s "
          f"({1e3 * hs_wall / hs_iters:.3f} ms/iter)", flush=True)
    check(it_ss % s0 == 0, f"sstep iterations {it_ss} not a multiple of {s0}")
    s1 = SSTEP_S[1]
    b5 = np.random.default_rng(5).standard_normal(sess.n)
    it_hs5 = handle_solve("hs-seeded", sess, sess.matrix(), b5, dev, launches)
    it4 = handle_solve(f"sstep-s{s1}-seeded", sess, sess.matrix(halo_depth=s1), b5, dev,
                       launches, variant="sstep", s=s1)
    print(f"sstep s={s1} seeded: iters {it4} against hs {it_hs5} on the same b", flush=True)
    check(it4 % s1 == 0, f"sstep s={s1} iterations {it4} not a multiple of {s1}")

    stamp("s-step")
    # --- AMG-PCG (the BCMG analog) on the main path's matrix --------------
    torch.cuda.empty_cache()
    matcher_phase(dev, sess.a)
    stamp("the matcher phase")
    pre_amg, _ = amg_paths(api, spec, sess, dev, launches, hs_iters)
    stamp("AMG-PCG at side 256")
    axpy_levels_phase(pre_amg)
    stamp("fused_axpy at the AMG levels")

    # --- the matrix-free stencil path: SpMV, solves, Jacobi sweeps ---------
    torch.cuda.empty_cache()
    matfree_spmv_phase(sess, dev)
    ell = {v: (reps[v].summary["BCMGX-analog"]["iters"], reps[v].summary["BCMGX-analog"]["wall_s"])
           for v in ("fcg", "pipecg")}
    ell.update(hs=(hs_iters, hs_wall), sstep=(it_ss, w_ss))
    matfree_paths(sess, dev, ell, launches)
    jacobi_path(dev, launches)
    stamp("the matrix-free path")

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
    stamp("the interior formats")
    # --- the energy-aware tuner (api.solve with autotune=True) ------------
    torch.cuda.empty_cache()
    autotune_phase(api, spec, sess, dev, launches, ell,
                   reps["block"].summary["BCMGX-analog"]["iters"])
    torch.cuda.empty_cache()
    stamp("the tuner")
    # --- the AmgX analog at side AMG_SIDE_AMGX ---------------------------
    torch.cuda.empty_cache()
    amgx_paths(api, dev, launches)
    stamp("the AmgX analog")
    for name, n in launches.items():
        rows[name]["launches"] = n

    for variant, nrhs in (("hs", 1), ("fcg", 1), ("pipecg", 1), ("hs", NRHS), ("sstep", 1)):
        profile_phase(sess, dev, variant, nrhs)
    profile_phase(sess, dev, "hs", 1, fmt="bcsr")
    profile_phase(sess_bone, dev, "hs", 1, fmt="auto", seeded=True)
    profile_phase(sess_bone, dev, "hs", NRHS, fmt="auto", seeded=True)
    profile_phase(sess_g3, dev, "hs", 1, fmt="auto", seeded=True)
    from repro_torch.core.stencil_solver import make_stencil_solver_fn
    from repro_torch.matrices.poisson import cube

    profile_solve("hs [poisson7, matrix-free]",
                  make_stencil_solver_fn(cube(SIDE, "7pt"), SHARDS, tol=1e-200, maxiter=20,
                                         device=dev),
                  torch.ones(SHARDS, sess.n // SHARDS, dtype=torch.float64, device=dev), 20, "hs")

    stamp("the profiles without AMG")
    profile_amg(sess, dev, pre_amg, "hs")
    stamp("the AMG profile")

    keys =("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
