"""Sparse-solver driver of the port: the paper's workload end to end.

    python -m repro_torch.launch.solve --problem poisson7 --side 64 --shards 4
    python -m repro_torch.launch.solve --device cpu --side 12

Prints iteration counts, wall time and the executed-energy report for the
BCMGX-analog and the Ginkgo-analog legs. The flags are those of
``python -m repro.launch.solve`` minus ``--devices`` (every shard is
stacked on one device here), plus ``--device {cuda,cpu}``: the run is on
the GPU unless ``--device cpu`` is given, and stops with an error when no
GPU is present. Flags of paths not ported yet stop with a message naming
their ``ROADMAP.md`` queue item.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="poisson7",
                    help="poisson7 | poisson27 | suitesparse names (synthetic analogs)")
    ap.add_argument("--side", type=int, default=24)
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--shards", type=int, default=0,
                    help="shards stacked on the device (0 = 1)")
    ap.add_argument("--variant", default="hs",
                    choices=["hs", "fcg", "pipecg", "sstep"])
    ap.add_argument("--op", default="cg", choices=["cg", "spmv"])
    ap.add_argument("--no-overlap", dest="overlap", action="store_false",
                    help="serialize the halo exchange before the SpMV")
    ap.add_argument("--format", dest="fmt", default="ell",
                    choices=["auto", "ell", "hyb", "bcsr"])
    ap.add_argument("--block", type=int, default=4)
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--objective", default="energy",
                    choices=["energy", "edp", "time"])
    ap.add_argument("--tune-budget", type=int, default=6)
    ap.add_argument("--tune-cache", default=None)
    ap.add_argument("--nrhs", type=int, default=1)
    ap.add_argument("--s", type=int, default=None)
    ap.add_argument("--grid", default=None)
    ap.add_argument("--amg", action="store_true")
    ap.add_argument("--amgx-analog", action="store_true")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--maxiter", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--ledger", default=None,
                    help="write the executed energy/time ledger JSON here")
    ap.add_argument("--telemetry", action="store_true")
    ap.add_argument("--profile", default=None, metavar="TRACE_JSON")
    ap.add_argument("--log-level", default=None,
                    choices=["debug", "info", "warning", "error"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the stacked shards run (default cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from repro_torch.obs import log as olog

    olog.setup(args.log_level)
    from repro_torch import api

    try:
        spec = api.ProblemSpec.from_args(args)
        config = api.SolverConfig.from_args(args)
        api.solve(spec, config, ledger=args.ledger, profile=args.profile,
                  device=args.device)
    except (api.ConfigError, NotImplementedError, RuntimeError) as e:
        raise SystemExit(str(e)) from e


if __name__ == "__main__":
    main()
