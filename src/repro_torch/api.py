"""Typed public API of the port: problem + config dataclasses, warm sessions.

Port of ``repro.api`` for the paths ported so far: ``op="cg"`` with the
``hs``, ``fcg``, ``pipecg`` and ``sstep`` variants (s-step CG on a
``halo_depth = s`` partition), AMG-preconditioned CG (``amg``, and the
AmgX analog ``amgx_analog``), multi-RHS block-HS CG
(``nrhs > 1``), and ``op="spmv"``, on the Poisson cubes and the SuiteSparse
analogs, with an ELL, HYB or BCSR interior (``fmt``, or ``"auto"``: the
stored-bytes cost model picks), with the BCMGX-analog (or AmgX-analog) leg
and the Ginkgo-analog leg beside it where the JAX package runs one. CG
also runs on a 2-D ``R x C`` process grid (``grid="RxC"``): per-dimension
halos, all-reduces staged over the grid, and, for a Poisson cube, the
pencil-permuted system. ``autotune=True`` lets the energy-aware tuner
(``repro_torch.autotune``) choose the format, variant, schedule, grid,
s-step block and modeled frequency of an unpreconditioned CG solve.

* :class:`ProblemSpec` — *what* to solve (problem/side/scale/shards);
* :class:`SolverConfig` — *how* to solve it, with the JAX package's
  :class:`ConfigError` validation and CLI round-trips, message for message;
* :func:`solve` — the full driver, returning a :class:`SolveReport`;
* :class:`SolverSession` — the warm per-matrix state behind it: partition
  once, keep every solver handle alive. :func:`session_for` keeps a small
  dict of sessions keyed by problem, shard count and device (and the grid
  of a pencil-permuted Poisson cube), in place of the JAX package's
  fingerprint-keyed session pool.

Every shard of a problem is stacked on one device. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; with no GPU and no
explicit CPU request they raise. Paths not ported yet raise
``NotImplementedError`` naming their ``ROADMAP.md`` queue item; none falls
back to another path.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Any

from repro_torch.obs.log import get_logger

LOG = get_logger("api")

VARIANTS = ("hs", "fcg", "pipecg", "sstep")
OPS = ("cg", "spmv")
FORMATS = ("auto", "ell", "hyb", "bcsr")
OBJECTIVES = ("energy", "edp", "time")


class ConfigError(ValueError):
    """A :class:`SolverConfig` combination that cannot run.

    Raised at dataclass construction time; the CLI adapter
    (``launch.solve``) converts it to ``SystemExit`` with the same text.
    """


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, queue 1, {item})"
    )


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """What to solve: the matrix source and its partitioning width.

    ``problem`` is ``poisson7`` / ``poisson27`` (side³ cube stencils) or a
    SuiteSparse name (``scale`` subsamples it — see
    ``matrices/suitesparse.py``). ``shards == 0`` means one shard per
    visible device — the port stacks every shard on one device, so that
    is 1.
    """

    problem: str = "poisson7"
    side: int = 24
    scale: float = 0.01
    shards: int = 0

    @classmethod
    def from_args(cls, args) -> "ProblemSpec":
        return cls(
            problem=str(args.problem), side=int(args.side),
            scale=float(args.scale), shards=int(args.shards),
        )

    def to_argv(self) -> list[str]:
        return [
            "--problem", self.problem, "--side", str(self.side),
            "--scale", str(self.scale), "--shards", str(self.shards),
        ]

    @property
    def stencil(self) -> str | None:
        """``7pt`` / ``27pt`` for a Poisson cube, None for a SuiteSparse
        problem."""
        if not self.problem.startswith("poisson"):
            return None
        return "7pt" if self.problem == "poisson7" else "27pt"

    @property
    def label(self) -> str:
        """Display name, e.g. ``7pt-24^3``, or the SuiteSparse name."""
        if self.stencil is None:
            return self.problem
        return f"{self.stencil}-{self.side}^3"

    def load(self):
        """Materialize the host matrix: ``(scipy CSR, display name)``."""
        from repro_torch.matrices import poisson
        from repro_torch.matrices.suitesparse import load_or_generate

        if self.stencil is None:
            return load_or_generate(self.problem, scale=self.scale), self.label
        p = poisson.cube(self.side, self.stencil)
        return poisson.poisson_scipy(p), self.label


# the JAX package's validation messages, byte for byte
_NRHS_MSG = (
    "--nrhs > 1 runs the batched block-HS CG: requires --op cg, "
    "--variant hs, and no --amg/--amgx-analog"
)
_AUTOTUNE_MSG = (
    "--autotune tunes the unpreconditioned CG path "
    "(--op cg without --amg/--amgx-analog)"
)
_GRID_MSG = (
    "--grid RxC runs the 2-D partitioned CG path: requires --op cg and "
    "no --amg/--amgx-analog/--autotune"
)
_SSTEP_MSG = (
    "--s sets the s-step block size: requires --variant sstep"
)


def parse_grid(text: str) -> tuple[int, int]:
    """``"RxC"`` -> ``(R, C)`` with positive integers (ConfigError on junk)."""
    parts = str(text).lower().split("x")
    try:
        r, c = (int(p) for p in parts)
    except ValueError:
        raise ConfigError(
            f"grid must look like RxC (e.g. 4x4): {text!r}"
        ) from None
    if r < 1 or c < 1:
        raise ConfigError(f"grid dimensions must be >= 1: {text!r}")
    return r, c


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """How to solve: every knob of the JAX package's solver stack.

    Invalid combinations raise :class:`ConfigError` at construction, with
    the JAX package's messages. Valid combinations that the port cannot run
    yet raise ``NotImplementedError`` in :func:`solve`.
    """

    op: str = "cg"
    variant: str = "hs"
    fmt: str = "ell"
    block: int = 4
    overlap: bool = True
    nrhs: int = 1
    tol: float = 1e-8
    maxiter: int = 200
    amg: bool = False
    amgx_analog: bool = False
    autotune: bool = False
    objective: str = "energy"
    tune_budget: int = 6
    tune_cache: str | None = None
    repeats: int = 1
    grid: str | None = None
    s: int | None = None
    telemetry: bool = False

    def __post_init__(self):
        self.validate()

    @property
    def grid_shape(self) -> tuple[int, int] | None:
        """``(rows, cols)`` of the requested process grid, or ``None``."""
        return parse_grid(self.grid) if self.grid else None

    def validate(self):
        if self.op not in OPS:
            raise ConfigError(f"op must be one of {OPS}: {self.op!r}")
        if self.variant not in VARIANTS:
            raise ConfigError(
                f"variant must be one of {VARIANTS}: {self.variant!r}"
            )
        if self.fmt not in FORMATS:
            raise ConfigError(
                f"format must be one of {FORMATS}: {self.fmt!r}"
            )
        if self.objective not in OBJECTIVES:
            raise ConfigError(
                f"objective must be one of {OBJECTIVES}: {self.objective!r}"
            )
        if self.block < 1:
            raise ConfigError(f"block must be >= 1: {self.block}")
        if self.nrhs < 1:
            raise ConfigError(f"nrhs must be >= 1: {self.nrhs}")
        if self.repeats < 1:
            raise ConfigError(f"repeats must be >= 1: {self.repeats}")
        if self.maxiter < 1:
            raise ConfigError(f"maxiter must be >= 1: {self.maxiter}")
        if not self.tol > 0.0:
            raise ConfigError(f"tol must be > 0: {self.tol}")
        if self.tune_budget < 1:
            raise ConfigError(
                f"tune-budget must be >= 1: {self.tune_budget}"
            )
        if self.s is not None:
            if self.s < 1:
                raise ConfigError(f"s must be >= 1: {self.s}")
            if self.variant != "sstep":
                raise ConfigError(_SSTEP_MSG)
        if self.nrhs > 1 and (
            self.op != "cg" or self.amg or self.amgx_analog
            or self.variant != "hs"
        ):
            raise ConfigError(_NRHS_MSG)
        if self.autotune and (
            self.op != "cg" or self.amg or self.amgx_analog
        ):
            raise ConfigError(_AUTOTUNE_MSG)
        if self.grid:
            parse_grid(self.grid)
            if (
                self.op != "cg" or self.amg or self.amgx_analog
                or self.autotune
            ):
                raise ConfigError(_GRID_MSG)

    @classmethod
    def from_args(cls, args) -> "SolverConfig":
        """Build from a ``launch.solve``-style argparse namespace
        (``--nrhs 0`` clamps to 1, as in the JAX package)."""
        return cls(
            op=str(args.op), variant=str(args.variant), fmt=str(args.fmt),
            block=int(args.block), overlap=bool(args.overlap),
            nrhs=max(int(args.nrhs), 1), tol=float(args.tol),
            maxiter=int(args.maxiter), amg=bool(args.amg),
            amgx_analog=bool(args.amgx_analog),
            autotune=bool(args.autotune), objective=str(args.objective),
            tune_budget=int(args.tune_budget), tune_cache=args.tune_cache,
            repeats=int(args.repeats),
            grid=getattr(args, "grid", None),
            s=(
                int(args.s)
                if getattr(args, "s", None) is not None else None
            ),
            telemetry=bool(getattr(args, "telemetry", False)),
        )

    def to_argv(self) -> list[str]:
        """The equivalent ``launch.solve`` CLI flags (round-trip tested)."""
        argv = [
            "--op", self.op, "--variant", self.variant,
            "--format", self.fmt, "--block", str(self.block),
            "--nrhs", str(self.nrhs), "--tol", str(self.tol),
            "--maxiter", str(self.maxiter),
            "--repeats", str(self.repeats),
            "--objective", self.objective,
            "--tune-budget", str(self.tune_budget),
        ]
        if not self.overlap:
            argv.append("--no-overlap")
        if self.amg:
            argv.append("--amg")
        if self.amgx_analog:
            argv.append("--amgx-analog")
        if self.autotune:
            argv.append("--autotune")
        if self.tune_cache:
            argv += ["--tune-cache", self.tune_cache]
        if self.grid:
            argv += ["--grid", self.grid]
        if self.s is not None:
            argv += ["--s", str(self.s)]
        if self.telemetry:
            argv.append("--telemetry")
        return argv

    def check_ported(self):
        """Raise ``NotImplementedError`` for a valid config the port cannot
        run yet, naming its ``ROADMAP.md`` queue item."""
        if self.telemetry:
            _not_ported("convergence telemetry", "item 14")


@dataclasses.dataclass(frozen=True)
class SolveReport:
    """What one :func:`solve` produced: identity, summary, full ledger.

    ``summary`` holds one compact dict per executed leg; ``ledger`` is the
    JSON payload ``--ledger`` writes; ``outputs`` maps each leg to its last
    result as a host numpy array in global (unpadded) order — the solution
    ``x`` of a CG leg (the ``(n, nrhs)`` block of a block leg), ``y = A @ 1``
    of an SpMV leg. On a 2-D grid a Poisson cube is solved in the pencil
    order: ``x`` is in the permuted order (``x[perm]`` of the original
    system's solution, ``perm`` from ``pencil_partition``)."""

    problem: str
    n: int
    nnz: int
    shards: int
    config: SolverConfig
    summary: dict
    ledger: dict
    outputs: dict = dataclasses.field(default_factory=dict)

    @property
    def solvers(self) -> dict:
        return self.ledger["solvers"]


class SolverSession:
    """Warm per-matrix solver state.

    One session owns one host CSR matrix pinned to one shard count and one
    device, and keeps what is expensive to derive from it:

    * ``mats`` — ``(fmt, block) -> DistMat`` partitions on the session's
      device (``(fmt, block, (R, C))`` on a 2-D process grid,
      ``+ (("halo", k),)`` for a ``halo_depth = k > 1`` partition; the
      all-gather Ginkgo-analog partition under ``("allgather", 0)``), with
      ``partition_s`` the seconds each took;
    * solver handles (``core.cg.solver_handle``), each carrying the energy
      trace captured at its first solve;
    * the AMG preconditioners (:meth:`amg`). The JAX package builds the
      hierarchy again on every solve; a session keeps it, as it keeps its
      partitions, and only the solve that built it reports setup seconds;
    * ``tune`` — the last :class:`~repro_torch.autotune.TuneResult` routed
      through :meth:`autotune`, whose trial partitions land in ``mats``.

    ``partitions`` / ``tune_trials`` / ``solves`` count the work actually
    performed (:meth:`stats`). A
    session of a pencil-permuted Poisson cube holds ``A[perm][:, perm]``
    and ``pencil = (grid, perm, row_partition)``, ``reorder_s`` the seconds
    the permutation took (:func:`session_for`).
    """

    def __init__(self, a_csr, n_shards: int, *, device=None, key=None,
                 pencil=None, reorder_s: float = 0.0):
        from repro_torch.launch.mesh import resolve_device

        self.a = a_csr.tocsr()
        self.n = int(self.a.shape[0])
        self.n_shards = int(n_shards)
        self.device = resolve_device(device)
        self.key = key
        self.pencil = pencil
        self.reorder_s = float(reorder_s)
        self.mats: dict[tuple, Any] = {}
        self.partition_s: dict[tuple, float] = {}
        self.handles: dict[tuple, Any] = {}
        self.amgs: dict[bool, tuple] = {}  # amgx_analog -> (precond, info)
        self.tune = None  # last TuneResult routed through this session
        self.partitions = 0
        self.tune_trials = 0
        self.solves = 0

    def _partition(self, k, **kw):
        from repro_torch.core.partition import partition_csr

        if k not in self.mats:
            t0 = time.perf_counter()
            self.mats[k] = partition_csr(
                self.a, self.n_shards, device=self.device, **kw
            )
            if self.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.device)
            self.partition_s[k] = time.perf_counter() - t0
            self.partitions += 1
        return self.mats[k]

    @staticmethod
    def matrix_key(fmt: str = "ell", block: int = 4, halo_depth: int = 1,
                   grid=None) -> tuple:
        """The ``mats`` key of a partition: ``(fmt, block[, grid])``,
        depth-tagged for a deep halo."""
        k = (fmt, int(block))
        if grid is not None:
            k = k + ((int(grid[0]), int(grid[1])),)
        depth = max(int(halo_depth), 1)
        return k + (("halo", depth),) if depth > 1 else k

    def matrix(self, fmt: str = "ell", block: int = 4, *, grid=None,
               partition=None, halo_depth: int = 1):
        """The DistMat for (fmt, block[, grid]); partitions on first use.
        ``grid=(R, C)`` plans per-dimension halos (``GridPlan``);
        ``partition`` fixes the row blocks (the ``pencil_partition`` of a
        permuted Poisson cube); ``halo_depth > 1`` builds the s-step ghost
        zones under a depth-tagged key."""
        depth = max(int(halo_depth), 1)
        if grid is not None:
            grid = (int(grid[0]), int(grid[1]))
        return self._partition(self.matrix_key(fmt, block, depth, grid), fmt=fmt,
                               block=(block, block), grid=grid,
                               partition=partition, halo_depth=depth)

    def amg(self, amgx_analog: bool = False) -> tuple:
        """``(precond, info, setup_s)``: the AMG preconditioner of the
        matrix on the session's device (the AmgX analog with
        ``amgx_analog``), built on first use (the finest level reuses
        :meth:`matrix`, built first if missing). ``setup_s`` is the seconds
        this call spent building it: 0 when the session already held it
        (``info.setup_s`` keeps the build's split)."""
        key = bool(amgx_analog)
        if key in self.amgs:
            return (*self.amgs[key], 0.0)
        from repro_torch.core.amg import make_amg_preconditioner

        t0 = time.perf_counter()
        # the finest level's matrix is the session's default partition
        pre, info = make_amg_preconditioner(
            self.a, self.n_shards, amgx_analog=key, device=self.device,
            level0=self.matrix(),
        )
        self.amgs[key] = (pre, info)
        return pre, info, time.perf_counter() - t0

    def autotune(self, *, objective: str = "energy", budget: int = 6,
                 cache_path: str | None = None, tol: float = 1e-8,
                 nrhs: int = 1, cost=None):
        """Run (or cache-hit) the two-stage autotuner through this session,
        on its device. Trial partitions land in ``mats`` (their seconds in
        ``partition_s``), so the winner's partition is reused by the final
        solve; executed trials and new partitions are charged to the
        session's counters. ``cost`` defaults to ``CostModel()``."""
        from repro_torch.autotune import DEFAULT_PATH
        from repro_torch.autotune import autotune as run_autotune

        before = len(self.mats)
        tune = run_autotune(
            self.a, self.n_shards, device=self.device, objective=objective,
            budget=budget, cost=cost, cache_path=cache_path or DEFAULT_PATH,
            tol=tol, mats=self.mats, nrhs=nrhs, partition_s=self.partition_s,
        )
        self.partitions += len(self.mats) - before
        self.tune_trials += tune.candidates_trialed
        self.tune = tune
        return tune

    def naive_matrix(self):
        """The padded-global (all-gather) partition of the naive baseline."""
        return self._partition(("allgather", 0), force_allgather=True)

    def solver(self, mat, *, op: str = "cg", nrhs: int = 1,
               variant: str = "hs", precond=None, tol: float = 1e-8,
               maxiter: int = 100, overlap: bool = True, s: int = 2):
        """Cached :class:`~repro_torch.core.cg.SolverHandle` for (mat, config)."""
        from repro_torch.core.cg import solver_handle

        return solver_handle(
            mat, op=op, nrhs=nrhs, variant=variant, precond=precond,
            tol=tol, maxiter=maxiter, s=s, overlap=overlap, device=self.device,
            cache=self.handles,
        )

    def close(self):
        """Release partitions, handles and the last tuning result; the
        session stays usable cold."""
        self.mats.clear()
        self.partition_s.clear()
        self.handles.clear()
        self.amgs.clear()
        self.tune = None

    def stats(self) -> dict:
        """JSON-ready counters of the work this session performed."""
        return dict(
            n=self.n, shards=self.n_shards, partitions=self.partitions,
            tune_trials=self.tune_trials, solves=self.solves,
            mats=len(self.mats),
        )


#: Process-wide sessions keyed by (problem, side, scale, shards, device,
#: pencil grid or None).
SESSIONS: "collections.OrderedDict[tuple, SolverSession]" = collections.OrderedDict()
SESSION_LIMIT = 4


def _pencil_grid(spec: ProblemSpec, grid) -> tuple[int, int] | None:
    """The grid whose pencil order a solve of ``spec`` on ``grid`` uses: a
    true 2-D grid (``R > 1``) on a Poisson cube, else None."""
    if grid is None or int(grid[0]) <= 1 or spec.stencil is None:
        return None
    return (int(grid[0]), int(grid[1]))


def session_for(spec: ProblemSpec, device=None, grid=None) -> SolverSession:
    """The warm session for ``spec`` on ``device``, loading and keeping the
    matrix on first use (least recently used sessions are closed past
    :data:`SESSION_LIMIT`).

    For a Poisson cube on a 2-D ``grid = (R, C)``, ``R > 1``, the session
    holds the pencil-permuted matrix ``A[perm][:, perm]``
    (``core.partition.pencil_partition``), as the JAX package builds its
    grid session from the permuted matrix; it is keyed apart from the 1-D
    session of the same spec, so neither reuses the other's matrix,
    partitions or handles; the permuted matrix is built from the 1-D
    session's when that one is warm."""
    from repro_torch.launch.mesh import resolve_device

    dev = resolve_device(device)
    n_shards = spec.shards or 1
    pgrid = _pencil_grid(spec, grid)
    key = (spec.problem, int(spec.side), float(spec.scale), n_shards, str(dev), pgrid)
    sess = SESSIONS.get(key)
    if sess is None:
        base = SESSIONS.get(key[:-1] + (None,)) if pgrid is not None else None
        a = base.a if base is not None else spec.load()[0]
        pencil, reorder_s = None, 0.0
        if pgrid is not None:
            from repro_torch.core.partition import pencil_partition
            from repro_torch.matrices import poisson

            t0 = time.perf_counter()
            perm, part = pencil_partition(poisson.cube(spec.side, spec.stencil), pgrid)
            a = a[perm][:, perm].tocsr()
            reorder_s = time.perf_counter() - t0
            pencil = (pgrid, perm, part)
        sess = SolverSession(a, n_shards, device=dev, key=key, pencil=pencil,
                             reorder_s=reorder_s)
        SESSIONS[key] = sess
        while len(SESSIONS) > SESSION_LIMIT:
            SESSIONS.popitem(last=False)[1].close()
    SESSIONS.move_to_end(key)
    return sess


def _print_regions(label: str, ledger: dict):
    for name, r in sorted(ledger["regions"].items()):
        LOG.info(
            "  [%s] region %-12s t=%.4es DE=%.4fJ flops=%.3e hbm=%.3eB "
            "ici=%.3eB",
            label, name, r["time_s"], r["de_j"], r["flops"],
            r["hbm_bytes"], r["ici_bytes"],
        )


def _plan_dim_bytes(plan) -> tuple[float, float]:
    """Per-shard halo bytes per exchange, split by grid dimension.

    GridPlan: the per-dimension widths (a corner buffer crosses both links,
    so it counts in both entries and the two sum to the hop-weighted
    collective total). 1-D plans: all traffic rides the single flat axis —
    the ``cols`` axis of the equivalent ``1 x N`` grid."""
    if plan.mode == "grid":
        rows_b, cols_b = plan.dim_bytes_per_shard(8)
        return float(rows_b), float(cols_b)
    return 0.0, float(plan.collective_bytes_per_shard(8))


def write_ledger_json(path: str | None, payload: dict):
    """Atomically write a ledger JSON (a reader never sees a half-write)."""
    if not path:
        return
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    LOG.info("ledger written: %s", path)


def solve(
    spec: ProblemSpec,
    config: SolverConfig | None = None,
    *,
    ledger: str | None = None,
    profile: str | None = None,
    session: SolverSession | None = None,
    device=None,
    verbose: bool = True,
) -> SolveReport:
    """The full solver driver (``launch.solve:main``'s body).

    Loads (or reuses) the problem and its partitions through a warm
    :class:`SolverSession` (``session``, else :func:`session_for`), runs
    the BCMGX-analog leg (the AmgX-analog leg under ``amgx_analog``) and
    the Ginkgo-analog leg under the energy trace — the latter, as in the
    JAX package, beside every single-RHS CG solve without AMG (a batched
    block-HS leg has no single-RHS baseline, and the paper compares its PCG
    with AmgX) and beside an SpMV only when the interior format resolves to
    ELL (the baseline keeps the flat ELL layout by definition) —
    prints the driver report (``verbose``), optionally writes the ledger
    JSON, and returns a :class:`SolveReport`. Everything runs in float64,
    as the JAX package's CLI does.

    ``config.grid = "RxC"`` (``R * C`` must equal the shard count) runs CG
    on a 2-D process grid: ``1 x N`` is the 1-D layout; with ``R > 1`` the
    partition plans per-dimension halos, every all-reduce is staged over
    the grid, a Poisson cube is solved in the pencil order (the session of
    the permuted matrix, :func:`session_for`), the cost model charges the
    staged tree depth, and no Ginkgo-analog leg runs. The ledger then
    carries ``grid``, ``halo_bytes_rows`` and ``halo_bytes_cols``.

    ``config.autotune`` tunes the solve first (:meth:`SolverSession.autotune`
    on the 1-D session, objective ``config.objective``, budget
    ``config.tune_budget``, cache ``config.tune_cache``): the chosen format,
    block, variant, overlap, s-step block and grid drive the solve, and the
    ledger is priced at the chosen modeled frequency (the card's clock is
    not touched). A chosen grid partitions the session's own matrix in its
    given order (no pencil permutation), as the JAX package does. No
    Ginkgo-analog leg runs (the trials are the comparison), and the ledger
    carries the ``autotune`` section.

    Each CG leg runs one warm-up solve (whose counts become the energy
    trace) and then ``config.repeats`` timed solves; an SpMV leg one warm-up
    and 100 timed products. ``amg``/``amgx_analog`` take the session's AMG
    preconditioner (:meth:`SolverSession.amg`, built on first use; the
    report's ``setup_s`` is the seconds this solve spent on that build, 0
    when the session already held it, as the JAX package reports the
    setup a solve performed). ``device``:
    ``cuda`` unless ``"cpu"`` is passed (ignored when ``session`` is given
    — the session fixes it).
    """
    config = config or SolverConfig()
    config.validate()
    config.check_ported()
    if profile:
        _not_ported("Chrome-trace profiles (--profile)", "item 14")

    import numpy as np
    import torch

    from repro_torch.core.partition import pad_block, pad_vector, unpad_vector
    from repro_torch.energy import trace
    from repro_torch.energy.accounting import CostModel
    from repro_torch.obs.provenance import ledger_meta

    def log(msg):
        if verbose:
            LOG.info("%s", msg)

    n_shards = session.n_shards if session is not None else (spec.shards or 1)
    grid_cfg = config.grid_shape
    grid = None
    if grid_cfg is not None:
        if grid_cfg[0] * grid_cfg[1] != n_shards:
            raise ConfigError(
                f"--grid {config.grid} covers "
                f"{grid_cfg[0] * grid_cfg[1]} shards; running with "
                f"{n_shards}"
            )
        if grid_cfg[0] > 1:  # 1 x N is the 1-D layout; build it identically
            grid = grid_cfg
    if session is None:
        session = session_for(spec, device, grid=grid)
    dev = session.device
    a = session.a
    name = spec.label
    n = a.shape[0]
    b = np.ones(n)
    nrhs = config.nrhs
    log(f"problem={name} n={n} nnz={a.nnz} shards={n_shards} nrhs={nrhs}")

    cost = CostModel()
    tune = None
    fmt, block = config.fmt, config.block
    variant, overlap = config.variant, config.overlap
    sstep_s = config.s or 2  # s-step block size (used iff variant == sstep)
    if config.autotune:
        # --grid and --autotune exclude each other: the session is the 1-D
        # one, and a chosen grid partitions its matrix as it stands
        tune = session.autotune(
            objective=config.objective, budget=config.tune_budget,
            cache_path=config.tune_cache, tol=config.tol, nrhs=nrhs, cost=cost,
        )
        ch = tune.chosen
        fmt, block = ch.fmt, ch.block
        variant, overlap = ch.variant, ch.overlap
        if ch.variant == "sstep":
            sstep_s = ch.s
        grid = ch.grid
        cost = cost.at_freq(ch.freq)
        log(
            f"autotune: objective={tune.objective} chosen={ch.label} "
            f"cached={tune.cached} trialed={tune.candidates_trialed} "
            f"(space {tune.candidates_total})"
        )
    grid_part = None
    pgrid = None if config.autotune else _pencil_grid(spec, grid)
    if pgrid is not None:
        # the pencil-reordered system A[perm][:, perm] (same spectrum, CG
        # iterates the same up to the permutation): each shard owns a z x y
        # pencil, its halo scales with the pencil's surface; b = ones is its
        # own permutation and x comes back permuted, as in the JAX package
        if session.pencil is not None and session.pencil[0] == pgrid:
            grid_part = session.pencil[2]
        else:
            from repro_torch.core.partition import pencil_partition
            from repro_torch.matrices import poisson

            grid_part = pencil_partition(poisson.cube(spec.side, spec.stencil), pgrid)[1]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if grid is not None:
        from repro_torch.roofline.analysis import reduce_hops

        # grid collectives stage over the grid's columns, then its rows: no
        # launch is deeper than the longer one (the extra stage launches
        # are in the trace)
        cost = dataclasses.replace(cost, coll_hops=float(reduce_hops(n_shards, grid)))
    payload = dict(
        schema=1, problem=name, n=int(n), nnz=int(a.nnz),
        shards=int(n_shards), op=config.op, overlap=bool(overlap),
        format=fmt, nrhs=nrhs, solvers={}, meta=ledger_meta(dev),
    )
    if tune is not None:
        payload["autotune"] = tune.ledger_section()
    precond = None
    setup_time = 0.0
    if config.amg or config.amgx_analog:
        precond, amg_info, setup_time = session.amg(config.amgx_analog)
        log(
            f"AMG: {amg_info.n_levels} levels rows={amg_info.level_rows} "
            f"opcx={amg_info.operator_complexity:.2f} setup={setup_time:.4f}s"
        )
        payload["amg"] = dict(
            n_levels=amg_info.n_levels,
            level_rows=list(amg_info.level_rows),
            level_nnz=list(amg_info.level_nnz),
            operator_complexity=amg_info.operator_complexity,
        )
    # an s-step solve partitions with halo_depth=s so the matrix-powers
    # basis pays one widened exchange per s-iteration block; a tuned solve
    # finds its winner's partition among the session's (the trials' keys)
    depth = sstep_s if (variant == "sstep" and config.op == "cg") else 1
    mkey = session.matrix_key(fmt, block, depth, grid)
    mat = session.matrix(fmt, block, grid=grid, partition=grid_part, halo_depth=depth)
    # the naive baseline keeps the flat ELL layout and is single-RHS by
    # definition: its (expensive) all-gather partition is built only when
    # a naive leg will run (the paper compares its PCG with AmgX, not
    # Ginkgo; a grid run's comparison leg is the 1-D run of the problem, a
    # tuned run's the trials)
    need_naive = (
        mat.fmt == "ell" if config.op == "spmv"
        else nrhs == 1 and precond is None and grid is None and tune is None
    )
    matg = session.naive_matrix() if need_naive else None
    log(
        f"format={mat.fmt} (requested {fmt}) "
        f"interior_bytes={mat.interior_stored_bytes()} "
        f"stored_bytes={mat.stored_bytes()}"
    )
    payload["resolved_format"] = mat.fmt
    payload["interior_stored_bytes"] = int(mat.interior_stored_bytes())
    payload["stored_bytes"] = int(mat.stored_bytes())
    if depth > 1:
        # s-step run: the ghost-zone depth actually built (an all-gather
        # fallback reports 1: the matrix-powers path did not engage)
        payload["halo_depth"] = int(mat.halo_depth)
        payload["s"] = int(sstep_s)
    if grid is not None or grid_cfg is not None:
        # written whenever a grid is given (1 x N included) or tuned
        g = grid or grid_cfg
        rows_b, cols_b = _plan_dim_bytes(mat.plan)
        payload["grid"] = [int(g[0]), int(g[1])]
        payload["halo_bytes_rows"] = rows_b
        payload["halo_bytes_cols"] = cols_b

    dt = mat.dtype
    if nrhs > 1:
        from repro_torch.core.cg import default_rhs_block

        bp = torch.from_numpy(pad_block(default_rhs_block(n, nrhs), mat)).to(dev, dt)
    else:
        bp = torch.from_numpy(pad_vector(b, mat)).to(dev, dt)
    x0 = torch.zeros_like(bp)
    summary, outputs = {}, {}

    if config.op == "spmv":
        legs = [
            ("BCMGX-analog", mat, mkey,
             session.solver(mat, op="spmv", overlap=overlap)),
        ]
        if need_naive:
            legs.append(("Ginkgo-analog", matg, ("allgather", 0),
                         session.solver(matg, op="spmv", variant="naive")))
        for label, m, key, h in legs:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            h.warm(bp)  # executed counts recorded
            tr = h.trace
            t0 = time.perf_counter()
            for _ in range(100):
                y = h.fn(bp)
                sync()
            wall = (time.perf_counter() - t0) / 100
            leg_overlap = overlap and label == "BCMGX-analog"
            led = trace.ledger_from_trace(
                tr, iters=0, n_shards=n_shards, cost=cost,
                overlap=leg_overlap, idle_s=0.01, setup_repeats=100,
            )
            e = led["totals"]
            t_model = sum(r["time_s"] for r in led["regions"].values())
            log(
                f"{label:14s} iters=100 relres=0.0e+00 "
                f"wall={wall:.6f}s modeled={t_model/100:.4e}s "
                f"DE={e['de_total']:.4f}J peak={e['gpu_power_peak']:.0f}W "
                f"DEgpu={e['de_gpu']:.4f}J DEcpu={e['de_cpu']:.4f}J"
            )
            if verbose:
                _print_regions(label, led)
            payload["solvers"][label] = dict(
                led, wall_s=wall, modeled_s=t_model / 100,
                partition_s=session.partition_s[key],
                peak_mem_bytes=_peak_mem(dev),
            )
            outputs[label] = unpad_vector(y, m)
            summary[label] = dict(
                wall_s=wall, modeled_s=t_model / 100,
                de_total=e["de_total"],
            )
        write_ledger_json(ledger, payload)
        return SolveReport(
            problem=name, n=int(n), nnz=int(a.nnz), shards=int(n_shards),
            config=config, summary=summary, ledger=payload, outputs=outputs,
        )

    legs = [
        ("AmgX-analog" if config.amgx_analog else "BCMGX-analog", mat, mkey,
         session.solver(
             mat, nrhs=nrhs, variant=variant, precond=precond,
             tol=config.tol, maxiter=config.maxiter, overlap=overlap, s=sstep_s,
         )),
    ]
    if need_naive:
        legs.append(("Ginkgo-analog", matg, ("allgather", 0), session.solver(
            matg, variant="naive", tol=config.tol, maxiter=config.maxiter,
        )))
    for label, m, key, hdl in legs:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        res = hdl.warm(bp, x0)  # warm-up: counts recorded
        tr = hdl.trace
        walls = []
        for _ in range(config.repeats):
            t0 = time.perf_counter()
            res = hdl.fn(bp, x0)
            sync()
            walls.append(time.perf_counter() - t0)
        wall = sum(walls) / len(walls)
        iters = int(res.iters)
        # the batched leg converges each column independently: report the
        # slowest column's residual (convergence of the whole batch)
        relres = float(res.rel_residual.max())
        is_bcmgx = label != "Ginkgo-analog"
        led = trace.ledger_from_trace(
            tr, iters=iters, n_shards=n_shards, cost=cost,
            overlap=(overlap and is_bcmgx), idle_s=0.01,
        )
        e = led["totals"]
        t_model = sum(r["time_s"] for r in led["regions"].values())
        matrix_bytes = sum(
            r.get("hbm_matrix_bytes", 0.0) for r in led["regions"].values()
        )
        log(
            f"{label:14s} iters={iters} relres={relres:.2e} "
            f"wall={wall:.4f}s modeled={t_model:.4e}s "
            f"DE={e['de_total']:.4f}J peak={e['gpu_power_peak']:.0f}W "
            f"DEgpu={e['de_gpu']:.4f}J DEcpu={e['de_cpu']:.4f}J "
            f"setup={setup_time:.4f}s solve={wall:.4f}s"
        )
        if verbose:
            _print_regions(label, led)
        entry = dict(
            led, wall_s=wall, modeled_s=t_model,
            relres=relres, setup_s=setup_time,
            variant=variant if is_bcmgx else "naive",
            # per-solve amortization view: a batched run is nrhs solves
            nrhs=nrhs,
            per_solve_modeled_s=t_model / nrhs,
            per_solve_de_j=e["de_total"] / nrhs,
            per_solve_spmv_matrix_bytes=matrix_bytes / nrhs,
            wall_repeats_s=walls,
            per_solve_wall_s=wall / nrhs,
            partition_s=session.partition_s[key],
            peak_mem_bytes=_peak_mem(dev),
        )
        if nrhs > 1:
            entry["iters_cols"] = [int(v) for v in res.iters_cols.tolist()]
        payload["solvers"][label] = entry
        outputs[label] = unpad_vector(res.x, m)
        summary[label] = dict(
            iters=iters, relres=relres, wall_s=wall, modeled_s=t_model,
            de_total=e["de_total"],
        )
        if is_bcmgx:
            session.solves += nrhs * config.repeats
    write_ledger_json(ledger, payload)
    return SolveReport(
        problem=name, n=int(n), nnz=int(a.nnz), shards=int(n_shards),
        config=config, summary=summary, ledger=payload, outputs=outputs,
    )


def _peak_mem(dev) -> int | None:
    """Peak device memory since the last reset (bytes; None on the CPU)."""
    if dev.type != "cuda":
        return None
    import torch

    return int(torch.cuda.max_memory_allocated(dev))
