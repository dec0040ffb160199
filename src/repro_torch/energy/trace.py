"""Region-marked execution tracing: energy accounting for *executed* code.

The paper instruments its solvers with powerMonitor/LIKWID region markers so
that every Joule is attributed to the component that actually ran (SpMV,
reductions, halo exchange). This module is the port's copy of
``repro.energy.trace``, recording while the eager PyTorch code runs:

* ``region(name)`` marks a component. Regions nest; a dispatched op is
  attributed to the **innermost** active region.
* the ``"overlap"`` region (:data:`OVERLAP`) holds compute *and*
  communication that the implementation co-schedules (the interior matvec +
  halo exchange of the split SpMV). ``monitor_from_trace`` always models it
  overlapped — segment time ``max(compute, memory, collective)``.
* ``section(name)`` separates per-solve setup from the iteration body. The
  eager solvers enter ``section("iteration")`` once per *executed*
  iteration, and every view divides by the number of entries, so the
  recorded counts come out per iteration — exactly what the JAX package
  gets from tracing its ``while_loop`` body once.
* ``record_op(op, counts)`` is called by the instrumented layers — the
  kernel dispatch OpSet (kernels/dispatch.py), the distributed vector ops
  (core/vectors.py), the SpMV/halo path (core/spmv.py) and the naive
  baseline (core/baselines.py) — with the **per-shard** :class:`OpCounts`
  of one op invocation: stacked ``(S, R)`` operands count with their
  per-shard length ``R``, never ``S * R``, because the ledger's counts are
  per device.

Recording costs a few dict updates per op, and only inside ``capture()``;
``monitor_from_trace`` replays the counts — scaled by the executed
iteration count — through the PowerMonitor, giving a per-region energy
ledger that sums to the monitor total by construction.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter

from repro_torch.energy.accounting import ZERO, OpCounts

DEFAULT_REGION = "other"
SETUP = "setup"
ITERATION = "iteration"
# Region holding co-scheduled compute + communication (always modeled
# overlapped — see module docstring and energy/monitor.py).
OVERLAP = "overlap"


@dataclasses.dataclass
class RegionTally:
    """Accumulated counts + per-op call counter for one (section, region)."""

    counts: OpCounts = ZERO
    calls: Counter = dataclasses.field(default_factory=Counter)

    def add(self, op: str, c: OpCounts):
        self.counts = self.counts + c
        self.calls[op] += 1


class EnergyTrace:
    """Per-section, per-region operation counts gathered while running.

    ``sections[section][region]`` is a :class:`RegionTally`;
    ``entries[section]`` counts how many times the section was entered —
    once per executed iteration for the eager solvers' iteration section —
    and every view divides by it.
    """

    def __init__(self):
        self.sections: dict[str, dict[str, RegionTally]] = {}
        self.entries: dict[str, int] = {}

    def enter(self, section: str):
        self.entries[section] = self.entries.get(section, 0) + 1

    def record(self, section: str, region: str, op: str, counts: OpCounts):
        self.sections.setdefault(section, {}).setdefault(
            region, RegionTally()
        ).add(op, counts)

    # -- views --------------------------------------------------------------

    def regions(self, section: str) -> dict[str, OpCounts]:
        """region -> OpCounts per section entry (per-iteration for the
        iteration section)."""
        norm = max(self.entries.get(section, 1), 1)
        return {
            name: tally.counts * (1.0 / norm)
            for name, tally in self.sections.get(section, {}).items()
        }

    def calls(self, section: str) -> dict[str, Counter]:
        return {
            name: tally.calls
            for name, tally in self.sections.get(section, {}).items()
        }

    def region_names(self) -> tuple[str, ...]:
        names: list[str] = []
        for sec in self.sections.values():
            for name in sec:
                if name not in names:
                    names.append(name)
        return tuple(names)

    @property
    def empty(self) -> bool:
        return not any(self.sections.values())

    def total(self, section: str | None = None) -> OpCounts:
        out = ZERO
        for sec, regs in self.sections.items():
            if section is not None and sec != section:
                continue
            norm = max(self.entries.get(sec, 1), 1)
            for tally in regs.values():
                out = out + tally.counts * (1.0 / norm)
        return out


# ---------------------------------------------------------------------------
# Module state: active trace + region stack + section
# ---------------------------------------------------------------------------

_trace: EnergyTrace | None = None
_stack: list[str] = []
_section: str = SETUP
_scale: float = 1.0


@contextlib.contextmanager
def capture():
    """Activate an :class:`EnergyTrace`; run solvers inside."""
    global _trace
    prev = _trace
    _trace = EnergyTrace()
    try:
        yield _trace
    finally:
        _trace = prev


@contextlib.contextmanager
def region(name: str):
    """Mark a component region for the ops recorded inside.

    ``name`` is a free-form region label; the solver layers use
    ``"spmv"``/``"halo"``/``"reductions"``/``"precond"``/``"vcycle"`` and
    the special :data:`OVERLAP`. Regions nest — an op is attributed to the
    *innermost* active region.
    """
    _stack.append(name)
    try:
        yield
    finally:
        _stack.pop()


@contextlib.contextmanager
def section(name: str):
    """Switch the accounting section — :data:`SETUP` (default, straight-line
    per-solve code) vs :data:`ITERATION` (one solver iteration).

    Counts recorded under a section are normalized by how many times the
    section was entered, then replayed per executed
    iteration (ITERATION) or per benchmark repeat (SETUP) by
    :func:`monitor_from_trace`. Solver bodies switch via
    ``kernels.dispatch.ledger_section`` so the sweep ledger stays in
    lockstep.
    """
    global _section
    prev = _section
    _section = name
    if _trace is not None:
        _trace.enter(name)
    try:
        yield
    finally:
        _section = prev


def active() -> EnergyTrace | None:
    return _trace


def current_region() -> str:
    return _stack[-1] if _stack else DEFAULT_REGION


def current_section() -> str:
    return _section


@contextlib.contextmanager
def repeated(k: float):
    """Scale ops recorded inside by ``k`` — for a body that runs once but
    stands for ``k`` accounting units (fractional ``k`` averages a block
    that covers several iterations)."""
    global _scale
    prev = _scale
    _scale = _scale * k
    try:
        yield
    finally:
        _scale = prev


def record_op(op: str, counts: OpCounts):
    """Attribute one op invocation to the innermost region.

    ``op`` is a per-op label for the call counter; ``counts`` the
    per-device :class:`OpCounts` of ONE invocation (flops, HBM bytes, ICI
    bytes, collective launches). No-op when no trace is active.
    """
    if _trace is not None:
        if _scale != 1.0:
            counts = counts * _scale
        _trace.record(_section, current_region(), op, counts)


def record_collective(n_scalars: int, itemsize: int = 8, op: str = "allreduce"):
    """One fused all-reduce of ``n_scalars`` scalars of ``itemsize`` bytes
    (ici_bytes = n_scalars * itemsize, one collective launch — i.e. one
    latency hop term in the cost model)."""
    record_op(
        op,
        OpCounts(ici_bytes=float(n_scalars * itemsize), n_collectives=1.0),
    )


# ---------------------------------------------------------------------------
# Executed-counts formulas (single source — the dispatch layer, the
# distributed vector ops and the naive baseline all account streamed vector
# work through these). Operands are stacked (S, R[, r]) shard tensors (or
# one (n,) vector); counts are per shard, so lengths are taken from the
# last axes, never from the stack.
# ---------------------------------------------------------------------------


def streamed_axpy_counts(n: int, itemsize: int, fused: int = 1) -> OpCounts:
    """``fused`` axpy-class updates in one pass: per update, stream x and y
    in and the result out (2 flops per element)."""
    return OpCounts(flops=2.0 * n * fused, hbm_bytes=3.0 * n * itemsize * fused)


def local_dots_counts(pairs) -> OpCounts:
    """Local partial inner products for ``[(x, y), ...]``: 2n flops per
    pair; each *distinct* operand streamed once (fused kernels dedup
    repeated vectors by identity)."""
    n = pairs[0][0].shape[-1]
    itemsize = pairs[0][0].element_size()
    distinct = {id(a) for x, y in pairs for a in (x, y)}
    return OpCounts(
        flops=2.0 * n * len(pairs),
        hbm_bytes=float(len(distinct)) * n * itemsize,
    )


def fused_dots_counts(pairs, n_out: int | None = None) -> OpCounts:
    """Local dots + the ONE all-reduce of the ``n_out`` reduced scalars."""
    itemsize = pairs[0][0].element_size()
    return local_dots_counts(pairs) + OpCounts(
        ici_bytes=float((n_out or len(pairs)) * itemsize), n_collectives=1.0
    )


def block_gram_counts(pairs) -> OpCounts:
    """Local (r, r) Gram blocks for ``[(X, Y), ...]`` of (n, r) operands:
    2·n·r² flops per pair; each *distinct* block streamed once (the block
    kernel dedups repeated operands, order-sensitively)."""
    n, r = pairs[0][0].shape[-2:]
    itemsize = pairs[0][0].element_size()
    distinct = {id(a) for x, y in pairs for a in (x, y)}
    return OpCounts(
        flops=2.0 * n * r * r * len(pairs),
        hbm_bytes=float(len(distinct)) * n * r * itemsize,
    )


def block_update_counts(n: int, r: int, itemsize: int,
                        terms: int = 1) -> OpCounts:
    """``terms`` block updates ``Y + X @ M`` in one pass: per term, stream
    X and Y in and the result out (2·n·r² matmul flops + n·r adds); the
    (r, r) coefficient blocks are noise next to the streamed blocks."""
    return OpCounts(
        flops=(2.0 * n * r * r + n * r) * terms,
        hbm_bytes=3.0 * n * r * itemsize * terms,
    )


def pointwise_counts(n: int, itemsize: int, reads: int) -> OpCounts:
    """Elementwise vector work not covered by a dispatch op: ``reads``
    streamed operands + one written result, one flop per read."""
    return OpCounts(
        flops=float(reads * n), hbm_bytes=float((reads + 1) * n * itemsize)
    )


# ---------------------------------------------------------------------------
# Trace -> PowerMonitor ledger
# ---------------------------------------------------------------------------


def monitor_from_trace(
    tr: EnergyTrace,
    *,
    iters: int,
    n_shards: int,
    cost=None,
    devices_per_host: int = 4,
    overlap: bool = True,
    idle_s: float = 0.0,
    setup_repeats: int = 1,
):
    """Integrate the traced per-region counts into a PowerMonitor.

    Setup-section regions are replayed ``setup_repeats`` times (1 for a
    solve; the repeat count for a benchmark that re-runs a straight-line
    program); iteration-section regions are replayed ``iters`` times (the
    executed iteration count). The resulting monitor's segment names are the
    region names, so ``monitor.energy_by_region()`` is the executed
    per-component ledger and sums to ``monitor.energy()`` totals exactly.

    ``overlap`` is the implementation-wide default (True for the
    BCMGX-analog paths, False for the serialized Ginkgo analog); the
    :data:`OVERLAP` region is always modeled overlapped regardless — that
    region *is* the co-scheduled compute+communication phase.
    """
    from repro_torch.energy.monitor import PowerMonitor

    mon = PowerMonitor(
        n_devices=n_shards, cost=cost, devices_per_host=devices_per_host
    )
    if idle_s > 0:
        mon.idle(idle_s)
    # hides_comm: only the OVERLAP region's compute is independent of its
    # collective by construction, so only it earns comm_hidden_s credit — a
    # blocking all-reduce (hs/fcg reductions) keeps the overlapped time
    # model but reports its latency exposed (matches roofline CG_COMM).
    for name, c in sorted(tr.regions(SETUP).items()):
        mon.region(
            name, c, n_shards=n_shards, overlap=overlap or name == OVERLAP,
            hides_comm=name == OVERLAP, repeats=max(int(setup_repeats), 1),
            section=SETUP,
        )
    for name, c in sorted(tr.regions(ITERATION).items()):
        mon.region(
            name, c, n_shards=n_shards, overlap=overlap or name == OVERLAP,
            hides_comm=name == OVERLAP, repeats=max(int(iters), 1),
            section=ITERATION,
        )
    if idle_s > 0:
        mon.idle(idle_s)
    return mon


def ledger_from_trace(
    tr: EnergyTrace,
    *,
    iters: int,
    n_shards: int,
    cost=None,
    devices_per_host: int = 4,
    overlap: bool = True,
    idle_s: float = 0.0,
    setup_repeats: int = 1,
) -> dict:
    """JSON-ready executed-energy ledger: per-region + totals.

    ``regions[name]`` carries modeled time, dynamic/total energy, the
    exposed-vs-hidden communication split (``comm_s`` / ``comm_exposed_s`` /
    ``comm_hidden_s``), and the raw activity counts; ``totals`` is the
    PowerMonitor energy dict (same comm split summed over regions). The idle
    padding segments carry zero dynamic energy and zero counts, so they are
    dropped from ``regions`` (their duration still extends
    ``totals.runtime`` and the static-energy terms) — by construction
    ``sum(regions[*].de_j) == totals.de_total``. Field-by-field reference:
    ``docs/ledger_schema.md``.
    """
    mon = monitor_from_trace(
        tr, iters=iters, n_shards=n_shards, cost=cost,
        devices_per_host=devices_per_host, overlap=overlap, idle_s=idle_s,
        setup_repeats=setup_repeats,
    )
    by_region = {
        k: v for k, v in mon.energy_by_region().items() if k != "idle"
    }
    iter_counts = tr.regions(ITERATION)
    setup_counts = tr.regions(SETUP)
    regions = {}
    for name, e in by_region.items():
        c = setup_counts.get(name, ZERO) * float(
            max(int(setup_repeats), 1)
        ) + iter_counts.get(name, ZERO) * float(max(int(iters), 1))
        regions[name] = dict(
            e,
            flops=c.flops,
            hbm_bytes=c.hbm_bytes,
            hbm_matrix_bytes=c.hbm_matrix_bytes,
            ici_bytes=c.ici_bytes,
            n_collectives=c.n_collectives,
        )
    return dict(
        iters=int(iters),
        n_shards=int(n_shards),
        regions=regions,
        totals=mon.energy(),
    )
