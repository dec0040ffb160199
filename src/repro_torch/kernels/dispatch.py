"""Kernel dispatch for the solver hot path (port of ``repro.kernels.dispatch``).

Two backends, chosen by the device the operands live on:

* ``cuda``  — the hand-written Hopper kernels (kernels/fused_reductions.py);
  every CUDA tensor goes here, always.
* ``torch`` — the plain PyTorch versions (kernels/ref.py), for CPU tensors.

``ops_for(None)`` follows the operands. An explicit choice only checks:
``ops_for("torch")`` raises on a CUDA tensor and ``ops_for("cuda")`` on a
CPU tensor. There is no override or environment variable that sends a
CUDA tensor to the plain version.

Every op invocation is recorded in the active :class:`SweepLedger` (enabled
with :func:`record_sweeps`), tagged with the current :func:`ledger_section`,
and its per-shard :class:`OpCounts` go to the energy trace. The eager
solvers enter ``ledger_section("iteration")`` once per executed iteration,
and both ledgers divide by the number of entries, so "calls to vector ops
per iteration" == "full-vector HBM sweeps per iteration", as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter

import torch

from repro_torch.energy import trace
from repro_torch.energy.accounting import OpCounts
from repro_torch.kernels import fused_reductions as fr

BACKENDS = ("cuda", "torch")

# Ops that stream full-length vectors exactly once per call (1 sweep each).
VECTOR_OPS = (
    "axpy", "fused_axpy2", "fused_axpy2_dots", "fused_dots_n",
    "block_gram", "block_update", "block_update2",
    "sstep_gram", "sstep_basis", "sstep_update",
)
# The SpMV is accounted separately (its traffic is the matrix term).
SPMV_OPS = ("stencil_matvec", "stencil_boundary", "bcsr_spmv", "bcsr_spmm")


# ---------------------------------------------------------------------------
# Sweep ledger
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SweepLedger:
    """Counts op calls per section.

    ``ops[section]`` maps op name -> number of calls; ``entries[section]``
    counts how many times the section was entered (once per executed
    iteration for the iteration section), used to normalize.
    """

    ops: dict = dataclasses.field(default_factory=dict)
    entries: dict = dataclasses.field(default_factory=dict)

    def count(self, section: str, name: str):
        self.ops.setdefault(section, Counter())[name] += 1

    def enter(self, section: str):
        self.entries[section] = self.entries.get(section, 0) + 1

    def vector_sweeps(self, section: str = "iteration") -> float:
        """Full-vector HBM sweeps per section entry (excludes the SpMV)."""
        c = self.ops.get(section, Counter())
        n = max(self.entries.get(section, 1), 1)
        return sum(v for k, v in c.items() if k in VECTOR_OPS) / n

    def spmv_calls(self, section: str = "iteration") -> float:
        c = self.ops.get(section, Counter())
        n = max(self.entries.get(section, 1), 1)
        return sum(v for k, v in c.items() if k in SPMV_OPS) / n


_ledger: SweepLedger | None = None
_section: str = "default"


@contextlib.contextmanager
def record_sweeps():
    """Activate a ledger; run solvers inside."""
    global _ledger
    prev = _ledger
    _ledger = SweepLedger()
    try:
        yield _ledger
    finally:
        _ledger = prev


@contextlib.contextmanager
def ledger_section(name: str):
    """Tag ops run inside with ``name`` (e.g. 'iteration').

    Also switches the energy-trace section (energy/trace.py), so the sweep
    ledger and the executed-counts region ledger stay in lockstep.
    """
    global _section
    prev = _section
    _section = name
    if _ledger is not None:
        _ledger.enter(name)
    try:
        with trace.section(name):
            yield
    finally:
        _section = prev


def _record(name: str, counts: OpCounts | None = None):
    if _ledger is not None:
        _ledger.count(_section, name)
    if counts is not None:
        trace.record_op(name, counts)


# ---------------------------------------------------------------------------
# Op set
# ---------------------------------------------------------------------------


def _require_vec(op: str, *ts):
    for t in ts:
        if t.dim() not in (1, 2):
            raise ValueError(
                f"{op} expects (S, R) stacked shard vectors or one (n,) "
                f"vector, got shape {tuple(t.shape)}"
            )


# executed-counts formulas shared with the other instrumented layers
_axpy_counts = trace.streamed_axpy_counts


class OpSet:
    """Hot-path ops; ``backend=None`` follows the operands' device."""

    def __init__(self, backend_name: str | None = None):
        assert backend_name in BACKENDS + (None,)
        self.backend = backend_name

    def __repr__(self):
        return f"OpSet(backend={self.backend!r})"

    def _check(self, op: str, t: torch.Tensor):
        on_cuda = t.device.type == "cuda"
        if self.backend == "torch" and on_cuda:
            raise ValueError(
                f"{op}: backend 'torch' is the plain version for CPU tensors; "
                "CUDA tensors always launch the kernel"
            )
        if self.backend == "cuda" and not on_cuda:
            raise ValueError(
                f"{op}: backend 'cuda' launches kernels and needs CUDA "
                f"tensors, got a tensor on {t.device}"
            )

    # -- fused vector ops (1 HBM sweep each) --------------------------------

    def axpy(self, a, x, y):
        """``a*x + y`` for a scalar ``a`` and stacked vectors ``x``/``y``.

        One fused HBM pass: 2R flops, 3R elements streamed per shard.
        """
        _require_vec("axpy", x, y)
        self._check("axpy", x)
        _record("axpy", _axpy_counts(x.shape[-1], x.element_size()))
        return fr.fused_axpy(a, x, y)

    def fused_axpy2_dots(self, a1, x1, y1, a2, x2, y2):
        """``(a1*x1+y1, a2*x2+y2, [o2·o2])`` in ONE pass.

        The third output is the per-shard partial squared norm of the
        second output — ``(S, 1)`` partials the caller all-reduces. Same
        HBM traffic as two fused axpys, +2R flops.
        """
        _require_vec("fused_axpy2_dots", x1, y1, x2, y2)
        self._check("fused_axpy2_dots", x1)
        n, ib = x1.shape[-1], x1.element_size()
        _record(
            "fused_axpy2_dots",
            _axpy_counts(n, ib, 2) + OpCounts(flops=2.0 * n),
        )
        return fr.fused_axpy2_dots(a1, x1, y1, a2, x2, y2)

    def fused_dots_n(self, pairs):
        """Local partial dots ``[(x, y), ...] -> (S, len(pairs))``, ONE pass.

        Repeated operands are deduplicated (each distinct vector is
        streamed once). Results are per-shard partials — the caller
        all-reduces them.
        """
        _require_vec("fused_dots_n", *[a for p in pairs for a in p])
        self._check("fused_dots_n", pairs[0][0])
        _record("fused_dots_n", trace.local_dots_counts(pairs))
        return fr.fused_dots_n(pairs)


def ops_for(kernels: str | None = None) -> OpSet:
    """An :class:`OpSet`: None/'auto' follows the operands' device, or one
    of :data:`BACKENDS` (checked against every operand)."""
    if kernels is None or kernels.strip().lower() in ("", "auto"):
        return OpSet(None)
    name = kernels.strip().lower()
    if name not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {kernels!r}; want one of {BACKENDS} or 'auto'"
        )
    return OpSet(name)
