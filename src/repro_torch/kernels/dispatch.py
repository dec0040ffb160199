"""Kernel dispatch for the solver hot path (port of ``repro.kernels.dispatch``).

Two backends, chosen by the device the operands live on:

* ``cuda``  — the hand-written Hopper kernels (kernels/fused_reductions.py,
  kernels/spmv_bcsr.py); every CUDA tensor goes here, always.
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
from repro_torch.kernels import spmv_bcsr as sb

BACKENDS = ("cuda", "torch")

# Ops that stream full-length vectors exactly once per call (1 sweep each).
VECTOR_OPS = (
    "axpy", "fused_axpy2", "fused_axpy2_dots", "fused_dots_n",
    "block_gram", "block_update", "block_update2",
    "sstep_gram", "sstep_basis", "sstep_update",
)
# The SpMV is accounted separately (its traffic is the matrix term);
# bcsr_spmv is the blocked interior matvec of the BCSR-format DistMat and
# bcsr_spmm its multi-RHS sibling.
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


def _require_block(op: str, *ts):
    for t in ts:
        if t.dim() not in (2, 3):
            raise ValueError(
                f"{op} expects (S, R, r) stacked shard blocks or one (n, r) "
                f"block, got shape {tuple(t.shape)}"
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

    def fused_axpy2(self, a1, x1, y1, a2, x2, y2):
        """``(a1*x1 + y1, a2*x2 + y2)`` — two independent axpys, ONE pass.

        The two updates may not feed each other (they are evaluated from
        the inputs as given). Counts as a single HBM sweep of 6R streamed
        elements / 4R flops per shard.
        """
        _require_vec("fused_axpy2", x1, y1, x2, y2)
        self._check("fused_axpy2", x1)
        _record("fused_axpy2", _axpy_counts(x1.shape[-1], x1.element_size(), 2))
        return fr.fused_axpy2(a1, x1, y1, a2, x2, y2)

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

    # -- multi-RHS block ops (1 HBM sweep each) -----------------------------

    def block_gram(self, pairs):
        """Local Gram blocks ``[Xᵀ @ Y, ...]`` for stacked ``(S, R, r)``
        pairs, ONE pass: one ``(S, r, r)`` per-shard partial per pair.

        Each distinct operand block is streamed once. Results are
        per-shard partials — callers pack them into one all-reduce
        (``fused_blocks``). Order-sensitive (XᵀY != YᵀX).
        """
        _require_block("block_gram", *[a for p in pairs for a in p])
        self._check("block_gram", pairs[0][0])
        _record("block_gram", trace.block_gram_counts(pairs))
        return fr.block_gram(pairs)

    def block_update(self, m, x, y, mask=None):
        """``y * mask + x @ m`` for ``(S, R, r)`` blocks and an ``(r, r)``
        coefficient block; ``mask`` is an optional ``(r,)`` column scale
        (the deflation mask) folded into the same pass. One sweep: read x,
        y; write the result."""
        _require_block("block_update", x, y)
        self._check("block_update", x)
        n, r = x.shape[-2:]
        _record("block_update", trace.block_update_counts(n, r, x.element_size()))
        return fr.block_update(m, x, y, mask)

    def block_update2(self, a1, x1, y1, a2, x2, y2):
        """``(y1 + x1 @ a1, y2 + x2 @ a2)`` — the block-CG X/R update pair
        in ONE pass over all four ``(S, R, r)`` blocks."""
        _require_block("block_update2", x1, y1, x2, y2)
        self._check("block_update2", x1)
        n, r = x1.shape[-2:]
        _record("block_update2",
                trace.block_update_counts(n, r, x1.element_size(), terms=2))
        return fr.block_update2(a1, x1, y1, a2, x2, y2)

    # -- SpMV -----------------------------------------------------------------

    def bcsr_spmv(self, blocks, bcol, x, *, n_brows, bpr, n_out=None):
        """Uniform-layout block-CSR SpMV (the BCSR DistMat interior).

        ``blocks`` is the stacked ``(S, n_brows*bpr, br, bc)`` tile array
        and ``bcol`` its ``(S, n_brows*bpr)`` block-column ids
        (``core.sparse.pack_bcsr`` layout, padding tiles zero with
        ``bcol == 0``); ``x`` is ``(S, R)``, the result ``(S, n_out)``.
        Accounted per shard as one streaming pass over the tiles, the block
        ids and the source vector (its length before any padding), writing
        the ``n_brows*br`` blocked result rows.
        """
        self._check("bcsr_spmv", x)
        _, nbk, br, bc = blocks.shape
        b = x.element_size()
        mat_bytes = float(nbk * br * bc * b + nbk * bcol.element_size())
        _record(
            "bcsr_spmv",
            OpCounts(
                flops=2.0 * nbk * br * bc,
                hbm_bytes=mat_bytes + float(x.shape[1] * b + n_brows * br * b),
                hbm_matrix_bytes=mat_bytes,
            ),
        )
        return sb.bcsr_spmv(blocks, bcol, x, n_brows=n_brows, bpr=bpr, n_out=n_out)

    def bcsr_spmm(self, blocks, bcol, x, *, n_brows, bpr, n_out=None):
        """Multi-RHS :meth:`bcsr_spmv`: ``x`` is an ``(S, R, r)`` block. The
        tiles and ids are streamed ONCE while vector traffic scales with
        ``r`` — the amortization the multi-RHS solver exists for, visible
        in the recorded ``hbm_matrix_bytes``."""
        self._check("bcsr_spmm", x)
        _, nbk, br, bc = blocks.shape
        R, r = x.shape[1], x.shape[-1]
        b = x.element_size()
        mat_bytes = float(nbk * br * bc * b + nbk * bcol.element_size())
        _record(
            "bcsr_spmm",
            OpCounts(
                flops=2.0 * nbk * br * bc * r,
                hbm_bytes=mat_bytes + float(R * r * b + n_brows * br * r * b),
                hbm_matrix_bytes=mat_bytes,
            ),
        )
        return sb.bcsr_spmm(blocks, bcol, x, n_brows=n_brows, bpr=bpr, n_out=n_out)


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
