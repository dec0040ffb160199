"""Search space of the energy-aware autotuner (port of
``repro.autotune.space``).

One :class:`Candidate` is a full operating point of the solver stack; every
axis maps onto an existing knob:

* ``fmt``     — interior storage format (``core/partition.py`` DistMat:
  ``ell`` / ``hyb`` / ``bcsr``, or ``auto``, resolved at prune time by the
  stored-bytes model ``roofline/format_model.choose_format``);
* ``block``   — BCSR tile side (``br == bc``; ignored by the other formats);
* ``variant`` — CG variant (``core/cg.py``: ``hs`` / ``fcg`` / ``pipecg``,
  plus ``sstep`` when the caller opens the ``s`` axis);
* ``s``       — s-step block size (``sstep`` only): the trial partition is
  built with ``halo_depth=s`` ghost zones, so the matrix-powers basis pays
  one widened exchange and 1/s of a reduction per iteration against
  (s-1)/s redundant ghost sweeps;
* ``overlap`` — the communication-hiding schedule (``core/spmv.py``);
* ``grid``    — the 2-D ``(R, C)`` process grid, or None for 1-D;
* ``freq``    — relative DVFS point (``roofline/hw.ChipSpec.at_freq``). It
  is a model, not a clock: a candidate at ``freq < 1`` re-prices the same
  executed counts on the downclocked chip model, while the card runs at
  its own clock. Nothing in the port sets a clock or a power limit.

The space is small (about a hundred points): stage 1 (``prune.py``) scores
all of it analytically, stage 2 (``trial.py``) runs only the top-K
survivors.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.roofline.hw import DEFAULT_CHIP, ChipSpec

FORMATS = ("ell", "hyb", "bcsr", "auto")
VARIANTS = ("hs", "fcg", "pipecg")
BCSR_BLOCKS = (2, 4, 8)
#: Tuned s-step block sizes (the ``sstep_s`` axis of ``enumerate_space``;
#: :func:`autotune.autotune` opens it at 8 shards or more).
SSTEP_S = (2, 4, 6)
# deterministic variant order for sort_key; sstep ranks after the
# single-exchange variants (it is the most intrusive choice)
_VORDER = VARIANTS + ("sstep",)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One operating point of the tuning space."""

    fmt: str  # "ell" | "hyb" | "bcsr" | "auto" (resolved at prune time)
    variant: str  # "hs" | "fcg" | "pipecg" | "sstep"
    overlap: bool
    block: int = 4  # BCSR tile side; meaningful only when fmt == "bcsr"
    freq: float = 1.0  # relative DVFS point of the chip model
    grid: tuple | None = None  # (rows, cols) process grid; None = 1-D
    s: int = 1  # s-step block size; meaningful only when variant == "sstep"

    @property
    def exec_key(self) -> tuple:
        """Key of the *execution* this candidate requires. Frequency is not
        part of it: it only re-prices the traced counts, so candidates that
        differ in ``freq`` alone share one trial."""
        return (
            self.fmt,
            self.block if self.fmt == "bcsr" else 0,
            self.variant,
            self.overlap,
            self.grid,
            self.s if self.variant == "sstep" else 0,
        )

    @property
    def label(self) -> str:
        """Stable label, e.g. ``hyb/pipecg/ov/f0.6`` (a 2-D candidate
        appends ``/gRxC``; an s-step one ``/s4``)."""
        fmt = f"bcsr{self.block}" if self.fmt == "bcsr" else self.fmt
        ov = "ov" if self.overlap else "ser"
        base = f"{fmt}/{self.variant}/{ov}/f{self.freq:g}"
        if self.grid is not None:
            base += f"/g{self.grid[0]}x{self.grid[1]}"
        if self.variant == "sstep":
            base += f"/s{self.s}"
        return base

    def to_dict(self) -> dict:
        d = dict(
            fmt=self.fmt, variant=self.variant, overlap=self.overlap,
            block=self.block, freq=self.freq,
        )
        # left out when 1-D and when s == 1, as the JAX package's ledgers
        # and caches do
        if self.grid is not None:
            d["grid"] = list(self.grid)
        if self.s != 1:
            d["s"] = self.s
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        g = d.get("grid")
        return cls(
            fmt=str(d["fmt"]), variant=str(d["variant"]),
            overlap=bool(d["overlap"]), block=int(d["block"]),
            freq=float(d["freq"]),
            grid=tuple(int(v) for v in g) if g else None,
            s=int(d.get("s", 1)),
        )


#: The out-of-the-box configuration (``launch.solve`` defaults): ELL
#: interior, HS-CG, communication hiding on, nominal frequency. The pruner
#: always keeps it, so the chosen candidate never scores worse.
DEFAULT = Candidate(fmt="ell", variant="hs", overlap=True, block=4, freq=1.0)


def sort_key(c: Candidate) -> tuple:
    """Deterministic preference order for score ties: nominal frequency
    first (never downclock without a measured win), then the simplest
    format/variant/schedule, 1-D layout before a process grid."""
    return (
        -c.freq,
        FORMATS.index(c.fmt),
        c.block,
        _VORDER.index(c.variant),
        not c.overlap,
        c.grid or (),
        c.s,
    )


def enumerate_space(
    chip: ChipSpec = DEFAULT_CHIP,
    *,
    formats: Iterable[str] = FORMATS,
    variants: Iterable[str] = VARIANTS,
    overlaps: Iterable[bool] = (True, False),
    blocks: Iterable[int] = BCSR_BLOCKS,
    freqs: Iterable[float] | None = None,
    grids: Iterable[tuple | None] = (None,),
    sstep_s: Iterable[int] = (),
) -> list[Candidate]:
    """All candidates, deterministically ordered (``sort_key``).

    ``freqs`` defaults to the chip's DVFS grid (``ChipSpec.freq_points``).
    ``bcsr`` fans out over ``blocks``; the other formats carry the default
    tile side. ``grids`` defaults to the 1-D layout only and ``sstep_s`` to
    no s-step candidate; :func:`autotune.autotune` opens both at 8 shards
    or more.
    """
    freqs = tuple(freqs) if freqs is not None else chip.freq_points
    out = []
    for fmt in formats:
        fmt_blocks = tuple(blocks) if fmt == "bcsr" else (DEFAULT.block,)
        for block in fmt_blocks:
            for variant in variants:
                for overlap in overlaps:
                    for freq in freqs:
                        for grid in grids:
                            out.append(
                                Candidate(fmt, variant, overlap, block,
                                          freq, grid)
                            )
            for s in sstep_s:
                for overlap in overlaps:
                    for freq in freqs:
                        for grid in grids:
                            out.append(
                                Candidate(fmt, "sstep", overlap, block,
                                          freq, grid, s=int(s))
                            )
    return sorted(out, key=sort_key)
