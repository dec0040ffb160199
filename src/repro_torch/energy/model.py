"""Calibrated analytical power model (the port's copy of ``repro.energy.model``).

Per-chip instantaneous power:

    P(t) = P_idle + e_flop * FLOP/s + e_hbm * B_hbm/s + e_ici * B_ici/s,
    clamped to P_peak.

Calibration (per published energy-cost-of-data-movement studies
[Kestor'13, Delestrac'24], applied to the chip envelope in roofline/hw.py):

* a roofline-saturating bf16 matmul (peak bf16 FLOP/s + full HBM rate)
  draws P_peak;
* an HBM-saturating stream (full HBM rate, negligible flops) draws ~65% of
  the dynamic envelope — data movement dominates FP energy;
* interconnect transfer energy per byte is ~2x HBM energy per byte.

Solving those three constraints for (e_flop, e_hbm, e_ici):

    e_hbm  = 0.65 * (P_peak - P_idle) / HBM_bw            [J/B]
    e_flop = (0.35 * (P_peak - P_idle)) / peak_flops       [J/FLOP]
    e_ici  = 2 * e_hbm                                     [J/B]

The host (CPU) model is LIKWID-socket-scoped: P_idle plus an active
increment while the host drives collectives/launch work.

DVFS axis: :meth:`PowerModel.at_freq` re-derives the same three calibration
constraints on the downclocked chip (``ChipSpec.at_freq``), so ``e_ici ==
2 * e_hbm`` and the clamp to the (scaled) ``p_peak_w`` hold at every grid
point.
"""

from __future__ import annotations

import dataclasses

from repro_torch.roofline.hw import DEFAULT_CHIP, DEFAULT_HOST, ChipSpec, HostSpec


@dataclasses.dataclass(frozen=True)
class PowerModel:
    chip: ChipSpec = DEFAULT_CHIP
    host: HostSpec = DEFAULT_HOST
    hbm_fraction: float = 0.65  # share of dynamic envelope at HBM saturation
    ici_hbm_ratio: float = 2.0  # ICI J/B relative to HBM J/B

    def at_freq(self, freq: float) -> "PowerModel":
        """The same calibrated model on the chip downclocked to ``freq``
        (relative; see :meth:`ChipSpec.at_freq`). Identity at 1.0."""
        if freq == 1.0:
            return self
        return dataclasses.replace(self, chip=self.chip.at_freq(freq))

    @property
    def dyn_envelope(self) -> float:
        return self.chip.p_peak_w - self.chip.p_idle_w

    @property
    def e_hbm(self) -> float:  # J/B
        return self.hbm_fraction * self.dyn_envelope / self.chip.hbm_bw

    @property
    def e_flop(self) -> float:  # J/FLOP
        return (1.0 - self.hbm_fraction) * self.dyn_envelope / self.chip.peak_flops_bf16

    @property
    def e_ici(self) -> float:  # J/B
        return self.ici_hbm_ratio * self.e_hbm

    def chip_power(self, flops_per_s: float, hbm_bps: float, ici_bps: float) -> float:
        """Instantaneous per-chip power [W] for the given activity rates."""
        p = (
            self.chip.p_idle_w
            + self.e_flop * flops_per_s
            + self.e_hbm * hbm_bps
            + self.e_ici * ici_bps
        )
        return min(p, self.chip.p_peak_w)

    def host_power(self, active_fraction: float = 0.0) -> float:
        """Host socket power; ``active_fraction`` in [0, 1] scales the
        active increment."""
        return self.host.p_idle_w + active_fraction * self.host.p_active_w

    # Convenience idle levels (static power in the paper's terminology).
    @property
    def chip_static_w(self) -> float:
        return self.chip.p_idle_w

    @property
    def host_static_w(self) -> float:
        return self.host.p_idle_w
