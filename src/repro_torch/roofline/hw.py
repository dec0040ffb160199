"""Hardware constants for the roofline/energy models of the port.

Target platform: one NVIDIA H100 SXM (80 GB HBM3). The constants
parameterize the analytical cost and power models only; nothing here
configures PyTorch or CUDA. ``ChipSpec``/``HostSpec`` keep the field names
of ``repro.roofline.hw`` so a ledger built with either package's chip
spec has the same shape; the tests price the port's executed counts with
the JAX package's own chip spec to compare the two ledgers field for field.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip capability + power envelope."""

    name: str
    # Compute.
    peak_flops_bf16: float  # FLOP/s
    peak_flops_f32: float  # FLOP/s
    # Memory.
    hbm_bytes: float
    hbm_bw: float  # bytes/s
    vmem_bytes: float
    # Interconnect (per-link, per-direction).
    ici_bw: float  # bytes/s per link
    ici_links: int  # links per chip
    # Power model (see energy/model.py for calibration notes).
    p_idle_w: float
    p_peak_w: float
    # DVFS axis: relative core-frequency grid; 1.0 is the calibration point
    # of the constants above.
    freq_points: tuple[float, ...] = (0.6, 0.8, 1.0)
    # Voltage floor as a fraction of nominal V as f -> 0; V scales linearly
    # with f above the floor (the classic P_dyn ~ f * V^2 DVFS model).
    v_floor: float = 0.5

    def v_frac(self, freq: float) -> float:
        """Relative supply voltage at relative core frequency ``freq``."""
        return self.v_floor + (1.0 - self.v_floor) * freq

    def at_freq(self, freq: float) -> "ChipSpec":
        """This chip downclocked to relative core frequency ``freq``.

        Compute and its dynamic power envelope scale with the core clock
        (``P_dyn ~ f * V(f)^2``, ``V`` linear in ``f`` down to ``v_floor``);
        HBM and the interconnect run their own clock domains and are held
        flat. Static (idle) power is leakage and does not scale.
        """
        if not 0.0 < freq <= 1.0:
            raise ValueError(f"relative frequency must be in (0, 1]: {freq}")
        if freq == 1.0:
            return self
        v = self.v_frac(freq)
        dyn = (self.p_peak_w - self.p_idle_w) * freq * v * v
        return dataclasses.replace(
            self,
            name=f"{self.name}@f{freq:g}",
            peak_flops_bf16=self.peak_flops_bf16 * freq,
            peak_flops_f32=self.peak_flops_f32 * freq,
            p_peak_w=self.p_idle_w + dyn,
        )


#: NVIDIA H100 SXM5 80 GB. Rates from NVIDIA's H100 Tensor Core GPU data
#: sheet (SXM column, dense, without sparsity); power from the card itself.
H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,  # data sheet: BF16 tensor core, dense
    peak_flops_f32=67e12,  # data sheet: FP32 outside the tensor cores
    hbm_bytes=80e9,  # data sheet: 80 GB HBM3
    hbm_bw=3.35e12,  # data sheet: 3.35 TB/s
    # On-chip memory a streamed tile can stay in: the 50 MB L2 cache
    # (Hopper architecture white paper).
    vmem_bytes=50 * 2**20,
    # Data sheet: NVLink 900 GB/s in total, 450 GB/s each way. Through the
    # NVSwitch all 18 links reach any peer, so the model carries them as one
    # 450 GB/s link per direction.
    ici_bw=450e9,
    ici_links=1,
    # Measured by chip_smoke.py on "NVIDIA H100 80GB HBM3, 700.00 W"
    # (nvidia-smi name, power.limit): the static power is the idle
    # power.draw it read before any work, the peak is the power limit.
    p_idle_w=72.46,
    p_peak_w=700.0,
)


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """Host (CPU socket) power envelope — LIKWID/RAPL-style socket scope."""

    name: str
    p_idle_w: float
    p_active_w: float  # additional power when the host is driving collectives/IO


HOST_XEON = HostSpec(name="xeon_gold_2s", p_idle_w=90.0, p_active_w=35.0)

# Default platform used across roofline + energy accounting.
DEFAULT_CHIP = H100_SXM
DEFAULT_HOST = HOST_XEON
