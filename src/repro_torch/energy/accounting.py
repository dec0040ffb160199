"""Operation counts + roofline cost/energy accounting (port of
``repro.energy.accounting``: ``OpCounts``, ``ZERO``, ``CostModel``).

``OpCounts`` carries the per-device activity of one operation: useful FLOPs,
HBM bytes moved, interconnect bytes sent, and the number of distinct
collectives (which pays a latency cost per hop).

``CostModel`` turns counts into modeled time and energy:

    T_compute = flops / peak_flops
    T_memory  = hbm_bytes / hbm_bw
    T_coll    = n_collectives * alpha * ceil(log2(S)) + ici_bytes / link_bw

    T = max(T_compute, T_memory) + T_coll          (serialized comm)
    T = max(T_compute, T_memory, T_coll)           (overlapped comm)

The declared-count helpers of the reference that take a ``DistMat``
(``spmv_counts``, ``cg_iteration_counts``, ...) are not ported yet: the
port's ledgers come from executed counts only (energy/trace.py).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.energy.model import PowerModel


@dataclasses.dataclass(frozen=True)
class OpCounts:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    ici_bytes: float = 0.0
    n_collectives: float = 0.0
    # The subset of ``hbm_bytes`` that is matrix traffic (stored values +
    # index layout).
    hbm_matrix_bytes: float = 0.0

    def __add__(self, o: "OpCounts") -> "OpCounts":
        return OpCounts(
            self.flops + o.flops,
            self.hbm_bytes + o.hbm_bytes,
            self.ici_bytes + o.ici_bytes,
            self.n_collectives + o.n_collectives,
            self.hbm_matrix_bytes + o.hbm_matrix_bytes,
        )

    def __mul__(self, k: float) -> "OpCounts":
        return OpCounts(
            self.flops * k, self.hbm_bytes * k, self.ici_bytes * k,
            self.n_collectives * k, self.hbm_matrix_bytes * k,
        )

    __rmul__ = __mul__


ZERO = OpCounts()


@dataclasses.dataclass(frozen=True)
class CostModel:
    power: PowerModel = PowerModel()
    alpha_latency: float = 5e-6  # per-collective latency per log2(S) hop [s]
    flops_efficiency: float = 0.85  # achievable fraction of peak
    bw_efficiency: float = 0.80
    # Per-collective tree depth override; None keeps ceil(log2(S)).
    coll_hops: float | None = None

    def at_freq(self, freq: float) -> "CostModel":
        """The same cost model on the chip downclocked to ``freq``."""
        if freq == 1.0:
            return self
        return dataclasses.replace(self, power=self.power.at_freq(freq))

    def times(self, c: OpCounts, n_shards: int, overlap: bool):
        chip = self.power.chip
        t_comp = c.flops / (chip.peak_flops_f32 * self.flops_efficiency)
        t_mem = c.hbm_bytes / (chip.hbm_bw * self.bw_efficiency)
        if self.coll_hops is not None:
            hops = self.coll_hops
        else:
            hops = max(math.ceil(math.log2(max(n_shards, 2))), 1)
        t_coll = (
            c.n_collectives * self.alpha_latency * hops
            + c.ici_bytes / chip.ici_bw
        )
        if n_shards == 1:
            t_coll = 0.0
        if overlap:
            t = max(t_comp, t_mem, t_coll)
        else:
            t = max(t_comp, t_mem) + t_coll
        return t, (t_comp, t_mem, t_coll)

    def device_energy(self, c: OpCounts, n_shards: int, overlap: bool):
        """(time, total_J, dynamic_J, peak_W) for ONE device executing c."""
        t, _ = self.times(c, n_shards, overlap)
        if t <= 0:
            return 0.0, 0.0, 0.0, self.power.chip_static_w
        p = self.power.chip_power(
            c.flops / t, c.hbm_bytes / t, c.ici_bytes / t
        )
        total = p * t
        dyn = (p - self.power.chip_static_w) * t
        return t, total, dyn, p
