"""powerMonitor analog: region-marked power-time curves + integration.

Reproduces the workflow of the paper's powerMonitor/GPowerU + LIKWID
MarkerAPI setup (Fig. 1): a monitor is started, the application executes
region-marked kernels, and per-device power samples are integrated into
total / static / dynamic energy, with idle<->active transition markers and
power-peak extraction (Fig. 2).

Because the power source here is the analytical model (see energy/model.py),
a "sample" is generated from the region's activity rates rather than read
from NVML; the sampling frequency (default 1 kHz, the paper samples NVML
~20x per ms) only affects curve rendering, not the integral, which is
computed exactly per segment.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager

import numpy as np

from repro_torch.energy.accounting import CostModel, OpCounts
from repro_torch.energy.model import PowerModel


@dataclasses.dataclass
class Segment:
    name: str
    t0: float
    t1: float
    chip_w: float  # per-device power during this segment
    host_active: float  # host active fraction (drives comm/launch)
    # modeled engine times over the whole segment (all repeats), seconds
    t_comp: float = 0.0
    t_mem: float = 0.0
    t_coll: float = 0.0
    overlapped: bool = True  # was the collective co-scheduled with compute?
    section: str = ""  # accounting section ("setup"/"iteration"/"idle")

    @property
    def dt(self) -> float:
        return self.t1 - self.t0

    @property
    def comm_hidden_s(self) -> float:
        """Collective time absorbed behind compute/memory (overlap model)."""
        if not self.overlapped:
            return 0.0
        return min(self.t_coll, max(self.t_comp, self.t_mem))

    @property
    def comm_exposed_s(self) -> float:
        """Collective time the segment actually waits on."""
        return self.t_coll - self.comm_hidden_s


class PowerMonitor:
    """Builds per-device power-time curves from region-marked execution."""

    def __init__(
        self,
        n_devices: int,
        cost: CostModel | None = None,
        devices_per_host: int = 4,  # the paper's nodes: 4 GPUs / dual-socket
    ):
        self.cost = cost or CostModel()
        self.model: PowerModel = self.cost.power
        self.n_devices = n_devices
        self.devices_per_host = devices_per_host
        self.segments: list[Segment] = []
        self._t = 0.0

    # -- recording ----------------------------------------------------------

    def idle(self, duration: float, name: str = "idle"):
        self._push(name, duration, self.model.chip_static_w, 0.0,
                   section="idle")

    def region(
        self,
        name: str,
        counts: OpCounts,
        *,
        n_shards: int | None = None,
        overlap: bool = True,
        hides_comm: bool | None = None,
        repeats: int = 1,
        duration: float | None = None,
        section: str = "",
    ) -> float:
        """Record a modeled region executing ``counts`` per device.

        Returns the modeled duration (seconds) of the whole region.
        ``duration`` overrides the modeled time (e.g. measured wall time on
        real hardware); the collective exposed/hidden split always comes
        from the modeled engine times. ``overlap`` selects the segment's
        comm schedule: ``max(compute, memory, collective)`` when True,
        ``max(compute, memory) + collective`` when False. ``hides_comm``
        controls whether the segment *credits* collective time as hidden
        (``comm_hidden_s``); default = ``overlap``. Trace-derived ledgers
        pass ``hides_comm`` only for the ``"overlap"`` region, where the
        compute is independent of the collective by construction — a
        blocking all-reduce whose result feeds the same region's updates
        keeps the overlapped *time* model but reports its latency exposed.
        """
        S = n_shards if n_shards is not None else self.n_devices
        _, (tc, tm, tl) = self.cost.times(counts, S, overlap)
        t, _, _, p = self.cost.device_energy(counts, S, overlap)
        t = t if duration is None else duration / max(repeats, 1)
        comm_frac = 0.0
        if counts.hbm_bytes + counts.ici_bytes > 0:
            comm_frac = counts.ici_bytes / (counts.hbm_bytes + counts.ici_bytes)
        self._push(
            name, t * repeats, p, min(1.0, 4.0 * comm_frac),
            t_comp=tc * repeats, t_mem=tm * repeats, t_coll=tl * repeats,
            overlapped=overlap if hides_comm is None else hides_comm,
            section=section,
        )
        return t * repeats

    def _push(self, name, dt, chip_w, host_active, *, t_comp=0.0, t_mem=0.0,
              t_coll=0.0, overlapped=True, section=""):
        if dt <= 0:
            return
        self.segments.append(
            Segment(name, self._t, self._t + dt, chip_w, host_active,
                    t_comp, t_mem, t_coll, overlapped, section)
        )
        self._t += dt

    @contextmanager
    def wall_region(self, name: str, counts: OpCounts, **kw):
        """Measured-wall-time region (for real-hardware runs)."""
        t0 = time.perf_counter()
        yield
        self.region(name, counts, duration=time.perf_counter() - t0, **kw)

    # -- curves & integration ------------------------------------------------

    @property
    def duration(self) -> float:
        return self._t

    def curve(self, hz: float = 1000.0):
        """(t, P_chip(t), P_host(t)) sampled curves (one device / one host)."""
        n = max(int(self.duration * hz), 2)
        ts = np.linspace(0.0, self.duration, n)
        p_chip = np.full(n, self.model.chip_static_w)
        p_host = np.full(n, self.model.host_static_w)
        for s in self.segments:
            m = (ts >= s.t0) & (ts < s.t1)
            p_chip[m] = s.chip_w
            p_host[m] = self.model.host_power(s.host_active)
        return ts, p_chip, p_host

    def energy_by_region(self):
        """Per-region energy ledger: segments aggregated by name.

        Returns ``{name: {time_s, te_gpu_j, de_gpu_j, de_cpu_j, de_j,
        comm_s, comm_exposed_s, comm_hidden_s}}`` summed over all
        devices/hosts (times are per-device-timeline seconds). Because
        segments partition the timeline, ``sum(de_j)`` over regions equals
        ``energy()['de_total']`` exactly — the invariant the executed-energy
        ledger is gated on. ``comm_s`` is the region's modeled collective
        time; ``comm_hidden_s`` the part absorbed behind concurrent
        compute/memory (nonzero only for overlapped segments, e.g. the
        ``"overlap"`` region); ``comm_exposed_s`` the remainder the timeline
        actually waits on.
        """
        n_hosts = max(self.n_devices // self.devices_per_host, 1)
        chip0 = self.model.chip_static_w
        host0 = self.model.host_static_w
        out: dict[str, dict] = {}
        for s in self.segments:
            d = out.setdefault(
                s.name,
                dict(time_s=0.0, te_gpu_j=0.0, de_gpu_j=0.0, de_cpu_j=0.0,
                     de_j=0.0, comm_s=0.0, comm_exposed_s=0.0,
                     comm_hidden_s=0.0),
            )
            de_gpu = (s.chip_w - chip0) * s.dt * self.n_devices
            de_cpu = (self.model.host_power(s.host_active) - host0) * s.dt * n_hosts
            d["time_s"] += s.dt
            d["te_gpu_j"] += s.chip_w * s.dt * self.n_devices
            d["de_gpu_j"] += de_gpu
            d["de_cpu_j"] += de_cpu
            d["de_j"] += de_gpu + de_cpu
            d["comm_s"] += s.t_coll
            d["comm_exposed_s"] += s.comm_exposed_s
            d["comm_hidden_s"] += s.comm_hidden_s
        return out

    def energy(self):
        """Exact per-segment integration -> paper §4.2 quantities.

        Returns a dict with chip/host total, static, dynamic energy (summed
        over all devices/hosts), the chip power peak, and the modeled
        communication split: ``comm_s`` (total collective seconds),
        ``comm_hidden_s`` (overlapped behind compute) and ``comm_exposed_s``
        (actually waited on) — all per device timeline.
        """
        T = self.duration
        n_hosts = max(self.n_devices // self.devices_per_host, 1)
        te_chip = sum(s.chip_w * s.dt for s in self.segments) * self.n_devices
        se_chip = self.model.chip_static_w * T * self.n_devices
        te_host = (
            sum(self.model.host_power(s.host_active) * s.dt for s in self.segments)
            * n_hosts
        )
        se_host = self.model.host_static_w * T * n_hosts
        peak = max((s.chip_w for s in self.segments), default=self.model.chip_static_w)
        return dict(
            runtime=T,
            comm_s=sum(s.t_coll for s in self.segments),
            comm_exposed_s=sum(s.comm_exposed_s for s in self.segments),
            comm_hidden_s=sum(s.comm_hidden_s for s in self.segments),
            te_gpu=te_chip,
            se_gpu=se_chip,
            de_gpu=te_chip - se_chip,
            te_cpu=te_host,
            se_cpu=se_host,
            de_cpu=te_host - se_host,
            de_total=(te_chip - se_chip) + (te_host - se_host),
            gpu_power_peak=peak,
            # paper Tables 2-6: dynamic as % of static
            gpu_pct=100.0 * (te_chip - se_chip) / max(se_chip, 1e-12),
            cpu_pct=100.0 * (te_host - se_host) / max(se_host, 1e-12),
            total_pct=100.0
            * ((te_chip - se_chip) + (te_host - se_host))
            / max(se_chip + se_host, 1e-12),
        )
