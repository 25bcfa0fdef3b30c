"""Shared-fabric multi-host simulation — the paper's pooling scenario,
ported from ``repro/core/fabric.py`` in synchronous mode.

The headline use case of CXL.mem is *pooling*: several servers attach to the
same expanders to fix memory stranding.  The interesting effects — queueing
at shared switches, noisy-neighbor bandwidth collapse, back-invalidation
storms — only appear when real per-host traces contend on one fabric.
:class:`FabricSession` makes that happen:

  1. **co-attach** N tenants (step functions or trace-only workloads) on a
     single :class:`~repro_torch.core.topology.Topology` with
     ``n_hosts == N``: per-tenant placement onto the shared pools, with a
     fabric-wide capacity check (stranding is a *sum* over tenants);
  2. **align** their epoch streams onto one shared timeline: co-scheduled
     rounds start at the same fabric instant, so epoch ``k`` of every tenant
     merges into one host-tagged, time-sorted trace;
  3. **analyze** each merged timeline in **one** batched dispatch per round
     through the ordinary :class:`~repro_torch.core.analyzer.EpochAnalyzer`
     on ``device`` — contention falls out of the (host, pool) route matrix,
     and the per-host delay decomposition comes back host-segmented from the
     same device pass (the host-segmented cascade kernel on the card);
  4. **coherency**: sharer sets and write fractions are derived from the
     actual per-host traces (:meth:`CoherencyModel.fabric_traffic`) and BI
     events are injected into the specific sharers' streams before the merge.

With one tenant the session degenerates to the single-host pipeline: the
merged timeline is the tenant's own trace and the analysis equals
:class:`~repro_torch.core.attach.CXLMemSim`'s.

Reported clocks: per-host native seconds (measured when the tenant has a
real step function, roofline-estimated otherwise), per-host simulated
seconds (native + that host's delay share), and the fabric-wide contention
decomposition (latency / congestion / bandwidth / coherency, per switch,
per pool, per host).

Analysis is synchronous: each round analyzes on the caller's thread before
the tenants' native steps run.  The reference's overlapped rounds
(``async_analysis=True``, ``engine=``) and ``pipeline=True`` come with
slice 4 of the port, ``migration=`` and ``cache=`` with slice 3; asking for
them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .analyzer import DelayBreakdown, EpochAnalyzer
from .attach import _synchronize_outputs, _unsupported
from .coherency import CoherencyConfig, CoherencyModel
from .engine import EngineClient, fold_dispatch_stats
from .events import MemEvents, RegionMap, concat_events
from .policy import PlacementPolicy
from .timer import EpochSchedule
from .topology import Topology
from .tracer import H100_SXM, HardwareModel, Phase, synthesize_step_trace
from .units import ns_to_s

__all__ = ["FabricReport", "FabricSession", "HostClock", "Tenant"]


@dataclasses.dataclass
class Tenant:
    """One attached host's workload: a program (or trace-only load) plus its
    private region map and placement policy."""

    name: str
    phases: Sequence[Phase]
    regions: RegionMap
    policy: PlacementPolicy
    step_fn: Optional[Callable] = None  # None => trace-only (roofline clock)
    step_args: Tuple = ()
    calibration: float = 1.0
    sample_rate: float = 1.0
    qos_class: int = 0  # arbitration class at QoS-disciplined switches


@dataclasses.dataclass
class HostClock:
    """Per-host clocks + delay decomposition (the two clocks of the paper,
    one pair per attached host).  ``simulated_s`` is derived: native + this
    host's delay share."""

    host: int
    name: str
    steps: int = 0
    native_s: float = 0.0
    latency_s: float = 0.0
    congestion_s: float = 0.0
    bandwidth_s: float = 0.0
    coherency_s: float = 0.0

    @property
    def simulated_s(self) -> float:
        return self.native_s + self.delay_s

    @property
    def slowdown(self) -> float:
        return self.simulated_s / self.native_s if self.native_s > 0 else float("nan")

    @property
    def delay_s(self) -> float:
        return self.latency_s + self.congestion_s + self.bandwidth_s + self.coherency_s


@dataclasses.dataclass
class FabricReport:
    """Fabric-wide totals + per-host clocks + contention decomposition."""

    hosts: List[HostClock]
    rounds: int = 0
    epochs: int = 0
    latency_s: float = 0.0
    congestion_s: float = 0.0
    bandwidth_s: float = 0.0
    coherency_s: float = 0.0
    analyzer_s: float = 0.0
    bi_messages: float = 0.0
    migration_moved_bytes: float = 0.0
    cache_hit_fraction: float = float("nan")
    dropped_batches: int = 0  # round analyses lost to analyzer failures
    dropped_epochs: int = 0  # their epochs: totals exclude exactly these
    # sharded-dispatch observability (maxima over this session's dispatches)
    devices_used: int = 1
    shard_rows: int = 0
    padded_waste: float = 0.0
    coalesced_group_size: int = 1
    # pipeline-phase timing (sums over this session's dispatches)
    stage_s: float = 0.0
    transfer_s: float = 0.0
    compile_s: float = 0.0
    compute_s: float = 0.0
    donated_dispatches: int = 0
    aot_cache_hits: int = 0
    qos_classes: int = 1
    per_pool_latency_ns: Optional[np.ndarray] = None
    per_switch_congestion_ns: Optional[np.ndarray] = None
    per_switch_bandwidth_ns: Optional[np.ndarray] = None
    per_class_congestion_ns: Optional[np.ndarray] = None

    @property
    def delay_s(self) -> float:
        return self.latency_s + self.congestion_s + self.bandwidth_s + self.coherency_s

    def qos_delay_shares(self) -> List[float]:
        """Fraction of switch queueing delay charged to each QoS class."""
        pcc = self.per_class_congestion_ns
        if pcc is None:
            return [1.0]
        total = float(pcc.sum())
        if total <= 0.0:
            return [0.0] * len(pcc)
        return [float(x) / total for x in pcc]

    def summary(self) -> Dict[str, float]:
        """Fabric-wide scalars + per-host clocks — the same key set as the
        reference's report."""
        out = {
            "rounds": self.rounds,
            "epochs": self.epochs,
            "latency_s": self.latency_s,
            "congestion_s": self.congestion_s,
            "bandwidth_s": self.bandwidth_s,
            "coherency_s": self.coherency_s,
            "bi_messages": self.bi_messages,
            "analyzer_s": self.analyzer_s,
            "migration_moved_bytes": self.migration_moved_bytes,
            "cache_hit_fraction": self.cache_hit_fraction,
            "dropped_batches": self.dropped_batches,
            "dropped_epochs": self.dropped_epochs,
            "devices_used": self.devices_used,
            "shard_rows": self.shard_rows,
            "padded_waste": self.padded_waste,
            "coalesced_group_size": self.coalesced_group_size,
            "stage_s": self.stage_s,
            "transfer_s": self.transfer_s,
            "compile_s": self.compile_s,
            "compute_s": self.compute_s,
            "donated_dispatches": self.donated_dispatches,
            "aot_cache_hits": self.aot_cache_hits,
            "qos_classes": self.qos_classes,
            "qos_delay_shares": self.qos_delay_shares(),
        }
        for hc in self.hosts:
            out[f"host{hc.host}_native_s"] = hc.native_s
            out[f"host{hc.host}_simulated_s"] = hc.simulated_s
            out[f"host{hc.host}_slowdown"] = hc.slowdown
        return out


class FabricSession(EngineClient):
    """Co-attach N tenants on one shared topology; see the module docstring.

    The topology's ``n_hosts`` must match ``len(tenants)``; as a convenience
    a single-host topology is automatically re-declared for N hosts (same
    components, full port visibility), since the fabric layout itself is
    host-count independent.  ``device`` is where the analyzer runs:
    ``"cuda"`` (the default; raises when no card is present) or ``"cpu"``
    (the plain PyTorch versions).
    """

    def __init__(
        self,
        topology: Topology,
        tenants: Sequence[Tenant],
        epoch: EpochSchedule = EpochSchedule("step"),
        hw: HardwareModel = H100_SXM,
        coherency: Optional[CoherencyConfig] = None,
        migration=None,
        cache=None,
        n_windows: int = 128,
        check_capacity: bool = True,
        max_events_per_access: int = 64,
        async_analysis: bool = False,
        engine=None,
        pipeline: bool = False,
        device="cuda",
    ):
        if migration is not None:
            raise _unsupported("migration", "slice 3")
        if cache is not None:
            raise _unsupported("the device cache", "slice 3")
        if async_analysis or engine is not None:
            raise _unsupported("overlapped rounds (the shared engine)", "slice 4")
        if pipeline:
            raise _unsupported("the device-resident pipeline", "slice 4")
        if not tenants:
            raise ValueError("need at least one tenant")
        self.tenants = list(tenants)
        H = len(self.tenants)
        if topology.n_hosts not in (1, H):
            # an explicit multi-host declaration that disagrees with the
            # tenant count is a configuration error, not a convenience case
            raise ValueError(
                f"topology declares {topology.n_hosts} hosts but "
                f"{H} tenants were attached"
            )
        if topology.n_hosts != H:
            topology = Topology(
                topology.pools,
                topology.switches,
                rc_latency_ns=topology.rc_latency_ns,
                rc_bandwidth_gbps=topology.rc_bandwidth_gbps,
                rc_stt_ns=topology.rc_stt_ns,
                local_dram_latency_ns=topology.local_dram_latency_ns,
                n_hosts=H,
                host_ports=topology.host_ports or None,
                n_qos_classes=topology.n_qos_classes,
            )
        self.topology = topology
        self.flat = topology.flatten()
        self.epoch = epoch
        self.hw = hw
        self.max_events_per_access = max_events_per_access
        self._analyzer = EpochAnalyzer(self.flat, n_windows=n_windows, device=device)
        if coherency is not None and H == 1:
            # trace-driven coherency needs a second host to derive sharers
            # from; silently reporting zero BI traffic would look like a
            # coherency-free result.  The analytic single-host fallback
            # lives in CXLMemSim(coherency=CoherencyModel(...)).
            raise ValueError(
                "coherency on a single-tenant fabric has no sharers to "
                "derive from traces — attach via CXLMemSim for the "
                "analytic n_hosts-1 fallback"
            )
        self._coherency = (
            CoherencyModel(coherency) if coherency is not None else None
        )

        for h, t in enumerate(self.tenants):
            if not 0 <= t.qos_class < self.flat.n_qos_classes:
                raise ValueError(
                    f"tenant {t.name!r} declares qos_class={t.qos_class} but the "
                    f"fabric has {self.flat.n_qos_classes} QoS class(es)"
                )
            t.policy.place(t.regions, self.flat)
            for r in t.regions:
                if not self.flat.host_reachable[h, r.pool]:
                    raise ValueError(
                        f"tenant {t.name!r} (host {h}) placed region "
                        f"{r.name!r} in pool {self.flat.pool_names[r.pool]!r}, "
                        "which its ports cannot reach"
                    )
        if check_capacity:
            self._fabric_capacity_check()

        self._trace_cache: List[Optional[tuple]] = [None] * H
        self._round_cache: Optional[tuple] = None
        self._report = FabricReport(
            hosts=[HostClock(h, t.name) for h, t in enumerate(self.tenants)],
            qos_classes=self.flat.n_qos_classes,
            per_pool_latency_ns=np.zeros((self.flat.n_pools,)),
            per_switch_congestion_ns=np.zeros((self.flat.n_switches,)),
            per_switch_bandwidth_ns=np.zeros((self.flat.n_switches,)),
            per_class_congestion_ns=np.zeros((self.flat.n_qos_classes,)),
        )

    @property
    def report(self) -> FabricReport:
        """The accumulated fabric report."""
        return self._report

    # ------------------------------------------------------------------ #

    def _fabric_capacity_check(self) -> None:
        """Stranding check across tenants: shared pools hold the *sum* of
        every tenant's bytes; local DRAM (pool 0) is private per host.

        When a coherency config declares shared classes, regions of those
        classes that match by name across tenants are **one** pooled object
        (the shared-kv-cache scenario) and occupy capacity once — the same
        name-matching rule :meth:`CoherencyModel.fabric_traffic` uses to
        derive sharers.  Everything else is a private allocation and sums.
        """
        P = self.flat.n_pools
        shared_classes = (
            self._coherency.cfg.shared_classes if self._coherency else ()
        )
        shared = np.zeros((P,), np.float64)
        pooled_objects: Dict[Tuple[str, int], float] = {}  # (name, pool) -> max bytes
        for h, t in enumerate(self.tenants):
            local = 0.0
            for r in t.regions:
                if r.pool == 0:
                    local += r.nbytes
                elif r.tensor_class in shared_classes:
                    key = (r.name, r.pool)
                    pooled_objects[key] = max(pooled_objects.get(key, 0.0), r.nbytes)
                else:
                    shared[r.pool] += r.nbytes
            if local > self.flat.pool_capacity[0]:
                raise ValueError(
                    f"tenant {t.name!r} overflows its local DRAM: "
                    f"{local:.3e} > {self.flat.pool_capacity[0]:.3e} bytes"
                )
        for (name, p), nbytes in pooled_objects.items():
            shared[p] += nbytes
        for p in range(1, P):
            if shared[p] > self.flat.pool_capacity[p]:
                raise ValueError(
                    f"shared pool {self.flat.pool_names[p]!r} oversubscribed "
                    f"across tenants: {shared[p]:.3e} > "
                    f"{self.flat.pool_capacity[p]:.3e} bytes"
                )

    def _tenant_epochs(self, h: int) -> Tuple[List[MemEvents], float]:
        """Host ``h``'s per-round epoch traces (host-tagged) + native estimate."""
        if self._trace_cache[h] is None:
            t = self.tenants[h]
            mode = "layer" if self.epoch.mode == "layer" else "step"
            traces, native_ns, _ = synthesize_step_trace(
                t.phases,
                t.regions,
                hw=self.hw,
                granularity_bytes=t.policy.granularity_bytes,
                max_events_per_access=self.max_events_per_access,
                calibration=t.calibration,
                epoch_mode=mode,
            )
            if self.epoch.mode == "quantum":
                # dense: slice index k == absolute quantum k, so positional
                # alignment across tenants pairs genuinely co-scheduled time
                cut: List[MemEvents] = []
                for tr in traces:
                    cut.extend(self.epoch.slices(tr, dense=True))
                traces = cut
            if t.sample_rate < 1.0:
                traces = [
                    tr.sample(t.sample_rate, seed=i) for i, tr in enumerate(traces)
                ]
            traces = [tr.with_host(h).with_qos(t.qos_class) for tr in traces]
            self._trace_cache[h] = (traces, ns_to_s(float(sum(native_ns))))
        return self._trace_cache[h]

    def _merged_round(self) -> Tuple[List[MemEvents], np.ndarray]:
        """Align every tenant's epoch stream and merge each aligned group.

        Epoch ``k`` of each host starts at the same fabric instant (the
        co-scheduling assumption).  Returns the merged shared-timeline
        epochs and per-host coherency miss latency for the round.

        Tenant traces are round-invariant, so the merged timelines, BI
        injection and miss latencies are built once and replayed; only the
        coherency model's running totals advance per round.
        """
        H = len(self.tenants)
        if self._round_cache is not None:
            merged, miss_total, bi_msgs, bi_bytes, miss_sum = self._round_cache
            if self._coherency is not None:
                self._coherency.bi_messages_total += bi_msgs
                self._coherency.bi_bytes_total += bi_bytes
                self._coherency.coherency_delay_total_ns += miss_sum
            return merged, miss_total
        coh0 = (
            (0.0, 0.0)
            if self._coherency is None
            else (self._coherency.bi_messages_total, self._coherency.bi_bytes_total)
        )
        per_host = [self._tenant_epochs(h)[0] for h in range(H)]
        n_epochs = max(len(e) for e in per_host)
        merged: List[MemEvents] = []
        miss_total = np.zeros((H,), np.float64)
        for k in range(n_epochs):
            group = [
                e[k] if k < len(e) else MemEvents.empty() for e in per_host
            ]
            if self._coherency is not None:
                bi, miss = self._coherency.fabric_traffic(
                    group, [t.regions for t in self.tenants]
                )
                group = [
                    concat_events([g, b]) if b.n else g for g, b in zip(group, bi)
                ]
                miss_total += miss
            # traces are already host-tagged; concat + sort onto one timeline
            merged.append(concat_events(group).sorted_by_time())
        self._round_cache = (
            merged,
            miss_total,
            (self._coherency.bi_messages_total - coh0[0]) if self._coherency else 0.0,
            (self._coherency.bi_bytes_total - coh0[1]) if self._coherency else 0.0,
            float(miss_total.sum()),
        )
        return merged, miss_total

    # ------------------------------------------------------------------ #

    def _fold_round(
        self,
        bd: DelayBreakdown,
        miss_ns: np.ndarray,
        analyzer_s: float,
        n_epochs: int,
    ) -> None:
        """Fold one analyzed round into the report."""
        r = self._report
        r.rounds += 1
        r.epochs += n_epochs
        r.analyzer_s += analyzer_s
        r.latency_s += ns_to_s(bd.latency_ns)
        r.congestion_s += ns_to_s(bd.congestion_ns)
        r.bandwidth_s += ns_to_s(bd.bandwidth_ns)
        r.coherency_s += ns_to_s(float(miss_ns.sum()))
        if self._coherency is not None:
            r.bi_messages = self._coherency.bi_messages_total
        r.per_pool_latency_ns += bd.per_pool_latency_ns
        r.per_switch_congestion_ns += bd.per_switch_congestion_ns
        r.per_switch_bandwidth_ns += bd.per_switch_bandwidth_ns
        if bd.per_class_congestion_ns is not None:
            pcc = np.asarray(bd.per_class_congestion_ns, np.float64)
            if len(pcc) == len(r.per_class_congestion_ns):
                r.per_class_congestion_ns += pcc
            else:  # qos-off breakdown on a multi-class fabric: all class 0
                r.per_class_congestion_ns[0] += float(pcc.sum())
        fold_dispatch_stats(r, self._analyzer.last_dispatch, 1)
        for h, hc in enumerate(r.hosts):
            hc.latency_s += ns_to_s(float(bd.per_host_latency_ns[h]))
            hc.congestion_s += ns_to_s(float(bd.per_host_congestion_ns[h]))
            hc.bandwidth_s += ns_to_s(float(bd.per_host_bandwidth_ns[h]))
            hc.coherency_s += ns_to_s(float(miss_ns[h]))

    def round(self) -> DelayBreakdown:
        """Run one co-scheduled round: analyze the merged shared timeline,
        fold it into :attr:`report`, then run the tenants' native steps;
        returns the round's breakdown.

        The analyzer intentionally re-runs every round even though the
        merged timelines are cached: per-round analyzer overhead is a
        reported quantity (the paper's accounting), matching how
        ``CXLMemSim.attach`` re-analyzes its cached trace each step."""
        merged, miss_ns = self._merged_round()
        n_epochs = len(merged)
        a0 = time.perf_counter()
        try:
            bd = self._analyzer.analyze_batch(merged)
        except BaseException:
            self._report.dropped_batches += 1
            self._report.dropped_epochs += n_epochs
            raise
        self._fold_round(bd, miss_ns, time.perf_counter() - a0, n_epochs)

        for h, tenant in enumerate(self.tenants):
            if tenant.step_fn is not None:
                t0 = time.perf_counter()
                out = tenant.step_fn(*tenant.step_args)
                _synchronize_outputs(out)
                native = time.perf_counter() - t0
            else:
                native = self._tenant_epochs(h)[1]
            hc = self._report.hosts[h]
            hc.steps += 1
            hc.native_s += native
        return bd

    def run(self, n_rounds: int) -> FabricReport:
        for _ in range(n_rounds):
            self.round()
        return self.report
