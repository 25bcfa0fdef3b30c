"""FleetSim — rack-scale cluster simulation in one stacked dispatch.  Port
of ``repro/core/fleet.py``.

The paper's opening problem is *memory stranding*: datacenter hosts are
provisioned for peak resident demand, so most DRAM sits idle most of the
time, and CXL pooling exists to reclaim it.  A single
:class:`~repro_torch.core.fabric.FabricSession` prices a handful of
co-attached tenants on ONE topology; this module scales that question to a
fleet — a cluster scheduler placing M tenant programs across R racks of
pooled expanders — and answers the capacity-planning trade: **how many
stranded GB does pooling recover, and what p99 tenant slowdown does the
shared fabric charge for them?**

The lowering:

  * every rack shares one topology *structure* (the same
    :class:`~repro_torch.core.topology.Topology` tree), so the route matrix,
    route-word table and cascade merge plan are planned once; per-rack
    numeric variation (expander latency, bandwidth, STT) rides on
    :class:`~repro_torch.core.topology.TopologyOverride` rows lowered by
    :func:`~repro_torch.core.topology.flatten_stack`, and per-rack QoS
    arbitration on ``rack_qos``;
  * each tenant synthesizes a placement-independent skeleton once
    (:func:`~repro_torch.core.tracer.synthesize_skeleton`); per-placement
    pools are a region→pool gather; per-host epoch timelines merge onto the
    rack's fabric clock exactly like
    :class:`~repro_torch.core.fabric.FabricSession`'s merged rounds;
  * the R racks stack into ONE ``[R, B, N]`` dispatch
    (:func:`~repro_torch.core.analyzer._analyze_fleet`): racks that share
    their service times (and arbitration) are one launch of the
    host-segmented cascade kernel on the card, and each rack's epochs are
    reduced on the device — one ``[R, ...]`` host transfer for the whole
    fleet.

:meth:`FleetSim.frontier` stacks F offload fractions × R racks into a
single ``[F·R, B, N]`` dispatch and returns the stranded-GB-recovered vs.
p99-slowdown curve.

The stranding model: a non-pooled cluster provisions every host's DRAM
for its tenants' full resident demand.  Under FleetSim's placement, only
*retained* bytes live in host DRAM; every byte the scheduler offloads to
the rack's shared expander is DRAM the host no longer has to provision —
so ``stranded_recovered_bytes`` is the fleet-wide sum of offloaded bytes,
and the frontier sweeps the offload fraction to trade it against tenant
slowdown.

Differences from the reference: the fleet runs on ``device`` (default
``"cuda"``, which raises without a card; ``"cpu"`` runs the kernels' plain
versions); a ``mesh`` (the reference's split of the rack axis over
devices) raises ``NotImplementedError``, so reports keep
``devices_used=1`` and ``shard_rows=0``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .analyzer import (
    DelayBreakdown,
    DispatchStats,
    _analyze_fleet,
    _check_device,
    _unpack,
    bucket_pow2,
    plan_cascade,
)
from .events import EventStager, MemEvents, RegionMap, concat_events
from .scenario import MESH_LATER, _np_dtype, _PhaseClock
from .topology import (
    QosSpec,
    Topology,
    TopologyOverride,
    flatten_stack,
    pooled_topology,
)
from .tracer import (
    H100_SXM,
    Access,
    HardwareModel,
    Phase,
    TraceSkeleton,
    skeleton_to_events,
    synthesize_skeleton,
)
from .units import bytes_to_gib, gib_to_bytes

__all__ = [
    "FleetPoint",
    "FleetReport",
    "FleetSim",
    "TenantPlacement",
    "TenantSpec",
    "model_zoo_tenant",
    "synthetic_tenant",
]


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One schedulable tenant program: its phase list and memory demand.

    ``regions``' pool fields are ignored — the fleet scheduler decides
    placement.  Names must be unique within a fleet (they key the skeleton
    cache and the per-tenant results).  ``qos_class`` is the tenant's
    arbitration class at QoS-disciplined switches (priority / WFQ racks).
    """

    name: str
    phases: Tuple[Phase, ...]
    regions: RegionMap
    qos_class: int = 0

    def demand_bytes(self) -> float:
        return float(self.regions.total_bytes())


def synthetic_tenant(
    name: str,
    seed: int = 0,
    gib: float = 1.0,
    read_intensity: float = 0.02,
) -> TenantSpec:
    """A deterministic synthetic tenant around ``~gib`` GiB of demand.

    Mirrors a train/serve step shape: params + activations are pinned
    tensor classes, optimizer state and KV cache are the offloadable bulk
    (together ~60% of demand — the stranding opportunity).  Sizes jitter
    per seed so a fleet of these has heterogeneous demand, which is what
    makes bin-packing and stranding interesting.
    """
    rng = np.random.default_rng(seed)
    total = gib_to_bytes(gib) * float(rng.uniform(0.7, 1.5))
    regions = RegionMap()
    regions.alloc(f"{name}/params", int(total * 0.22), "param")
    regions.alloc(f"{name}/acts", int(total * 0.18), "activation")
    regions.alloc(f"{name}/opt", int(total * 0.35), "opt_state")
    regions.alloc(f"{name}/kv", int(total * 0.25), "kvcache")
    touch = lambda frac: total * frac * read_intensity

    def ph(label, flops_scale, accesses):
        return Phase(
            name=f"{name}/{label}",
            flops=float(rng.uniform(0.5, 1.5)) * flops_scale * 1e12,
            accesses=tuple(
                Access(region=f"{name}/{r}", bytes_=b, is_write=w)
                for r, b, w in accesses
            ),
        )

    phases = (
        ph("fwd", 2.0, [("params", touch(0.22), False), ("acts", touch(0.18), True),
                        ("kv", touch(0.12), False)]),
        ph("bwd", 4.0, [("params", touch(0.22), False), ("acts", touch(0.18), False),
                        ("kv", touch(0.13), True)]),
        ph("opt", 0.5, [("opt", touch(0.35), True), ("params", touch(0.11), True)]),
    )
    return TenantSpec(name=name, phases=phases, regions=regions)


def model_zoo_tenant(
    name: str,
    arch: str = "starcoder2-3b",
    mode: str = "train",
    batch: int = 2,
    seq: int = 64,
) -> TenantSpec:
    """A tenant drawn from the model zoo's memory programs
    (:func:`~repro_torch.models.phases.build_regions_and_phases`)."""
    from ..configs import get_smoke
    from ..models.phases import build_regions_and_phases

    regions, phases = build_regions_and_phases(get_smoke(arch), mode, batch=batch, seq=seq)
    return TenantSpec(name=name, phases=tuple(phases), regions=regions)


@dataclasses.dataclass(frozen=True)
class TenantPlacement:
    """Where one tenant landed and how its bytes split local vs pooled."""

    tenant: TenantSpec
    rack: int
    host: int
    local_bytes: float  # resident in the host's private DRAM
    pooled_bytes: float  # offloaded to the rack's shared expander
    pool_of_region: np.ndarray  # [n_regions] region -> pool id


@dataclasses.dataclass
class FleetReport:
    """One fleet round: per-rack breakdowns + the capacity-planning scalars."""

    n_racks: int
    hosts_per_rack: int
    offload_fraction: float
    placements: List[TenantPlacement]
    breakdowns: List[DelayBreakdown]  # [R]
    native_ns: np.ndarray  # [R, H] per-host roofline-paced native time
    delay_ns: np.ndarray  # [R, H] per-host simulated fabric delay
    stranded_recovered_bytes: float
    devices_used: int = 1
    shard_rows: int = 0
    padded_fraction: float = 0.0
    qos_classes: int = 1

    @property
    def n_hosts(self) -> int:
        return self.n_racks * self.hosts_per_rack

    @property
    def n_tenants(self) -> int:
        return len(self.placements)

    def host_slowdowns(self) -> np.ndarray:
        """[R, H] simulated/native per host (1.0 for idle hosts)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            s = (self.native_ns + self.delay_ns) / self.native_ns
        return np.where(self.native_ns > 0, s, 1.0)

    def tenant_slowdowns(self) -> np.ndarray:
        """[M] each tenant inherits its host's fabric slowdown."""
        s = self.host_slowdowns()
        return np.asarray([s[p.rack, p.host] for p in self.placements])

    def p99_slowdown(self) -> float:
        return float(np.percentile(self.tenant_slowdowns(), 99))

    def mean_slowdown(self) -> float:
        return float(self.tenant_slowdowns().mean())

    def summary(self) -> Dict[str, float]:
        return {
            "n_racks": self.n_racks,
            "n_hosts": self.n_hosts,
            "n_tenants": self.n_tenants,
            "offload_fraction": self.offload_fraction,
            "stranded_recovered_gb": bytes_to_gib(self.stranded_recovered_bytes),
            "p99_slowdown": self.p99_slowdown(),
            "mean_slowdown": self.mean_slowdown(),
            "devices_used": self.devices_used,
            "shard_rows": self.shard_rows,
            "padded_fraction": self.padded_fraction,
            "qos_classes": self.qos_classes,
        }


@dataclasses.dataclass(frozen=True)
class FleetPoint:
    """One frontier point: what an offload fraction buys and costs."""

    offload_fraction: float
    stranded_recovered_gb: float
    p99_slowdown: float
    mean_slowdown: float
    report: FleetReport


class FleetSim:
    """Cluster scheduler + stacked fleet dispatch over R pooled racks.

    ``rack_topology`` (default: the paper's :func:`~repro_torch.core.
    topology.pooled_topology` with ``hosts_per_rack`` hosts) is the
    structure every rack shares; ``rack_overrides`` optionally varies
    numeric parameters per rack (a heterogeneous fleet — e.g. two expander
    generations), ``rack_qos`` the racks' QoS arbitration.  The fleet runs
    on ``device`` (default ``"cuda"``, which raises without a card);
    ``dtype`` is a torch dtype; ``mesh`` raises ``NotImplementedError``.
    """

    def __init__(
        self,
        n_racks: int,
        hosts_per_rack: int = 4,
        rack_topology: Optional[Topology] = None,
        rack_overrides: Optional[Sequence[Optional[TopologyOverride]]] = None,
        hw: HardwareModel = H100_SXM,
        epoch_mode: str = "step",
        granularity_bytes: float = 4096.0,
        max_events_per_access: int = 64,
        calibration: float = 1.0,
        bw_window_ns: float = 10_000.0,
        n_windows: int = 64,
        dtype: torch.dtype = torch.float32,
        mesh=None,
        offload_classes: Sequence[str] = ("opt_state", "kvcache", "expert"),
        rack_qos: Optional[Sequence[Optional[QosSpec]]] = None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(MESH_LATER)
        self.device = _check_device(device)
        if n_racks < 1:
            raise ValueError("need at least one rack")
        self.n_racks = int(n_racks)
        self.topology = (
            rack_topology
            if rack_topology is not None
            else pooled_topology(n_hosts=hosts_per_rack)
        )
        self.hosts_per_rack = self.topology.n_hosts
        if rack_overrides is not None and len(rack_overrides) != self.n_racks:
            raise ValueError(
                f"{len(rack_overrides)} rack_overrides for {n_racks} racks"
            )
        self.rack_overrides = (
            list(rack_overrides)
            if rack_overrides is not None
            else [None] * self.n_racks
        )
        self.hw = hw
        if epoch_mode not in ("step", "layer"):
            raise ValueError(epoch_mode)
        self.epoch_mode = epoch_mode
        self.granularity_bytes = float(granularity_bytes)
        self.max_events_per_access = int(max_events_per_access)
        self.calibration = float(calibration)
        self.bw_window_ns = float(bw_window_ns)
        self.n_windows = int(n_windows)
        self.dtype = dtype
        self._np_dtype = _np_dtype(dtype)
        self.offload_classes = frozenset(offload_classes)

        flat = self.topology.flatten()
        if flat.n_switches > 31:
            raise ValueError("fleet dispatch requires the fused cascade (<= 31 stages)")
        self.flat = flat
        locals_ = [i for i, p in enumerate(self.topology.pools) if p.is_local]
        shared = [i for i, p in enumerate(self.topology.pools) if not p.is_local]
        if not shared:
            raise ValueError(
                "rack topology has no shared pool — nothing to offload to "
                "(add a non-local expander, e.g. pooled_topology())"
            )
        self.local_pool = locals_[0]
        # the offload target: the largest shared expander of the rack
        self.shared_pool = max(
            shared, key=lambda i: self.topology.pools[i].capacity_bytes
        )
        self.local_capacity = float(
            self.topology.pools[self.local_pool].capacity_bytes
        )
        self.shared_capacity = float(
            self.topology.pools[self.shared_pool].capacity_bytes
        )

        bits_pool, self._merge_plan, self._stage_order = plan_cascade(flat)
        self._bits_table = torch.tensor(bits_pool, dtype=torch.int32, device=self.device)
        self._route = torch.tensor(flat.route, dtype=dtype, device=self.device)
        # numeric leaves, one row per rack (structure shared by construction)
        self._leaf_stack = flatten_stack(self.topology, self.rack_overrides)
        # per-rack QoS arbitration policies: disciplines and class weights
        # are numeric leaves on the rack axis (the same contract as the
        # stt/bw overrides)
        if rack_qos is not None and len(rack_qos) != self.n_racks:
            raise ValueError(f"{len(rack_qos)} rack_qos entries for {n_racks} racks")
        C = flat.n_qos_classes
        if rack_qos is not None:
            C = max([C] + [s.n_classes() for s in rack_qos if s is not None])
        disc = np.tile(
            np.asarray(flat.discipline_codes(), np.int32)[None], (self.n_racks, 1)
        )
        weights = np.ones((self.n_racks, flat.n_switches, C), self._np_dtype)
        base_w = flat.class_weight_table().astype(self._np_dtype)
        weights[:, :, : base_w.shape[1]] = base_w[None]
        if rack_qos is not None:
            for r, spec in enumerate(rack_qos):
                if spec is not None:
                    spec.apply(disc[r], weights[r], flat.switch_names)
        self._disc_stack = disc
        self._weights_stack = weights
        self.n_qos_classes = C
        self.qos_on = bool(flat.has_qos) or bool(
            rack_qos is not None and any(s is not None for s in rack_qos)
        )
        self._stager = EventStager(self._np_dtype)
        self._skeletons: Dict[str, TraceSkeleton] = {}
        self.dispatch_count = 0
        self.last_dispatch = DispatchStats()

    # ------------------------------------------------------------------ #
    # scheduling + placement
    # ------------------------------------------------------------------ #

    def _skeleton(self, tenant: TenantSpec) -> TraceSkeleton:
        sk = self._skeletons.get(tenant.name)
        if sk is None:
            sk = synthesize_skeleton(
                tenant.phases,
                tenant.regions,
                self.hw,
                granularity_bytes=self.granularity_bytes,
                max_events_per_access=self.max_events_per_access,
                calibration=self.calibration,
                epoch_mode=self.epoch_mode,
            )
            self._skeletons[tenant.name] = sk
        return sk

    def place(
        self,
        tenants: Sequence[TenantSpec],
        policy: str = "least_loaded",
        offload_fraction: float = 1.0,
    ) -> List[TenantPlacement]:
        """Assign tenants to (rack, host) slots and split their bytes.

        ``policy``: ``'round_robin'`` cycles slots in order;
        ``'least_loaded'`` picks the host with the most free local DRAM;
        ``'first_fit'`` packs the first host whose free DRAM holds the
        tenant's resident (post-offload) bytes.  ``offload_fraction`` of
        each tenant's offloadable classes (``offload_classes``, largest
        regions first) moves to the rack's shared expander; more is
        offloaded only if the pinned+retained bytes would not fit the
        host.  Raises with a clear message when a tenant cannot fit
        anywhere or a rack's expander runs out.
        """
        if policy not in ("round_robin", "least_loaded", "first_fit"):
            raise ValueError(policy)
        if not tenants:
            raise ValueError("need at least one tenant")
        if not 0.0 <= offload_fraction <= 1.0:
            raise ValueError("offload_fraction must be in [0, 1]")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError("tenant names must be unique within a fleet")
        for t in tenants:
            if not 0 <= t.qos_class < self.n_qos_classes:
                raise ValueError(
                    f"tenant {t.name!r} declares qos_class={t.qos_class} but "
                    f"the fleet has {self.n_qos_classes} QoS class(es)"
                )
        R, H = self.n_racks, self.hosts_per_rack
        free_local = np.full((R, H), self.local_capacity)
        free_shared = np.full((R,), self.shared_capacity)
        placements: List[TenantPlacement] = []
        rr = 0
        for t in tenants:
            regions = [r for r in t.regions.regions if r.nbytes > 0]
            pinned = [r for r in regions if r.tensor_class not in self.offload_classes]
            off = sorted(
                (r for r in regions if r.tensor_class in self.offload_classes),
                key=lambda r: -r.nbytes,
            )
            pinned_b = float(sum(r.nbytes for r in pinned))
            off_total = float(sum(r.nbytes for r in off))
            # offload the largest regions until the requested fraction is met
            target = offload_fraction * off_total
            spill, spill_b = [], 0.0
            for r in off:
                if spill_b >= target:
                    break
                spill.append(r)
                spill_b += r.nbytes
            retained = [r for r in off if r not in spill]

            def resident() -> float:
                return pinned_b + sum(r.nbytes for r in retained)

            # slot selection against the *resident* footprint
            if policy == "round_robin":
                slot = rr % (R * H)
                rr += 1
                rack, host = divmod(slot, H)
            elif policy == "least_loaded":
                slot = int(np.argmax(free_local))
                rack, host = divmod(slot, H)
            else:  # first_fit
                fits = np.argwhere(free_local.reshape(-1) >= resident())
                slot = int(fits[0, 0]) if fits.size else int(np.argmax(free_local))
                rack, host = divmod(slot, H)
            # spill more (largest retained first) until the host fits
            while retained and resident() > free_local[rack, host]:
                r = retained.pop(0)
                spill.append(r)
                spill_b += r.nbytes
            if resident() > free_local[rack, host]:
                raise ValueError(
                    f"tenant {t.name!r} needs {bytes_to_gib(resident()):.1f} GiB "
                    f"resident but host ({rack}, {host}) has only "
                    f"{bytes_to_gib(free_local[rack, host]):.1f} GiB local DRAM free "
                    "— its pinned classes alone overflow the host"
                )
            if spill_b > free_shared[rack]:
                raise ValueError(
                    f"rack {rack}'s shared expander is out of capacity "
                    f"({bytes_to_gib(spill_b):.1f} GiB needed, "
                    f"{bytes_to_gib(free_shared[rack]):.1f} GiB free) placing "
                    f"tenant {t.name!r}"
                )
            free_local[rack, host] -= resident()
            free_shared[rack] -= spill_b
            pool_of = np.full((len(t.regions),), self.local_pool, np.int32)
            spilled = {r.rid for r in spill}
            for r in regions:
                if r.rid in spilled:
                    pool_of[r.rid] = self.shared_pool
            placements.append(
                TenantPlacement(
                    tenant=t,
                    rack=rack,
                    host=host,
                    local_bytes=resident(),
                    pooled_bytes=spill_b,
                    pool_of_region=pool_of,
                )
            )
        return placements

    # ------------------------------------------------------------------ #
    # the stacked fleet dispatch
    # ------------------------------------------------------------------ #

    def _rack_timelines(
        self, placements: Sequence[TenantPlacement]
    ) -> Tuple[List[List[MemEvents]], np.ndarray]:
        """Per-rack merged epoch timelines + per-host native durations."""
        R, H = self.n_racks, self.hosts_per_rack
        native = np.zeros((R, H), np.float64)
        per_rack_epochs: List[List[List[MemEvents]]] = [[] for _ in range(R)]
        for p in placements:
            sk = self._skeleton(p.tenant)
            epochs = [
                tr.with_host(p.host).with_qos(p.tenant.qos_class)
                for tr in skeleton_to_events(sk, p.pool_of_region)
            ]
            native[p.rack, p.host] += float(sum(sk.native_ns))
            racks = per_rack_epochs[p.rack]
            for e, tr in enumerate(epochs):
                while len(racks) <= e:
                    racks.append([])
                racks[e].append(tr)
        B = max((len(r) for r in per_rack_epochs), default=1) or 1
        rack_traces: List[List[MemEvents]] = []
        for r in range(R):
            rows = []
            for e in range(B):
                parts = per_rack_epochs[r][e] if e < len(per_rack_epochs[r]) else []
                # co-scheduled tenants share the rack's fabric instant:
                # merge onto one time-sorted timeline (FabricSession's
                # merged-round contract)
                rows.append(concat_events(parts).sorted_by_time())
            rack_traces.append(rows)
        return rack_traces, native

    def _dispatch(
        self, rack_traces: List[List[MemEvents]], tiles: int
    ) -> List[DelayBreakdown]:
        """ONE ``[K, B, N]`` fleet dispatch (K = tiles × n_racks).  The
        planes are staged in the reference's K, B and N buckets; the K real
        planes (the stack bucket's pad planes are all-invalid and price to
        zero) go to the device, are analyzed, and come back as one
        ``[K, M]`` copy."""
        flat = self.flat
        P, S, H = flat.n_pools, flat.n_switches, flat.n_hosts
        V = H * P
        K = len(rack_traces)
        if K != tiles * self.n_racks:
            raise ValueError(f"{K} rack planes for {tiles} x {self.n_racks} racks")
        n_max = max((tr.n for rows in rack_traces for tr in rows), default=1)
        B = max(len(rows) for rows in rack_traces)
        n_bucket = bucket_pow2(max(n_max, 1))
        b_bucket = bucket_pow2(B, floor=1)
        k_bucket = bucket_pow2(K, floor=1)
        t_stage = time.perf_counter()
        buf = self._stager.stage_stack(rack_traces, k_bucket, b_bucket, n_bucket)
        span = np.maximum(buf["span"][:K], self.bw_window_ns)
        bw_window = np.maximum(span / self.n_windows, 1.0)
        scale = np.ones((K, b_bucket, V), self._np_dtype)
        stage_s = time.perf_counter() - t_stage

        ls = self._leaf_stack
        fd = self._np_dtype
        dev = self.device

        def tiled(a: np.ndarray) -> np.ndarray:
            return np.concatenate([a] * tiles, axis=0) if tiles > 1 else a

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.dispatch_count += 1
        clock = _PhaseClock(dev)
        clock.mark()
        args = dict(
            t=put(buf["t"][:K]),
            pool=put(buf["pool"][:K]),
            nbytes=put(buf["bytes"][:K]),
            weight=put(buf["weight"][:K]),
            host=put(buf["host"][:K]) if H > 1 else None,  # one host: no plane to move
            qos=put(buf["qos"][:K]) if self.qos_on else None,  # FIFO: no plane to move
            valid=put(buf["valid"][:K]),
            bw_window_ns=put(bw_window.astype(fd)),
            lat_scale=put(scale),
            bits_table=self._bits_table,
            pool_latency_ns=put(tiled(ls.pool_latency_ns).astype(fd)),
            local_latency_ns=put(tiled(ls.local_latency_ns).astype(fd)),
            route=self._route,
            switch_stt_ns=put(tiled(ls.switch_stt_ns).astype(fd)),
            switch_bw=put(tiled(ls.switch_bandwidth_gbps).astype(fd)),
            disc_code=put(tiled(self._disc_stack)),
            class_weights=put(tiled(self._weights_stack)),
        )
        clock.mark()
        out = _analyze_fleet(
            **args,
            stage_order=self._stage_order,
            n_windows=self.n_windows,
            n_hosts=H,
            merge_plan=self._merge_plan,
            qos_on=self.qos_on,
        )
        # the single host-boundary crossing for the whole fleet
        tot = out.cpu().numpy().astype(np.float64)
        clock.mark()
        transfer_s, compute_s = clock.seconds()
        self.last_dispatch = DispatchStats(
            devices_used=1,
            shard_rows=0,
            rows=K,
            padded_fraction=float(k_bucket - K) / k_bucket,
            stage_s=stage_s,
            transfer_s=transfer_s,
            compute_s=compute_s,
            qos_classes=self.n_qos_classes,
        )
        return [_unpack(tot[k], P, S, H) for k in range(K)]

    def _report_from(
        self,
        placements: List[TenantPlacement],
        breakdowns: List[DelayBreakdown],
        native: np.ndarray,
        offload_fraction: float,
    ) -> FleetReport:
        R, H = self.n_racks, self.hosts_per_rack
        delay = np.zeros((R, H), np.float64)
        for r, bd in enumerate(breakdowns):
            delay[r] = bd.per_host_total_ns
        return FleetReport(
            n_racks=R,
            hosts_per_rack=H,
            offload_fraction=float(offload_fraction),
            placements=placements,
            breakdowns=breakdowns,
            native_ns=native,
            delay_ns=delay,
            stranded_recovered_bytes=float(
                sum(p.pooled_bytes for p in placements)
            ),
            devices_used=self.last_dispatch.devices_used,
            shard_rows=self.last_dispatch.shard_rows,
            padded_fraction=self.last_dispatch.padded_fraction,
            qos_classes=self.n_qos_classes,
        )

    def simulate(
        self,
        tenants: Sequence[TenantSpec],
        policy: str = "least_loaded",
        offload_fraction: float = 1.0,
        mesh=None,
    ) -> FleetReport:
        """Schedule the tenants and price one steady-state fleet round.
        ``mesh`` raises ``NotImplementedError``."""
        if mesh is not None:
            raise NotImplementedError(MESH_LATER)
        placements = self.place(tenants, policy, offload_fraction)
        rack_traces, native = self._rack_timelines(placements)
        breakdowns = self._dispatch(rack_traces, tiles=1)
        return self._report_from(
            placements, breakdowns[: self.n_racks], native, offload_fraction
        )

    def frontier(
        self,
        tenants: Sequence[TenantSpec],
        offload_fractions: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0),
        policy: str = "least_loaded",
        mesh=None,
    ) -> List[FleetPoint]:
        """The stranded-GB-recovered vs. p99-slowdown frontier, in ONE
        ``[F·R, B, N]`` stacked dispatch.

        Every fraction re-places the tenants (skeletons are cached — a new
        placement is only a region→pool gather) and all F·R rack planes
        stack on the same leading axis.  Points come back in
        ``offload_fractions`` order.  ``mesh`` raises
        ``NotImplementedError``.
        """
        if mesh is not None:
            raise NotImplementedError(MESH_LATER)
        fracs = [float(f) for f in offload_fractions]
        if not fracs:
            raise ValueError("need at least one offload fraction")
        all_traces: List[List[MemEvents]] = []
        per_f: List[Tuple[List[TenantPlacement], np.ndarray]] = []
        for f in fracs:
            placements = self.place(tenants, policy, f)
            traces, native = self._rack_timelines(placements)
            all_traces.extend(traces)
            per_f.append((placements, native))
        breakdowns = self._dispatch(all_traces, tiles=len(fracs))
        points: List[FleetPoint] = []
        for i, f in enumerate(fracs):
            placements, native = per_f[i]
            rep = self._report_from(
                placements,
                breakdowns[i * self.n_racks : (i + 1) * self.n_racks],
                native,
                f,
            )
            points.append(
                FleetPoint(
                    offload_fraction=f,
                    stranded_recovered_gb=bytes_to_gib(rep.stranded_recovered_bytes),
                    p99_slowdown=rep.p99_slowdown(),
                    mean_slowdown=rep.mean_slowdown(),
                    report=rep,
                )
            )
        return points
