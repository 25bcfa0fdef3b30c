"""Batched scenario sweeps: K (topology × policy × cache × granularity ×
QoS) configurations of one workload in one stacked dispatch.  Port of
``repro/core/scenario.py``.

The paper's headline use case is *exploration* — "experimentation with
memory pooling configurations, scheduling policies, data migration
strategies, and caching techniques that were previously infeasible to
evaluate at scale".  :class:`ScenarioSuite` folds a whole sweep into one
dispatch (:func:`~repro_torch.core.analyzer._sweep_cascades`, then
:func:`~repro_torch.core.analyzer._sweep_reduce`):

  * **Placement** is a ``[K, R]`` matrix (:func:`~repro_torch.core.policy.
    assign_batch` over the vectorized policy ``assign`` paths); per-event
    pools are gathered on the device.
  * **Traces** share one structural skeleton per management granule
    (:func:`~repro_torch.core.tracer.synthesize_skeleton`): times, bytes and
    region ids are placement-independent, so K scenarios pay one synthesis
    and one sort, not K.
  * **Topologies** are numeric variants of one structure
    (:class:`~repro_torch.core.topology.TopologyOverride`), lowered to
    stacked ``[K, ...]`` leaves by :func:`~repro_torch.core.topology.
    flatten_stack`; the route matrix and the cascade's merge plan are
    shared.
  * **Caches** lower to per-scenario latency-scale rows
    (:meth:`~repro_torch.core.cache.DeviceCacheModel.observe_scale`, the
    host's tag simulation, one per distinct granule, placement, cache and
    latency leaves).
  * **Congestion** runs once per *unique* (granule, placement, STT row,
    and under QoS discipline and weight rows) cascade, and the unique
    cascades that share their service times and arbitration are one launch
    of the cascade kernel on the card (the FIFO cascade, or the QoS cascade
    on the ``qos`` axis).

One ``[K, M]`` device-to-host copy returns every scenario's totals.
:class:`SweepResult` is the frontier API: best configuration under
capacity and latency constraints, plus :meth:`ScenarioSuite.
successive_halving` for hillclimb-style refinement sweeps.

Differences from the reference: the suite runs on ``device`` (default
``"cuda"``, which raises without a card; ``"cpu"`` runs the kernels'
plain versions); its stage, transfer and compute split is timed with CUDA
events on the card; the reference's ``compile_cache_size`` reads XLA's
compile cache and has no counterpart here; and with a ``mesh`` the U
unique cascades run once, on the mesh's first device, where the
reference's run on every device.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.sharding import (
    Replicas,
    check_mesh,
    pad_to_multiple,
    resolve_data_mesh,
    shard_rows,
)
from ..launch.mesh import mesh_devices
from .analyzer import (
    DelayBreakdown,
    DispatchStats,
    _check_device,
    _sweep_cascades,
    _sweep_reduce,
    _unpack,
    bucket_pow2,
    plan_cascade,
)
from .cache import DeviceCacheConfig, DeviceCacheModel
from .events import RegionMap
from .policy import PlacementPolicy, RegionArrays, assign_batch, bytes_per_pool_batch
from .topology import QosSpec, Topology, TopologyOverride, flatten_stack
from .tracer import (
    H100_SXM,
    HardwareModel,
    Phase,
    TraceSkeleton,
    skeleton_to_events,
    synthesize_skeleton,
)
from .units import bytes_to_gib, bytes_to_mib, ms_to_ns, ns_to_ms, ns_to_s

__all__ = ["Scenario", "ScenarioSuite", "SweepResult"]


def _class_shares(b: DelayBreakdown) -> List[float]:
    """Per-QoS-class share of a breakdown's congestion delay."""
    pcc = b.per_class_congestion_ns
    if pcc is None:
        return [1.0]
    total = float(pcc.sum())
    if total <= 0.0:
        return [0.0] * len(pcc)
    return [float(x) / total for x in pcc]


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((0,), dtype=dtype).numpy().dtype


class _PhaseClock:
    """The stage / transfer / compute split of one dispatch: the host clock
    on the CPU; on the card CUDA events on the current stream, read once
    the dispatch's result is on the host."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[object] = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> List[float]:
        """Seconds between consecutive marks."""
        if self.cuda:
            return [
                ns_to_s(ms_to_ns(a.elapsed_time(b)))
                for a, b in zip(self.marks, self.marks[1:])
            ]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One point of a sweep: placement policy × topology numeric variant ×
    device-cache config × QoS arbitration.  The management granularity
    rides on the policy (``policy.granularity_bytes``; see
    :meth:`~repro_torch.core.policy.PlacementPolicy.with_granularity`)."""

    policy: PlacementPolicy
    topology: Optional[TopologyOverride] = None
    cache: Optional[DeviceCacheConfig] = None
    qos: Optional[QosSpec] = None
    name: str = ""

    def label(self) -> str:
        if self.name:
            return self.name
        parts = [self.policy.describe()]
        parts.append(self.topology.describe() if self.topology else "base")
        if self.cache is not None:
            parts.append(f"cache={bytes_to_mib(self.cache.capacity_bytes):g}MiB")
        if self.qos is not None:
            parts.append(self.qos.describe())
        return "|".join(parts)


@dataclasses.dataclass
class SweepResult:
    """Per-scenario outcome of one :meth:`ScenarioSuite.run` dispatch."""

    scenarios: List[Scenario]
    breakdowns: List[DelayBreakdown]
    native_ns: float  # roofline-paced native step time (shared: one workload)
    feasible: np.ndarray  # [K] bool: every pool within capacity
    utilization: np.ndarray  # [K, P] bytes placed / capacity
    # dispatch observability: the split of the scenario axis over a mesh
    devices_used: int = 1
    shard_rows: int = 0
    padded_fraction: float = 0.0
    # phase timing of this run's dispatch (host pack / H2D / device compute)
    stage_s: float = 0.0
    transfer_s: float = 0.0
    compute_s: float = 0.0
    qos_classes: int = 1  # QoS class count of this run's dispatch

    @property
    def k(self) -> int:
        return len(self.scenarios)

    def totals_ns(self) -> np.ndarray:
        return np.asarray([b.total_ns for b in self.breakdowns], np.float64)

    def slowdowns(self) -> np.ndarray:
        """Simulated step time over native step time, per scenario."""
        return (self.native_ns + self.totals_ns()) / self.native_ns

    def order(self, require_feasible: bool = True) -> np.ndarray:
        """Scenario indices sorted best-first (lowest total simulated delay);
        infeasible scenarios sort last when ``require_feasible``."""
        key = self.totals_ns().copy()
        if require_feasible:
            key[~self.feasible] = np.inf
        return np.argsort(key, kind="stable")

    def top(self, n: int, require_feasible: bool = True) -> List[int]:
        return [int(i) for i in self.order(require_feasible)[: max(int(n), 1)]]

    def best(
        self,
        max_total_ns: Optional[float] = None,
        max_slowdown: Optional[float] = None,
        require_feasible: bool = True,
    ) -> Optional[int]:
        """Index of the best scenario under the given constraints.

        ``require_feasible`` enforces the capacity constraint (every pool's
        placed bytes within its capacity); ``max_total_ns``/``max_slowdown``
        bound the simulated delay.  Returns None when nothing qualifies.
        """
        totals = self.totals_ns()
        ok = np.ones((self.k,), bool)
        if require_feasible:
            ok &= self.feasible
        if max_total_ns is not None:
            ok &= totals <= max_total_ns
        if max_slowdown is not None:
            ok &= self.slowdowns() <= max_slowdown
        if not ok.any():
            return None
        key = np.where(ok, totals, np.inf)
        return int(np.argmin(key))

    def table(self) -> List[Dict]:
        """One row per scenario — the purchasing-decision table."""
        slow = self.slowdowns()
        return [
            {
                "scenario": s.label(),
                "latency_ms": ns_to_ms(b.latency_ns),
                "congestion_ms": ns_to_ms(b.congestion_ns),
                "bandwidth_ms": ns_to_ms(b.bandwidth_ns),
                "total_ms": ns_to_ms(b.total_ns),
                "slowdown": float(slow[i]),
                "feasible": bool(self.feasible[i]),
                "devices_used": self.devices_used,
                "shard_rows": self.shard_rows,
                "padded_fraction": self.padded_fraction,
                "stage_s": self.stage_s,
                "transfer_s": self.transfer_s,
                "compute_s": self.compute_s,
                "qos_classes": self.qos_classes,
                "qos_delay_shares": _class_shares(b),
            }
            for i, (s, b) in enumerate(zip(self.scenarios, self.breakdowns))
        ]


class ScenarioSuite:
    """Evaluate K scenarios against one workload in one stacked dispatch.

    The workload (``regions`` + ``phases``, e.g. from
    :func:`repro_torch.models.phases.build_regions_and_phases`) and the base
    topology *structure* are fixed per suite; scenarios vary placement,
    numeric topology parameters, device caching, granularity and QoS
    arbitration.  Staged skeletons are cached across :meth:`run` calls per
    (granule, event bucket); shapes are bucketed to powers of two like the
    epoch analyzer's.  The suite runs on ``device`` (default ``"cuda"``,
    which raises without a card; ``"cpu"`` runs the kernels' plain
    versions); ``dtype`` is a torch dtype.
    """

    def __init__(
        self,
        topology: Topology,
        regions: RegionMap,
        phases: Sequence[Phase],
        hw: HardwareModel = H100_SXM,
        max_events_per_access: int = 64,
        calibration: float = 1.0,
        epoch_mode: str = "step",
        bw_window_ns: float = 10_000.0,
        n_windows: int = 128,
        dtype: torch.dtype = torch.float32,
        mesh=None,
        region_qos: Optional[Mapping[str, int]] = None,
        device="cuda",
    ):
        """``region_qos`` maps region names to QoS class ids (absent
        regions default to class 0); with it — or a QoS-bearing topology,
        or any scenario carrying a :class:`~repro_torch.core.topology.QosSpec`
        — the sweep routes congestion through the QoS arbitration cascade
        and reports per-class delay shares.  ``mesh`` (a ``('data',)``
        :class:`~repro_torch.launch.mesh.Mesh` of ``device``'s type) splits
        every :meth:`run`'s scenario axis over its entries."""
        self.device = _check_device(device)
        self.mesh = check_mesh(mesh, self.device)
        self.topology = topology
        self.regions = regions
        self.phases = list(phases)
        self.hw = hw
        self.max_events_per_access = int(max_events_per_access)
        self.calibration = float(calibration)
        if epoch_mode not in ("step", "layer"):
            raise ValueError(epoch_mode)
        self.epoch_mode = epoch_mode
        self.bw_window_ns = float(bw_window_ns)
        self.n_windows = int(n_windows)
        self.dtype = dtype
        self._np_dtype = _np_dtype(dtype)

        self.base_flat = topology.flatten()
        if self.base_flat.n_switches > 31:
            raise ValueError(
                "scenario sweeps require the fused cascade (<= 31 stages)"
            )
        bits_pool, self._merge_plan, self._stage_order = plan_cascade(self.base_flat)
        self._bits_table = torch.tensor(bits_pool, dtype=torch.int32, device=self.device)
        self._route = torch.tensor(self.base_flat.route, dtype=dtype, device=self.device)
        self.region_arrays = RegionArrays.from_regions(regions)
        self._region_qos = {str(k): int(v) for k, v in (region_qos or {}).items()}
        self._qos_of_region = np.asarray(
            [self._region_qos.get(name, 0) for name in self.region_arrays.names],
            np.int32,
        )
        if (self._qos_of_region < 0).any():
            raise ValueError("region_qos classes must be >= 0")
        self._skeletons: Dict[float, TraceSkeleton] = {}
        self._staged: Dict[Tuple[float, int], Dict[str, np.ndarray]] = {}
        # (bits_table, route) on each mesh device, each copy made once
        self._replicas = Replicas((self._bits_table, self._route))
        self.dispatch_count = 0  # sweep dispatches (tests assert 1 per run)
        self.last_unique_cascades = 0  # U of the latest run (dedup visibility)
        self.last_dispatch = DispatchStats()

    # ------------------------------------------------------------------ #
    # scenario construction helpers
    # ------------------------------------------------------------------ #

    @staticmethod
    def cartesian(
        policies: Mapping[str, PlacementPolicy],
        overrides: Optional[Mapping[str, Optional[TopologyOverride]]] = None,
        caches: Optional[Mapping[str, Optional[DeviceCacheConfig]]] = None,
        granularities: Optional[Sequence[int]] = None,
    ) -> List[Scenario]:
        """Cartesian scenario grid; names are ``topo/policy[/gN][/cache]``.

        ``granularities`` multiplies every policy by
        :meth:`~repro_torch.core.policy.PlacementPolicy.with_granularity`
        copies.
        """
        overrides = overrides or {"base": None}
        caches = caches or {"nocache": None}
        pol_items: List[Tuple[str, PlacementPolicy]] = []
        for pname, pol in policies.items():
            if granularities is None:
                pol_items.append((pname, pol))
            else:
                pol_items += [
                    (f"{pname}/g{g}", pol.with_granularity(g)) for g in granularities
                ]
        out = []
        for (tname, ov), (pname, pol), (cname, cache) in itertools.product(
            overrides.items(), pol_items, caches.items()
        ):
            out.append(
                Scenario(
                    policy=pol, topology=ov, cache=cache,
                    name=f"{tname}/{pname}/{cname}",
                )
            )
        return out

    # ------------------------------------------------------------------ #
    # skeleton staging
    # ------------------------------------------------------------------ #

    _bucket = staticmethod(bucket_pow2)

    def skeleton_for(self, granularity_bytes: float) -> TraceSkeleton:
        g = float(granularity_bytes)
        skel = self._skeletons.get(g)
        if skel is None:
            skel = synthesize_skeleton(
                self.phases,
                self.regions,
                self.hw,
                granularity_bytes=g,
                max_events_per_access=self.max_events_per_access,
                calibration=self.calibration,
                epoch_mode=self.epoch_mode,
            )
            self._skeletons[g] = skel
        return skel

    def _staged_group(self, granularity_bytes: float, n_bucket: int):
        """Sorted, padded ``[B, n_bucket]`` arrays for one skeleton —
        built once per (granule, bucket) and reused across runs.

        Deliberately not :class:`~repro_torch.core.events.EventStager`: the
        stager refills mutable per-call buffers from finished ``MemEvents``
        (pool already resolved), while this stages the placement-independent
        *skeleton* — region ids instead of pools — into an immutable cache
        that whole sweeps alias.  The padding contract (bucketing,
        tail-invalid, span = max t + 1) is shared via
        :func:`~repro_torch.core.analyzer.bucket_pow2`, and the row order
        (one stable sort of each unsorted epoch) is the stager's, so a
        scenario stages exactly as its solo analysis does.
        """
        key = (float(granularity_bytes), int(n_bucket))
        buf = self._staged.get(key)
        if buf is not None:
            return buf
        skel = self.skeleton_for(granularity_bytes)
        B = skel.n_epochs
        fd = self._np_dtype
        buf = {
            "t": np.zeros((B, n_bucket), fd),
            "bytes": np.zeros((B, n_bucket), fd),
            "weight": np.zeros((B, n_bucket), fd),
            "host": np.zeros((B, n_bucket), np.int32),
            "valid": np.zeros((B, n_bucket), bool),
            "region": np.zeros((B, n_bucket), np.int64),
            "span": np.zeros((B,), np.float64),
        }
        for e in range(B):
            lo, hi = int(skel.epoch_ptr[e]), int(skel.epoch_ptr[e + 1])
            n = hi - lo
            if n == 0:
                continue
            t = skel.t_ns[lo:hi]
            if np.all(t[1:] >= t[:-1]):  # single-access epochs stage as-is
                order = slice(None)
            else:
                order = np.argsort(t, kind="stable")  # the group's ONE sort
            buf["t"][e, :n] = t[order]
            buf["bytes"][e, :n] = skel.bytes_[lo:hi][order]
            buf["region"][e, :n] = skel.region[lo:hi][order]
            buf["weight"][e, :n] = 1.0
            buf["valid"][e, :n] = True
            buf["span"][e] = float(buf["t"][e, n - 1]) + 1.0
        self._staged[key] = buf
        return buf

    # ------------------------------------------------------------------ #
    # the stacked dispatch
    # ------------------------------------------------------------------ #

    def run(
        self,
        scenarios: Sequence[Scenario],
        on_overflow: str = "mark",
        mesh=None,
    ) -> SweepResult:
        """Evaluate every scenario in ONE stacked dispatch.

        ``on_overflow``: ``'mark'`` records capacity violations in
        ``SweepResult.feasible`` (the frontier API filters on it);
        ``'raise'`` fails fast like :func:`~repro_torch.core.policy.
        capacity_check`.

        ``mesh`` (defaulting to the suite's) splits the scenario axis over
        its ``('data',)`` entries: K is padded (scenario 0 repeated) to a
        multiple of the entries, each entry prices its own slice of the
        scenarios on its device, and the U unique cascades run once, on the
        mesh's first device, so the sweep's cascade launches are the same
        whatever the mesh.  Padded rows are dropped before results are
        built.
        """
        if on_overflow not in ("mark", "raise"):
            raise ValueError(on_overflow)
        scenarios = list(scenarios)
        if not scenarios:
            raise ValueError("empty scenario list")
        K = len(scenarios)
        flat = self.base_flat
        P, S, H = flat.n_pools, flat.n_switches, flat.n_hosts
        V = H * P
        ra = self.region_arrays

        # 1. [K, R] placement matrix (vectorized; repeated policies dedup'd)
        assign = assign_batch([s.policy for s in scenarios], ra, flat)
        util_bytes = bytes_per_pool_batch(assign, ra.nbytes, P)
        cap = np.asarray(flat.pool_capacity, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            utilization = np.where(cap[None, :] > 0, util_bytes / cap[None, :], 0.0)
        feasible = (util_bytes <= cap[None, :]).all(axis=1)
        if on_overflow == "raise" and not feasible.all():
            k = int(np.argmin(feasible))
            over = int(np.argmax(util_bytes[k] - cap))
            raise ValueError(
                f"scenario {scenarios[k].label()!r}: pool "
                f"{flat.pool_names[over]} over capacity "
                f"({bytes_to_gib(util_bytes[k, over]):.1f} GiB placed, "
                f"{bytes_to_gib(cap[over]):.1f} GiB available)"
            )
        if flat.host_reachable is not None and not flat.host_reachable.all():
            bad = ~flat.host_reachable[0, assign]
            if bad.any():
                k, r = np.argwhere(bad)[0]
                raise ValueError(
                    f"scenario {scenarios[k].label()!r} places region "
                    f"{ra.names[r]!r} on a pool host 0 cannot reach"
                )

        # 2. granularity groups share one skeleton + one sort each
        grans = sorted({float(s.policy.granularity_bytes) for s in scenarios})
        group_of = np.asarray(
            [grans.index(float(s.policy.granularity_bytes)) for s in scenarios],
            np.int64,
        )
        skels = [self.skeleton_for(g) for g in grans]
        B = skels[0].n_epochs
        n_bucket = self._bucket(
            max(
                (int(np.diff(sk.epoch_ptr).max()) if sk.n else 1)
                for sk in skels
            )
        )
        groups = [self._staged_group(g, n_bucket) for g in grans]

        def stack_np(f: str) -> np.ndarray:
            return np.stack([gr[f] for gr in groups])

        span = np.maximum(stack_np("span"), self.bw_window_ns)  # [G, B]
        bw_window = np.maximum(span / self.n_windows, 1.0)

        # 3. stacked topology leaves (one structure for every scenario)
        topo_stack = flatten_stack(self.topology, [s.topology for s in scenarios])

        # 3a. the qos axis: per-scenario discipline/weight rows, numeric
        # data to the QoS cascade; all-FIFO suites keep the FIFO cascade
        qos_specs = [s.qos for s in scenarios]
        qos_on = bool(
            flat.has_qos
            or self._qos_of_region.any()
            or any(sp is not None for sp in qos_specs)
        )
        C = int(flat.n_qos_classes)
        if qos_on:
            C = max(
                C,
                int(self._qos_of_region.max(initial=0)) + 1,
                max((sp.n_classes() for sp in qos_specs if sp), default=1),
            )
        disc_base = flat.discipline_codes()  # [S] i32
        w_base = np.ones((S, C), self._np_dtype)
        w_base[:, : flat.n_qos_classes] = flat.class_weight_table()
        disc_np = np.tile(disc_base, (K, 1))
        w_np = np.tile(w_base, (K, 1, 1))
        for k, sp in enumerate(qos_specs):
            if sp is not None:
                sp.apply(disc_np[k], w_np[k], flat.switch_names)

        # 3b. cascade dedup: congestion (and the post-queue times bandwidth
        # windows see) depends only on (granularity group, placement row,
        # STT row — plus the discipline/weight rows when QoS is on) —
        # scenarios differing only in latency/bandwidth/cache share one
        # cascade on the device
        stt_np = topo_stack.switch_stt_ns.astype(self._np_dtype)
        cas_index: Dict[Tuple, int] = {}
        cascade_of = np.empty((K,), np.int64)
        cas_rows: List[int] = []
        for k in range(K):
            ck = (int(group_of[k]), assign[k].tobytes(), stt_np[k].tobytes())
            if qos_on:
                ck += (disc_np[k].tobytes(), w_np[k].tobytes())
            u = cas_index.get(ck)
            if u is None:
                u = len(cas_rows)
                cas_index[ck] = u
                cas_rows.append(k)
            cascade_of[k] = u
        cas_rows_np = np.asarray(cas_rows, np.int64)
        self.last_unique_cascades = len(cas_rows)

        # 4. per-scenario device-cache latency scales (the host's tag model),
        # dedup'd like the cascades: the scale depends only on (granularity
        # group, placement row, cache config, scenario latency leaves), so
        # bandwidth/STT variants share one tag simulation
        lat_scale = np.ones((K, B, V), self._np_dtype)
        scale_cache: Dict[Tuple, np.ndarray] = {}
        for k, s in enumerate(scenarios):
            if s.cache is None:
                continue
            sk = (
                int(group_of[k]),
                assign[k].tobytes(),
                s.cache,
                topo_stack.pool_latency_ns[k].tobytes(),
                topo_stack.pool_media_latency_ns[k].tobytes(),
                float(topo_stack.local_latency_ns[k]),
            )
            rows = scale_cache.get(sk)
            if rows is None:
                model = DeviceCacheModel(s.cache, topo_stack.member(k), [self.regions])
                epochs = skeleton_to_events(
                    self.skeleton_for(s.policy.granularity_bytes), assign[k]
                )
                rows = np.ones((B, V), self._np_dtype)
                for e, tr in enumerate(epochs):
                    sc = model.observe_scale(tr)
                    if sc is not None:
                        rows[e] = sc
                scale_cache[sk] = rows
            lat_scale[k] = rows

        # 5. ONE stacked dispatch; per-scenario totals come back together.
        # With a mesh, the scenario axis is padded to a multiple of its
        # entries (scenario 0 repeated: its cascade and group indices stay
        # valid) and split over them; the U unique cascades run once, on the
        # mesh's first device, and their outcomes are copied to the others.
        # Host staging (pack), H2D, then the dispatch proper — the split
        # DispatchStats reports for the pipeline
        mesh, n_shards = resolve_data_mesh(
            check_mesh(self.mesh if mesh is None else mesh, self.device), K,
            what="scenario sweep",
        )
        Kp = pad_to_multiple(K, n_shards)

        def pad_k(a: np.ndarray) -> np.ndarray:
            if Kp == a.shape[0]:
                return a
            return np.concatenate([a, np.repeat(a[:1], Kp - a.shape[0], axis=0)], axis=0)

        fd = self._np_dtype
        clock = _PhaseClock(self.device)
        t0 = time.perf_counter()
        shared = {  # the skeletons' planes: every scenario reads them
            "nbytes": stack_np("bytes"), "weight": stack_np("weight"),
            "host": stack_np("host"), "valid": stack_np("valid"),
            "region": stack_np("region"), "bw_window": bw_window.astype(fd),
        }
        cascade_planes = {
            "t": stack_np("t"),
            "cas_group": group_of[cas_rows_np], "cas_assign": assign[cas_rows_np].astype(np.int64),
            "cas_stt": stt_np[cas_rows_np], "cas_disc": disc_np[cas_rows_np],
            "cas_weights": w_np[cas_rows_np].astype(fd), "qos_of_region": self._qos_of_region,
        }
        per_k = {  # one row a scenario: split over the mesh
            "group_of": group_of, "cascade_of": cascade_of,
            "assign": assign.astype(np.int64), "lat_scale": lat_scale,
            "pool_latency_ns": topo_stack.pool_latency_ns.astype(fd),
            "local_latency_ns": topo_stack.local_latency_ns.astype(fd),
            "switch_bw": topo_stack.switch_bandwidth_gbps.astype(fd),
        }
        stage_s = time.perf_counter() - t0
        devs = [self.device] if mesh is None else mesh_devices(mesh)
        structure = self._replicas.on(devs)

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(devs[0])

        clock.mark()
        shared_dev = {name: put(a) for name, a in shared.items()}
        cascade_dev = {name: put(a) for name, a in cascade_planes.items()}
        per_k_dev = {name: [put(a)] if mesh is None else shard_rows(mesh, pad_k(a))
                     for name, a in per_k.items()}
        clock.mark()
        self.dispatch_count += 1
        cascades = _sweep_cascades(
            host=shared_dev["host"], valid=shared_dev["valid"], region=shared_dev["region"],
            **cascade_dev,
            bits_table=structure[0][0],
            stage_order=self._stage_order,
            n_hosts=H,
            merge_plan=self._merge_plan,
            qos_on=qos_on,
        )
        # the cascades' outcomes and the skeletons' planes, once a device
        on_dev = {d: (cascades.to(d), {n: x.to(d) for n, x in shared_dev.items()})
                  for d in dict.fromkeys(devs)}
        outs = [
            _sweep_reduce(
                on_dev[d][0], **on_dev[d][1], **{n: parts[j] for n, parts in per_k_dev.items()},
                route=structure[j][1], n_windows=self.n_windows, n_hosts=H,
            )
            for j, d in enumerate(devs)
        ]
        # one [K, M] host-boundary crossing for the whole sweep (one a shard)
        tot = np.concatenate([o.cpu().numpy() for o in outs])[:K].astype(np.float64)
        clock.mark()
        transfer_s, compute_s = clock.seconds()
        self.last_dispatch = DispatchStats(
            devices_used=n_shards,
            shard_rows=Kp // n_shards if mesh is not None else 0,
            rows=K,
            padded_fraction=float(Kp - K) / Kp,
            stage_s=stage_s,
            transfer_s=transfer_s,
            compute_s=compute_s,
            qos_classes=C,
        )
        breakdowns = [_unpack(tot[k], P, S, H) for k in range(K)]
        native = float(sum(skels[0].native_ns))
        return SweepResult(
            scenarios=scenarios,
            breakdowns=breakdowns,
            native_ns=native,
            feasible=feasible,
            utilization=utilization,
            devices_used=self.last_dispatch.devices_used,
            shard_rows=self.last_dispatch.shard_rows,
            padded_fraction=self.last_dispatch.padded_fraction,
            stage_s=stage_s,
            transfer_s=transfer_s,
            compute_s=compute_s,
            qos_classes=C,
        )

    # ------------------------------------------------------------------ #
    # hillclimb-style refinement
    # ------------------------------------------------------------------ #

    def successive_halving(
        self,
        scenarios: Sequence[Scenario],
        refine: Callable[[Scenario, int], Iterable[Scenario]],
        rounds: int = 2,
        keep: float = 0.5,
        on_overflow: str = "mark",
    ) -> Tuple[SweepResult, int]:
        """Batched hillclimb: evaluate, keep the best ``keep`` fraction,
        expand survivors via ``refine(scenario, round)``, repeat.

        Every round is one stacked dispatch, so a whole search costs
        ``rounds + 1`` dispatches regardless of population size.  Returns
        the final round's :class:`SweepResult` and its best index.

        Capacity-infeasible scenarios never survive a round while at
        least one feasible scenario exists (``top`` pads with infeasible
        entries only to fill its quota — they are filtered here, so
        refinement budget is not spent expanding capacity violations).
        If the *entire* final population is infeasible the returned index
        is the lowest-delay infeasible scenario; check
        ``result.feasible[index]`` before acting on it.
        """
        pop = list(scenarios)
        res = self.run(pop, on_overflow=on_overflow)
        for r in range(int(rounds)):
            n_keep = int(np.ceil(len(pop) * keep))
            survivors = [
                pop[i] for i in res.top(n_keep) if res.feasible[i]
            ] or [pop[i] for i in res.top(n_keep)]
            children, seen = [], {s.label() for s in survivors}
            for s in survivors:
                for c in refine(s, r):
                    if c.label() not in seen:
                        seen.add(c.label())
                        children.append(c)
            pop = survivors + children
            res = self.run(pop, on_overflow=on_overflow)
        best = res.best()
        if best is None:  # nothing feasible anywhere: least-bad, flagged
            best = int(res.order(require_feasible=False)[0])
        return res, int(best)
