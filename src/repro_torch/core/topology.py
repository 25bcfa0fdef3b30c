"""CXL.mem topology model (paper §2, Figure 1).

A topology is a tree: a CXL Root Complex (RC) at the root, CXL switches as
internal nodes, and memory pools (expanders) as leaves.  Local DRAM is pool 0
and hangs directly off the memory controller (empty switch path).  Every
component is annotated with the paper's three quantities:

  * ``latency_ns``  — added round-trip latency of traversing the component,
  * ``bandwidth_gbps`` — sustained bandwidth (GB/s) through the component,
  * ``stt_ns``      — serial transmission time: minimum spacing between two
                      transactions through the same component (switches only).

``FlatTopology`` lowers the tree to dense arrays so the timing analyzer
(:mod:`repro_torch.core.analyzer`) can run as batched tensor ops.

Port of ``repro/core/topology.py`` (numpy only, arrays bitwise equal to the
reference's), the stacked parameter lowering of a sweep's or a fleet's
numeric variants (:class:`TopologyOverride`, :func:`flatten_stack`)
included.  Switches may arbitrate by QoS class (``Switch.discipline``,
``class_weights``); :class:`QosSpec` re-disciplines a flattened topology's
stages by name, as a sweep's ``qos`` axis does.

**Multi-host fabrics** (the paper's pooling scenario): a topology may declare
``n_hosts`` attached servers.  Switches and expanders are *shared* fabric
components; each host brings its own private Root Complex (and its own local
DRAM — pool 0 is per-host private, so local traffic never crosses hosts).
The lowering emits one route row per ``(host, pool)`` pair: two hosts
reaching the same expander share every switch row on its path — which is
what creates cross-host contention — but each traverses its *own* RC row.
``host_ports`` restricts which top-level components a host's RC is cabled
to, modelling partial fabrics (a host that cannot see an expander at all).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .units import BYTES_PER_GIB, bytes_to_gib, gib_to_bytes

__all__ = [
    "DISCIPLINES",
    "DISCIPLINE_CODES",
    "Pool",
    "QosSpec",
    "Switch",
    "Topology",
    "TopologyOverride",
    "FlatTopology",
    "FlatTopologyStack",
    "flatten_stack",
    "chained_topology",
    "figure1_topology",
    "local_only_topology",
    "pooled_topology",
    "two_tier_topology",
]

# queue disciplines a switch's arbiter can run; codes are the traced-integer
# encoding the vectorized QoS cascade consumes (the reference's DESIGN.md §QoS arbitration)
DISCIPLINES: Tuple[str, ...] = ("fifo", "priority", "wfq")
DISCIPLINE_CODES: Dict[str, int] = {d: i for i, d in enumerate(DISCIPLINES)}


@dataclasses.dataclass(frozen=True)
class QosSpec:
    """A hashable QoS arbitration policy — one value of a sweep's ``qos``
    axis, applied on top of a topology's own per-switch settings.

    ``discipline``/``class_weights`` set every switch; ``switch_disciplines``
    / ``switch_weights`` override individual switches by name (a bare name
    also matches its ECMP replicas ``name@r``).  Disciplines and weights are
    *numeric data* to the QoS cascade, so scenarios differing only in a
    :class:`QosSpec` run the same kernel.
    """

    discipline: Optional[str] = None
    class_weights: Optional[Tuple[float, ...]] = None
    switch_disciplines: Tuple[Tuple[str, str], ...] = ()
    switch_weights: Tuple[Tuple[str, Tuple[float, ...]], ...] = ()

    def __post_init__(self) -> None:
        for d in (self.discipline, *(d for _, d in self.switch_disciplines)):
            if d is not None and d not in DISCIPLINE_CODES:
                raise ValueError(f"unknown discipline {d!r} (use {DISCIPLINES})")
        for w in (self.class_weights, *(w for _, w in self.switch_weights)):
            if w is not None and (len(w) == 0 or any(x <= 0 for x in w)):
                raise ValueError("class weights must be non-empty and positive")

    def n_classes(self) -> int:
        n = len(self.class_weights) if self.class_weights else 1
        for _, w in self.switch_weights:
            n = max(n, len(w))
        return n

    def apply(
        self,
        disc_row: np.ndarray,  # [S] i32, mutated in place
        w_row: np.ndarray,  # [S, C] float, mutated in place
        switch_names: Sequence[str],
    ) -> None:
        base = [n.split("@")[0] for n in switch_names]

        def select(name: str) -> List[int]:
            sel = [
                i for i, b in enumerate(base)
                if b == name or switch_names[i] == name
            ]
            if not sel:
                raise ValueError(f"QosSpec names unknown switch {name!r}")
            return sel

        if self.discipline is not None:
            disc_row[:] = DISCIPLINE_CODES[self.discipline]
        if self.class_weights is not None:
            w = np.asarray(self.class_weights, w_row.dtype)
            w_row[:, : len(w)] = w
        for name, d in self.switch_disciplines:
            disc_row[select(name)] = DISCIPLINE_CODES[d]
        for name, ws in self.switch_weights:
            w_row[np.ix_(select(name), range(len(ws)))] = np.asarray(
                ws, w_row.dtype
            )

    def describe(self) -> str:
        parts = []
        if self.discipline is not None:
            parts.append(self.discipline)
        if self.class_weights is not None:
            parts.append(":".join(f"{w:g}" for w in self.class_weights))
        parts += [f"{n}={d}" for n, d in self.switch_disciplines]
        parts += [
            f"{n}={':'.join(f'{x:g}' for x in ws)}"
            for n, ws in self.switch_weights
        ]
        return "qos[" + ",".join(parts or ["base"]) + "]"


@dataclasses.dataclass(frozen=True)
class Switch:
    """A CXL switch (or the Root Complex, which behaves like one)."""

    name: str
    latency_ns: float  # added latency per transaction through this switch
    bandwidth_gbps: float  # GB/s through the switch
    stt_ns: float  # serial transmission time (min gap between transactions)
    parent: Optional[str] = None  # parent switch name; None => attached to RC
    # QoS arbitration: 'fifo' (arrival order), 'priority' (strict, class 0
    # highest), or 'wfq' (weighted fair, per-class virtual finish times)
    discipline: str = "fifo"
    # per-QoS-class weights ('wfq' only; None = equal); length must equal the
    # topology's n_qos_classes
    class_weights: Optional[Tuple[float, ...]] = None
    # ECMP-style multipath: lower this switch to ``multipath`` parallel route
    # columns; each (host, pool) flow deterministically picks one replica
    multipath: int = 1


@dataclasses.dataclass(frozen=True)
class Pool:
    """A memory pool / expander (leaf of the topology tree)."""

    name: str
    latency_ns: float  # device media latency (round trip, added)
    bandwidth_gbps: float  # device-side bandwidth
    capacity_bytes: int
    parent: Optional[str] = None  # switch it hangs off; None => direct to RC
    is_local: bool = False  # True only for local DRAM


class Topology:
    """A validated CXL.mem topology tree.

    Construction order does not matter; ``validate()`` checks the tree is
    acyclic, parents exist, and there is exactly one local DRAM pool.
    """

    def __init__(
        self,
        pools: Sequence[Pool],
        switches: Sequence[Switch] = (),
        rc_latency_ns: float = 10.0,
        rc_bandwidth_gbps: float = 256.0,
        rc_stt_ns: float = 0.5,
        local_dram_latency_ns: float = 88.9,  # paper's measured platform latency
        n_hosts: int = 1,
        host_ports: Optional[Mapping[int, Sequence[str]]] = None,
        n_qos_classes: Optional[int] = None,  # None: derive from class_weights
    ) -> None:
        self.pools: List[Pool] = list(pools)
        self.switches: List[Switch] = list(switches)
        self.rc_latency_ns = float(rc_latency_ns)
        self.rc_bandwidth_gbps = float(rc_bandwidth_gbps)
        self.rc_stt_ns = float(rc_stt_ns)
        self.local_dram_latency_ns = float(local_dram_latency_ns)
        self.n_hosts = int(n_hosts)
        derived = max(
            (len(s.class_weights) for s in self.switches if s.class_weights),
            default=1,
        )
        self.n_qos_classes = derived if n_qos_classes is None else int(n_qos_classes)
        # host -> top-level component names (parentless switches/pools) the
        # host's RC is attached to; hosts absent from the map see everything
        self.host_ports: Dict[int, Tuple[str, ...]] = {
            int(h): tuple(names) for h, names in (host_ports or {}).items()
        }
        self._switch_by_name: Dict[str, Switch] = {s.name: s for s in self.switches}
        self._pool_index: Dict[str, int] = {p.name: i for i, p in enumerate(self.pools)}
        self.validate()

    # ------------------------------------------------------------------ #

    def validate(self) -> None:
        if len({p.name for p in self.pools}) != len(self.pools):
            raise ValueError("duplicate pool names")
        if len(self._switch_by_name) != len(self.switches):
            raise ValueError("duplicate switch names")
        locals_ = [p for p in self.pools if p.is_local]
        if len(locals_) != 1:
            raise ValueError(f"need exactly one local DRAM pool, got {len(locals_)}")
        if self.pools.index(locals_[0]) != 0:
            raise ValueError("local DRAM must be pool index 0")
        if locals_[0].parent is not None:
            raise ValueError("local DRAM must attach directly (parent=None)")
        for s in self.switches:
            if s.parent is not None and s.parent not in self._switch_by_name:
                raise ValueError(f"switch {s.name}: unknown parent {s.parent}")
        for p in self.pools:
            if p.parent is not None and p.parent not in self._switch_by_name:
                raise ValueError(f"pool {p.name}: unknown parent {p.parent}")
        # acyclicity: walk each switch to the RC with a step bound
        for s in self.switches:
            seen = set()
            cur: Optional[str] = s.name
            while cur is not None:
                if cur in seen:
                    raise ValueError(f"cycle through switch {cur}")
                seen.add(cur)
                cur = self._switch_by_name[cur].parent
        if self.n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        if self.n_qos_classes < 1:
            raise ValueError("n_qos_classes must be >= 1")
        for s in self.switches:
            if s.discipline not in DISCIPLINES:
                raise ValueError(
                    f"switch {s.name}: unknown discipline {s.discipline!r} "
                    f"(one of {DISCIPLINES})"
                )
            if s.multipath < 1:
                raise ValueError(f"switch {s.name}: multipath must be >= 1")
            if s.class_weights is not None:
                if len(s.class_weights) != self.n_qos_classes:
                    raise ValueError(
                        f"switch {s.name}: {len(s.class_weights)} class "
                        f"weights for {self.n_qos_classes} QoS classes"
                    )
                if any(w <= 0 for w in s.class_weights):
                    raise ValueError(
                        f"switch {s.name}: class weights must be > 0"
                    )
        top_level = {s.name for s in self.switches if s.parent is None} | {
            p.name for p in self.pools if p.parent is None and not p.is_local
        }
        for h, names in self.host_ports.items():
            if not (0 <= h < self.n_hosts):
                raise ValueError(f"host_ports host {h} out of range [0, {self.n_hosts})")
            for name in names:
                if name not in top_level:
                    raise ValueError(
                        f"host {h} port {name!r} is not a top-level component"
                    )

    # ------------------------------------------------------------------ #

    def host_reaches(self, host: int, pool: Pool) -> bool:
        """Whether ``host``'s RC has a fabric path to ``pool``.

        Local DRAM is always reachable (it is the host's own).  Remote pools
        are reachable iff the top-level component of their path is among the
        host's declared ports (all of them when the host declares none).
        """
        if pool.is_local:
            return True
        ports = self.host_ports.get(int(host))
        if ports is None:
            return True
        top = pool.name
        cur = pool.parent
        while cur is not None:
            top = cur
            cur = self._switch_by_name[cur].parent
        return top in ports

    def pool_index(self, name: str) -> int:
        return self._pool_index[name]

    def switch_path(self, pool: Pool) -> List[Switch]:
        """Switches traversed from the pool up to (not including) the RC."""
        path: List[Switch] = []
        cur = pool.parent
        while cur is not None:
            sw = self._switch_by_name[cur]
            path.append(sw)
            cur = sw.parent
        return path

    def pool_total_latency_ns(self, pool: Pool) -> float:
        """End-to-end added latency of one access to ``pool``.

        Local DRAM: its media latency only.  Remote pools: media latency +
        every switch on the path + the RC.
        """
        if pool.is_local:
            return pool.latency_ns
        lat = pool.latency_ns + self.rc_latency_ns
        for sw in self.switch_path(pool):
            lat += sw.latency_ns
        return lat

    def pool_path_bandwidth_gbps(self, pool: Pool) -> float:
        """Min bandwidth along the path (bottleneck link)."""
        bw = pool.bandwidth_gbps
        if not pool.is_local:
            bw = min(bw, self.rc_bandwidth_gbps)
            for sw in self.switch_path(pool):
                bw = min(bw, sw.bandwidth_gbps)
        return bw

    def flatten(self) -> "FlatTopology":
        return FlatTopology.from_topology(self)

    def flatten_stack(
        self, overrides: Sequence[Optional["TopologyOverride"]]
    ) -> "FlatTopologyStack":
        """Lower K numeric parameter variants in one pass; see
        :func:`flatten_stack`."""
        return flatten_stack(self, overrides)

    def describe(self) -> str:
        hosts = "" if self.n_hosts == 1 else f", {self.n_hosts} hosts"
        lines = [
            f"Topology: {len(self.pools)} pools, {len(self.switches)} switches"
            f"{hosts} "
            f"(RC lat={self.rc_latency_ns}ns bw={self.rc_bandwidth_gbps}GB/s "
            f"stt={self.rc_stt_ns}ns; local DRAM lat={self.local_dram_latency_ns}ns)"
        ]
        for p in self.pools:
            path = " -> ".join(s.name for s in self.switch_path(p)) or "(direct)"
            lines.append(
                f"  pool[{self.pool_index(p.name)}] {p.name}: lat={p.latency_ns}ns "
                f"bw={p.bandwidth_gbps}GB/s cap={bytes_to_gib(p.capacity_bytes):.1f}GiB "
                f"path={path} total_lat={self.pool_total_latency_ns(p):.1f}ns"
            )
        for s in self.switches:
            lines.append(
                f"  switch {s.name}: lat={s.latency_ns}ns bw={s.bandwidth_gbps}GB/s "
                f"stt={s.stt_ns}ns parent={s.parent or 'RC'}"
            )
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class FlatTopology:
    """Dense-array lowering of a :class:`Topology` for the analyzer.

    The analyzer routes each event through its **virtual pool**
    ``vp = host * n_pools + pool``: route/latency/bandwidth arrays have one
    row per (host, pool) pair.  Shared fabric switches keep one row each —
    every host's traffic lands on the same row, which is where cross-host
    contention comes from — while each host gets a private RC pseudo-switch.
    Switch arrays therefore have ``n_switches + n_hosts`` entries, host
    ``h``'s RC at index ``n_switches + h``.

    With ``n_hosts == 1`` every array is bit-identical to the historical
    single-host lowering (one RC, ``route`` is ``[P, S]``), so all existing
    single-host consumers and oracles are unchanged.
    """

    n_pools: int  # physical pools (per host)
    n_switches: int  # shared switches + one RC pseudo-switch per host
    pool_latency_ns: np.ndarray  # [H*P] total added latency per access
    pool_bandwidth_gbps: np.ndarray  # [H*P] bottleneck bandwidth on path
    pool_capacity: np.ndarray  # [P] bytes (physical device capacity)
    # [P] device media latency alone (the leaf component of pool_latency_ns);
    # the device-cache model (core/cache.py) replaces this component with
    # the expander's DRAM-cache hit latency on cache hits
    pool_media_latency_ns: np.ndarray
    local_latency_ns: float
    # route[H*P, S] == 1 iff accesses by host H to pool P traverse switch S
    route: np.ndarray
    switch_stt_ns: np.ndarray  # [S]
    switch_bandwidth_gbps: np.ndarray  # [S]
    # depth of each switch in the tree (RC = 0, children of RC = 1, ...).
    # The analyzer cascades serial queues deepest-first so an event's shift at
    # a leaf switch is visible when it merges at its parent — matching the
    # event-by-event fine-grained simulator.
    switch_depth: np.ndarray
    pool_names: Tuple[str, ...]
    switch_names: Tuple[str, ...]
    n_hosts: int = 1
    # host_reachable[H, P]: False where the host's ports exclude the pool
    host_reachable: Optional[np.ndarray] = None
    # QoS arbitration (empty/None => every stage is a plain FIFO):
    # per-column queue discipline (ECMP replicas and RCs included) ...
    switch_discipline: Tuple[str, ...] = ()
    # ... per-column class weights [S, C] (wfq rows; ones elsewhere) ...
    qos_class_weights: Optional[np.ndarray] = None
    # ... and the class count every weight row shares
    n_qos_classes: int = 1

    @property
    def n_vpools(self) -> int:
        """Virtual (host, pool) row count of ``route`` / latency tables."""
        return self.n_hosts * self.n_pools

    def vp_index(self, host: int, pool: int) -> int:
        return int(host) * self.n_pools + int(pool)

    def stage_order(self) -> np.ndarray:
        """Switch indices ordered deepest-first (RCs last)."""
        return np.argsort(-self.switch_depth, kind="stable")

    @property
    def has_qos(self) -> bool:
        """True when any stage arbitrates (non-FIFO) or classes exist."""
        return self.n_qos_classes > 1 or any(
            d != "fifo" for d in self.switch_discipline
        )

    def discipline_codes(self) -> np.ndarray:
        """[S] int32 discipline codes (``DISCIPLINE_CODES``; all-FIFO when
        the topology declares no disciplines)."""
        if not self.switch_discipline:
            return np.zeros((self.n_switches,), np.int32)
        return np.array(
            [DISCIPLINE_CODES[d] for d in self.switch_discipline], np.int32
        )

    def class_weight_table(self) -> np.ndarray:
        """[S, C] per-stage class weights (ones where undeclared)."""
        if self.qos_class_weights is None:
            return np.ones((self.n_switches, self.n_qos_classes), np.float64)
        return self.qos_class_weights

    @staticmethod
    def from_topology(t: Topology) -> "FlatTopology":
        P = len(t.pools)
        H = t.n_hosts
        # ECMP expansion: a multipath-m switch lowers to m route columns
        # (replicas share every numeric parameter; names 'sw', 'sw@1', ...)
        rep_src = _multipath_columns(t.switches)
        n_sw = len(rep_src)
        col_of: Dict[Tuple[str, int], int] = {}
        exp_names: List[str] = []
        for col, i in enumerate(rep_src):
            s = t.switches[i]
            r = len([c for c in rep_src[:col] if c == i])
            col_of[(s.name, r)] = col
            exp_names.append(s.name if r == 0 else f"{s.name}@{r}")
        S = n_sw + H  # + one RC pseudo-switch per host
        C = t.n_qos_classes
        pool_lat = np.zeros((H * P,), np.float64)
        pool_bw = np.zeros((H * P,), np.float64)
        pool_cap = np.zeros((P,), np.float64)
        pool_media = np.array([p.latency_ns for p in t.pools], np.float64)
        route = np.zeros((H * P, S), np.float64)
        reach = np.ones((H, P), bool)
        for i, p in enumerate(t.pools):
            pool_cap[i] = p.capacity_bytes
            for h in range(H):
                vp = h * P + i
                pool_lat[vp] = t.pool_total_latency_ns(p)
                pool_bw[vp] = t.pool_path_bandwidth_gbps(p)
                if p.is_local:
                    continue
                if not t.host_reaches(h, p):
                    reach[h, i] = False
                    continue  # no route: the host's ports exclude this pool
                route[vp, n_sw + h] = 1.0  # the host's private RC
                for sw in t.switch_path(p):
                    # each flow hashes onto one replica of a multipath switch
                    route[vp, col_of[(sw.name, vp % max(1, sw.multipath))]] = 1.0
        exp_sw = [t.switches[i] for i in rep_src]
        stt = np.array(
            [s.stt_ns for s in exp_sw] + [t.rc_stt_ns] * H, np.float64
        )
        sw_bw = np.array(
            [s.bandwidth_gbps for s in exp_sw] + [t.rc_bandwidth_gbps] * H,
            np.float64,
        )

        def depth(sw: Switch) -> int:
            d = 1
            cur = sw.parent
            while cur is not None:
                d += 1
                cur = t._switch_by_name[cur].parent
            return d

        sw_depth = np.array([depth(s) for s in exp_sw] + [0] * H, np.int32)
        rc_names = ("RC",) if H == 1 else tuple(f"RC{h}" for h in range(H))
        disc = tuple(s.discipline for s in exp_sw) + ("fifo",) * H
        weights = np.ones((S, C), np.float64)
        for col, s in enumerate(exp_sw):
            if s.class_weights is not None:
                weights[col] = s.class_weights
        return FlatTopology(
            n_pools=P,
            n_switches=S,
            pool_latency_ns=pool_lat,
            pool_bandwidth_gbps=pool_bw,
            pool_capacity=pool_cap,
            pool_media_latency_ns=pool_media,
            local_latency_ns=t.local_dram_latency_ns,
            route=route,
            switch_stt_ns=stt,
            switch_bandwidth_gbps=sw_bw,
            switch_depth=sw_depth,
            pool_names=tuple(p.name for p in t.pools),
            switch_names=tuple(exp_names) + rc_names,
            n_hosts=H,
            host_reachable=reach,
            switch_discipline=disc,
            qos_class_weights=weights,
            n_qos_classes=C,
        )


def _multipath_columns(switches: Sequence[Switch]) -> List[int]:
    """Expanded-column -> original-switch index for the ECMP lowering.

    Replicas of switch ``i`` occupy consecutive columns; the same layout is
    used by :meth:`FlatTopology.from_topology` and :func:`flatten_stack`, so
    per-column numeric leaves always line up with the route matrix.
    """
    src: List[int] = []
    for i, s in enumerate(switches):
        src.extend([i] * max(1, int(s.multipath)))
    return src


# --------------------------------------------------------------------------- #
# Parameterized stacked lowering (the scenario sweep's topology axis)
# --------------------------------------------------------------------------- #

_POOL_FIELDS = ("latency_ns", "bandwidth_gbps")
_SWITCH_FIELDS = ("latency_ns", "bandwidth_gbps", "stt_ns")


@dataclasses.dataclass(frozen=True)
class TopologyOverride:
    """Numeric parameter overrides against a base :class:`Topology`.

    Overrides never change *structure* (which components exist, who parents
    whom, pool capacities): a whole override stack shares the base
    topology's route matrix, stage order and cascade merge plan, which is
    what lets :func:`flatten_stack` lower K scenarios to ``[K, ...]`` leaf
    arrays under one analyzer dispatch.  Structural variation (pool
    count, switch depth, capacity) is a different base topology — sweep it
    as an outer loop of suites.

    ``pools``/``switches`` map component name -> field -> value; pool
    fields: ``latency_ns``/``bandwidth_gbps``, switch fields those plus
    ``stt_ns``.  Scalar fields override the RC / local-DRAM constants.

    Bandwidth semantics: the three-delay model prices bandwidth at
    *switch* rows (windowed stretch) — a pool's ``bandwidth_gbps`` feeds
    only the reported path-bottleneck figure
    (``FlatTopology.pool_bandwidth_gbps``), never a delay.  To sweep an
    expander's link rate, override the switch it hangs off; sweeping pool
    bandwidth alone yields identical delay totals by design.  A bandwidth of 0
    means "unconstrained" — every analyzer skips the component's
    bandwidth charge (no division happens).
    """

    pools: Mapping[str, Mapping[str, float]] = dataclasses.field(default_factory=dict)
    switches: Mapping[str, Mapping[str, float]] = dataclasses.field(default_factory=dict)
    rc_latency_ns: Optional[float] = None
    rc_bandwidth_gbps: Optional[float] = None
    rc_stt_ns: Optional[float] = None
    local_dram_latency_ns: Optional[float] = None

    def validate_against(self, t: "Topology") -> None:
        pool_names = {p.name for p in t.pools}
        switch_names = {s.name for s in t.switches}
        for name, fields in self.pools.items():
            if name not in pool_names:
                raise ValueError(f"override names unknown pool {name!r}")
            for f, v in fields.items():
                if f not in _POOL_FIELDS:
                    raise ValueError(f"pool {name}: unknown field {f!r}")
                if v < 0:
                    raise ValueError(f"pool {name}.{f} must be >= 0")
        for name, fields in self.switches.items():
            if name not in switch_names:
                raise ValueError(f"override names unknown switch {name!r}")
            for f, v in fields.items():
                if f not in _SWITCH_FIELDS:
                    raise ValueError(f"switch {name}: unknown field {f!r}")
                if v < 0:
                    raise ValueError(f"switch {name}.{f} must be >= 0")

    def describe(self) -> str:
        parts = []
        for name, fields in self.pools.items():
            parts += [f"{name}.{f}={v:g}" for f, v in fields.items()]
        for name, fields in self.switches.items():
            parts += [f"{name}.{f}={v:g}" for f, v in fields.items()]
        for f in ("rc_latency_ns", "rc_bandwidth_gbps", "rc_stt_ns", "local_dram_latency_ns"):
            v = getattr(self, f)
            if v is not None:
                parts.append(f"{f}={v:g}")
        return ",".join(parts) or "base"


@dataclasses.dataclass(frozen=True)
class FlatTopologyStack:
    """K parameter variants of one topology, lowered to stacked leaves.

    ``base`` carries everything structural — route matrix, switch depths,
    names, capacities, reachability — shared by every scenario (so
    :func:`~repro_torch.core.analyzer.plan_cascade` runs once for the
    stack).  The numeric leaves get a leading scenario axis: the per-row
    leaves of the sweep's and the fleet's analyses.
    """

    base: FlatTopology
    pool_latency_ns: np.ndarray  # [K, H*P]
    pool_bandwidth_gbps: np.ndarray  # [K, H*P]
    pool_media_latency_ns: np.ndarray  # [K, P]
    local_latency_ns: np.ndarray  # [K]
    switch_stt_ns: np.ndarray  # [K, S]
    switch_bandwidth_gbps: np.ndarray  # [K, S]

    @property
    def k(self) -> int:
        return int(self.pool_latency_ns.shape[0])

    def member(self, k: int) -> FlatTopology:
        """Materialize scenario ``k`` as a plain :class:`FlatTopology`
        (sequential oracles, cache models, and spot-checks run on this)."""
        return dataclasses.replace(
            self.base,
            pool_latency_ns=self.pool_latency_ns[k],
            pool_bandwidth_gbps=self.pool_bandwidth_gbps[k],
            pool_media_latency_ns=self.pool_media_latency_ns[k],
            local_latency_ns=float(self.local_latency_ns[k]),
            switch_stt_ns=self.switch_stt_ns[k],
            switch_bandwidth_gbps=self.switch_bandwidth_gbps[k],
        )


def flatten_stack(
    t: Topology, overrides: Sequence[Optional[TopologyOverride]]
) -> FlatTopologyStack:
    """Lower ``len(overrides)`` parameter variants of ``t`` in one pass.

    Per-component leaf values are overridden per scenario, then the
    path-derived aggregates (total pool latency, bottleneck bandwidth) are
    recomputed vectorized across the whole stack; ``None`` entries are the
    unmodified base.  Row k agrees with ``Topology``-level lowering of the
    same parameters (``member(k)`` vs a rebuilt tree) to float tolerance.
    """
    base_flat = t.flatten()
    P, H, n_sw = len(t.pools), t.n_hosts, len(t.switches)
    K = len(overrides)
    if K == 0:
        raise ValueError("empty override stack")

    pool_media = np.tile([p.latency_ns for p in t.pools], (K, 1))
    pool_leaf_bw = np.tile([p.bandwidth_gbps for p in t.pools], (K, 1))
    sw_lat = np.tile([s.latency_ns for s in t.switches], (K, 1)).reshape(K, n_sw)
    sw_bw = np.tile([s.bandwidth_gbps for s in t.switches], (K, 1)).reshape(K, n_sw)
    sw_stt = np.tile([s.stt_ns for s in t.switches], (K, 1)).reshape(K, n_sw)
    rc_lat = np.full((K,), t.rc_latency_ns)
    rc_bw = np.full((K,), t.rc_bandwidth_gbps)
    rc_stt = np.full((K,), t.rc_stt_ns)
    local_lat = np.full((K,), t.local_dram_latency_ns)

    pool_idx = {p.name: i for i, p in enumerate(t.pools)}
    sw_idx = {s.name: i for i, s in enumerate(t.switches)}
    leaf = {
        ("pool", "latency_ns"): pool_media,
        ("pool", "bandwidth_gbps"): pool_leaf_bw,
        ("switch", "latency_ns"): sw_lat,
        ("switch", "bandwidth_gbps"): sw_bw,
        ("switch", "stt_ns"): sw_stt,
    }
    for k, ov in enumerate(overrides):
        if ov is None:
            continue
        ov.validate_against(t)
        for name, fields in ov.pools.items():
            for f, v in fields.items():
                leaf[("pool", f)][k, pool_idx[name]] = v
        for name, fields in ov.switches.items():
            for f, v in fields.items():
                leaf[("switch", f)][k, sw_idx[name]] = v
        if ov.rc_latency_ns is not None:
            rc_lat[k] = ov.rc_latency_ns
        if ov.rc_bandwidth_gbps is not None:
            rc_bw[k] = ov.rc_bandwidth_gbps
        if ov.rc_stt_ns is not None:
            rc_stt[k] = ov.rc_stt_ns
        if ov.local_dram_latency_ns is not None:
            local_lat[k] = ov.local_dram_latency_ns

    # path membership from the tree (structure: shared by the whole stack)
    pathm = np.zeros((P, n_sw), np.float64)
    nonlocal_ = np.zeros((P,), bool)
    for i, p in enumerate(t.pools):
        if p.is_local:
            continue
        nonlocal_[i] = True
        for sw in t.switch_path(p):
            pathm[i, sw_idx[sw.name]] = 1.0

    # total added latency per (scenario, pool): media + RC + path switches
    path_lat = sw_lat @ pathm.T if n_sw else np.zeros((K, P))
    pool_lat = pool_media + nonlocal_[None, :] * (rc_lat[:, None] + path_lat)
    # bottleneck bandwidth: min(leaf, RC, switches on path)
    if n_sw:
        masked = np.where(pathm[None, :, :] > 0, sw_bw[:, None, :], np.inf)
        path_bw = masked.min(axis=-1)
    else:
        path_bw = np.full((K, P), np.inf)
    pool_bw = np.where(
        nonlocal_[None, :],
        np.minimum(np.minimum(pool_leaf_bw, rc_bw[:, None]), path_bw),
        pool_leaf_bw,
    )

    # expand to virtual (host, pool) rows, duplicate multipath replica
    # columns (replicas share their switch's numbers, so overriding the
    # switch overrides every replica), and append per-host RC columns —
    # the same layout FlatTopology.from_topology emits
    rep_src = _multipath_columns(t.switches)
    return FlatTopologyStack(
        base=base_flat,
        pool_latency_ns=np.tile(pool_lat, (1, H)),
        pool_bandwidth_gbps=np.tile(pool_bw, (1, H)),
        pool_media_latency_ns=pool_media,
        local_latency_ns=local_lat,
        switch_stt_ns=np.concatenate(
            [sw_stt[:, rep_src], np.repeat(rc_stt[:, None], H, axis=1)], axis=1
        ),
        switch_bandwidth_gbps=np.concatenate(
            [sw_bw[:, rep_src], np.repeat(rc_bw[:, None], H, axis=1)], axis=1
        ),
    )


# --------------------------------------------------------------------------- #
# Canonical topologies
# --------------------------------------------------------------------------- #


def local_only_topology(capacity_gib: float = 96.0) -> Topology:
    """Degenerate topology: local DRAM only (native execution baseline)."""
    return Topology(
        pools=[
            Pool(
                "local_dram",
                latency_ns=88.9,
                bandwidth_gbps=76.8,  # DDR5-4800 dual channel
                capacity_bytes=int(gib_to_bytes(capacity_gib)),
                is_local=True,
            )
        ]
    )


def figure1_topology() -> Topology:
    """The paper's Figure 1: two CXL switches, three memory pools.

    The figure annotates BW/Lat/STT per component; the published text embeds
    them in an image, so we use representative CXL 2.0 numbers (x8 PCIe 5.0
    links, ~70 ns switch traversal) consistent with the paper's prose.

        RC ── switch0 ── pool1 (near pool, direct expander)
              └─ switch1 ── pool2, pool3 (far pools behind 2nd-level switch)
    """
    return Topology(
        pools=[
            Pool("local_dram", 88.9, 76.8, 96 * BYTES_PER_GIB, is_local=True),
            Pool("cxl_pool1", 150.0, 32.0, 128 * BYTES_PER_GIB, parent="switch0"),
            Pool("cxl_pool2", 180.0, 32.0, 256 * BYTES_PER_GIB, parent="switch1"),
            Pool("cxl_pool3", 180.0, 32.0, 256 * BYTES_PER_GIB, parent="switch1"),
        ],
        switches=[
            Switch("switch0", latency_ns=70.0, bandwidth_gbps=64.0, stt_ns=2.0),
            Switch(
                "switch1",
                latency_ns=70.0,
                bandwidth_gbps=32.0,
                stt_ns=4.0,
                parent="switch0",
            ),
        ],
        rc_latency_ns=10.0,
        rc_bandwidth_gbps=128.0,
        rc_stt_ns=0.5,
    )


def chained_topology(depth: int = 8, attach_bw: float = 32.0) -> Topology:
    """A daisy-chained expander string: ``depth`` switches in series, one
    expander hanging off each.

    The strictly nested switch masks (every event through ``sw{d}`` also
    traverses ``sw0..sw{d-1}``) make this the canonical chain-eligible
    topology for the device-resident epoch pipeline
    (:func:`repro.core.analyzer.plan_chain`), and the deep cascade is what
    stresses the congestion stages — the pipeline benchmark's workhorse.
    """
    if depth < 1:
        raise ValueError("chained_topology needs depth >= 1")
    pools = [Pool("local_dram", 88.9, 76.8, 96 * BYTES_PER_GIB, is_local=True)]
    switches = []
    for d in range(depth):
        switches.append(
            Switch(
                f"sw{d}",
                latency_ns=70.0,
                bandwidth_gbps=64.0,
                stt_ns=2.0 + 0.25 * d,
                parent=f"sw{d - 1}" if d else None,
            )
        )
        pools.append(
            Pool(
                f"exp{d}",
                170.0,
                attach_bw,
                256 * BYTES_PER_GIB,
                parent=f"sw{d}",
            )
        )
    return Topology(pools=pools, switches=switches)


def two_tier_topology(
    cxl_latency_ns: float = 170.0,
    cxl_bandwidth_gbps: float = 32.0,
    cxl_capacity_gib: float = 512.0,
) -> Topology:
    """Simple two-tier topology: local DRAM + one direct CXL expander."""
    return Topology(
        pools=[
            Pool("local_dram", 88.9, 76.8, 96 * BYTES_PER_GIB, is_local=True),
            Pool(
                "cxl_pool",
                cxl_latency_ns,
                cxl_bandwidth_gbps,
                int(gib_to_bytes(cxl_capacity_gib)),
                parent="sw",
            ),
        ],
        switches=[Switch("sw", latency_ns=70.0, bandwidth_gbps=cxl_bandwidth_gbps, stt_ns=2.0)],
    )


def pooled_topology(
    n_hosts: int = 2,
    cxl_latency_ns: float = 170.0,
    cxl_bandwidth_gbps: float = 32.0,
    cxl_capacity_gib: float = 1024.0,
    switch_stt_ns: float = 2.0,
    host_ports: Optional[Mapping[int, Sequence[str]]] = None,
    discipline: str = "fifo",
    class_weights: Optional[Sequence[float]] = None,
    multipath: int = 1,
) -> Topology:
    """The paper's pooling scenario: N hosts sharing one CXL expander.

    Each host keeps its private local DRAM (pool 0) and private RC; the
    expander and its switch are shared fabric components, so co-attached
    hosts contend there.  This is the canonical noisy-neighbor /
    memory-stranding topology.  ``discipline``/``class_weights`` set the
    shared switch's QoS arbitration policy (the per-rack policy knob);
    ``multipath`` lowers it to that many ECMP route columns.
    """
    weights = tuple(class_weights) if class_weights is not None else None
    return Topology(
        pools=[
            Pool("local_dram", 88.9, 76.8, 96 * BYTES_PER_GIB, is_local=True),
            Pool(
                "shared_pool",
                cxl_latency_ns,
                cxl_bandwidth_gbps,
                int(gib_to_bytes(cxl_capacity_gib)),
                parent="fabric_sw",
            ),
        ],
        switches=[
            Switch(
                "fabric_sw",
                latency_ns=70.0,
                bandwidth_gbps=cxl_bandwidth_gbps,
                stt_ns=switch_stt_ns,
                discipline=discipline,
                class_weights=weights,
                multipath=multipath,
            )
        ],
        n_hosts=n_hosts,
        host_ports=host_ports,
    )
