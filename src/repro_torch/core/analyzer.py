"""The Timing Analyzer — the paper's core contribution (§3, component 3),
ported from ``repro/core/analyzer.py`` to PyTorch.

Given one epoch's memory-event trace and a flattened topology, compute the
three delays the paper defines:

  1. **latency delay**    Σ_events (total latency of target pool − local DRAM
                          latency).  Pure gather + one-hot contraction.
  2. **congestion delay** per switch, events traversing the same switch must
                          be ≥ STT apart; later events are pushed back and the
                          push cascades through the path (leaf switch → RC).
  3. **bandwidth delay**  per switch, windows whose traffic exceeds BW × window
                          are stretched to bytes/BW.

Three implementations, in increasing speed order:

  * :class:`FineGrainedSimulator` — event-by-event discrete-event simulation
    (a copy of the reference's; pure Python).
  * :func:`analyze_ref` — vectorized numpy epoch analyzer, float64 (a copy
    of the reference's oracle).
  * :class:`EpochAnalyzer` — batched PyTorch analyzer over ``[B, N]``
    epochs.  Its congestion stage is the fused S-stage cascade
    (:func:`repro_torch.kernels.ops.congestion_cascade`), or on topologies
    whose switches arbitrate by QoS class the QoS cascade
    (:func:`repro_torch.kernels.ops.qos_congestion_cascade`): the
    hand-written CUDA kernels on the card, the plain PyTorch versions on the
    CPU.

The serial queue ``out_i = max(arr_i, out_{i-1} + STT)`` is solved in closed
form with a cumulative max:  let ``f_i = cummax(arr_i − STT·rank_i)``; then
``out_i = f_i + STT·rank_i``.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.sharding import (
    Replicas,
    check_mesh,
    pad_to_multiple,
    resolve_data_mesh,
    shard_rows,
)
from ..kernels import ops as kops
from ..launch.mesh import mesh_devices
from .aot import AotDispatchCache
from .events import EventStager, MemEvents
from .topology import FlatTopology
from .units import ms_to_ns, ns_to_s

__all__ = [
    "ChainPlan",
    "DelayBreakdown",
    "DispatchStats",
    "EpochAnalyzer",
    "FineGrainedSimulator",
    "PendingBatch",
    "analyze_any",
    "analyze_ref",
    "bucket_pow2",
    "plan_cascade",
    "plan_chain",
    "serial_queue_ref",
]


@dataclasses.dataclass(frozen=True)
class DispatchStats:
    """Observability record for the most recent dispatch (a copy of the
    reference's record).

    ``devices_used`` is the mesh entries the leading axis split over (a
    virtual mesh counts each repeat of its device), 1 whenever the split did
    not engage; ``shard_rows`` is the per-entry slice of the (padded)
    leading axis, 0 when unsharded;
    ``padded_fraction`` is the fraction of leading-axis rows that were
    bucket/alignment padding — wasted compute the caller can act on.

    The pipeline breakdown splits the dispatch wall clock: ``stage_s``
    host staging (pack/fill, zero argsort on the pipeline path),
    ``transfer_s`` H2D placement (on the card the copy stream's time between
    two events around the copies; on the CPU the host clock),
    ``compile_s`` the dispatch cache's build of the key's device buffers
    (nonzero only on a miss — steady state is 0), ``compute_s`` time spent
    enqueueing and blocked
    on device execution (under the engine's overlapped dispatcher this is
    only the *exposed* compute, the part H2D/staging of the next batch
    could not hide).  ``donated`` stays False: eager PyTorch has no
    buffer donation, and the reuse that the reference's donation buys comes
    here from the dispatch cache's preallocated buffers on every dispatch;
    ``aot_cache_hit`` whether the key's buffers were already built.
    Non-pipeline dispatches leave all six at their defaults.

    ``qos_classes`` is the number of QoS classes the dispatched graph
    decomposed congestion over (1 = the plain FIFO fabric).
    """

    devices_used: int = 1
    shard_rows: int = 0
    rows: int = 0
    padded_fraction: float = 0.0
    stage_s: float = 0.0
    transfer_s: float = 0.0
    compile_s: float = 0.0
    compute_s: float = 0.0
    donated: bool = False
    aot_cache_hit: bool = False
    qos_classes: int = 1


def _opt_add(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> Optional[np.ndarray]:
    if a is None:
        return None if b is None else np.array(b, copy=True)
    if b is None:
        return np.array(a, copy=True)
    return a + b


@dataclasses.dataclass(frozen=True)
class DelayBreakdown:
    """Per-epoch simulated delays (ns), plus per-component decomposition.

    ``per_pool_latency_ns`` stays indexed by *physical* pool (summed over
    hosts); the optional ``per_host_*`` arrays carry the host-segmented
    decomposition of each delay class for multi-host fabric analyses.  Each
    per-host array sums (within analyzer tolerance) to its fabric total.
    ``per_class_congestion_ns`` decomposes queueing delay by QoS class
    (length ``n_qos_classes``; ``[congestion_ns]`` on plain FIFO fabrics,
    ``None`` when the producing path predates the QoS axis).
    """

    latency_ns: float
    congestion_ns: float
    bandwidth_ns: float
    per_pool_latency_ns: np.ndarray  # [P]
    per_switch_congestion_ns: np.ndarray  # [S]
    per_switch_bandwidth_ns: np.ndarray  # [S]
    per_host_latency_ns: Optional[np.ndarray] = None  # [H]
    per_host_congestion_ns: Optional[np.ndarray] = None  # [H]
    per_host_bandwidth_ns: Optional[np.ndarray] = None  # [H]
    per_class_congestion_ns: Optional[np.ndarray] = None  # [C]

    @property
    def total_ns(self) -> float:
        return self.latency_ns + self.congestion_ns + self.bandwidth_ns

    @property
    def per_host_total_ns(self) -> Optional[np.ndarray]:
        """[H] total delay per host (None when host decomposition is absent)."""
        if self.per_host_latency_ns is None:
            return None
        return (
            self.per_host_latency_ns
            + self.per_host_congestion_ns
            + self.per_host_bandwidth_ns
        )

    def __add__(self, other: "DelayBreakdown") -> "DelayBreakdown":
        return DelayBreakdown(
            self.latency_ns + other.latency_ns,
            self.congestion_ns + other.congestion_ns,
            self.bandwidth_ns + other.bandwidth_ns,
            self.per_pool_latency_ns + other.per_pool_latency_ns,
            self.per_switch_congestion_ns + other.per_switch_congestion_ns,
            self.per_switch_bandwidth_ns + other.per_switch_bandwidth_ns,
            _opt_add(self.per_host_latency_ns, other.per_host_latency_ns),
            _opt_add(self.per_host_congestion_ns, other.per_host_congestion_ns),
            _opt_add(self.per_host_bandwidth_ns, other.per_host_bandwidth_ns),
            _opt_add(
                self.per_class_congestion_ns, other.per_class_congestion_ns
            ),
        )

    @staticmethod
    def zero(n_pools: int, n_switches: int, n_hosts: int = 1) -> "DelayBreakdown":
        return DelayBreakdown(
            0.0,
            0.0,
            0.0,
            np.zeros((n_pools,)),
            np.zeros((n_switches,)),
            np.zeros((n_switches,)),
            np.zeros((n_hosts,)),
            np.zeros((n_hosts,)),
            np.zeros((n_hosts,)),
        )


# --------------------------------------------------------------------------- #
# Closed-form serial queue
# --------------------------------------------------------------------------- #


def bucket_pow2(n: int, floor: int = 16) -> int:
    """Next power-of-two bucket >= n (>= floor) — the epoch analyzer's
    padding rule, the same as the reference's."""
    b = floor
    while b < n:
        b <<= 1
    return b


def serial_queue_ref(arrival_sorted: np.ndarray, stt: float) -> np.ndarray:
    """Start times of a FIFO queue with constant service time ``stt``.

    out_i = max(arrival_i, out_{i-1} + stt), solved as
    out_i = cummax(arrival_i - i*stt) + i*stt.
    """
    if len(arrival_sorted) == 0:
        return arrival_sorted
    idx = np.arange(len(arrival_sorted), dtype=np.float64)
    return np.maximum.accumulate(arrival_sorted - idx * stt) + idx * stt


def _check_reachable(flat: FlatTopology, events: MemEvents) -> None:
    """Reject events whose (host, pool) pair has no row on this fabric.

    Out-of-range host ids would be silently clamped by a batched gather
    (routing the event through the wrong virtual-pool row and dropping it
    from the host decomposition), and traffic to a pool the issuing host's
    ports exclude has no fabric route — analyzing it would charge latency
    with zero switch traversal.  Both are attach-time mistakes, so both
    raise.
    """
    if events.n == 0:
        return
    hmax = int(events.host.max())
    if hmax >= flat.n_hosts or int(events.host.min()) < 0:
        raise ValueError(
            f"trace carries host id {hmax} but the topology declares "
            f"{flat.n_hosts} host(s) — flatten a Topology(n_hosts=...) that "
            "covers every merged host"
        )
    reach = flat.host_reachable
    if reach is None or reach.all():
        return
    bad = ~reach[events.host, events.pool]
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"event targets pool {flat.pool_names[events.pool[i]]!r} which "
            f"host {int(events.host[i])}'s ports cannot reach "
            f"({int(bad.sum())} such events)"
        )


# --------------------------------------------------------------------------- #
# Reference (numpy, float64) epoch analyzer
# --------------------------------------------------------------------------- #


def analyze_ref(
    flat: FlatTopology,
    events: MemEvents,
    bw_window_ns: float = 10_000.0,
    lat_scale: Optional[np.ndarray] = None,
    n_windows: Optional[int] = None,
    presorted: bool = False,
) -> DelayBreakdown:
    """Vectorized numpy implementation of the three-delay model (oracle).

    Multi-host fabrics: each event is routed through its virtual pool
    ``vp = host * n_pools + pool`` (shared switch rows, private RC rows);
    every delay class additionally comes back host-segmented.  With
    ``n_hosts == 1`` this is numerically identical to the historical
    single-host oracle (``vp == pool`` and the host segment is the total).

    ``lat_scale`` (``[H*P]``, from
    the reference's ``DeviceCacheModel.latency_scale``, slice 3) multiplies
    each event's added latency — the device-cache epoch summary.  Hits
    still traverse the fabric, so congestion/bandwidth are deliberately
    unscaled; an all-ones vector is bitwise identical to passing None.

    ``n_windows`` pins the bandwidth-window count, with overflow clamped
    into the last window — the batched analyzers' static-window semantics
    (they cannot grow window counts with the post-congestion span).  Pass
    the analyzer's ``n_windows`` together with its effective per-epoch
    ``bw_window_ns`` to compare against the batched/scenario paths at
    float tolerance instead of window-discretization tolerance.  Default
    (None) keeps the historical behavior: enough windows to cover the
    shifted span.

    ``presorted=True`` promises ``events.t_ns`` is already non-decreasing
    (merged host traces, staged epochs),
    letting the first cascade stage skip its stable argsort — the
    permutation would be the identity.  Later stages re-sort only after a
    stage actually rewrote times.
    """
    P, S, H = flat.n_pools, flat.n_switches, flat.n_hosts
    if events.n == 0:
        return DelayBreakdown.zero(P, S, H)
    _check_reachable(flat, events)

    t = events.t_ns.astype(np.float64).copy()
    pool = events.pool.astype(np.int64)
    host = events.host.astype(np.int64)
    vp = host * P + pool
    nbytes = events.bytes_.astype(np.float64)

    # -- 1. latency delay ------------------------------------------------- #
    per_event_lat = flat.pool_latency_ns[vp] - flat.local_latency_ns
    per_event_lat = np.maximum(per_event_lat, 0.0)
    if lat_scale is not None:
        per_event_lat = per_event_lat * np.asarray(lat_scale, np.float64)[vp]
    per_event_lat = per_event_lat * events.weight
    per_pool_lat = np.bincount(pool, weights=per_event_lat, minlength=P)[:P]
    per_host_lat = np.bincount(host, weights=per_event_lat, minlength=H)[:H]
    latency_ns = float(per_event_lat.sum())

    # -- 2. congestion delay (cascaded serial queues, deepest switch first) - #
    # QoS fabrics (per-switch priority/WFQ disciplines) replace the single
    # FIFO scan with per-level / per-class scans over the same sorted
    # subsequence; plain FIFO fabrics take the historical path bitwise.
    C = int(flat.n_qos_classes)
    qos_on = flat.has_qos
    qcls = np.clip(events.qos.astype(np.int64), 0, C - 1)
    w_table = flat.class_weight_table().astype(np.float64)
    per_switch_cong = np.zeros((S,), np.float64)
    per_host_cong = np.zeros((H,), np.float64)
    per_class_cong = np.zeros((C,), np.float64)
    sorted_now = bool(presorted)
    for s in flat.stage_order():
        stt = float(flat.switch_stt_ns[s])
        mask = flat.route[vp, s] > 0
        if stt <= 0 or not mask.any():
            continue
        if sorted_now:
            sub = np.nonzero(mask)[0]
        else:
            order = np.argsort(t, kind="stable")
            m_sorted = mask[order]
            sub = order[m_sorted]
        disc = (
            flat.switch_discipline[s]
            if qos_on and flat.switch_discipline
            else "fifo"
        )
        if disc == "fifo":
            start = serial_queue_ref(t[sub], stt)
        elif disc == "priority":
            # event of class c takes its start from the FIFO scan over the
            # subsequence of classes <= c (strict priority, FIFO in class)
            q_sub = qcls[sub]
            start = np.empty((len(sub),), np.float64)
            for lvl in range(C):
                lv = q_sub <= lvl
                st_l = serial_queue_ref(t[sub[lv]], stt)
                start[q_sub == lvl] = st_l[q_sub[lv] == lvl]
        else:  # wfq: per-class virtual time with inflated service stt*W/w_c
            q_sub = qcls[sub]
            w_row = w_table[s]
            w_total = float(w_row.sum())
            start = np.empty((len(sub),), np.float64)
            for c in range(C):
                cm = q_sub == c
                start[cm] = serial_queue_ref(
                    t[sub[cm]], stt * w_total / float(w_row[c])
                )
        delay = start - t[sub]
        t[sub] = start
        sorted_now = False  # this stage rewrote times
        per_switch_cong[s] = delay.sum()
        per_host_cong += np.bincount(host[sub], weights=delay, minlength=H)[:H]
        per_class_cong += np.bincount(qcls[sub], weights=delay, minlength=C)[:C]
    congestion_ns = float(per_switch_cong.sum())

    # -- 3. bandwidth delay (windowed, after latency+congestion shifts) ---- #
    # Paper: observed bandwidth is measured after the earlier delays are
    # applied, so windows are computed on the shifted times plus the latency
    # component of each event's pool.
    t_obs = t + per_event_lat
    if n_windows is None:
        span = max(float(t_obs.max()) + 1.0, bw_window_ns)
        n_win = int(np.ceil(span / bw_window_ns))
    else:
        n_win = int(n_windows)
    win = np.minimum((t_obs / bw_window_ns).astype(np.int64), n_win - 1)
    per_switch_bw = np.zeros((S,), np.float64)
    per_host_bw = np.zeros((H,), np.float64)
    for s in range(S):
        bw = float(flat.switch_bandwidth_gbps[s])  # GB/s == bytes/ns
        if bw <= 0:
            continue
        mask = flat.route[vp, s] > 0
        if not mask.any():
            continue
        # per-(window, host) bytes through this switch; the window stretch is
        # attributed to hosts proportionally to their byte share in it
        key = win[mask] * H + host[mask]
        wb_h = np.bincount(key, weights=nbytes[mask], minlength=n_win * H)
        wb_h = wb_h.reshape(n_win, H)
        wbytes = wb_h.sum(axis=1)
        stretch = np.maximum(wbytes / bw - bw_window_ns, 0.0)
        per_switch_bw[s] = stretch.sum()
        share = np.divide(
            wb_h,
            wbytes[:, None],
            out=np.zeros_like(wb_h),
            where=wbytes[:, None] > 0,
        )
        per_host_bw += (stretch[:, None] * share).sum(axis=0)
    bandwidth_ns = float(per_switch_bw.sum())

    return DelayBreakdown(
        latency_ns,
        congestion_ns,
        bandwidth_ns,
        per_pool_lat,
        per_switch_cong,
        per_switch_bw,
        per_host_lat,
        per_host_cong,
        per_host_bw,
        per_class_cong,
    )


# --------------------------------------------------------------------------- #
# Cascade planning
# --------------------------------------------------------------------------- #


def plan_cascade(flat: FlatTopology):
    """Derive the fused cascade's static route bits and merge plan.

    The cascade keeps the event array sorted by current time.  A stage's
    scan only needs *its own masked events* to appear in non-decreasing
    order — and a subsequence of a sorted run is sorted.  Simulating the run
    partition of the array (runs split as stages rewrite their events) tells
    us, per stage, which previously-independent sorted runs its mask spans;
    only those need merging, piecewise, before the scan.  Chains (every pool
    behind the deepest switch) need zero merges; the paper's Figure 1 needs
    exactly one.  Falls back to the conservative merge-every-stage plan when
    the needed masks exceed the 31 bits of an int32 route word.

    Returns ``(bits_pool [V] int32, merge_plan | None, stage_order tuple)``
    where bit ``k`` of an event's route word marks membership in the pool
    set ``k`` (the first ``S`` bits are the stage masks, in stage order).
    Rows are **virtual pools** — one per (host, pool) pair — so a shared
    switch's stage mask spans every host that routes through it while each
    host's RC stage covers only that host's rows; with ``n_hosts == 1``
    virtual and physical pools coincide.
    """
    route = np.asarray(flat.route)
    P = route.shape[0]  # virtual (host, pool) rows
    stage_order = tuple(int(s) for s in flat.stage_order())
    masks = [
        frozenset(int(p) for p in np.nonzero(route[:, s] > 0)[0]) for s in stage_order
    ]
    # pool index P is a pseudo-pool for padded/invalid events: routed nowhere
    all_ids = frozenset(range(P + 1))

    sets: List[frozenset] = list(masks)  # bit k <-> sets[k]; first S are stages

    def bit_of(pool_set: frozenset) -> int:
        for k, existing in enumerate(sets):
            if existing == pool_set:
                return k
        sets.append(pool_set)
        return len(sets) - 1

    runs = [all_ids]
    plan: List[Tuple[Tuple[int, Optional[int]], ...]] = []
    for mask in masks:
        hits = [r & mask for r in runs if r & mask]
        ops: List[Tuple[int, Optional[int]]] = []
        if len(hits) > 1:
            # fold the runs the mask spans into one sorted subsequence; the
            # local pool and the padding pseudo-pool are never routed, so a
            # whole-array (within=None) merge can't arise here — it belongs
            # to the conservative fallback plan only
            acc = hits[0]
            for piece in hits[1:]:
                within = acc | piece
                ops.append((bit_of(piece), bit_of(within)))
                acc = within
            runs = [mask] + [r - mask for r in runs if r - mask]
        else:
            runs = [p for r in runs for p in (r & mask, r - mask) if p]
        plan.append(tuple(ops))

    if len(sets) > 31:  # int32 route word exhausted: conservative plan
        sets = list(masks)
        merge_plan = None
    else:
        merge_plan = tuple(plan)
    if len(sets) > 31:
        raise ValueError(
            f"{len(sets)} cascade stages exceed the 31-bit route word "
            f"(every switch plus one RC pseudo-switch per host is a stage; "
            f"this topology has {flat.n_hosts} hosts)"
        )
    bits_pool = np.zeros((P,), np.int32)
    for k, pool_set in enumerate(sets):
        for p in pool_set:
            if p < P:
                bits_pool[p] |= np.int32(1) << k
    return bits_pool, merge_plan, stage_order


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """Static routing data for the device-resident pipeline dispatch.

    ``enter_stage[v]`` is the cascade stage position at which events of
    virtual pool ``v`` first enter the fabric (-1 = local, never routed).
    Valid only for *chain* topologies: single host, and every stage mask a
    subset of the next in stage order (deepest-first) — then an event
    entering at position ``p`` traverses exactly stages ``p..S-1``, which
    is what lets :func:`repro_torch.kernels.ref.chain_cascade` process a
    compact growing suffix instead of the full padded plane.
    """

    enter_stage: np.ndarray  # [V] int32
    stage_order: Tuple[int, ...]


def plan_chain(flat: FlatTopology) -> Optional[ChainPlan]:
    """Chain-eligibility check; None when the compact cascade cannot apply.

    Eligible: ``n_hosts == 1`` and nested stage masks (``M_p ⊆ M_{p+1}``
    in stage order).  Every linear expander chain — the paper's Figure 1
    shape, two-tier trees with one leaf switch per level on the path, and
    the deep ``chained_topology`` — qualifies; sibling switches at the
    same depth (disjoint masks) do not, and those dispatches run the
    full-plane path through the same dispatch cache.
    """
    if flat.n_hosts != 1:
        return None
    route = np.asarray(flat.route)
    stage_order = tuple(int(s) for s in flat.stage_order())
    masks = [route[:, s] > 0 for s in stage_order]
    for p in range(len(masks) - 1):
        if np.any(masks[p] & ~masks[p + 1]):
            return None
    enter = np.full((route.shape[0],), -1, np.int32)
    for p in range(len(masks) - 1, -1, -1):
        enter[masks[p]] = p
    return ChainPlan(enter_stage=enter, stage_order=stage_order)


# --------------------------------------------------------------------------- #
# Batched epoch analysis in PyTorch (the production path)
# --------------------------------------------------------------------------- #


def _host_sums(values: torch.Tensor, host: torch.Tensor, n_hosts: int) -> torch.Tensor:
    """``[B, N]`` values summed per host into ``[B, H]`` f64.  A scatter-add
    takes its own order (atomics, on the card), and in f32 that order moves
    a sum over a million events by parts in 1e4; in f64 it does not."""
    out = torch.zeros(
        (values.shape[0], n_hosts), dtype=torch.float64, device=values.device
    )
    return out.scatter_add_(1, host, values.to(torch.float64))


def _accumulator(x: torch.Tensor) -> torch.dtype:
    """The dtype a sum over a row's events (or windows) accumulates in.  On
    the card f64: an f32 reduction there takes the order of its atomics, or
    the order its launch configuration picks for the batch's row count (how
    many CTAs share a row), so one row sums apart from run to run or when
    the rows are split differently (a mesh's shards), while f64 sums of f32
    values come out the same in any order.  On the CPU ``x``'s own dtype:
    the plain path keeps the reference's f32 arithmetic, which the tests
    hold it to."""
    return torch.float64 if x.device.type == "cuda" else x.dtype


def _latency(
    pool64: torch.Tensor,  # [B, N] i64 physical pool
    vp: torch.Tensor,  # [B, N] i64 virtual pool (host * P + pool)
    weight: torch.Tensor,  # [B, N] f32
    valid: torch.Tensor,  # [B, N] bool
    lat_scale: torch.Tensor,  # [B, V] f32
    pool_latency_ns: torch.Tensor,  # [V] f32, or [B, V]: one row of leaves a row
    local_latency_ns: torch.Tensor,  # [] f32, or [B]
    n_pools: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Latency delay: a gather plus a one-hot contraction.  Returns the
    per-event delays ``[B, N]`` (0 on invalid events), their sums per
    physical pool ``[B, P]`` and their totals ``[B]``.  The topology's
    leaves are shared by every row, or given per row (a sweep's or a
    fleet's rows, each priced against its own topology); rows that repeat
    one set of leaves price bitwise as the shared form.  Both sums over the
    events accumulate in :func:`_accumulator`'s dtype."""
    if pool_latency_ns.dim() == 1:
        pool_lat = pool_latency_ns[vp]
    else:
        pool_lat = torch.gather(pool_latency_ns, 1, vp)
    if local_latency_ns.dim() == 1:
        local_latency_ns = local_latency_ns[:, None]
    per_event_lat = (
        torch.clamp(pool_lat - local_latency_ns, min=0.0)
        * torch.gather(lat_scale, 1, vp)
        * weight
    )
    per_event_lat = torch.where(valid, per_event_lat, 0.0)
    acc = per_event_lat.to(_accumulator(per_event_lat))
    # keyed by the *physical* pool: multi-host batches report [P], not [H*P]
    pool_onehot = (  # [B, N, P]
        pool64[..., None] == torch.arange(n_pools, device=pool64.device)
    ).to(acc.dtype)
    per_pool_lat = torch.bmm(acc[:, None, :], pool_onehot)[:, 0]  # [B, P]
    return per_event_lat, per_pool_lat.to(weight.dtype), acc.sum(dim=1).to(weight.dtype)


def _bandwidth(
    t_end: torch.Tensor,  # [B, M] f32 post-congestion times
    lat_e: torch.Tensor,  # [B, M] f32 each event's latency delay
    vp_e: torch.Tensor,  # [B, M] i64 each event's virtual pool
    nbytes_e: torch.Tensor,  # [B, M] f32
    valid_e: torch.Tensor,  # [B, M] bool
    bw_window_ns: torch.Tensor,  # [B] f32
    route: torch.Tensor,  # [V, S] f32
    switch_bw: torch.Tensor,  # [S] f32 bytes/ns, or [B, S]: one row a row
    n_windows: int,
    n_hosts: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bandwidth delay: one scatter-add over (window, virtual pool) keys,
    then a tiny ``[W, V] @ [V, S]`` product distributes pools onto
    switches.  Returns per-switch ``[B, S]``, total ``[B]`` and per-host
    ``[B, H]`` stretch.  Per-row switch bandwidths that repeat one row
    stretch bitwise as the shared form."""
    n_rows = t_end.shape[0]
    V, S = route.shape
    P = V // n_hosts
    t_obs = torch.where(valid_e, t_end + lat_e, 0.0)
    win = torch.clamp(
        (t_obs / bw_window_ns[:, None]).to(torch.int32), max=n_windows - 1
    )
    win = torch.where(valid_e, win, n_windows - 1)
    key = win.to(torch.int64) * V + vp_e
    # each window's bytes per virtual pool, summed in _accumulator's dtype
    # (on the card an f32 scatter-add adds in atomic order, and a window's
    # bytes pass 2**24 on sweeps), then rounded to the batch's dtype once
    acc = _accumulator(nbytes_e)
    wp = torch.zeros((n_rows, n_windows * V), dtype=acc, device=t_end.device)
    wp.scatter_add_(1, key, torch.where(valid_e, nbytes_e, 0.0).to(acc))
    if n_hosts == 1:
        wbytes = torch.matmul(wp.view(n_rows, n_windows, V), route.to(acc))  # [B, W, S]
        wbytes_h = None
    else:
        wbytes_h = torch.einsum(  # [B, W, H, S]
            "bwhp,hps->bwhs",
            wp.view(n_rows, n_windows, n_hosts, P),
            route.view(n_hosts, P, S).to(acc),
        ).to(t_end.dtype)
        wbytes = wbytes_h.sum(dim=2)
    wbytes = wbytes.to(t_end.dtype)
    if switch_bw.dim() == 2:
        switch_bw = switch_bw[:, None, :]  # [B, 1, S] against [B, W, S]
    # bw <= 0 means an unconstrained component (analyze_ref skips it)
    bw_ok = switch_bw > 0
    bw_safe = torch.where(bw_ok, switch_bw, 1.0)
    stretch = torch.clamp(
        wbytes / bw_safe - bw_window_ns[:, None, None], min=0.0
    )
    stretch = torch.where(bw_ok, stretch, 0.0)
    per_switch_bw = stretch.sum(dim=1)  # [B, S]
    bandwidth = per_switch_bw.sum(dim=1)
    if wbytes_h is None:
        per_host_bw = bandwidth[:, None]
    else:
        # window stretch attributed to hosts by their byte share in the
        # window, summed over windows and switches in _accumulator's dtype
        share = stretch / torch.clamp(wbytes, min=1e-30)
        acc = _accumulator(share)
        per_host_bw = torch.einsum(
            "bws,bwhs->bh", share.to(acc), wbytes_h.to(acc)
        ).to(t_end.dtype)
    return per_switch_bw, bandwidth, per_host_bw


@functools.lru_cache(maxsize=None)
def _stage_index(stage_order: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The stages' switch indices on ``device``, made once per order and
    device: a ``torch.tensor(..., device=...)`` per dispatch is a host copy
    that waits for the work already queued on the stream (under the engine,
    work that shares the card with the attached program's step)."""
    return torch.tensor(stage_order, dtype=torch.int64, device=device)


def _has_merges(dev: torch.device, merge_plan) -> bool:
    """Whether a FIFO cascade's slot order may differ from its input order:
    always on the card (the kernels run the conservative merge schedule, as
    the TPU kernels did), on the CPU when the plan schedules a merge."""
    return dev.type != "cpu" or merge_plan is None or any(len(ops) for ops in merge_plan)


def _analyze_batch(
    t: torch.Tensor,  # [B, N] f32 epoch-relative ns, each row TIME-SORTED
    pool: torch.Tensor,  # [B, N] i32 physical pool (padded entries: 0)
    nbytes: torch.Tensor,  # [B, N] f32 (padded entries: 0)
    weight: torch.Tensor,  # [B, N] f32 statistical multiplicity
    host: Optional[torch.Tensor],  # [B, N] i32 host index (padded: 0); None if n_hosts == 1
    valid: torch.Tensor,  # [B, N] bool
    bw_window_ns: torch.Tensor,  # [B] f32 per-epoch window length
    lat_scale: torch.Tensor,  # [B, V] f32 latency scale (ones: no cache)
    bits_table: torch.Tensor,  # [V] i32 per-virtual-pool route word (plan_cascade)
    pool_latency_ns: torch.Tensor,  # [V] f32 (V = n_hosts * n_pools), or [B, V]
    local_latency_ns: torch.Tensor,  # [] f32, or [B]
    route: torch.Tensor,  # [V, S] f32
    switch_stt_ns: torch.Tensor,  # [S] f32
    switch_bw: torch.Tensor,  # [S] f32 bytes/ns, or [B, S]
    stage_order: Tuple[int, ...],
    n_windows: int,
    n_hosts: int = 1,
    merge_plan=None,
    stage_stt_ns: Optional[Tuple[float, ...]] = None,  # unfused loop: per-switch STT
    qos: Optional[torch.Tensor] = None,  # [B, N] i32 QoS classes; None: FIFO cascade
    disc_code: Optional[torch.Tensor] = None,  # [S_stages] i32 codes, stage order
    class_weights: Optional[torch.Tensor] = None,  # [S_stages, C] f32, stage order
) -> torch.Tensor:
    """B epochs' three-delay analysis, one row of totals per epoch.

    Port of the reference's ``_analyze_jax`` with the ``vmap`` of
    ``_analyze_batch_jax`` written out as the leading dimension (the rows of
    a coalesced dispatch are K sessions' B epochs, ``[K·B, N]``).
    Multi-host fabrics (``n_hosts > 1``) key every lookup by the virtual
    pool ``vp = host * P + pool`` (shared switches see the merged timeline,
    per-host RCs stay private) and host-segment every delay class.  The
    congestion stage is the fused cascade, or with ``stage_stt_ns`` given
    the unfused per-stage loop (a stable sort of each row, then one switch's
    queue scan, per stage) that fabrics wider than the 31-bit route word
    take.  The latency and bandwidth leaves may be given per row (the
    fleet's racks, each on its own numeric topology); the service times
    and arbitration are one set for all rows, as the cascade kernels take
    them.  With ``qos`` (and the stages' ``disc_code`` / ``class_weights``)
    the congestion stage is the QoS cascade instead, whose ``[B, S, H, C]``
    delays also give the congestion per QoS class.  Returns one flat f32
    tensor ``[latency, congestion, bandwidth, per_pool_latency (P),
    per_switch_congestion (S), per_switch_bandwidth (S), per_host_latency
    (H), per_host_congestion (H), per_host_bandwidth (H),
    per_class_congestion (C, or 1 without ``qos``)]`` per row, ``[B, M]``;
    its callers sum the rows on the device, so the host needs one transfer
    per batch.
    """
    n_rows = t.shape[0]
    V = pool_latency_ns.shape[-1]
    P = V // n_hosts  # physical pools
    S = switch_stt_ns.shape[0]
    dtype = t.dtype
    dev = t.device
    pool64 = pool.to(torch.int64)
    host64 = None if n_hosts == 1 else host.to(torch.int64)
    vp = pool64 if n_hosts == 1 else host64 * P + pool64

    big = torch.finfo(dtype).max / 4
    t_cur = torch.where(valid, t, big)
    per_switch_cong = torch.zeros((n_rows, S), dtype=dtype, device=dev)
    per_class_cong = None
    if stage_stt_ns is None:  # the fused cascades: one route word per event
        ev_bits = torch.where(valid, bits_table[vp], 0)
        stage_idx = _stage_index(tuple(stage_order), dev)
        stage_stt = switch_stt_ns[stage_idx].contiguous()
    if qos is not None:
        # -- congestion: the QoS cascade (a kernel on the card) ------------- #
        t_end, slot_idx, psd = kops.qos_congestion_cascade(
            t_cur, ev_bits, stage_stt,
            torch.where(valid, qos, 0), disc_code, class_weights,
            hosts=None if n_hosts == 1 else host.contiguous(),
            n_hosts=n_hosts,
        )
        # psd is [B, S_stages, H, C]: host- and class-segmented queueing delay
        per_switch_cong[:, stage_idx] = psd.sum(dim=(2, 3))
        per_class_cong = psd.sum(dim=(1, 2))
        per_host_cong = None if n_hosts == 1 else psd.sum(dim=(1, 3))
        # the QoS cascade's fold is data-driven, so slot order never
        # matches input order
    elif stage_stt_ns is None:
        # -- congestion: the fused cascade (a kernel on the card) ----------- #
        t_end, slot_idx, psd = kops.congestion_cascade(
            t_cur, ev_bits, stage_stt,
            merge_plan=merge_plan,
            hosts=None if n_hosts == 1 else host.contiguous(),
            n_hosts=n_hosts,
        )
        if n_hosts == 1:
            per_switch_cong[:, stage_idx] = psd
            per_host_cong = None
        else:
            # psd is [B, S_stages, H]: host-segmented per-stage queueing delay
            per_switch_cong[:, stage_idx] = psd.sum(dim=2)
            per_host_cong = psd.sum(dim=1)
        # the kernels always run the conservative merge schedule, so their
        # slot order never matches input order; the plain path skips the
        # gathers when its plan schedules no merge at all
        if not _has_merges(dev, merge_plan):
            slot_idx = None
    else:
        # -- congestion: the unfused per-stage loop (a kernel per stage) ---- #
        routed = route > 0  # [V, S]
        per_host_cong = None if n_hosts == 1 else 0.0
        for s in stage_order:
            mask = routed[:, s][vp] & valid
            t_sorted, order = torch.sort(t_cur, dim=1, stable=True)
            m_sorted = torch.gather(mask, 1, order)
            start, delay = kops.congestion_queue(
                t_sorted, m_sorted.contiguous(), stage_stt_ns[s]
            )
            t_cur = t_cur.scatter(1, order, start)
            per_switch_cong[:, s] = delay.sum(dim=1)
            if per_host_cong is not None:
                per_host_cong = per_host_cong + _host_sums(
                    delay, torch.gather(host64, 1, order), n_hosts
                )
        if per_host_cong is not None:
            per_host_cong = per_host_cong.to(dtype)
        t_end, slot_idx = t_cur, None  # t_cur stays in input order
    return _price(
        t_end, slot_idx, pool64, vp, host64, nbytes, weight,
        valid, bw_window_ns, lat_scale, pool_latency_ns, local_latency_ns, route,
        switch_bw, per_switch_cong, per_host_cong, per_class_cong, n_windows, n_hosts,
    )


def _price(
    t_end: torch.Tensor,  # [B, N] post-congestion times, slot order
    slot_idx: Optional[torch.Tensor],  # [B, N] input event of each slot; None: input order
    pool64: torch.Tensor,  # [B, N] i64 physical pool, input order
    vp: torch.Tensor,  # [B, N] i64 virtual pool, input order
    host64: Optional[torch.Tensor],  # [B, N] i64 host (None if n_hosts == 1)
    nbytes: torch.Tensor,  # [B, N] f32, input order
    weight: torch.Tensor,  # [B, N] f32, input order
    valid: torch.Tensor,  # [B, N] bool, input order
    bw_window_ns: torch.Tensor,  # [B] f32
    lat_scale: torch.Tensor,  # [B, V] f32
    pool_latency_ns: torch.Tensor,  # [V] or [B, V] f32
    local_latency_ns: torch.Tensor,  # [] or [B] f32
    route: torch.Tensor,  # [V, S] f32
    switch_bw: torch.Tensor,  # [S] or [B, S] f32 bytes/ns
    per_switch_cong: torch.Tensor,  # [B, S]
    per_host_cong: Optional[torch.Tensor],  # [B, H]; None: the row's congestion
    per_class_cong: Optional[torch.Tensor],  # [B, C]; None: the row's congestion
    n_windows: int,
    n_hosts: int,
) -> torch.Tensor:
    """Price a congestion cascade's outcome: latency in input order,
    bandwidth on the post-congestion times in slot order, and every delay
    class in :func:`_analyze_batch`'s ``[B, M]`` row layout.  The sweep
    prices one cascade's outcome under every scenario that shares it."""
    dtype = t_end.dtype
    P = pool_latency_ns.shape[-1] // n_hosts
    per_event_lat, per_pool_lat, latency = _latency(
        pool64, vp, weight, valid, lat_scale, pool_latency_ns, local_latency_ns, P
    )
    if n_hosts == 1:
        per_host_lat = latency[:, None]
    else:
        per_host_lat = _host_sums(per_event_lat, host64, n_hosts).to(dtype)
    congestion = per_switch_cong.sum(dim=1)
    if per_host_cong is None:
        per_host_cong = congestion[:, None]
    if per_class_cong is None:
        per_class_cong = congestion[:, None]

    if slot_idx is not None:
        # bandwidth runs in final slot order: gather the payloads through
        # the cascade's permutation (slot k held input event slot_idx[k])
        sl = slot_idx.to(torch.int64)
        lat_e = torch.gather(per_event_lat, 1, sl)
        vp_e = torch.gather(vp, 1, sl)
        nbytes_e = torch.gather(nbytes, 1, sl)
        valid_e = torch.gather(valid, 1, sl)
    else:
        lat_e, vp_e, nbytes_e, valid_e = per_event_lat, vp, nbytes, valid

    per_switch_bw, bandwidth, per_host_bw = _bandwidth(
        t_end, lat_e, vp_e, nbytes_e, valid_e, bw_window_ns, route, switch_bw,
        n_windows, n_hosts,
    )

    return torch.cat(
        [
            latency[:, None], congestion[:, None], bandwidth[:, None],
            per_pool_lat, per_switch_cong, per_switch_bw,
            per_host_lat, per_host_cong, per_host_bw, per_class_cong,
        ],
        dim=1,
    )


# phase 2 of a sweep prices this many events at once (16 scenarios of a
# [32, 131072] batch): a chunk's working set stays within a few GB on the card
SWEEP_CHUNK_EVENTS = 1 << 26


def _launch_groups(
    stt: torch.Tensor,  # [U, S] service times of each row
    disc: Optional[torch.Tensor],  # [U, S] discipline codes (QoS only)
    weights: Optional[torch.Tensor],  # [U, S, C] class weights (QoS only)
) -> List[torch.Tensor]:
    """Rows that share their service times (and, under QoS, their
    disciplines and class weights) in first-seen order: each group is one
    cascade launch, since a cascade kernel takes one set a launch.  Returns
    each group's row indices on the rows' device."""
    keys = [stt]
    if disc is not None:
        keys += [disc.to(stt.dtype), weights.flatten(1).to(stt.dtype)]
    table = torch.cat(keys, dim=1).cpu().numpy()
    groups: Dict[bytes, List[int]] = {}
    for u, row in enumerate(table):
        groups.setdefault(row.tobytes(), []).append(u)
    return [
        torch.tensor(rows, dtype=torch.int64).to(stt.device) for rows in groups.values()
    ]


@dataclasses.dataclass
class SweepCascades:
    """Phase 1 of a sweep: the U unique cascades' outcomes.  ``slot``,
    ``host_cong`` and ``class_cong`` are None where the sweep has no slot
    order, one host or no QoS classes."""

    t_fin: torch.Tensor  # [U, B, N] f32 post-congestion times, slot order
    slot: Optional[torch.Tensor]  # [U, B, N] i32 input event of each slot
    cong: torch.Tensor  # [U, B, S] f32 per-switch congestion
    host_cong: Optional[torch.Tensor]  # [U, B, H] f32
    class_cong: Optional[torch.Tensor]  # [U, B, C] f32

    def to(self, device: torch.device) -> "SweepCascades":
        return SweepCascades(*(None if x is None else x.to(device)
                               for x in dataclasses.astuple(self)))


def _sweep_cascades(
    t: torch.Tensor,  # [G, B, N] f32 time-sorted epochs per granularity group
    host: torch.Tensor,  # [G, B, N] i32
    valid: torch.Tensor,  # [G, B, N] bool
    region: torch.Tensor,  # [G, B, N] i64 region ids (the skeleton's payload)
    cas_group: torch.Tensor,  # [U] i64 cascade -> skeleton group
    cas_assign: torch.Tensor,  # [U, R] i64 placement rows of the unique cascades
    cas_stt: torch.Tensor,  # [U, S] f32 STT rows of the unique cascades
    cas_disc: torch.Tensor,  # [U, S] i32 discipline rows of the unique cascades
    cas_weights: torch.Tensor,  # [U, S, C] f32 class-weight rows of the unique cascades
    qos_of_region: torch.Tensor,  # [R] i32 QoS class of each region
    bits_table: torch.Tensor,  # [V] i32 shared (structure)
    stage_order: Tuple[int, ...],
    n_hosts: int,
    merge_plan=None,
    qos_on: bool = False,
) -> SweepCascades:
    """Phase 1 of a sweep of K scenarios × B epochs (with
    :func:`_sweep_reduce`, the port of the reference's
    ``_analyze_sweep_jax``): the U unique cascades.

    Congestion, and the post-queue times the bandwidth windows see, depend
    only on a scenario's granularity group, placement row and STT row (and
    under QoS its discipline and weight rows); the caller dedups scenarios
    onto U cascades.  Each cascade's route words are built on the device
    from its placement row (``bits_table[vp]``, ``pool =
    cas_assign[u][region]``), its QoS classes from ``qos_of_region``.  The
    cascades that share their service times (and arbitration) stack as the
    ``[U_g·B, N]`` rows of one cascade call (:func:`_launch_groups`): a
    sweep over policies, granularities, latencies, bandwidths and caches on
    one STT row is one launch."""
    G, B, N = t.shape
    U = int(cas_group.shape[0])
    S = cas_stt.shape[1]
    P = bits_table.shape[0] // n_hosts
    dev, dtype = t.device, t.dtype
    stage_idx = _stage_index(tuple(stage_order), dev)
    big = torch.finfo(dtype).max / 4
    R = cas_assign.shape[1]
    C = cas_weights.shape[2] if qos_on else 1
    launches = _launch_groups(cas_stt, cas_disc if qos_on else None,
                              cas_weights if qos_on else None)
    multi = n_hosts > 1
    slot_order = qos_on or _has_merges(dev, merge_plan)
    out = SweepCascades(
        t_fin=torch.empty((U, B, N), dtype=dtype, device=dev),
        slot=torch.empty((U, B, N), dtype=torch.int32, device=dev) if slot_order else None,
        cong=torch.zeros((U, B, S), dtype=dtype, device=dev),
        host_cong=torch.empty((U, B, n_hosts), dtype=dtype, device=dev) if multi else None,
        class_cong=torch.empty((U, B, C), dtype=dtype, device=dev) if qos_on else None,
    )
    for us in launches:
        n_u = int(us.shape[0])
        g = cas_group[us]
        valid_g = valid[g]  # [U_g, B, N]
        region_g = region[g]
        host_g = host[g] if multi else None
        pool_g = torch.gather(
            cas_assign[us][:, None, :].expand(n_u, B, R), 2, region_g
        )
        vp_g = host_g.to(torch.int64) * P + pool_g if multi else pool_g
        rows = (n_u * B, N)
        t_cur = torch.where(valid_g, t[g], big).view(rows)
        bits = torch.where(valid_g, bits_table[vp_g], 0).view(rows)
        hosts = host_g.view(rows) if multi else None
        stt = cas_stt[us[0]][stage_idx].contiguous()
        if qos_on:
            q = torch.where(valid_g, qos_of_region[region_g], 0).view(rows)
            t_end, slot_idx, psd = kops.qos_congestion_cascade(
                t_cur, bits, stt, q,
                cas_disc[us[0]][stage_idx].contiguous(),
                cas_weights[us[0]][stage_idx].contiguous(),
                hosts=hosts, n_hosts=n_hosts,
            )
            psd = psd.view(n_u, B, *psd.shape[1:])  # [U_g, B, S_st, H, C]
            out.cong[us.view(-1, 1), :, stage_idx] = psd.sum(dim=(3, 4)).permute(0, 2, 1)
            out.class_cong[us] = psd.sum(dim=(2, 3))
            if multi:
                out.host_cong[us] = psd.sum(dim=(2, 4))
        else:
            t_end, slot_idx, psd = kops.congestion_cascade(
                t_cur, bits, stt, merge_plan=merge_plan, hosts=hosts, n_hosts=n_hosts,
            )
            psd = psd.view(n_u, B, *psd.shape[1:])  # [U_g, B, S_st(, H)]
            if multi:
                out.cong[us.view(-1, 1), :, stage_idx] = psd.sum(dim=3).permute(0, 2, 1)
                out.host_cong[us] = psd.sum(dim=2)
            else:
                out.cong[us.view(-1, 1), :, stage_idx] = psd.permute(0, 2, 1)
        out.t_fin[us] = t_end.view(n_u, B, N)
        if out.slot is not None:
            out.slot[us] = slot_idx.view(n_u, B, N)
    return out


def _sweep_reduce(
    cascades: SweepCascades,
    nbytes: torch.Tensor,  # [G, B, N] f32
    weight: torch.Tensor,  # [G, B, N] f32
    host: torch.Tensor,  # [G, B, N] i32
    valid: torch.Tensor,  # [G, B, N] bool
    region: torch.Tensor,  # [G, B, N] i64
    bw_window: torch.Tensor,  # [G, B] f32 per-epoch window lengths
    group_of: torch.Tensor,  # [K] i64 scenario -> skeleton group
    cascade_of: torch.Tensor,  # [K] i64 scenario -> unique cascade
    assign: torch.Tensor,  # [K, R] i64 placement matrix
    lat_scale: torch.Tensor,  # [K, B, V] f32 per-scenario device-cache scales
    pool_latency_ns: torch.Tensor,  # [K, V] f32 stacked topology leaves
    local_latency_ns: torch.Tensor,  # [K] f32
    switch_bw: torch.Tensor,  # [K, S] f32
    route: torch.Tensor,  # [V, S] f32 shared (structure)
    n_windows: int,
    n_hosts: int,
) -> torch.Tensor:
    """Phase 2 of a sweep: the K scenario reductions, per-scenario totals
    reduced on the device, ``[K, M]`` rows in :func:`_analyze_batch`'s
    layout.  In chunks of about :data:`SWEEP_CHUNK_EVENTS` events, each
    scenario takes its cascade's final times and slot permutation, derives
    its events' pools from its own placement row, and is priced
    (:func:`_price`) against its own row of topology leaves and cache
    scales.  Each scenario's row depends on its own inputs only, so any
    split of the K axis (the chunks, a mesh's shards) changes no number."""
    G, B, N = valid.shape
    K = int(cascade_of.shape[0])
    V = pool_latency_ns.shape[1]
    P = V // n_hosts
    S = switch_bw.shape[1]
    R = assign.shape[1]
    C = 1 if cascades.class_cong is None else cascades.class_cong.shape[2]
    multi = n_hosts > 1
    M = 3 + P + 2 * S + 3 * n_hosts + C
    out = torch.empty((K, M), dtype=cascades.t_fin.dtype, device=valid.device)
    chunk = max(1, SWEEP_CHUNK_EVENTS // max(B * N, 1))

    def per_row(x: torch.Tensor) -> torch.Tensor:  # [n_k, ...] -> [n_k·B, ...]
        return x.repeat_interleave(B, dim=0)

    for k0 in range(0, K, chunk):
        ks = slice(k0, min(K, k0 + chunk))
        n_k = ks.stop - ks.start
        u, g = cascade_of[ks], group_of[ks]
        rows = (n_k * B, N)
        valid_k = valid[g]
        pool64 = torch.where(
            valid_k,
            torch.gather(assign[ks][:, None, :].expand(n_k, B, R), 2, region[g]),
            0,
        ).view(rows)
        host64 = host[g].view(rows).to(torch.int64) if multi else None
        vp = host64 * P + pool64 if multi else pool64
        priced = _price(
            cascades.t_fin[u].view(rows),
            None if cascades.slot is None else cascades.slot[u].view(rows),
            pool64, vp, host64,
            nbytes[g].view(rows), weight[g].view(rows), valid_k.view(rows),
            bw_window[g].view(-1),
            lat_scale[ks].reshape(n_k * B, V),
            per_row(pool_latency_ns[ks]), per_row(local_latency_ns[ks]),
            route, per_row(switch_bw[ks]),
            cascades.cong[u].view(n_k * B, S),
            cascades.host_cong[u].view(n_k * B, n_hosts) if multi else None,
            None if cascades.class_cong is None else cascades.class_cong[u].view(n_k * B, C),
            n_windows, n_hosts,
        )
        out[ks] = priced.view(n_k, B, M).sum(dim=1)
    return out


def _analyze_fleet(
    t: torch.Tensor,  # [K, B, N] f32 K racks' stacked epoch batches
    pool: torch.Tensor,  # [K, B, N] i32
    nbytes: torch.Tensor,  # [K, B, N] f32
    weight: torch.Tensor,  # [K, B, N] f32
    host: Optional[torch.Tensor],  # [K, B, N] i32 (None if n_hosts == 1)
    qos: Optional[torch.Tensor],  # [K, B, N] i32 (None unless qos_on)
    valid: torch.Tensor,  # [K, B, N] bool
    bw_window_ns: torch.Tensor,  # [K, B] f32
    lat_scale: torch.Tensor,  # [K, B, V] f32
    bits_table: torch.Tensor,  # [V] i32 shared (one rack structure)
    pool_latency_ns: torch.Tensor,  # [K, V] f32 per-rack numeric leaves
    local_latency_ns: torch.Tensor,  # [K] f32
    route: torch.Tensor,  # [V, S] f32 shared (structure)
    switch_stt_ns: torch.Tensor,  # [K, S] f32
    switch_bw: torch.Tensor,  # [K, S] f32
    disc_code: torch.Tensor,  # [K, S] i32 per-rack QoS policies
    class_weights: torch.Tensor,  # [K, S, C] f32
    stage_order: Tuple[int, ...],
    n_windows: int,
    n_hosts: int,
    merge_plan=None,
    qos_on: bool = False,
) -> torch.Tensor:
    """K racks × B epochs with per-rack numeric topologies, per-rack
    totals reduced on the device (port of the reference's
    ``_analyze_fleet_jax``).  Returns ``[K, M]`` rows in
    :func:`_analyze_batch`'s layout, summed over epochs.

    The racks that share their service times (and, with ``qos_on``, their
    disciplines and class weights) run as the ``[K_g·B, N]`` rows of one
    :func:`_analyze_batch`, so one cascade launch; their latency and
    bandwidth leaves go in per row.  A homogeneous fleet is one launch."""
    K, B, N = t.shape
    stage_idx = _stage_index(tuple(stage_order), t.device)
    out = None
    groups = _launch_groups(switch_stt_ns, disc_code if qos_on else None,
                            class_weights if qos_on else None)
    whole = len(groups) == 1  # every rack, in order: no gather
    for racks in groups:
        n_k = int(racks.shape[0])

        def rows(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
            if x is None:
                return None
            x = x if whole else x.index_select(0, racks)
            return x.reshape((n_k * B,) + tuple(x.shape[2:]))

        def per_row(x: torch.Tensor) -> torch.Tensor:  # [K_g, ...] -> [K_g·B, ...]
            return x.index_select(0, racks).repeat_interleave(B, dim=0)

        r0 = racks[0]
        res = _analyze_batch(
            rows(t), rows(pool), rows(nbytes), rows(weight), rows(host), rows(valid),
            rows(bw_window_ns), rows(lat_scale), bits_table,
            per_row(pool_latency_ns), per_row(local_latency_ns), route,
            switch_stt_ns[r0], per_row(switch_bw),
            stage_order=stage_order, n_windows=n_windows, n_hosts=n_hosts,
            merge_plan=merge_plan, qos=rows(qos),
            disc_code=disc_code[r0][stage_idx].contiguous() if qos_on else None,
            class_weights=class_weights[r0][stage_idx].contiguous() if qos_on else None,
        )
        per_rack = res.view(n_k, B, -1).sum(dim=1)
        if out is None:
            out = torch.empty((K, per_rack.shape[1]), dtype=t.dtype, device=t.device)
        out[racks] = per_rack
    return out


def _analyze_pipeline(
    t_pack: torch.Tensor,  # [B, W] f32 per-stage packed sorted runs (+inf pads)
    idx_pack: torch.Tensor,  # [B, W] i32 positions into the staged row (-1 pads)
    pool: torch.Tensor,  # [B, N] i32 full plane (staged row order)
    nbytes: torch.Tensor,  # [B, N] f32
    weight: torch.Tensor,  # [B, N] f32
    valid: torch.Tensor,  # [B, N] bool
    bw_window_ns: torch.Tensor,  # [B] f32
    lat_scale: torch.Tensor,  # [B, V] f32
    pool_latency_ns: torch.Tensor,  # [V] f32
    local_latency_ns: torch.Tensor,  # [] f32
    route: torch.Tensor,  # [V, S] f32
    switch_bw: torch.Tensor,  # [S] f32
    stage_idx: torch.Tensor,  # [D] i64 switch of each stage, stage order
    stage_stt: Tuple[float, ...],  # [D] service times, stage order, on the host
    seg_caps: Tuple[int, ...],  # packed segment widths
    n_windows: int,
) -> torch.Tensor:
    """Device-resident single-host chain dispatch (port of the reference's
    ``_analyze_pipeline_jax``).

    The merge of the per-stage sorted runs into one fabric timeline and
    every serial-queue scan run on the device
    (:func:`repro_torch.kernels.ops.chain_cascade` over a compact suffix
    that only ever holds routed events), so staging performed zero host
    argsorts.  Bandwidth windows come straight off the compact array:
    local-DRAM route rows are all zero, so unrouted events could only ever
    contribute zero bytes to every switch — skipping them is exact.
    Latency stays the full-plane gather.  Returns the summed totals in
    :func:`_analyze_batch`'s layout (this path is FIFO and single-host, so
    the per-host and per-class leaves are the totals).
    """
    n_rows = t_pack.shape[0]
    V, S = route.shape
    pool64 = pool.to(torch.int64)
    per_event_lat, per_pool_lat, latency = _latency(
        pool64, pool64, weight, valid, lat_scale, pool_latency_ns, local_latency_ns, V
    )

    # congestion: compact suffix cascade (merges, then each stage's scan)
    t_fin, idx_fin, dsums = kops.chain_cascade(t_pack, idx_pack, stage_stt, seg_caps)
    per_switch_cong = torch.zeros((n_rows, S), dtype=t_pack.dtype, device=t_pack.device)
    per_switch_cong[:, stage_idx] = dsums
    congestion = per_switch_cong.sum(dim=1)

    # bandwidth from the compact array: payloads gathered through the
    # staged-row positions the cascade carried along
    real = idx_fin >= 0
    safe = idx_fin.clamp(min=0).to(torch.int64)
    per_switch_bw, bandwidth, _ = _bandwidth(
        t_fin,
        torch.gather(per_event_lat, 1, safe),
        torch.gather(pool64, 1, safe),
        torch.gather(nbytes, 1, safe),
        real, bw_window_ns, route, switch_bw, n_windows, 1,
    )

    rows = torch.cat(
        [
            latency[:, None], congestion[:, None], bandwidth[:, None],
            per_pool_lat, per_switch_cong, per_switch_bw,
            latency[:, None], congestion[:, None], bandwidth[:, None],
            congestion[:, None],
        ],
        dim=1,
    )
    return rows.sum(dim=0)


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class _DeviceRing:
    """One ``(batch, length)`` bucket's device side of the staging ring: a
    preallocated device buffer for every full plane (``planes``), one flat
    device buffer each for the chain path's packed ``(t, idx)`` as wide as
    the widest segment capacities reserved yet (:meth:`reserve`), and host
    buffers (pinned for a card) for the window and scale rows, which each
    dispatch makes anew.  Every dispatch key of the bucket runs from this
    one ring, so new capacities never allocate full planes again.

    :meth:`upload` copies a dispatch's host planes in: on the card
    asynchronously on ``copy_stream``, after the last compute-stream use of
    these buffers (``read``: the last dispatch that read them, or their
    allocation) and ending in an event (``copied``) that the compute stream
    waits on; on the CPU as plain copies.
    """

    ROWS = ("window", "scale")  # the per-dispatch rows, staged here
    PACKED = {"t": torch.float32, "idx": torch.int32}

    def __init__(self, specs: Dict[str, tuple], device: torch.device):
        self.device = device
        self.planes = {
            name: torch.empty(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in specs.items()
        }
        pin = device.type == "cuda"
        self.rows = {
            name: torch.empty(specs[name][0], dtype=specs[name][1], pin_memory=pin)
            for name in self.ROWS
        }
        self.flat: Dict[str, torch.Tensor] = {}
        self.copied = None
        self.release()

    def reserve(self, b_bucket: int, width: int) -> None:
        """Make room for packed planes of ``[b_bucket, width]``: the flat
        buffers grow (the narrower ones are freed) only past the widest
        reservation yet."""
        if self.flat and self.flat["t"].numel() >= b_bucket * width:
            return
        if self.device.type == "cuda":
            # the buffers may have been allocated on another thread's stream
            # (a warm-up at attach) and last read on this one (the engine's):
            # the allocator must not hand them out before this stream is done
            for buf in self.flat.values():
                buf.record_stream(torch.cuda.current_stream(self.device))
        self.flat = {
            name: torch.empty(b_bucket * width, dtype=dtype, device=self.device)
            for name, dtype in self.PACKED.items()
        }
        self.release()

    def packed(self, b_bucket: int, width: int) -> Dict[str, torch.Tensor]:
        """The packed ``(t, idx)`` planes of one dispatch: contiguous
        ``[b_bucket, width]`` views at the head of the flat buffers."""
        n = b_bucket * width
        return {name: buf[:n].view(b_bucket, width) for name, buf in self.flat.items()}

    def upload(
        self, dst: Dict[str, torch.Tensor], host: Dict[str, np.ndarray], copy_stream
    ):
        """Copy one dispatch's host planes into ``dst``, this ring's device
        buffers (the window and scale rows through its own host buffers).
        Returns the copy's seconds on the CPU, or on the card its ``(start,
        end)`` timing events on ``copy_stream``."""
        if self.copied is not None:  # the host rows' last copy is done
            self.copied.synchronize()
        for name in self.ROWS:
            self.rows[name].numpy()[:] = host[name]
        src = {
            name: self.rows[name] if name in self.rows else torch.from_numpy(host[name])
            for name in dst
        }
        if copy_stream is None:
            t0 = time.perf_counter()
            for name, a in src.items():
                dst[name].copy_(a)
            return time.perf_counter() - t0
        copy_stream.wait_event(self.read)
        start = torch.cuda.Event(enable_timing=True)
        self.copied = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(copy_stream):
            start.record(copy_stream)
            for name, a in src.items():
                dst[name].copy_(a, non_blocking=True)
            self.copied.record(copy_stream)
        torch.cuda.current_stream(self.device).wait_event(self.copied)
        return start, self.copied

    def release(self) -> None:
        """Mark the device buffers as used by the compute stream up to now
        (the dispatch just enqueued, or an allocation, whose memory may
        have served work still queued there); the next copy waits for it."""
        if self.device.type == "cuda":
            self.read = torch.cuda.Event()
            self.read.record(torch.cuda.current_stream(self.device))
        else:
            self.read = None


@dataclasses.dataclass
class PendingBatch:
    """An in-flight epoch dispatch: staged, transferred and launched, but
    not yet resolved.  :meth:`finish` makes the batch's single D2H copy and
    returns the :class:`DelayBreakdown`; until then the caller is free to
    stage and launch the *next* batch.  ``stats.compute_s`` is finalized at
    finish time with the exposed device wait, and on the card
    ``stats.transfer_s`` with the copy stream's time between ``copies``."""

    analyzer: "EpochAnalyzer"
    out: Optional[torch.Tensor]
    stats: DispatchStats
    copies: Optional[tuple] = None  # (start, end) CUDA events around the H2D copies

    def finish(self) -> DelayBreakdown:
        a = self.analyzer
        P, S, H = a.flat.n_pools, a.flat.n_switches, a.flat.n_hosts
        if self.out is None:
            a.last_dispatch = self.stats
            return DelayBreakdown.zero(P, S, H)
        t0 = time.perf_counter()
        # the single host-boundary crossing for the whole batch
        tot = self.out.cpu().numpy().astype(np.float64)
        stats = self.stats
        if a.pipeline:
            stats = dataclasses.replace(
                stats, compute_s=stats.compute_s + (time.perf_counter() - t0)
            )
        if self.copies is not None:
            start, end = self.copies
            stats = dataclasses.replace(
                stats, transfer_s=ns_to_s(ms_to_ns(start.elapsed_time(end)))
            )
        a.last_dispatch = self.stats = stats
        self.out = None
        return _unpack(tot, P, S, H)


def _unpack(tot: np.ndarray, P: int, S: int, H: int) -> DelayBreakdown:
    """One f64 row of summed totals (:func:`_analyze_batch`'s layout) as a
    :class:`DelayBreakdown`."""
    lat, cong, bw = (float(x) for x in tot[:3])
    parts = np.split(tot[3:], np.cumsum([P, S, S, H, H, H]))
    ppl, psc, psb, phl, phc, phb, pcc = parts
    return DelayBreakdown(lat, cong, bw, ppl, psc, psb, phl, phc, phb, pcc)


class EpochAnalyzer:
    """Batched epoch analyzer with bucketed padding.

    Event counts vary per epoch; traces are padded up to the next power-of-
    two bucket (via reusable :class:`~repro_torch.core.events.EventStager`
    buffers, no per-epoch allocation).  :meth:`analyze_batch` stacks B
    bucketed epochs into ``[B, N]`` tensors on ``device``, runs one batched
    analysis whose per-epoch breakdowns are summed **on the device**, and
    crosses to the host once per batch.  :meth:`analyze` is the B=1 case.

    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    ``device="cpu"`` runs the plain PyTorch versions (the tests' path).
    Multi-host fabrics (``n_hosts > 1``) run the host-segmented cascade.
    ``fused=False`` runs the unfused per-stage loop, which fabrics whose
    switches plus per-host RCs exceed the 31-bit route word take
    automatically, as in the reference.  Topologies with QoS classes or
    arbitrating switches (``FlatTopology.has_qos``) run the QoS cascade,
    host-segmented on multi-host fabrics, and report congestion per class;
    it needs the fused cascade, so QoS on the unfused loop raises
    ``ValueError`` as in the reference.  ``mesh=`` (a ``('data',)``
    :class:`~repro_torch.launch.mesh.Mesh` of this analyzer's device type)
    splits :meth:`analyze_batch_multi`'s session axis over its entries.

    ``pipeline=True`` enables the device-resident dispatch path
    (:meth:`launch_batch`): the host planes are staged into pinned buffers
    (on a card) and copied asynchronously on a side stream into the
    preallocated device buffers of the dispatch key (``aot``, an
    :class:`~repro_torch.core.aot.AotDispatchCache`, private by default).
    Keys of one ``(batch, length)`` bucket share its full-plane buffers.
    Chain-eligible FIFO topologies (:func:`plan_chain`) then run the packed
    compact cascade (:func:`_analyze_pipeline`), the merges on the device
    and each stage's scan in the scan kernel; every other topology runs the
    full-plane :func:`_analyze_batch` from the dispatch cache's buffers.
    The stage/transfer/compile/compute split lands in
    :attr:`last_dispatch`.  The default (``pipeline=False``) copies each
    plane with a pageable ``torch.from_numpy(a).to(device)``.
    """

    def __init__(
        self,
        flat: FlatTopology,
        bw_window_ns: float = 10_000.0,
        n_windows: int = 128,
        device="cuda",
        fused: bool = True,
        pipeline: bool = False,
        aot: Optional[AotDispatchCache] = None,
        mesh=None,
    ):
        self.flat = flat
        self.device = _check_device(device)
        self.mesh = check_mesh(mesh, self.device)
        self.last_dispatch = DispatchStats()
        self.sharded_dispatches = 0
        self.bw_window_ns = float(bw_window_ns)
        self.n_windows = int(n_windows)
        self.dtype = torch.float32
        dev, f32 = self.device, self.dtype
        self._pool_lat = torch.tensor(flat.pool_latency_ns, dtype=f32, device=dev)
        self._local_lat = torch.tensor(flat.local_latency_ns, dtype=f32, device=dev)
        self._route = torch.tensor(flat.route, dtype=f32, device=dev)
        self._stt = torch.tensor(flat.switch_stt_ns, dtype=f32, device=dev)
        self._bw = torch.tensor(flat.switch_bandwidth_gbps, dtype=f32, device=dev)
        # the fused cascade encodes one stage per switch (per-host RCs
        # included) in a 31-bit route word; wider fabrics fall back to the
        # unfused per-stage loop, slower but any host count works
        self.fused = bool(fused) and flat.n_switches <= 31
        self.qos_on = bool(flat.has_qos)
        if self.qos_on and not self.fused:
            raise ValueError(
                "QoS disciplines require the fused cascade: pass fused=True "
                "and keep the fabric within the 31-switch route-word budget"
            )
        if self.fused:
            bits_pool, self._merge_plan, self._stage_order = plan_cascade(flat)
            self._stage_stt = None
        else:
            bits_pool = np.zeros((flat.route.shape[0],), np.int32)
            self._merge_plan = None
            self._stage_order = tuple(int(s) for s in flat.stage_order())
            # per-stage STT on the host: each stage's scan takes it by value
            self._stage_stt = tuple(
                float(x) for x in np.asarray(flat.switch_stt_ns, np.float32)
            )
        self._bits_table = torch.tensor(bits_pool, dtype=torch.int32, device=dev)
        if self.qos_on:  # per-stage disciplines and class weights, stage order
            order = list(self._stage_order)
            self._disc = torch.tensor(
                flat.discipline_codes()[order], dtype=torch.int32, device=dev
            )
            self._weights = torch.tensor(
                flat.class_weight_table()[order], dtype=f32, device=dev
            )
        else:
            self._disc = self._weights = None
        self.pipeline = bool(pipeline)
        # pinned host planes only where an asynchronous copy reads them
        self._stager = EventStager(np.float32, pin=self.pipeline and dev.type == "cuda")
        self._chain_plan: Optional[ChainPlan] = None
        self._aot: Optional[AotDispatchCache] = None
        self._rings: Dict[Tuple[int, int], _DeviceRing] = {}
        self._copy_stream = None
        if self.pipeline:
            self._aot = aot if aot is not None else AotDispatchCache()
            # the packed compact cascade is FIFO-only: QoS topologies run the
            # full-plane path (still through the dispatch cache) instead
            self._chain_plan = None if self.qos_on else plan_chain(flat)
            if dev.type == "cuda":
                self._copy_stream = torch.cuda.Stream(dev)
        if self._chain_plan is not None:
            order = list(self._chain_plan.stage_order)
            self._chain_stage_idx = torch.tensor(order, dtype=torch.int64, device=dev)
            # each stage's scan takes its STT by value, as the unfused loop's
            self._chain_stt = tuple(
                float(x) for x in np.asarray(flat.switch_stt_ns, np.float32)[order]
            )
        # the topology's tensors on each mesh device, each copy made once
        self._replicas = Replicas(self._topology())

    _bucket = staticmethod(bucket_pow2)

    def _topology(self) -> Tuple[Optional[torch.Tensor], ...]:
        """The tensors :func:`_analyze_batch` reads besides the planes."""
        return (self._bits_table, self._pool_lat, self._local_lat, self._route,
                self._stt, self._bw, self._disc, self._weights)


    def analyze(
        self, events: MemEvents, lat_scale: Optional[np.ndarray] = None
    ) -> DelayBreakdown:
        return self.analyze_batch(
            [events], None if lat_scale is None else [lat_scale]
        )

    def _clean_pairs(
        self,
        traces: Sequence[MemEvents],
        lat_scales: Optional[Sequence[Optional[np.ndarray]]],
    ) -> List[Tuple[MemEvents, Optional[np.ndarray]]]:
        """Pair epochs with their scales, drop empties, validate routes."""
        if lat_scales is None:
            lat_scales = [None] * len(traces)
        elif len(lat_scales) != len(traces):
            raise ValueError(
                f"{len(lat_scales)} lat_scales for {len(traces)} traces — "
                "pass one (possibly None) per epoch"
            )
        pairs = [(tr, sc) for tr, sc in zip(traces, lat_scales) if tr.n]
        for tr, _ in pairs:
            _check_reachable(self.flat, tr)
        return pairs

    def _run_batch(self, t, pool, nbytes, weight, host, valid, window, scale, qos,
                   topology=None):
        """:func:`_analyze_batch`'s ``[B, M]`` rows on device planes with this
        analyzer's topology tensors (``topology``: their copies on the
        planes' device)."""
        bits, pool_lat, local_lat, route, stt, bw, disc, weights = (
            topology if topology is not None else self._topology()
        )
        return _analyze_batch(
            t,
            pool,
            nbytes,
            weight,
            host,
            valid,
            window,
            scale,
            bits,
            pool_lat,
            local_lat,
            route,
            stt,
            bw,
            stage_order=self._stage_order,
            n_windows=self.n_windows,
            n_hosts=self.flat.n_hosts,
            merge_plan=self._merge_plan,
            stage_stt_ns=self._stage_stt,
            qos=qos,
            disc_code=disc,
            class_weights=weights,
        )

    def _ring(self, b_bucket: int, n_bucket: int, width: int) -> _DeviceRing:
        """The bucket's device ring, made on first use, with room for packed
        planes ``width`` wide (0: none, off the chain).  The full planes are
        those the dispatch kind reads, the reference's staged planes."""
        ring = self._rings.get((b_bucket, n_bucket))
        if ring is None:
            full = (b_bucket, n_bucket)
            specs = {
                "pool": (full, torch.int32),
                "bytes": (full, torch.float32),
                "weight": (full, torch.float32),
                "valid": (full, torch.bool),
                "window": ((b_bucket,), torch.float32),
                "scale": ((b_bucket, self.flat.n_hosts * self.flat.n_pools), torch.float32),
            }
            if self._chain_plan is None:
                specs["t"] = (full, torch.float32)
                if self.flat.n_hosts > 1:
                    specs["host"] = (full, torch.int32)
                if self.qos_on:
                    specs["qos"] = (full, torch.int32)
            ring = self._rings[(b_bucket, n_bucket)] = _DeviceRing(specs, self.device)
        if width:
            ring.reserve(b_bucket, width)
        return ring

    def launch_batch(
        self,
        traces: Sequence[MemEvents],
        lat_scales: Optional[Sequence[Optional[np.ndarray]]] = None,
        stager: Optional[EventStager] = None,
    ) -> PendingBatch:
        """Stage, transfer and launch one epoch batch without blocking.

        The non-blocking half of :meth:`analyze_batch` (same arguments,
        same semantics once the returned :class:`PendingBatch` is
        finished).  Pipeline analyzers copy the staged planes into the
        dispatch key's device buffers on the side stream and run the packed
        chain dispatch on chain-eligible topologies, the full-plane
        analysis otherwise, recording the stage/transfer/compile/compute
        split; non-pipeline analyzers copy each plane with a pageable
        ``torch.from_numpy(a).to(device)`` and leave the split at its
        defaults.  ``stager`` substitutes the caller's staging buffers for
        the analyzer's own: the shared engine passes its own, so its
        dispatcher thread never shares mutable buffers with callers
        analyzing on this analyzer from theirs.
        """
        P, H = self.flat.n_pools, self.flat.n_hosts
        pairs = self._clean_pairs(traces, lat_scales)
        if not pairs:
            return PendingBatch(self, None, DispatchStats(rows=0))
        traces = [tr for tr, _ in pairs]
        t0 = time.perf_counter()
        n_bucket = self._bucket(max(tr.n for tr in traces))
        b_bucket = self._bucket(len(traces), floor=1)
        st = stager if stager is not None else self._stager
        chain = self._chain_plan
        pack = caps = None
        if chain is not None:
            # the chain path never reads the qos plane
            buf, pack, caps = st.stage_packed(
                traces, b_bucket, n_bucket, chain.enter_stage,
                len(chain.stage_order), qos=False,
            )
        else:
            buf = st.stage(traces, b_bucket, n_bucket, qos=self.qos_on)
        scale_buf = np.ones((b_bucket, H * P), np.float32)
        for row, (_, sc) in enumerate(pairs):
            if sc is not None:
                scale_buf[row] = sc
        # per-epoch window length: n_windows static windows tile each span
        span = np.maximum(buf["span"], self.bw_window_ns)
        bw_window = np.maximum(span / self.n_windows, 1.0).astype(np.float32)
        stats = DispatchStats(
            devices_used=1,
            shard_rows=0,
            rows=len(traces),
            padded_fraction=float(b_bucket - len(traces)) / b_bucket,
            qos_classes=self.flat.n_qos_classes,
        )
        if not self.pipeline:
            dev = self.device

            def put(a: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(a).to(dev)

            out = self._run_batch(
                put(buf["t"]),
                put(buf["pool"]),
                put(buf["bytes"]),
                put(buf["weight"]),
                put(buf["host"]) if H > 1 else None,  # one host: no plane to move
                put(buf["valid"]),
                put(bw_window),
                put(scale_buf),
                put(buf["qos"]) if self.qos_on else None,  # FIFO: no plane to move
            ).sum(dim=0)
            return PendingBatch(self, out, stats)
        t1 = time.perf_counter()

        # the reference's dispatch keys; a key's entry is its bucket's ring
        width = 0 if chain is None else int(sum(caps))
        key = ("batch", b_bucket, n_bucket) if chain is None else (
            "chain", b_bucket, n_bucket, caps)
        ring, hit = self._aot.get(key, lambda: self._ring(b_bucket, n_bucket, width))
        compile_s = 0.0 if hit else time.perf_counter() - t1
        d = dict(ring.planes)
        if chain is not None:
            d.update(ring.packed(b_bucket, width))
        planes = {**buf, **(pack or {}), "window": bw_window, "scale": scale_buf}
        copies = ring.upload(d, {name: planes[name] for name in d}, self._copy_stream)
        if self._copy_stream is None:
            transfer_s, copies = copies, None
        else:  # read off the copy events at finish
            transfer_s = 0.0
            st.fence([buf] if pack is None else [buf, pack], copies[1])
        t2 = time.perf_counter()
        if chain is not None:
            out = _analyze_pipeline(
                d["t"], d["idx"], d["pool"], d["bytes"], d["weight"], d["valid"],
                d["window"], d["scale"], self._pool_lat, self._local_lat, self._route,
                self._bw, self._chain_stage_idx, self._chain_stt, caps, self.n_windows,
            )
        else:
            out = self._run_batch(
                d["t"], d["pool"], d["bytes"], d["weight"], d.get("host"), d["valid"],
                d["window"], d["scale"], d.get("qos"),
            ).sum(dim=0)
        ring.release()
        stats = dataclasses.replace(
            stats,
            stage_s=t1 - t0,
            transfer_s=transfer_s,
            compile_s=compile_s,
            compute_s=time.perf_counter() - t2,
            aot_cache_hit=hit,
        )
        self.last_dispatch = stats
        return PendingBatch(self, out, stats, copies)

    def warmup(
        self,
        traces: Sequence[MemEvents],
        lat_scales: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> bool:
        """Build the dispatch cache's entry that this batch shape would use
        (one throwaway dispatch), so the first *real* dispatch of a serving
        loop finds its device buffers in place.  Returns True if a build
        actually happened (False: already warm, empty batch, or a
        non-pipeline analyzer)."""
        if not self.pipeline:
            return False
        before = self._aot.lowerings
        self.launch_batch(traces, lat_scales).finish()
        return self._aot.lowerings > before

    def analyze_batch(
        self,
        traces: Sequence[MemEvents],
        lat_scales: Optional[Sequence[Optional[np.ndarray]]] = None,
        stager: Optional[EventStager] = None,
    ) -> DelayBreakdown:
        """Analyze B epochs in one batched pass; returns summed totals —
        :meth:`launch_batch`, then at once :meth:`PendingBatch.finish`.

        ``lat_scales`` optionally pairs each epoch with a ``[H*P]`` latency
        scale vector; ``None`` entries (and padded rows) analyze with the
        exact ones vector.  ``stager`` as for :meth:`launch_batch`.
        """
        return self.launch_batch(traces, lat_scales, stager=stager).finish()

    def analyze_batch_multi(
        self,
        groups: Sequence[Sequence[MemEvents]],
        lat_scale_groups: Optional[Sequence[Optional[Sequence]]] = None,
        stager: Optional[EventStager] = None,
        mesh=None,
    ) -> List[DelayBreakdown]:
        """K sessions' epoch batches → K summed breakdowns, one dispatch.

        The multi-session entry point the shared engine coalesces through:
        ``groups[k]`` is session k's epoch list and comes back as its own
        :class:`DelayBreakdown`.  The K batches are staged into one
        ``[K, B, N]`` stack (:meth:`EventStager.stage_stack`; every axis a
        :func:`bucket_pow2` bucket, as in the reference) and analyzed as the
        ``[K·B, N]`` rows of **one** :func:`_analyze_batch` — on the card one
        cascade launch over all K·B rows (the host-segmented cascade on
        fabrics, the QoS cascade on QoS topologies), whose per-row host bins
        keep every row's per-host sums apart.  The rows are reduced to
        per-session totals on the device and cross to the host as one
        ``[K, M]`` copy.  Every session must share this analyzer's topology,
        arbitration and window configuration
        (:func:`~repro_torch.core.engine.dispatch_key` guarantees it).
        Empty groups come back as zero breakdowns; a single live group runs
        :meth:`analyze_batch`.

        ``mesh`` (defaulting to the analyzer's own) splits the session axis
        over its ``('data',)`` entries, as the reference does: K is padded
        with empty sessions to a multiple of the entries, each entry's
        ``[k_shard·B, N]`` rows run the same :func:`_analyze_batch` on its
        own device (one cascade launch a shard) against the topology's
        tensors copied there once, and reduce to per-session totals there.
        Every shard's copies and launches are issued before the first
        ``[k_shard, M]`` copy back, which go in mesh order.  Each row's
        arithmetic is the unsharded dispatch's.
        """
        P, S, H = self.flat.n_pools, self.flat.n_switches, self.flat.n_hosts
        K = len(groups)
        if lat_scale_groups is None:
            lat_scale_groups = [None] * K
        elif len(lat_scale_groups) != K:
            raise ValueError(
                f"{len(lat_scale_groups)} lat_scale_groups for {K} groups"
            )
        cleaned = [
            self._clean_pairs(traces, scales)
            for traces, scales in zip(groups, lat_scale_groups)
        ]
        out = [DelayBreakdown.zero(P, S, H) for _ in range(K)]
        rows = [i for i, p in enumerate(cleaned) if p]
        if not rows:
            return out
        if len(rows) == 1:  # degenerate stack: the plain batched path
            i = rows[0]
            out[i] = self.analyze_batch(
                [tr for tr, _ in cleaned[i]],
                [sc for _, sc in cleaned[i]],
                stager=stager,
            )
            return out
        mesh, n_shards = resolve_data_mesh(
            check_mesh(self.mesh if mesh is None else mesh, self.device),
            len(rows),
            what="coalesced session dispatch",
        )
        n_bucket = self._bucket(max(tr.n for i in rows for tr, _ in cleaned[i]))
        b_bucket = self._bucket(max(len(cleaned[i]) for i in rows), floor=1)
        k_bucket = pad_to_multiple(self._bucket(len(rows), floor=1), n_shards)
        k_shard = k_bucket // n_shards
        st = stager if stager is not None else self._stager
        buf = st.stage_stack(
            [[tr for tr, _ in cleaned[i]] for i in rows], k_bucket, b_bucket, n_bucket
        )
        scale_buf = np.ones((k_bucket, b_bucket, H * P), np.float32)
        for k, i in enumerate(rows):
            for row, (_, sc) in enumerate(cleaned[i]):
                if sc is not None:
                    scale_buf[k, row] = sc
        span = np.maximum(buf["span"], self.bw_window_ns)
        bw_window = np.maximum(span / self.n_windows, 1.0).astype(np.float32)
        self.last_dispatch = DispatchStats(
            devices_used=n_shards,
            shard_rows=k_shard if mesh is not None else 0,
            rows=len(rows),
            padded_fraction=float(k_bucket - len(rows)) / k_bucket,
            qos_classes=self.flat.n_qos_classes,
        )
        if mesh is not None:
            self.sharded_dispatches += 1
        n_rows = k_shard * b_bucket
        topologies = [None] if mesh is None else self._replicas.on(mesh_devices(mesh))

        def put(a: np.ndarray) -> List[torch.Tensor]:
            # [K, B, ...] planes as each shard's [k_shard·B, ...] rows
            parts = [torch.from_numpy(a).to(self.device)] if mesh is None else shard_rows(mesh, a)
            return [p.view((n_rows,) + a.shape[2:]) for p in parts]

        planes = [
            put(buf["t"]),
            put(buf["pool"]),
            put(buf["bytes"]),
            put(buf["weight"]),
            put(buf["host"]) if H > 1 else None,  # one host: no plane to move
            put(buf["valid"]),
            put(bw_window),
            put(scale_buf),
            put(buf["qos"]) if self.qos_on else None,  # FIFO: no plane to move
        ]
        per_session = [
            self._run_batch(*(None if p is None else p[j] for p in planes), topology=topo)
            .view(k_shard, b_bucket, -1).sum(dim=1)
            for j, topo in enumerate(topologies)
        ]
        # one [k_shard, M] transfer a shard, in mesh order
        tot = np.concatenate([x.cpu().numpy() for x in per_session])[: len(rows)]
        tot = tot.astype(np.float64)
        for k, i in enumerate(rows):
            out[i] = _unpack(tot[k], P, S, H)
        return out


def analyze_any(
    analyzer,
    traces: Sequence[MemEvents],
    lat_scales: Optional[Sequence] = None,
    stager: Optional[EventStager] = None,
) -> DelayBreakdown:
    """Run one epoch batch through whichever analyzer a session carries:
    an :class:`EpochAnalyzer` batches on its device; DES-style analyzers
    (anything with ``.flat`` and ``.simulate``) run per epoch and sum.
    The single dispatch point shared by the synchronous sessions and the
    engine's solo submissions."""
    if isinstance(analyzer, EpochAnalyzer):
        if stager is None:
            # the caller's thread, the analyzer's own stager: called with two
            # arguments, so an ``analyze_batch`` replaced on the instance by
            # a ``(traces, lat_scales)`` wrapper (one that records the
            # batches) keeps working on the synchronous path
            return analyzer.analyze_batch(traces, lat_scales)
        return analyzer.analyze_batch(traces, lat_scales, stager=stager)
    flat = analyzer.flat
    bd = DelayBreakdown.zero(flat.n_pools, flat.n_switches, flat.n_hosts)
    for i, tr in enumerate(traces):
        bd = bd + analyzer.simulate(
            tr, None if lat_scales is None else lat_scales[i]
        )
    return bd


# --------------------------------------------------------------------------- #
# Fine-grained discrete-event baseline (the "Gem5" of our Table 1)
# --------------------------------------------------------------------------- #


class FineGrainedSimulator:
    """Event-by-event DES through the switch hierarchy.

    Every transaction is walked individually through its pool's switch path
    (deepest switch -> RC) with per-switch FIFO occupancy.  ``bandwidth_mode``:

      * ``'stt'``      service time = STT only (matches the epoch analyzer's
                       congestion model exactly; used for oracle agreement).
      * ``'per_txn'``  service time = max(STT, bytes/BW): fine-grained
                       bandwidth modelling the epoch analyzer approximates
                       with windows (used for the accuracy benchmark).
    """

    def __init__(self, flat: FlatTopology, bandwidth_mode: str = "per_txn"):
        if bandwidth_mode not in ("stt", "per_txn"):
            raise ValueError(bandwidth_mode)
        self.flat = flat
        self.bandwidth_mode = bandwidth_mode
        # per-(host, pool) switch path, deepest first (the analyzer's stage
        # order); shared switches appear in several hosts' paths, private RCs
        # in exactly one — the same contention structure the epoch analyzer
        # derives from the virtual-pool route matrix
        order = list(flat.stage_order())
        self._paths: List[List[int]] = []
        for v in range(flat.route.shape[0]):
            self._paths.append([s for s in order if flat.route[v, s] > 0])

    def simulate(
        self,
        events: MemEvents,
        lat_scale: Optional[np.ndarray] = None,
        presorted: bool = False,
    ) -> DelayBreakdown:
        bd, _ = self._run(events, lat_scale, presorted)
        return bd

    def final_times(
        self, events: MemEvents, presorted: bool = False
    ) -> np.ndarray:
        """Per-event post-cascade times (the DES decision oracle the
        vectorized QoS cascades are gated against): ``out[i]`` is event
        ``i``'s departure time from its last switch — its service *start*
        under ``bandwidth_mode='stt'``, matching the kernels' final-time
        semantics exactly.  Times align with the simulated (time-sorted)
        event order; pass ``presorted=True`` on an already-sorted trace to
        keep input order."""
        _, t_out = self._run(events, None, presorted)
        return t_out

    def _run(
        self,
        events: MemEvents,
        lat_scale: Optional[np.ndarray],
        presorted: bool,
    ) -> Tuple[DelayBreakdown, np.ndarray]:
        flat = self.flat
        P, S, H = flat.n_pools, flat.n_switches, flat.n_hosts
        C = int(getattr(flat, "n_qos_classes", 1))
        if events.n == 0:
            return DelayBreakdown.zero(P, S, H), np.zeros((0,), np.float64)
        _check_reachable(flat, events)
        # presorted: the caller promises a non-decreasing timeline (e.g.
        # merge_host_traces output), skipping even the monotone check
        ev = events if presorted else events.sorted_by_time()
        pool = ev.pool.astype(np.int64)
        hostv = ev.host.astype(np.int64)
        qcls = np.clip(ev.qos.astype(np.int64), 0, C - 1)
        vpool = hostv * P + pool
        per_event_lat = np.maximum(
            flat.pool_latency_ns[vpool] - flat.local_latency_ns, 0.0
        )
        if lat_scale is not None:
            # device-cache epoch summary, same contract as analyze_ref
            per_event_lat = per_event_lat * np.asarray(lat_scale, np.float64)[vpool]
        per_event_lat = per_event_lat * ev.weight
        per_pool_lat = np.bincount(pool, weights=per_event_lat, minlength=P)[:P]
        per_host_lat = np.bincount(hostv, weights=per_event_lat, minlength=H)[:H]

        # per-(switch, class) horizons: FIFO switches use column 0 (one
        # shared queue), strict-priority ones carve per-level horizons a
        # high-class arrival pushes forward, WFQ ones advance class-private
        # virtual time by the weight-inflated service
        discs = (
            list(flat.switch_discipline)
            if getattr(flat, "switch_discipline", None)
            else ["fifo"] * S
        )
        w_table = flat.class_weight_table().astype(np.float64)
        w_total = w_table.sum(axis=1)
        fin = np.zeros((S, C), np.float64)
        per_switch_cong = np.zeros((S,), np.float64)
        per_switch_bw = np.zeros((S,), np.float64)
        per_host_cong = np.zeros((H,), np.float64)
        per_host_bw = np.zeros((H,), np.float64)
        per_class_cong = np.zeros((C,), np.float64)
        t_out = np.zeros((ev.n,), np.float64)
        # priority queue of (time, seq, event_idx, stage_pos); ``ev`` is
        # time-sorted, so the seed list already satisfies the heap invariant
        # — one O(n) pass instead of n heappushes.
        heap: List[Tuple[float, int, int, int]] = [
            (float(ev.t_ns[i]), i, i, 0) for i in range(ev.n)
        ]
        seq = ev.n
        while heap:
            t_arr, _, i, stage = heapq.heappop(heap)
            path = self._paths[vpool[i]]
            if stage >= len(path):
                t_out[i] = t_arr
                continue
            s = path[stage]
            stt = float(flat.switch_stt_ns[s])
            if self.bandwidth_mode == "per_txn":
                bw = float(flat.switch_bandwidth_gbps[s])
                service = max(stt, float(ev.bytes_[i]) / bw if bw > 0 else stt)
            else:
                service = stt
            disc = discs[s]
            c = int(qcls[i])
            if disc == "priority":
                start = max(t_arr, fin[s, c])
                for lvl in range(c, C):
                    fin[s, lvl] = max(t_arr, fin[s, lvl]) + service
            elif disc == "wfq":
                start = max(t_arr, fin[s, c])
                fin[s, c] = start + service * w_total[s] / w_table[s, c]
            else:  # fifo: one shared horizon
                start = max(t_arr, fin[s, 0])
                fin[s, 0] = start + service
            per_switch_cong[s] += start - t_arr  # queueing delay
            per_host_cong[hostv[i]] += start - t_arr
            per_class_cong[c] += start - t_arr
            if self.bandwidth_mode == "per_txn" and service > stt:
                per_switch_bw[s] += service - stt
                per_host_bw[hostv[i]] += service - stt
            heapq.heappush(heap, (start + service if self.bandwidth_mode == "per_txn" else start, seq, i, stage + 1))
            seq += 1

        return DelayBreakdown(
            float(per_event_lat.sum()),
            float(per_switch_cong.sum()),
            float(per_switch_bw.sum()),
            per_pool_lat,
            per_switch_cong,
            per_switch_bw,
            per_host_lat,
            per_host_cong,
            per_host_bw,
            per_class_cong,
        ), t_out
