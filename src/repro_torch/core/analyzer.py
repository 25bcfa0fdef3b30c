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
    (:func:`repro_torch.kernels.ops.congestion_cascade`): the hand-written
    CUDA kernel on the card, the plain PyTorch version on the CPU.

The serial queue ``out_i = max(arr_i, out_{i-1} + STT)`` is solved in closed
form with a cumulative max:  let ``f_i = cummax(arr_i − STT·rank_i)``; then
``out_i = f_i + STT·rank_i``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from .events import EventStager, MemEvents
from .topology import FlatTopology

__all__ = [
    "DelayBreakdown",
    "DispatchStats",
    "EpochAnalyzer",
    "FineGrainedSimulator",
    "analyze_any",
    "analyze_ref",
    "bucket_pow2",
    "plan_cascade",
    "serial_queue_ref",
]


@dataclasses.dataclass(frozen=True)
class DispatchStats:
    """Observability record for the most recent dispatch (a copy of the
    reference's record; this slice fills ``rows``, ``padded_fraction`` and
    ``qos_classes`` and leaves the rest at their defaults).

    ``devices_used`` is 1 whenever sharding did not engage; ``shard_rows``
    is the per-device slice of the (padded) leading axis, 0 when unsharded;
    ``padded_fraction`` is the fraction of leading-axis rows that were
    bucket/alignment padding — wasted compute the caller can act on.

    The pipeline breakdown splits the dispatch wall clock: ``stage_s``
    host staging (pack/fill, zero argsort on the pipeline path),
    ``transfer_s`` H2D placement, ``compile_s`` AOT lowering (nonzero only
    on a cache miss — steady state is 0), ``compute_s`` time spent blocked
    on device execution (under the engine's overlapped dispatcher this is
    only the *exposed* compute, the part H2D/staging of the next batch
    could not hide).  ``donated`` records whether the dispatch reused the
    staged device buffers in place; ``aot_cache_hit`` whether it ran a
    pre-compiled executable.  Non-pipeline dispatches leave all six at
    their defaults.

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
    pool_latency_ns: torch.Tensor,  # [V] f32 (V = n_hosts * n_pools)
    local_latency_ns: torch.Tensor,  # [] f32
    route: torch.Tensor,  # [V, S] f32
    switch_stt_ns: torch.Tensor,  # [S] f32
    switch_bw: torch.Tensor,  # [S] f32 bytes/ns
    stage_order: Tuple[int, ...],
    n_windows: int,
    n_hosts: int = 1,
    merge_plan=None,
    stage_stt_ns: Optional[Tuple[float, ...]] = None,  # unfused loop: per-switch STT
) -> torch.Tensor:
    """B epochs' three-delay analysis (FIFO switches), summed over the batch
    on the device.

    Port of the reference's FIFO branches of ``_analyze_jax`` with the
    ``vmap`` of ``_analyze_batch_jax`` written out as the leading dimension.
    Multi-host fabrics (``n_hosts > 1``) key every lookup by the virtual
    pool ``vp = host * P + pool`` (shared switches see the merged timeline,
    per-host RCs stay private) and host-segment every delay class.  The
    congestion stage is the fused cascade, or with ``stage_stt_ns`` given
    the unfused per-stage loop (a stable sort of each row, then one switch's
    queue scan, per stage) that fabrics wider than the 31-bit route word
    take.  Returns one flat f32 tensor ``[latency, congestion, bandwidth,
    per_pool_latency (P), per_switch_congestion (S), per_switch_bandwidth
    (S), per_host_latency (H), per_host_congestion (H), per_host_bandwidth
    (H)]`` so the host needs one transfer per batch.
    """
    n_rows = t.shape[0]
    V = pool_latency_ns.shape[0]
    P = V // n_hosts  # physical pools
    S = switch_stt_ns.shape[0]
    dtype = t.dtype
    dev = t.device
    pool64 = pool.to(torch.int64)
    host64 = None if n_hosts == 1 else host.to(torch.int64)
    vp = pool64 if n_hosts == 1 else host64 * P + pool64

    # -- latency: gather + one-hot contraction ----------------------------- #
    per_event_lat = (
        torch.clamp(pool_latency_ns[vp] - local_latency_ns, min=0.0)
        * torch.gather(lat_scale, 1, vp)
        * weight
    )
    per_event_lat = torch.where(valid, per_event_lat, 0.0)
    # keyed by the *physical* pool: multi-host batches report [P], not [H*P]
    pool_onehot = (pool64[..., None] == torch.arange(P, device=dev)).to(dtype)  # [B, N, P]
    per_pool_lat = torch.bmm(per_event_lat[:, None, :], pool_onehot)[:, 0]  # [B, P]
    latency = per_event_lat.sum(dim=1)
    if n_hosts == 1:
        per_host_lat = latency[:, None]
    else:
        per_host_lat = _host_sums(per_event_lat, host64, n_hosts).to(dtype)

    big = torch.finfo(dtype).max / 4
    t_cur = torch.where(valid, t, big)
    per_switch_cong = torch.zeros((n_rows, S), dtype=dtype, device=dev)
    if stage_stt_ns is None:
        # -- congestion: the fused cascade (a kernel on the card) ----------- #
        ev_bits = torch.where(valid, bits_table[vp], 0)
        stage_idx = torch.tensor(stage_order, dtype=torch.int64, device=dev)
        t_end, slot_idx, psd = kops.congestion_cascade(
            t_cur, ev_bits, switch_stt_ns[stage_idx].contiguous(),
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
        has_merges = (
            dev.type != "cpu"
            or merge_plan is None
            or any(len(ops) for ops in merge_plan)
        )
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
        t_end = t_cur
        has_merges = False  # t_cur stays in input order
    congestion = per_switch_cong.sum(dim=1)
    if per_host_cong is None:
        per_host_cong = congestion[:, None]

    if has_merges:
        # bandwidth runs in final slot order: gather the payloads through
        # the cascade's permutation (slot k held input event slot_idx[k])
        sl = slot_idx.to(torch.int64)
        lat_e = torch.gather(per_event_lat, 1, sl)
        vp_e = torch.gather(vp, 1, sl)
        nbytes_e = torch.gather(nbytes, 1, sl)
        valid_e = torch.gather(valid, 1, sl)
    else:
        lat_e, vp_e, nbytes_e, valid_e = per_event_lat, vp, nbytes, valid

    # -- bandwidth: one scatter-add over (window, virtual pool) keys, then a
    #    tiny [W, V] @ [V, S] product distributes pools onto switches ------ #
    t_obs = torch.where(valid_e, t_end + lat_e, 0.0)
    win = torch.clamp(
        (t_obs / bw_window_ns[:, None]).to(torch.int32), max=n_windows - 1
    )
    win = torch.where(valid_e, win, n_windows - 1)
    key = win.to(torch.int64) * V + vp_e
    wp = torch.zeros((n_rows, n_windows * V), dtype=dtype, device=dev)
    wp.scatter_add_(1, key, torch.where(valid_e, nbytes_e, 0.0))
    if n_hosts == 1:
        wbytes = torch.matmul(wp.view(n_rows, n_windows, V), route)  # [B, W, S]
        wbytes_h = None
    else:
        wbytes_h = torch.einsum(  # [B, W, H, S]
            "bwhp,hps->bwhs",
            wp.view(n_rows, n_windows, n_hosts, P),
            route.view(n_hosts, P, S),
        )
        wbytes = wbytes_h.sum(dim=2)
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
        # window stretch attributed to hosts by their byte share in the window
        share = stretch / torch.clamp(wbytes, min=1e-30)
        per_host_bw = torch.einsum("bws,bwhs->bh", share, wbytes_h)

    rows = torch.cat(
        [
            latency[:, None], congestion[:, None], bandwidth[:, None],
            per_pool_lat, per_switch_cong, per_switch_bw,
            per_host_lat, per_host_cong, per_host_bw,
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
    automatically, as in the reference.  QoS disciplines (slice 5),
    ``pipeline=`` (slice 4) and ``mesh=`` (slice 6) raise
    ``NotImplementedError``.
    """

    def __init__(
        self,
        flat: FlatTopology,
        bw_window_ns: float = 10_000.0,
        n_windows: int = 128,
        device="cuda",
        fused: bool = True,
        pipeline: bool = False,
        mesh=None,
    ):
        if flat.has_qos:
            raise NotImplementedError(
                "QoS switch disciplines come with slice 5 of the port"
            )
        if pipeline:
            raise NotImplementedError(
                "the device-resident pipeline (pipeline=True) comes with "
                "slice 4 of the port"
            )
        if mesh is not None:
            raise NotImplementedError("sharded dispatch (mesh=) comes with slice 6 of the port")
        self.flat = flat
        self.device = _check_device(device)
        self.last_dispatch = DispatchStats()
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
        self._stager = EventStager(np.float32)

    _bucket = staticmethod(bucket_pow2)

    def analyze(
        self, events: MemEvents, lat_scale: Optional[np.ndarray] = None
    ) -> DelayBreakdown:
        return self.analyze_batch(
            [events], None if lat_scale is None else [lat_scale]
        )

    def analyze_batch(
        self,
        traces: Sequence[MemEvents],
        lat_scales: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> DelayBreakdown:
        """Analyze B epochs in one batched pass; returns summed totals.

        ``lat_scales`` optionally pairs each epoch with a ``[P]`` latency
        scale vector; ``None`` entries (and padded rows) analyze with the
        exact ones vector.
        """
        P, S, H = self.flat.n_pools, self.flat.n_switches, self.flat.n_hosts
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
        if not pairs:
            return DelayBreakdown.zero(P, S, H)
        traces = [tr for tr, _ in pairs]
        n_bucket = self._bucket(max(tr.n for tr in traces))
        b_bucket = self._bucket(len(traces), floor=1)
        buf = self._stager.stage(traces, b_bucket, n_bucket)
        scale_buf = np.ones((b_bucket, H * P), np.float32)
        for row, (_, sc) in enumerate(pairs):
            if sc is not None:
                scale_buf[row] = sc
        # per-epoch window length: n_windows static windows tile each span
        span = np.maximum(buf["span"], self.bw_window_ns)
        bw_window = np.maximum(span / self.n_windows, 1.0)
        self.last_dispatch = DispatchStats(
            devices_used=1,
            shard_rows=0,
            rows=len(traces),
            padded_fraction=float(b_bucket - len(traces)) / b_bucket,
            qos_classes=self.flat.n_qos_classes,
        )
        dev = self.device

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(dev)

        out = _analyze_batch(
            put(buf["t"]),
            put(buf["pool"]),
            put(buf["bytes"]),
            put(buf["weight"]),
            put(buf["host"]) if H > 1 else None,  # one host: no plane to move
            put(buf["valid"]),
            put(bw_window.astype(np.float32)),
            put(scale_buf),
            self._bits_table,
            self._pool_lat,
            self._local_lat,
            self._route,
            self._stt,
            self._bw,
            stage_order=self._stage_order,
            n_windows=self.n_windows,
            n_hosts=H,
            merge_plan=self._merge_plan,
            stage_stt_ns=self._stage_stt,
        )
        # the single host-boundary crossing for the whole batch
        tot = out.cpu().numpy().astype(np.float64)
        lat, cong, bw = (float(x) for x in tot[:3])
        parts = np.split(tot[3:], np.cumsum([P, S, S, H, H]))
        ppl, psc, psb, phl, phc, phb = parts
        return DelayBreakdown(
            lat, cong, bw, ppl, psc, psb, phl, phc, phb, np.array([cong])
        )

    def analyze_batch_multi(self, *args, **kwargs):
        raise NotImplementedError(
            "multi-session stacked dispatch (analyze_batch_multi) comes with "
            "the analysis engine, slice 4 of the port"
        )


def analyze_any(
    analyzer,
    traces: Sequence[MemEvents],
    lat_scales: Optional[Sequence] = None,
) -> DelayBreakdown:
    """Run one epoch batch through whichever analyzer a session carries:
    an :class:`EpochAnalyzer` batches on its device; DES-style analyzers
    (anything with ``.flat`` and ``.simulate``) run per epoch and sum."""
    if isinstance(analyzer, EpochAnalyzer):
        return analyzer.analyze_batch(traces, lat_scales)
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
