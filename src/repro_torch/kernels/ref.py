"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``):
the fused cascade, single-host and host-segmented, the single-switch scan,
the QoS-arbitrated cascade (priority / WFQ / FIFO per switch; a
static-discipline spec and the data-driven form the kernel computes),
Mamba2's SSD scan (the sequential recurrence and the chunked algorithm), and
full-matrix GQA attention with the split-KV form of the decode kernel.
Beside the two cascades stand their partitioned mirrors
(:func:`serial_queue_cascade_partitioned`, :func:`qos_cascade_partitioned`):
the same results, computed the way the cascade kernels split a row between
the CTAs of a cluster, for the tests and ``chip_smoke.py``; beside the
single-switch scan stands :func:`congestion_scan_tiled`, the scan computed
tile by tile with the scan kernel's look-back.  The device-resident
pipeline's merges (:func:`two_run_merge`, :func:`staging_sort`) and its
chain cascade (:func:`chain_cascade`) never had a Pallas kernel: they are
plain batched torch ops on every device, and on the card the chain
cascade's per-stage scans run in the scan kernel.

They define what the CUDA kernels (:mod:`repro_torch.kernels.congestion`,
:mod:`repro_torch.kernels.ssd_scan`, :mod:`repro_torch.kernels.flash_attention`)
compute.  The CPU tests hold them against the reference, ``chip_smoke.py``
holds the kernel against them on the card, and :mod:`.ops` runs them for
tensors that lie on the CPU.  On the card nothing on the main path calls
them but the chain cascade's merges.

Every function works on ``[..., N]`` tensors along the last dimension, so a
batch of epochs is a leading dimension (the reference's ``vmap``), and the
reference's ``lax.cond(dirty > 0, ...)`` becomes a per-row mask.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..annotations import axes

__all__ = [
    "DISC_FIFO",
    "DISC_PRIORITY",
    "DISC_WFQ",
    "KERNEL_TILE",
    "MERGE_NONE",
    "MERGE_RAN",
    "MERGE_SKIPPED",
    "SCAN_TILE",
    "chain_cascade",
    "congestion_scan",
    "congestion_scan_tiled",
    "check_expand_rows",
    "expand_events",
    "merge_sorted_runs",
    "mha_attention",
    "qos_cascade_dyn",
    "qos_cascade_partitioned",
    "qos_serial_queue_cascade",
    "qos_service_table",
    "serial_queue",
    "serial_queue_cascade",
    "serial_queue_cascade_partitioned",
    "split_kv_attention",
    "ssd_chunked",
    "ssd_naive",
    "staging_sort",
    "two_run_merge",
]

# discipline codes of the data-driven QoS cascade (the topology's
# DISCIPLINE_CODES order: fifo, priority, wfq)
DISC_FIFO, DISC_PRIORITY, DISC_WFQ = 0, 1, 2


def _big(dtype: torch.dtype) -> float:
    """The "minus infinity" of the masked cummax and the pad time of
    invalid events: ``finfo.max / 4``, as in the reference — padded events
    enter the cascade at ``+big`` and must sort last."""
    return torch.finfo(dtype).max / 4


def _rank(mask: torch.Tensor) -> torch.Tensor:
    """int32 ``cumsum(mask) - 1`` along the last dimension (an int32 rank:
    a float cumsum stops counting exactly at 2**24 events)."""
    return torch.cumsum(mask.to(torch.int32), dim=-1, dtype=torch.int32) - 1


def serial_queue(t_sorted: torch.Tensor, mask: torch.Tensor, stt) -> torch.Tensor:
    """Start times of a FIFO queue with constant service time over the masked
    subsequence of a time-sorted event stream; unmasked events pass through.

    out_i = max(arr_i, out_{i-1} + stt) over masked events, closed form
    out_i = cummax(arr_i − stt·rank_i) + stt·rank_i.
    """
    stt = torch.as_tensor(stt, dtype=t_sorted.dtype, device=t_sorted.device)
    rankf = _rank(mask).to(t_sorted.dtype)
    g = torch.where(mask, t_sorted - stt * rankf, -_big(t_sorted.dtype))
    f = torch.cummax(g, dim=-1).values
    return torch.where(mask, f + stt * rankf, t_sorted)


def congestion_scan(
    t_sorted: torch.Tensor, mask: torch.Tensor, stt
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One switch's masked FIFO scan: ``(start, delay)`` over ``[..., N]``,
    ``delay = start - t`` where masked and 0 elsewhere (the reference's
    ``ops.congestion_queue``)."""
    start = serial_queue(t_sorted, mask, stt)
    return start, torch.where(mask, start - t_sorted, 0.0)


SCAN_TILE = 8192  # events a CTA of the scan kernel takes (kTile of congestion_scan.cu)


def _look_back(agg, op, reduce, identity, generator):
    """Each tile's prefix over the tiles before it (``[..., nt]`` per-tile
    aggregates in, exclusive prefixes out), found as the scan kernel's
    look-back finds it.  Tile ``j`` walks back over its predecessors'
    aggregates until it reaches one whose inclusive prefix is already
    published, takes that and stops; tile 0's inclusive prefix is its
    aggregate.  With a ``generator`` the stopping predecessor is drawn at
    random for each tile (any order in which the tiles publish); without
    one the walk reads aggregates back to tile 0."""
    nt = agg.shape[-1]
    excl = [torch.full_like(agg[..., 0], identity)]
    incl = [agg[..., 0]]
    for j in range(1, nt):
        stop = 0 if generator is None else int(torch.randint(j, (1,), generator=generator))
        acc = incl[stop]
        if stop + 1 < j:
            acc = op(acc, reduce(agg[..., stop + 1:j]))
        excl.append(acc)
        incl.append(op(acc, agg[..., j]))
    return torch.stack(excl, -1)


def congestion_scan_tiled(
    t_sorted: torch.Tensor,
    mask: torch.Tensor,
    stt,
    tile: int = SCAN_TILE,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`congestion_scan` computed as the scan kernel
    (``csrc/congestion_scan.cu``) computes it: each row cut into tiles of
    ``tile`` events; each tile's masked count, then its count prefix by
    look-back (:func:`_look_back`); the global ranks, ``g = t - stt*rank``,
    each tile's max of ``g``, then its max prefix by look-back; then
    ``start`` and ``delay``.  Integer sums and f32 maxima are exact in any
    grouping, so the result is :func:`congestion_scan`'s bit for bit, for
    every tile and every look-back schedule (``generator``)."""
    n = t_sorted.shape[-1]
    nt = -(-n // tile)
    lead = t_sorted.shape[:-1]
    pad = nt * tile - n
    t = torch.cat([t_sorted, t_sorted.new_zeros(lead + (pad,))], -1).reshape(lead + (nt, tile))
    m = torch.cat([mask, mask.new_zeros(lead + (pad,))], -1).reshape(lead + (nt, tile))
    mi = m.to(torch.int32)
    # 1. count: each tile's rank base
    base_c = _look_back(mi.sum(-1, dtype=torch.int32), torch.add,
                        lambda w: w.sum(-1, dtype=torch.int32), 0, generator)
    rank = base_c[..., None] + torch.cumsum(mi, -1, dtype=torch.int32) - mi
    p = torch.as_tensor(stt, dtype=t.dtype, device=t.device) * rank.to(t.dtype)
    # 2. max: each tile's max of g over the row before it
    g = torch.where(m, t - p, float("-inf"))
    base_g = _look_back(g.amax(-1), torch.maximum, lambda w: w.amax(-1), float("-inf"),
                        generator)
    f = torch.maximum(torch.cummax(g, -1).values, base_g[..., None])
    start = torch.where(m, f + p, t)
    delay = torch.where(m, start - t, 0.0)
    return (start.reshape(lead + (nt * tile,))[..., :n],
            delay.reshape(lead + (nt * tile,))[..., :n])


def _scatter_drop(
    n: int, idx: torch.Tensor, keep: torch.Tensor, src: torch.Tensor, fill
) -> torch.Tensor:
    """``full(fill).at[where(keep, idx, n)].set(src, mode='drop')`` along the
    last dimension: dropped writes land in a spare column that is cut off."""
    shape = src.shape[:-1] + (n + 1,)
    out = torch.full(shape, fill, dtype=src.dtype, device=src.device)
    where = torch.where(keep, idx, torch.full_like(idx, n)).to(torch.int64)
    return out.scatter(-1, where, src)[..., :n]


def merge_sorted_runs(
    x: torch.Tensor,
    changed: torch.Tensor,
    *payloads: torch.Tensor,
    within: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Restore sortedness of ``x`` after a masked serial-queue update.

    ``x`` interleaves two individually-sorted runs: the ``changed`` events
    and the rest.  Each element's merged position is its rank within its
    own run plus a ``searchsorted`` count against the other run; ties place
    changed-run elements first (``side='left'`` for changed queries,
    ``'right'`` for the others).

    With ``within`` (a superset of ``changed``), only the ``within``
    subsequence is merged — its elements are redistributed over the
    ``within`` positions, everything else stays put.

    Returns ``(x, *payloads)`` permuted into the merged order.
    """
    n = x.shape[-1]
    w = torch.ones_like(changed) if within is None else within
    a = changed
    b = w & ~changed
    idx_a = _rank(a)
    idx_b = _rank(b)
    a_run = _scatter_drop(n, idx_a, a, x, float("inf")).contiguous()
    b_run = _scatter_drop(n, idx_b, b, x, float("inf")).contiguous()
    xc = x.contiguous()
    rank = torch.where(
        a,
        idx_a + torch.searchsorted(b_run, xc, out_int32=True),
        idx_b + torch.searchsorted(a_run, xc, right=True, out_int32=True),
    )
    iota = torch.arange(n, dtype=torch.int32, device=x.device).expand_as(rank)
    if within is None:
        pos = rank
    else:
        idx_w = _rank(w)
        w_pos = _scatter_drop(n, idx_w, w, iota, n)
        taken = torch.gather(w_pos, -1, rank.clamp(0, n - 1).to(torch.int64))
        pos = torch.where(w, taken, iota)
    pos = pos.to(torch.int64)
    return tuple(
        torch.zeros_like(p).scatter(-1, pos, p) for p in (x,) + payloads
    )


@axes("B,N", lead="N")
def two_run_merge(
    x: torch.Tensor, lead: torch.Tensor, *payloads: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Merge two interleaved sorted runs by rank arithmetic (no compaction).

    ``x`` (``[..., n]``) holds two individually-sorted runs per row, marked
    by the boolean ``lead`` mask (``[n]`` or ``x``'s shape); ties place
    ``lead`` elements first.  Each run is ranked against the forward-filled
    cumulative-max envelope of the other run in place: for a ``lead``
    element the merged rank is its own-run rank plus the count of other-run
    elements strictly below it, read off one ``searchsorted`` against the
    envelope plus a prefix count — the reference's formulation, bit for bit.

    Padding contract (the device pipeline's): entries keyed ``+inf`` in
    either run sort to the tail, ``lead``-run pads before the others, and
    never perturb the ranks of finite entries.

    Returns ``(x, *payloads)`` permuted into merged order.
    """
    n = x.shape[-1]
    a = lead.expand(x.shape)
    b = ~a
    ca = torch.cumsum(a.to(torch.int32), dim=-1, dtype=torch.int32)
    cb = torch.cumsum(b.to(torch.int32), dim=-1, dtype=torch.int32)
    neg = float("-inf")
    m_a = torch.cummax(torch.where(a, x, neg), dim=-1).values
    m_b = torch.cummax(torch.where(b, x, neg), dim=-1).values
    xc = x.contiguous()
    # a-queries count b-elements strictly below ('left': a first on ties);
    # b-queries count a-elements at-or-below ('right')
    pos_b = torch.searchsorted(m_b, xc)
    pos_a = torch.searchsorted(m_a, xc, right=True)
    cnt_b = torch.where(pos_b > 0, torch.gather(cb, -1, (pos_b - 1).clamp(min=0)), 0)
    cnt_a = torch.where(pos_a > 0, torch.gather(ca, -1, (pos_a - 1).clamp(min=0)), 0)
    rank = torch.where(a, (ca - 1) + cnt_b, (cb - 1) + cnt_a).to(torch.int64)
    # rank is a permutation of [0, n) in each row: invert once, gather every
    # payload
    iota = torch.arange(n, dtype=torch.int64, device=x.device).expand_as(rank)
    src = torch.empty_like(rank).scatter_(-1, rank, iota)
    return tuple(torch.gather(p, -1, src) for p in (x,) + payloads)


@axes("B,W")
def staging_sort(
    x: torch.Tensor, run_caps: Sequence[int], *payloads: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Sort R concatenated time-sorted runs, row by row.

    ``x`` (``[..., W]``) is the concatenation of ``len(run_caps)``
    individually-sorted runs, run ``r`` occupying the slice of width
    ``run_caps[r]`` (pad entries keyed ``+inf`` at each run's tail).  A
    ``ceil(log2 R)`` round tree of :func:`two_run_merge` calls over adjacent
    run pairs produces the fully-sorted order; ties keep the lower run
    first, so the result is **bitwise identical** to a host stable argsort
    of the run-major concatenation (all pads land at the global tail).

    Returns ``(x, *payloads)`` fully sorted.
    """
    caps = [int(c) for c in run_caps]
    if sum(caps) != x.shape[-1]:
        raise ValueError(f"run_caps {caps} do not tile length {x.shape[-1]}")
    arrs = (x,) + payloads
    runs = []
    off = 0
    for c in caps:
        if c:
            runs.append((off, c))
        off += c
    while len(runs) > 1:
        nxt = []
        pieces = [[] for _ in arrs]
        cursor = 0

        def flush_gap(lo, hi):
            if hi > lo:
                for j, p in enumerate(arrs):
                    pieces[j].append(p[..., lo:hi])

        for i in range(0, len(runs) - 1, 2):
            (s0, w0), (s1, w1) = runs[i], runs[i + 1]
            flush_gap(cursor, s0)
            lead = torch.arange(w0 + w1, device=x.device) < w0
            merged = two_run_merge(
                arrs[0][..., s0 : s1 + w1], lead, *(p[..., s0 : s1 + w1] for p in arrs[1:])
            )
            for j, m in enumerate(merged):
                pieces[j].append(m)
            nxt.append((s0, w0 + w1))
            cursor = s1 + w1
        if len(runs) % 2:
            nxt.append(runs[-1])
        flush_gap(cursor, x.shape[-1])
        arrs = tuple(torch.cat(ps, dim=-1) for ps in pieces)
        runs = nxt
    return arrs


def check_expand_rows(longest: int, n_bucket: int) -> None:
    """Refuse an expansion whose longest row does not fit the planes: the
    card reads the offsets only on the card, so its wrapper and the plain
    version both take the longest row from the caller's host offsets and
    raise the same ``ValueError`` here."""
    if int(longest) > int(n_bucket):
        raise ValueError(f"a row of {int(longest)} events exceeds the planes' {int(n_bucket)} slots")


@axes("E", offsets="R", pool="E", nbytes="E", weight="E", host="E", qos="E")
def expand_events(
    t: torch.Tensor,  # [E] f32, the rows' events in row order
    offsets: torch.Tensor,  # [B + 1] i32, row r's events at offsets[r]:offsets[r + 1]
    pool: torch.Tensor,  # [E] i32
    nbytes: torch.Tensor,  # [E] f32
    weight: torch.Tensor,  # [E] f32
    host: Optional[torch.Tensor],  # [E] i32, or None: no host plane
    qos: Optional[torch.Tensor],  # [E] i32, or None: no qos plane
    n_bucket: int,  # the planes' row length
    longest: int,  # the longest row's events, as the caller's host offsets give it
) -> Tuple[Optional[torch.Tensor], ...]:
    """The analyzer's padded planes from the compact staging: ``(t, pool,
    bytes, weight, host, qos, valid)``, each ``[B, n_bucket]`` (host and
    qos None when not given).  Row r holds its events in its prefix and
    ``valid`` marks them; every other slot is zero (False), as the host
    fill (``EventStager.stage``) leaves it.  ``longest`` above ``n_bucket``
    raises ``ValueError`` before any work, as the kernel's wrapper does
    (:func:`check_expand_rows`).  The compact path has no reference
    counterpart: the reference stages these planes on the host."""
    check_expand_rows(longest, n_bucket)
    counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
    valid = torch.arange(int(n_bucket), device=t.device)[None, :] < counts[:, None]

    def plane(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if x is None:
            return None
        out = torch.zeros(valid.shape, dtype=x.dtype, device=x.device)
        out[valid] = x  # row-major: each row's prefix, the rows in order
        return out

    return tuple(plane(x) for x in (t, pool, nbytes, weight, host, qos)) + (valid,)


@axes("B,W", idx_pack="B,W")
def chain_cascade(
    t_pack: torch.Tensor,  # [..., W] f32 depth-packed times (+inf pads per segment)
    idx_pack: torch.Tensor,  # [..., W] i32 original slot of each event (-1 pads)
    stts: Sequence[float],  # [D] service times in stage order (f32 values)
    seg_caps: Sequence[int],  # per-stage entry-segment capacities, sum == W
    scan=None,  # None: the arange scan; else fn(t, mask, stt) -> (start, delay)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact suffix cascade for nested-mask (chained) topologies.

    Eligibility (checked by ``plan_chain``): in deepest-first stage order
    every stage's route mask is a subset of the next stage's, so an event
    entering the fabric at depth ``d`` traverses every shallower switch on
    its way to the RC.  The working array ``A`` holds exactly the events
    that traverse the current stage; each stage folds in the time-sorted
    segment of events whose *deepest* switch it is with one
    :func:`two_run_merge`, and the stage's scan runs over ``A`` — its start
    times are non-decreasing, so ``A`` stays sorted.  Local-DRAM traffic
    never enters at all.

    Per-event final times are bitwise identical to
    :func:`serial_queue_cascade` on tie-free inputs.  (Exact-time ties
    *across* entry depths may resolve in a different — equally valid FIFO —
    order; per-stage delay sums then still agree.)

    Pads ride along keyed ``+inf`` with ``idx < 0``: merges keep them at the
    tail of every row, so after each merge a row's real events form its
    prefix.  The scan is the reference's unmasked one (``rank = arange``),
    or with ``scan`` a masked scan over ``mask = idx >= 0``
    (:func:`congestion_scan`'s contract; on the card the scan kernel):
    on a prefix the masked rank is the ``arange`` rank, and pads pass
    through unmasked, so the two agree bit for bit.

    Returns ``(t_fin [..., W], idx [..., W], per_stage_delay [..., D])``.
    """
    caps = [int(c) for c in seg_caps]
    if sum(caps) != t_pack.shape[-1]:
        raise ValueError(f"seg_caps {caps} do not tile length {t_pack.shape[-1]}")
    stt_values = [float(s) for s in stts]
    if len(stt_values) != len(caps):
        raise ValueError(f"{len(stt_values)} service times for {len(caps)} stages")
    a_t = t_pack[..., :0]
    a_i = idx_pack[..., :0]
    per_stage = []
    off = 0
    for p, cap in enumerate(caps):
        if cap:
            seg_t = t_pack[..., off : off + cap]
            seg_i = idx_pack[..., off : off + cap]
            if a_t.shape[-1] == 0:
                a_t, a_i = seg_t, seg_i
            else:
                w0 = a_t.shape[-1]
                lead = torch.arange(w0 + cap, device=t_pack.device) < w0
                a_t, a_i = two_run_merge(
                    torch.cat([a_t, seg_t], dim=-1), lead, torch.cat([a_i, seg_i], dim=-1)
                )
            off += cap
        if a_t.shape[-1] == 0:
            per_stage.append(t_pack.new_zeros(t_pack.shape[:-1]))
            continue
        stt = stt_values[p]
        real = a_i >= 0
        if scan is None:
            rankf = torch.arange(a_t.shape[-1], dtype=a_t.dtype, device=a_t.device)
            f = torch.cummax(a_t - stt * rankf, dim=-1).values
            start = f + stt * rankf
            d = torch.where(real, start - a_t, 0.0)
        else:
            start, d = scan(a_t.contiguous(), real.contiguous(), stt)
        per_stage.append(d.sum(dim=-1))
        a_t = torch.where(real, start, a_t)
    return a_t, a_i, torch.stack(per_stage, dim=-1)


def serial_queue_cascade(
    t_sorted: torch.Tensor,  # [..., N] f32, time-sorted arrivals per row
    route_bits: torch.Tensor,  # [..., N] i32, bit s set iff event crosses stage s
    stts: torch.Tensor,  # [S] f32, service times in stage order
    merge_plan: Optional[Sequence] = None,  # per-stage ((changed_bit, within_bit|None), ...)
    hosts: Optional[torch.Tensor] = None,  # [..., N] i32 host ids, input order
    n_hosts: int = 1,
):
    """Fused S-stage congestion cascade over time-sorted epochs.

    Runs every switch's serial queue (deepest stage first, encoded by the
    caller's stage order) over the same rows with **one** initial sort: each
    row is kept sorted (per stage mask) by *current* time, so each stage's
    scan sees true arrival order.

    ``merge_plan`` lists, per stage, the :func:`merge_sorted_runs` ops to
    run *before* that stage's scan (``None``: the conservative schedule — a
    whole-row two-run merge before every stage ``s > 0``, folding in stage
    ``s-1``'s events).  A row's merges are skipped while its cumulative
    delay is not positive.

    Returns ``(t_final [..., N], slot_idx [..., N] i32, per_stage_delay
    [..., S])``: ``t_final[k]`` is the post-congestion time of the event
    originally at sorted position ``slot_idx[k]``.

    With ``hosts`` (per-event host ids in the same order as ``t_sorted``),
    ``per_stage_delay`` is host-segmented to ``[..., S, n_hosts]``: a
    stage's queueing delay is charged to the host whose event waited.
    Hosts are recovered through the live permutation (``hosts[idx]``), so
    the merges carry no extra payload.
    """
    dtype = t_sorted.dtype
    n = t_sorted.shape[-1]
    s_stages = int(stts.shape[0])
    if merge_plan is None:
        merge_plan = tuple(((s - 1, None),) if s else () for s in range(s_stages))
    big = _big(dtype)
    ts = t_sorted
    bits = route_bits.to(torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=ts.device).expand_as(bits)
    # cumulative delay per row: 0 => nothing ever moved
    dirty = torch.zeros(ts.shape[:-1] + (1,), dtype=dtype, device=ts.device)
    per_stage = []
    for s in range(s_stages):
        for changed_bit, within_bit in merge_plan[s]:
            changed = ((bits >> changed_bit) & 1) == 1
            within = None if within_bit is None else ((bits >> within_bit) & 1) == 1
            m_ts, m_bits, m_idx = merge_sorted_runs(
                ts, changed, bits, idx, within=within
            )
            go = dirty > 0
            ts = torch.where(go, m_ts, ts)
            bits = torch.where(go, m_bits, bits)
            idx = torch.where(go, m_idx, idx)
        m = ((bits >> s) & 1) == 1
        stt = stts[s]
        rankf = _rank(m).to(dtype)
        g = torch.where(m, ts - stt * rankf, -big)
        f = torch.cummax(g, dim=-1).values
        start = torch.where(m, f + stt * rankf, ts)
        d = torch.where(m, start - ts, 0.0)
        dsum = d.sum(dim=-1, keepdim=True)
        if hosts is None:
            per_stage.append(dsum)
        else:
            # per-host sums accumulate in f64 (as the kernel's do), so their
            # rounding does not depend on the order a scatter-add takes
            h_cur = torch.gather(hosts, -1, idx.to(torch.int64)).to(torch.int64)
            seg = torch.zeros(
                ts.shape[:-1] + (n_hosts,), dtype=torch.float64, device=ts.device
            )
            per_stage.append(seg.scatter_add_(-1, h_cur, d.to(torch.float64)).to(dtype))
        dirty = dirty + dsum
        ts = torch.where(m, start, ts)
    if hosts is not None:
        psd = torch.stack(per_stage, dim=-2) if per_stage else torch.zeros(
            ts.shape[:-1] + (0, n_hosts), dtype=dtype, device=ts.device
        )
    elif per_stage:
        psd = torch.cat(per_stage, dim=-1)
    else:
        psd = torch.zeros(ts.shape[:-1] + (0,), dtype=dtype, device=ts.device)
    return ts, idx.contiguous(), psd


# --------------------------------------------------------------------------- #
# QoS arbitration cascades
# --------------------------------------------------------------------------- #


def qos_service_table(
    stts: torch.Tensor,  # [S] f32 service times in stage order
    disc_code: torch.Tensor,  # [S] i32 DISC_* codes
    class_weights: torch.Tensor,  # [S, C] per-stage class weights
) -> torch.Tensor:
    """``[S, C]`` f32 service time of each (stage, class) queue: ``(stt·W) /
    w_c`` under WFQ, ``W`` the f32 sum of the stage's weights in class
    order, and ``stt`` under FIFO and priority.  The plain cascades and the
    kernel's wrapper both take their service times from here, so they
    start from the same f32 values."""
    stts = stts.to(torch.float32)
    w = class_weights.to(device=stts.device, dtype=torch.float32)
    total = w[:, 0]
    for c in range(1, w.shape[1]):
        total = total + w[:, c]
    wfq = (disc_code.to(stts.device) == DISC_WFQ)[:, None]
    return torch.where(wfq, (stts * total)[:, None] / w, stts[:, None]).contiguous()


def _class_delays(
    d: torch.Tensor,  # [..., N] per-slot delay
    q_cur: torch.Tensor,  # [..., N] actual class of the event in each slot
    idx: torch.Tensor,  # [..., N] slot -> input position
    hosts: Optional[torch.Tensor],  # [..., N] host ids in input order
    n_hosts: int,
    n_classes: int,
) -> torch.Tensor:
    """``[..., H, C]`` delay sums by (host, class), accumulated in f64 (as
    the kernel's are) and rounded to ``d``'s type."""
    seg = q_cur.to(torch.int64)
    if hosts is not None:
        h = torch.gather(hosts, -1, idx.to(torch.int64)).to(torch.int64)
        seg = h * n_classes + seg
    out = torch.zeros(
        d.shape[:-1] + (n_hosts * n_classes,), dtype=torch.float64, device=d.device
    )
    out.scatter_add_(-1, seg, d.to(torch.float64))
    return out.to(d.dtype).view(d.shape[:-1] + (n_hosts, n_classes))


def _qos_fold(ts, bits, idx, qos, s, n_classes, dirty, fifo_like):
    """Restore sortedness after stage ``s``'s per-class scans (the static
    spec's fold): ``C`` sequential :func:`merge_sorted_runs` calls, step
    ``c`` merging class ``c``'s run *within* the subsequence that excludes
    the not-yet-folded classes ``> c``.  ``fifo_like`` treats every event
    as class 0, which makes step 0 the conservative full two-run merge and
    the rest identities.  Rows whose cumulative delay is not positive keep
    their order."""
    go = dirty > 0
    for c in range(n_classes):
        m_cur = ((bits >> s) & 1) == 1
        q_cur = torch.gather(qos, -1, idx.to(torch.int64))
        if fifo_like:
            q_cur = torch.zeros_like(q_cur)
        changed = m_cur & (q_cur == c)
        within = ~(m_cur & (q_cur > c))
        m_ts, m_bits, m_idx = merge_sorted_runs(ts, changed, bits, idx, within=within)
        ts = torch.where(go, m_ts, ts)
        bits = torch.where(go, m_bits, bits)
        idx = torch.where(go, m_idx, idx)
    return ts, bits, idx


def qos_serial_queue_cascade(
    t_sorted: torch.Tensor,  # [..., N] f32, time-sorted arrivals per row
    route_bits: torch.Tensor,  # [..., N] i32, bit s set iff event crosses stage s
    stts: torch.Tensor,  # [S] f32, service times in stage order
    qos: torch.Tensor,  # [..., N] i32 QoS class per event, input order
    class_weights: torch.Tensor,  # [S, C] per-stage WFQ class weights
    disciplines: Sequence[str],  # one of "fifo" | "priority" | "wfq" per stage
    merge_plan: Optional[Sequence] = None,  # forwarded to the all-FIFO path
    hosts: Optional[torch.Tensor] = None,  # [..., N] i32 host ids, input order
    n_hosts: int = 1,
):
    """QoS-arbitrated S-stage cascade with static disciplines (the spec the
    data-driven :func:`qos_cascade_dyn` is held to).

    * ``fifo`` — the plain serial queue;
    * ``priority`` — strict priority, FIFO within class (class 0 highest):
      an event of class ``c`` starts as the FIFO scan over the classes
      ``<= c`` says — it waits behind every earlier higher-or-equal arrival
      and is invisible to them;
    * ``wfq`` — class ``c`` is its own FIFO queue with service time
      ``stt·W / w_c`` (the fluid GPS limit: a ``w_c / W`` bandwidth share).

    With every stage ``fifo`` this takes exactly the
    :func:`serial_queue_cascade` path (its merge schedule and scan
    arithmetic), so final times and slot indices are bitwise equal; the
    class only splits the delays.  Otherwise every stage but the last is
    followed by the per-class fold of :func:`_qos_fold`.

    Returns ``(t_final [..., N], slot_idx [..., N], per_stage_delay)``, the
    delays ``[..., S, C]`` (``[..., S, n_hosts, C]`` with ``hosts``),
    charged to the (host, class) whose event waited.
    """
    dtype = t_sorted.dtype
    n = t_sorted.shape[-1]
    s_stages = int(stts.shape[0])
    n_classes = int(class_weights.shape[-1])
    disciplines = tuple(disciplines)
    if len(disciplines) != s_stages:
        raise ValueError(f"{len(disciplines)} disciplines for {s_stages} stages")
    codes = []
    for d in disciplines:
        if d not in ("fifo", "priority", "wfq"):
            raise ValueError(f"unknown discipline {d!r}")
        codes.append(("fifo", "priority", "wfq").index(d))
    all_fifo = all(d == "fifo" for d in disciplines)
    if merge_plan is None:
        merge_plan = tuple(((s - 1, None),) if s else () for s in range(s_stages))
    table = qos_service_table(
        stts, torch.tensor(codes, dtype=torch.int32, device=stts.device), class_weights
    )
    ts = t_sorted
    bits = route_bits.to(torch.int32)
    qos = qos.to(torch.int32).clamp(0, n_classes - 1)
    idx = torch.arange(n, dtype=torch.int32, device=ts.device).expand_as(bits)
    if hosts is None:
        n_hosts = 1
    dirty = torch.zeros(ts.shape[:-1] + (1,), dtype=dtype, device=ts.device)
    per_stage = []
    for s in range(s_stages):
        if all_fifo:
            # serial_queue_cascade's merge schedule, bitwise
            for changed_bit, within_bit in merge_plan[s]:
                changed = ((bits >> changed_bit) & 1) == 1
                within = None if within_bit is None else ((bits >> within_bit) & 1) == 1
                m_ts, m_bits, m_idx = merge_sorted_runs(
                    ts, changed, bits, idx, within=within
                )
                go = dirty > 0
                ts = torch.where(go, m_ts, ts)
                bits = torch.where(go, m_bits, bits)
                idx = torch.where(go, m_idx, idx)
        m = ((bits >> s) & 1) == 1
        q_cur = torch.gather(qos, -1, idx.to(torch.int64))
        disc = disciplines[s]
        if disc == "fifo":
            start = serial_queue(ts, m, stts[s])
        elif disc == "priority":
            start = ts
            for lvl in range(n_classes):
                sc = serial_queue(ts, m & (q_cur <= lvl), stts[s])
                start = torch.where(m & (q_cur == lvl), sc, start)
        else:
            start = ts
            for c in range(n_classes):
                M = m & (q_cur == c)
                start = torch.where(M, serial_queue(ts, M, table[s, c]), start)
        d = torch.where(m, start - ts, 0.0)
        dsum = d.sum(dim=-1, keepdim=True)
        if hosts is None and n_classes == 1:
            per_stage.append(dsum)  # the FIFO cascade's own sum, bitwise
        else:
            per_stage.append(_class_delays(d, q_cur, idx, hosts, n_hosts, n_classes))
        dirty = dirty + dsum
        ts = torch.where(m, start, ts)
        if not all_fifo and s < s_stages - 1:
            ts, bits, idx = _qos_fold(
                ts, bits, idx, qos, s, n_classes, dirty, fifo_like=(disc == "fifo")
            )
    if hosts is None and n_classes == 1:
        psd = torch.stack(per_stage, dim=-2)  # [..., S, 1]
    else:
        psd = torch.stack(per_stage, dim=-3)
        if hosts is None:
            psd = psd[..., 0, :]
    return ts, idx.contiguous(), psd


def _f32_sort_key(ts: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 image of an f32 tensor: non-negative floats'
    bit patterns are already monotone, negatives get their magnitude bits
    flipped so that more negative sorts lower."""
    x = ts.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(x >= 0, x, x ^ 0x7FFFFFFF)


def _qos_rank_fold(ts, bits, idx, run_id, n_runs):
    """Restore time order after a stage by ONE stable multi-run merge.

    Each row interleaves ``n_runs`` individually sorted runs (the per-class
    start-time runs and the untouched events).  An element's merged
    position is its rank in its own run plus, for every other run ``j``,
    the run-``j`` elements that precede it: with ``a`` the run-``j`` keys
    below its key, ``a2`` those at or below, and ``pc`` the run-``j``
    elements at earlier array positions, that count is ``clamp(pc, a,
    a2)`` — tied elements keep their array order.  That is the DES heap's
    tie rule (push order, which is the previous stage's processing order).
    ``a`` and ``a2`` are ``searchsorted`` counts against run ``j``'s cummax
    key envelope (within a run, keys never decrease along the row)."""
    key = _f32_sort_key(ts)
    neg = torch.iinfo(torch.int32).min
    pos = torch.zeros_like(key)
    for j in range(n_runs):
        mj = run_id == j
        env = torch.cummax(torch.where(mj, key, neg), dim=-1).values.contiguous()
        pcj = torch.cumsum(mj.to(torch.int32), dim=-1, dtype=torch.int32)  # inclusive
        counts = []
        for right in (False, True):
            p = torch.searchsorted(env, key, right=right)
            got = torch.gather(pcj, -1, (p - 1).clamp(min=0))
            counts.append(torch.where(p > 0, got, 0))
        stable = torch.minimum(torch.maximum(pcj, counts[0]), counts[1])
        pos = pos + torch.where(mj, pcj - 1, stable)
    pos = pos.to(torch.int64)
    return tuple(torch.zeros_like(x).scatter(-1, pos, x) for x in (ts, bits, idx))


@axes(
    "B,N", route_bits="B,N", stts="S", qos="B,N", disc_code="S", class_weights="S,C",
    hosts="B,N",
)
def qos_cascade_dyn(
    t_sorted: torch.Tensor,  # [..., N] f32, time-sorted arrivals per row
    route_bits: torch.Tensor,  # [..., N] i32, bit s set iff event crosses stage s
    stts: torch.Tensor,  # [S] f32, service times in stage order
    qos: torch.Tensor,  # [..., N] i32 QoS class per event, input order
    disc_code: torch.Tensor,  # [S] i32 DISC_* code per stage
    class_weights: torch.Tensor,  # [S, C] per-stage class weights
    hosts: Optional[torch.Tensor] = None,  # [..., N] i32 host ids, input order
    n_hosts: int = 1,
):
    """Data-driven QoS cascade: disciplines and weights are operands (the
    plain version of the QoS cascade kernel).

    Per stage ``s`` with nonzero service, ``C`` per-class closed-form scans
    (:func:`serial_queue`): class ``c``'s queue holds the stage's events with
    ``q_eff <= c`` under priority and ``q_eff == c`` otherwise, ``q_eff``
    being the event's class (0 for every event at a FIFO stage), with the
    service time of :func:`qos_service_table`; an event starts as its own
    class's scan says.  A zero-service stage is an identity (the DES never
    queues there).  Delays are charged to the event's *actual* class.

    After every stage but the last, rows whose cumulative delay is positive
    are re-sorted by the stable rank fold :func:`_qos_rank_fold` over the
    ``C + 1`` runs (the stage's events keyed by ``q_eff``, then the untouched
    ones) — unless the next stage is WFQ over the same events of the row
    (WFQ reads only each class's own subsequence, which every stage leaves
    sorted) or is the last stage and serves in zero time.

    The schedule (stable fold, fold elision, zero-service skip, cumulative
    guard) is that of the reference's ``qos_cascade_dyn``; the per-stage
    arithmetic is the FIFO cascade's closed form, class by class.

    Returns ``(t_final [..., N], slot_idx [..., N] i32, per_stage_delay
    [..., S, H, C])`` with ``H = n_hosts`` (1 without ``hosts``).
    """
    dtype = t_sorted.dtype
    n = t_sorted.shape[-1]
    s_stages = int(stts.shape[0])
    n_classes = int(class_weights.shape[-1])
    ts = t_sorted
    bits = route_bits.to(torch.int32)
    qos = qos.to(torch.int32).clamp(0, n_classes - 1)
    idx = torch.arange(n, dtype=torch.int32, device=ts.device).expand_as(bits)
    if hosts is None:
        n_hosts = 1
    codes = [int(x) for x in disc_code.tolist()]
    served = [float(x) > 0 for x in stts.tolist()]
    table = qos_service_table(stts, disc_code, class_weights)
    # cumulative delay per row, f64 as the kernel's: 0 => nothing moved
    dirty = torch.zeros(ts.shape[:-1] + (1,), dtype=torch.float64, device=ts.device)
    per_stage = []
    for s in range(s_stages):
        m = ((bits >> s) & 1) == 1
        q_cur = torch.gather(qos, -1, idx.to(torch.int64))
        q_eff = torch.zeros_like(q_cur) if codes[s] == DISC_FIFO else q_cur
        if served[s]:
            start = ts
            for c in range(1 if codes[s] == DISC_FIFO else n_classes):
                sel = (q_eff <= c) if codes[s] == DISC_PRIORITY else (q_eff == c)
                sc = serial_queue(ts, m & sel, table[s, c])
                start = torch.where(m & (q_eff == c), sc, start)
            d = torch.where(m, start - ts, 0.0)
            ts = torch.where(m, start, ts)
        else:
            d = torch.zeros_like(ts)
        per_stage.append(_class_delays(d, q_cur, idx, hosts, n_hosts, n_classes))
        dirty = dirty + d.to(torch.float64).sum(dim=-1, keepdim=True)
        if s == s_stages - 1:
            break
        nxt = ((bits >> (s + 1)) & 1) == 1
        if codes[s + 1] == DISC_WFQ:
            skip = (nxt == m).all(dim=-1, keepdim=True)
        else:
            skip = torch.zeros_like(dirty, dtype=torch.bool)
        if s + 1 == s_stages - 1 and not served[s + 1]:
            skip = torch.ones_like(skip)
        do_fold = (dirty > 0) & ~skip
        if not bool(do_fold.any()):
            continue
        run_id = torch.where(m, q_eff, n_classes)
        f_ts, f_bits, f_idx = _qos_rank_fold(ts, bits, idx, run_id, n_classes + 1)
        ts = torch.where(do_fold, f_ts, ts)
        bits = torch.where(do_fold, f_bits, bits)
        idx = torch.where(do_fold, f_idx, idx)
    if per_stage:
        psd = torch.stack(per_stage, dim=-3)
    else:
        psd = torch.zeros(
            ts.shape[:-1] + (0, n_hosts, n_classes), dtype=dtype, device=ts.device
        )
    return ts, idx.contiguous(), psd


# --------------------------------------------------------------------------- #
# partitioned mirrors of the cascade kernels
# --------------------------------------------------------------------------- #

KERNEL_TILE = 4096  # events a CTA of the cascade kernels takes at a time (kTile)
KERNEL_ITEMS = 8  # consecutive events a thread takes (kItems): segments are whole groups
# merge flags, one per (row, stage): what became of the merge (FIFO) or fold
# (QoS) before the stage's scan
MERGE_NONE = 0  # not run: stage 0, the cumulative-delay guard, or a fold elision
MERGE_RAN = 1
MERGE_SKIPPED = 2  # the guard asked for it, but it would have been the identity


def _lower_bound(x: torch.Tensor, value: float) -> int:
    """First index of the sorted 1-D ``x`` whose value is ``>= value``, by
    the kernels' bisection."""
    lo, hi = 0, int(x.shape[0])
    while lo < hi:
        mid = (lo + hi) // 2
        if float(x[mid]) < value:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _live_length(t: torch.Tensor, bits: torch.Tensor) -> int:
    """How many events of a row the kernels process: those before the first
    time ``>= finfo.max/4`` (one bisection), provided every event from there
    on is a pad (such a time, no route bit); otherwise the whole row.  Pads
    never queue and sort last through every merge, so they stay in place."""
    big = _big(t.dtype)
    cut = _lower_bound(t, big)
    if bool((bits[cut:] != 0).any()) or bool((t[cut:] < big).any()):
        return int(t.shape[0])
    return cut


def _segments(n: int, k: int):
    """CTA ``r`` of ``k`` takes events ``[lo_r, hi_r)`` of ``n``: slices of
    ``ceil(n / k)`` rounded up to whole groups of ``KERNEL_ITEMS``, the last
    ones short or empty."""
    step = -(-(-(-n // k)) // KERNEL_ITEMS) * KERNEL_ITEMS
    return [(min(r * step, n), min(r * step + step, n)) for r in range(k)]


def _partitioned_scan(ts, mask, stt, segs):
    """One masked FIFO scan over a row split into segments, as the kernels
    run it.  Each segment first counts its masked events: the counts of the
    earlier segments (an exact int32 prefix) are its rank base.  Then it
    takes the max of ``t - stt*rank`` over its events at those global ranks
    (a max is exact in any order).  Then it writes its starts from its own
    running max and the max over the earlier segments.  So any split gives
    the serial scan bitwise: nothing is rebased after rounding."""
    neg = torch.tensor(float("-inf"), dtype=ts.dtype, device=ts.device)
    counts = [int(mask[lo:hi].sum()) for lo, hi in segs]
    out, carry, base = ts.clone(), neg, 0
    for (lo, hi), count in zip(segs, counts):
        if hi == lo:
            continue
        m = mask[lo:hi]
        mi = m.to(torch.int32)
        rank = base + torch.cumsum(mi, 0, dtype=torch.int32) - mi
        p = stt * rank.to(ts.dtype)
        g = torch.where(m, ts[lo:hi] - p, neg)
        f = torch.maximum(torch.cummax(g, 0).values, carry)
        out[lo:hi] = torch.where(m, f + p, ts[lo:hi])
        carry = torch.maximum(carry, g.max())
        base += count
    return out


def _fold_sum(d: torch.Tensor, segs) -> float:
    """A stage's delay: each segment's f64 sum, folded in segment order (the
    kernels' deterministic cross-CTA fold)."""
    total = 0.0
    for lo, hi in segs:
        total += float(d[lo:hi].to(torch.float64).sum())
    return total


def _fifo_merge_is_identity(ts, changed) -> bool:
    """True when merging the ``changed`` run back into the rest (ties:
    changed first) would leave the row as it is: no event is earlier than
    the one before it (float ``<``, so -0.0 ties +0.0), and no tied pair has
    an untouched event directly before a changed one.  The kernels check
    every adjacent pair: inside a segment, and across each boundary from the
    neighbours' published ends."""
    x, y = ts[:-1], ts[1:]
    bad = (y < x) | ((y == x) & ~changed[:-1] & changed[1:])
    return not bool(bad.any())


def _keys_ordered(ts) -> bool:
    """True when the row is non-decreasing by ``_f32_sort_key`` (so -0.0
    sorts before +0.0): the QoS fold, a stable sort by that key, would then
    be the identity."""
    key = _f32_sort_key(ts)
    return not bool((key[1:] < key[:-1]).any())


def _merge_path(a_key, b_key, segs, tile):
    """Where each element of two sorted runs lands in their merge, ties
    putting run a first, found as the kernels find it.  The output is cut
    into tiles of ``tile`` inside each CTA's range ``segs``; each tile
    boundary ``d`` is split by one bisection into ``i`` elements of a and
    ``d - i`` of b (the smallest ``i`` whose a element does not precede
    b's ``d - i - 1``-th); inside a tile an element lands at its index in
    its own slice plus the elements of the other slice before it.  Returns
    ``(pos_a, pos_b)``."""
    na, nb = int(a_key.shape[0]), int(b_key.shape[0])
    dev = a_key.device
    cuts = {0}
    for lo, hi in segs:
        cuts.update(range(lo, hi, tile))
        cuts.add(hi)
    d = torch.tensor(sorted(cuts), dtype=torch.int64, device=dev)
    lo = (d - nb).clamp(min=0)
    hi = torch.clamp(d, max=na)
    while True:
        act = lo < hi
        if not bool(act.any()):
            break
        mid = (lo + hi) // 2
        ai = mid.clamp(0, max(na - 1, 0))
        bi = (d - 1 - mid).clamp(0, max(nb - 1, 0))
        before = a_key[ai] <= b_key[bi]
        lo = torch.where(act & before, mid + 1, lo)
        hi = torch.where(act & ~before, mid, hi)
    ia, ib = lo, d - lo

    def place(own, other, own_cut, other_cut, right):
        i = torch.arange(own.shape[0], dtype=torch.int64, device=dev)
        j = torch.searchsorted(own_cut, i, right=True) - 1
        below = torch.searchsorted(other, own, right=right).to(torch.int64)
        inside = torch.minimum(torch.maximum(below, other_cut[j]), other_cut[j + 1])
        return d[j] + (i - own_cut[j]) + (inside - other_cut[j])

    return place(a_key, b_key, ia, ib, False), place(b_key, a_key, ib, ia, True)


def _merge_into(pa, pb, a_vals, b_vals):
    out = []
    for xa, xb in zip(a_vals, b_vals):
        y = torch.empty(xa.shape[0] + xb.shape[0], dtype=xa.dtype, device=xa.device)
        y[pa] = xa
        y[pb] = xb
        out.append(y)
    return out


def _fifo_row(t, bits, stts, k, hosts, n_hosts, tile):
    n, s_stages = int(t.shape[0]), int(stts.shape[0])
    live = _live_length(t, bits)
    segs = _segments(live, k)
    ts, b = t[:live], bits[:live]
    idx = torch.arange(live, dtype=torch.int32, device=t.device)
    flags = torch.zeros(s_stages, dtype=torch.int8)
    psd, dirty = [], 0.0
    for s in range(s_stages):
        m = ((b >> s) & 1) == 1
        start = _partitioned_scan(ts, m, stts[s], segs)
        d = torch.where(m, start - ts, 0.0)
        stage = _fold_sum(d, segs)
        if hosts is None:
            psd.append(torch.tensor([stage], dtype=t.dtype, device=t.device))
        else:
            h = hosts[:live][idx.to(torch.int64)].to(torch.int64)
            acc = torch.zeros(n_hosts, dtype=torch.float64, device=t.device)
            psd.append(acc.scatter_add_(0, h, d.to(torch.float64)).to(t.dtype))
        dirty += stage
        ts = start
        if s + 1 < s_stages and dirty > 0:
            if _fifo_merge_is_identity(ts, m):
                flags[s + 1] = MERGE_SKIPPED
                continue
            a, rest = m, ~m
            pa, pb = _merge_path(ts[a], ts[rest], segs, tile)
            ts, b, idx = _merge_into(pa, pb, (ts[a], b[a], idx[a]), (ts[rest], b[rest], idx[rest]))
            flags[s + 1] = MERGE_RAN
    tail = torch.arange(live, n, dtype=torch.int32, device=t.device)
    psd = torch.stack(psd) if psd else torch.zeros((0, n_hosts), dtype=t.dtype, device=t.device)
    return torch.cat([ts, t[live:]]), torch.cat([idx, tail]), psd, flags


def serial_queue_cascade_partitioned(
    t_sorted: torch.Tensor,  # [..., N] f32, time-sorted arrivals per row
    route_bits: torch.Tensor,  # [..., N] i32, bit s set iff event crosses stage s
    stts: torch.Tensor,  # [S] f32, service times in stage order
    ctas: int,  # CTAs per row
    hosts: Optional[torch.Tensor] = None,  # [..., N] i32 host ids, input order
    n_hosts: int = 1,
    tile: int = KERNEL_TILE,
):
    """:func:`serial_queue_cascade` (``merge_plan=None``) computed the way
    the cascade kernel splits a row between ``ctas`` CTAs: pads cut off
    (:func:`_live_length`), each stage's scan by :func:`_partitioned_scan`,
    each merge by merge path (:func:`_merge_path`), and a merge skipped when
    it would be the identity.  Returns ``(t_final, slot_idx,
    per_stage_delay, merge_flags [..., S] int8)``: the first three are the
    plain version's (``slot_idx`` and ``t_final`` bitwise; each stage's
    delay summed in f64 by segment), the flags are ``MERGE_*``.  For tests
    and ``chip_smoke.py``; a Python loop over rows."""
    n = t_sorted.shape[-1]
    lead = t_sorted.shape[:-1]
    t2 = t_sorted.reshape(-1, n)
    b2 = route_bits.to(torch.int32).reshape(-1, n)
    h2 = None if hosts is None else hosts.reshape(-1, n)
    rows = [
        _fifo_row(t2[r], b2[r], stts, int(ctas), None if h2 is None else h2[r], n_hosts, tile)
        for r in range(t2.shape[0])
    ]
    tf, idx, psd, flags = (torch.stack([row[i] for row in rows]) for i in range(4))
    psd_shape = lead + ((stts.shape[0],) if hosts is None else (stts.shape[0], n_hosts))
    return (tf.reshape(t_sorted.shape), idx.reshape(t_sorted.shape), psd.reshape(psd_shape),
            flags.reshape(lead + (stts.shape[0],)))


def _qos_fold_partitioned(ts, bits, idx, run_id, n_runs, k, tile):
    """The stable multi-run fold of :func:`_qos_rank_fold` as the QoS kernel
    runs it: each run compacted in array order, then the non-empty runs
    merged one after the other by merge path, smallest first, keyed by
    (``_f32_sort_key``, array position): a total order in which every run is
    sorted, so the chain of two-way merges is the stable fold."""
    pos = torch.arange(ts.shape[0], dtype=torch.int64, device=ts.device)
    key = (_f32_sort_key(ts).to(torch.int64) << 32) | pos
    runs = [sel for sel in (run_id == j for j in range(n_runs)) if bool(sel.any())]
    runs.sort(key=lambda sel: int(sel.sum()))  # stable: ties keep run order
    cur = [x[runs[0]] for x in (key, ts, bits, idx)]
    for sel in runs[1:]:
        nxt = [x[sel] for x in (key, ts, bits, idx)]
        segs = _segments(int(cur[0].shape[0] + nxt[0].shape[0]), k)
        pa, pb = _merge_path(cur[0], nxt[0], segs, tile)
        cur = _merge_into(pa, pb, cur, nxt)
    return cur[1], cur[2], cur[3]


def _qos_row(t, bits, qos, stts, codes, served, table, k, hosts, n_hosts, n_classes, tile):
    n, s_stages = int(t.shape[0]), int(stts.shape[0])
    live = _live_length(t, bits)
    segs = _segments(live, k)
    ts, b = t[:live], bits[:live]
    q_in = qos[:live]
    h_in = None if hosts is None else hosts[:live]
    idx = torch.arange(live, dtype=torch.int32, device=t.device)
    flags = torch.zeros(s_stages, dtype=torch.int8)
    psd, dirty, ordered = [], 0.0, True
    for s in range(s_stages):
        m = ((b >> s) & 1) == 1
        q_cur = q_in[idx.to(torch.int64)]
        q_eff = torch.zeros_like(q_cur) if codes[s] == DISC_FIFO else q_cur
        if served[s]:
            start = ts
            for c in range(1 if codes[s] == DISC_FIFO else n_classes):
                sel = (q_eff <= c) if codes[s] == DISC_PRIORITY else (q_eff == c)
                sc = _partitioned_scan(ts, m & sel, table[s, c], segs)
                start = torch.where(m & (q_eff == c), sc, start)
            d = torch.where(m, start - ts, 0.0)
            ts = start
            ordered = _keys_ordered(ts)
        else:
            d = torch.zeros_like(ts)
        psd.append(_class_delays(d, q_cur, idx, h_in, n_hosts, n_classes))
        dirty += _fold_sum(d, segs)
        if s == s_stages - 1 or not dirty > 0:
            continue
        nxt = ((b >> (s + 1)) & 1) == 1
        if (s + 1 == s_stages - 1 and not served[s + 1]) or (
            codes[s + 1] == DISC_WFQ and bool((nxt == m).all())
        ):
            continue
        if ordered:
            flags[s + 1] = MERGE_SKIPPED
            continue
        run_id = torch.where(m, q_eff, n_classes)
        ts, b, idx = _qos_fold_partitioned(ts, b, idx, run_id, n_classes + 1, k, tile)
        ordered = True
        flags[s + 1] = MERGE_RAN
    tail = torch.arange(live, n, dtype=torch.int32, device=t.device)
    psd = torch.stack(psd) if psd else torch.zeros(
        (0, n_hosts, n_classes), dtype=t.dtype, device=t.device)
    return torch.cat([ts, t[live:]]), torch.cat([idx, tail]), psd, flags


def qos_cascade_partitioned(
    t_sorted: torch.Tensor,  # [..., N] f32, time-sorted arrivals per row
    route_bits: torch.Tensor,  # [..., N] i32, bit s set iff event crosses stage s
    stts: torch.Tensor,  # [S] f32, service times in stage order
    qos: torch.Tensor,  # [..., N] i32 QoS class per event, input order
    disc_code: torch.Tensor,  # [S] i32 DISC_* code per stage
    class_weights: torch.Tensor,  # [S, C] per-stage class weights
    ctas: int,  # CTAs per row
    hosts: Optional[torch.Tensor] = None,  # [..., N] i32 host ids, input order
    n_hosts: int = 1,
    tile: int = KERNEL_TILE,
):
    """:func:`qos_cascade_dyn` computed the way the QoS cascade kernel
    splits a row between ``ctas`` CTAs: pads cut off, each class's scan by
    :func:`_partitioned_scan`, each fold by :func:`_qos_fold_partitioned`,
    and a fold skipped when the row is already in key order.  Returns
    ``(t_final, slot_idx, per_stage_delay [..., S, H, C], merge_flags [...,
    S] int8)``, the first three the plain version's (``slot_idx`` and
    ``t_final`` bitwise).  For tests and ``chip_smoke.py``; a Python loop
    over rows."""
    n = t_sorted.shape[-1]
    lead = t_sorted.shape[:-1]
    n_classes = int(class_weights.shape[-1])
    if hosts is None:
        n_hosts = 1
    codes = [int(x) for x in disc_code.tolist()]
    served = [float(x) > 0 for x in stts.tolist()]
    table = qos_service_table(stts, disc_code, class_weights)
    t2 = t_sorted.reshape(-1, n)
    b2 = route_bits.to(torch.int32).reshape(-1, n)
    q2 = qos.to(torch.int32).clamp(0, n_classes - 1).reshape(-1, n)
    h2 = None if hosts is None else hosts.reshape(-1, n)
    rows = [
        _qos_row(t2[r], b2[r], q2[r], stts, codes, served, table, int(ctas),
                 None if h2 is None else h2[r], n_hosts, n_classes, tile)
        for r in range(t2.shape[0])
    ]
    tf, idx, psd, flags = (torch.stack([row[i] for row in rows]) for i in range(4))
    s_stages = int(stts.shape[0])
    return (tf.reshape(t_sorted.shape), idx.reshape(t_sorted.shape),
            psd.reshape(lead + (s_stages, n_hosts, n_classes)),
            flags.reshape(lead + (s_stages,)))


# --------------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------------- #


def mha_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Hk, Sk, D]
    v: torch.Tensor,  # [B, Hk, Sk, D]
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full-matrix GQA attention in f32 (the flash kernel's plain version),
    returned in q's dtype.  Query head h reads KV head ``h // (H // Hk)``.

    ``q_offset``: absolute position of q[0] (for decode: Sq = 1, offset =
    cache length), so causality is computed on absolute positions.  As in
    the reference, masked logits are ``-inf``: a row with no visible key
    is NaN here (the kernel returns 0 there).
    """
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    if H % Hk:
        raise ValueError(f"GQA needs H % Hk == 0, got H={H}, Hk={Hk}")
    g = H // Hk
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    f32 = torch.float32
    kk = k.to(f32).repeat_interleave(g, dim=1)
    vv = v.to(f32).repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), kk) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device)
        logits = logits.masked_fill(qpos[:, None] < kpos[None, :], float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vv).to(q.dtype)


def split_kv_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Hk, Sk, D]
    v: torch.Tensor,  # [B, Hk, Sk, D]
    split_len: int,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """The decode kernel's arithmetic in plain PyTorch, f32: the keys cut into
    splits of ``split_len``, each split's online-softmax partial (m, l, acc)
    with masked logits at -1e30 and masked keys adding exactly 0, then the
    splits merged by rescaling with ``exp(m_split - m)``.  Equals
    :func:`mha_attention` where a row sees a key; a row that sees none (or
    a split past its visible keys) contributes 0, as in the kernel.
    Returned in q's dtype."""
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    if H % Hk:
        raise ValueError(f"GQA needs H % Hk == 0, got H={H}, Hk={Hk}")
    if split_len <= 0:
        raise ValueError(f"split_len must be positive, got {split_len}")
    g = H // Hk
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    f32 = torch.float32
    qf = q.to(f32)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    ms, ls, accs = [], [], []
    for j0 in range(0, Sk, split_len):
        kk = k[:, :, j0:j0 + split_len].to(f32).repeat_interleave(g, dim=1)
        vv = v[:, :, j0:j0 + split_len].to(f32).repeat_interleave(g, dim=1)
        kpos = torch.arange(j0, j0 + kk.shape[2], device=q.device)
        visible = torch.ones((Sq, kk.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            visible = kpos[None, :] <= qpos[:, None]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale
        s = s.masked_fill(~visible, -1e30)
        m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)  # [B, H, Sq, 1]
        p = torch.exp(s - m).masked_fill(~visible, 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhqk,bhkd->bhqd", p, vv))
    if not ms:  # no key at all
        return torch.zeros_like(q)
    m_all = torch.stack(ms)  # [splits, B, H, Sq, 1]
    w = torch.exp(m_all - m_all.amax(dim=0))
    l_tot = (w * torch.stack(ls)).sum(dim=0)
    acc = (w * torch.stack(accs)).sum(dim=0)
    inv = torch.where(l_tot > 0, 1.0 / l_tot.clamp_min(1e-30), torch.zeros_like(l_tot))
    return (acc * inv).to(q.dtype)


# --------------------------------------------------------------------------- #
# Mamba2 SSD
# --------------------------------------------------------------------------- #


def ssd_naive(
    x: torch.Tensor,  # [B, L, H, P]   (P = head dim)
    dt: torch.Tensor,  # [B, L, H]      (softplus-activated step)
    A: torch.Tensor,  # [H]            (negative; per-head scalar decay rate)
    Bm: torch.Tensor,  # [B, L, N]      (input projection onto state, 1 group)
    Cm: torch.Tensor,  # [B, L, N]      (state readout, 1 group)
) -> torch.Tensor:
    """Sequential state-space recurrence (the exact semantics), in f32:

        h_t = exp(A·dt_t) ⊙ h_{t−1} + dt_t · B_t ⊗ x_t        h ∈ [N, P]
        y_t = C_t · h_t

    returned in x's dtype.
    """
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    xf, dtf, Bf, Cf = (a.to(f32) for a in (x, dt, Bm, Cm))
    decay = torch.exp(A.to(f32)[None, None, :] * dtf)  # [B, L, H]
    h = torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device)
    ys = []
    for t in range(L):
        inp = dtf[:, t, :, None, None] * (Bf[:, t, None, :, None] * xf[:, t, :, None, :])
        h = decay[:, t, :, None, None] * h + inp
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)  # [B, L, H, P]


def ssd_chunked(
    x: torch.Tensor,  # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H]
    A: torch.Tensor,  # [H]
    Bm: torch.Tensor,  # [B, L, N]
    Cm: torch.Tensor,  # [B, L, N]
    chunk: int = 64,
) -> torch.Tensor:
    """Chunked SSD (state-space duality), the blocked algorithm the kernel
    implements: quadratic attention-like math within chunks, linear state
    passing between chunks.  Must agree with :func:`ssd_naive`."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of chunk {chunk}")
    C = L // chunk
    f32 = torch.float32
    x_ = x.to(f32).reshape(Bsz, C, chunk, H, P)
    dt_ = dt.to(f32).reshape(Bsz, C, chunk, H)
    B_ = Bm.to(f32).reshape(Bsz, C, chunk, N)
    C_ = Cm.to(f32).reshape(Bsz, C, chunk, N)

    # per-position log decay a_t = A·dt_t, cumulative within the chunk
    acum = torch.cumsum(A.to(f32) * dt_, dim=2)  # [B, C, c, H]

    # ---- intra-chunk (quadratic, like masked attention) ------------------- #
    # y_intra[t] = sum_{s<=t} C_t·B_s dt_s exp(acum_t - acum_s) x_s; above the
    # diagonal the exponent is -inf before exp, never exp(...) masked after
    seg = acum[:, :, :, None, :] - acum[:, :, None, :, :]  # [B, C, t, s, H]
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    seg = seg.masked_fill(~tri[None, None, :, :, None], float("-inf"))
    G = torch.einsum("bctn,bcsn->bcts", C_, B_)  # [B, C, t, s]
    W = G[..., None] * torch.exp(seg) * dt_[:, :, None, :, :]  # [B, C, t, s, H]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", W, x_)

    # ---- chunk states ------------------------------------------------------ #
    # state_c = sum_s B_s dt_s exp(acum_last - acum_s) x_s, in [N, P]
    decay_to_end = torch.exp(acum[:, :, -1:, :] - acum)  # [B, C, c, H]
    S = torch.einsum("bcsn,bcshp->bchnp", B_, (dt_ * decay_to_end)[..., None] * x_)
    chunk_decay = torch.exp(acum[:, :, -1, :])  # [B, C, H]

    # ---- inter-chunk scan: the state entering each chunk ------------------- #
    h = torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device)
    h_prev = []
    for c in range(C):
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # [B, C, H, N, P]

    # ---- inter-chunk contribution: y_inter[t] = C_t · (exp(acum_t) h_prev) - #
    y_inter = torch.einsum("bctn,bchnp->bcthp", C_, h_prev) * torch.exp(acum)[..., None]
    return (y_intra + y_inter).reshape(Bsz, L, H, P).to(x.dtype)
