"""Plain PyTorch versions of the congestion kernels (port of
``repro/kernels/ref.py``): the fused cascade, single-host and
host-segmented, and the single-switch scan.

They define what the CUDA kernels (:mod:`repro_torch.kernels.congestion`)
compute.  The CPU tests hold them against the reference, ``chip_smoke.py``
holds the kernel against them on the card, and :mod:`.ops` runs them for
tensors that lie on the CPU.  On the card nothing on the main path calls
them.

Every function works on ``[..., N]`` tensors along the last dimension, so a
batch of epochs is a leading dimension (the reference's ``vmap``), and the
reference's ``lax.cond(dirty > 0, ...)`` becomes a per-row mask.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

__all__ = [
    "congestion_scan",
    "merge_sorted_runs",
    "serial_queue",
    "serial_queue_cascade",
]


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
