"""Memory-event traces and the region->pool allocation map.

Port of ``repro/core/events.py`` (numpy only; staged buffers bitwise equal
to the reference's).  The paper's Tracer has two halves:

  1. an *allocation* tracer (eBPF probes on mmap/sbrk/brk) that maintains a
     map from address ranges to memory pools, and
  2. an *event* tracer (PEBS) that samples memory operations.

Every logical tensor region of a step function is registered with a
:class:`RegionMap`; a placement policy assigns each region to a pool.  Event
traces are dense struct-of-arrays so the timing analyzer runs as batched
tensor ops.

Times inside a trace are **epoch-relative nanoseconds** (float).  Keeping
them epoch-relative bounds their magnitude (epochs are ms-scale), so float32
retains sub-ns resolution inside the analyzer; totals are accumulated
host-side in float64.

The stager's ring slots and packed planes (the device-resident pipeline)
and its stacked ``[K, B, N]`` planes (the analysis engine's coalesced
dispatch) are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "CACHELINE_BYTES",
    "PAGE_BYTES",
    "EventStager",
    "MemEvents",
    "Region",
    "RegionMap",
    "concat_events",
    "merge_host_traces",
    "split_by_host",
    "synthetic_trace",
]

CACHELINE_BYTES = 64
PAGE_BYTES = 4096
# synthetic-trace burst width as a *fraction* of the epoch (dimensionless
# tuning knob, not a ns conversion)
_BURST_SPREAD_FRAC = 1e-3


@dataclasses.dataclass(frozen=True)
class MemEvents:
    """A struct-of-arrays trace of memory events within one epoch.

    Attributes:
      t_ns:    [N] issue time, ns, relative to epoch start, non-decreasing
               not required (the analyzer sorts).
      pool:    [N] int32 pool index into the FlatTopology.
      bytes_:  [N] bytes moved by the event (a transaction may cover many
               cachelines; granularity is the policy's choice).
      is_write:[N] bool (writes may cost differently; coherency uses this).
      region:  [N] int32 region id (for migration/hotness accounting).
      weight:  [N] statistical multiplicity (1.0 exact; 1/rate under PEBS-style
               sampling so count-proportional delays stay unbiased).
      host:    [N] int32 attached-host index (0 for single-host simulation).
               In a shared-fabric session events from several hosts are merged
               onto one timeline; the analyzer routes each event through its
               (host, pool) pair so contention appears only at shared
               components.
      qos:     [N] int32 QoS class (0 = default / highest priority).  Switch
               arbiters running 'priority' or 'wfq' disciplines order their
               queues by this class; FIFO switches ignore it.
    """

    t_ns: np.ndarray
    pool: np.ndarray
    bytes_: np.ndarray
    is_write: np.ndarray
    region: np.ndarray
    weight: np.ndarray = None  # type: ignore[assignment]
    host: np.ndarray = None  # type: ignore[assignment]
    qos: np.ndarray = None  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.weight is None:
            object.__setattr__(self, "weight", np.ones((len(self.t_ns),), np.float64))
        if self.host is None:
            object.__setattr__(self, "host", np.zeros((len(self.t_ns),), np.int32))
        if self.qos is None:
            object.__setattr__(self, "qos", np.zeros((len(self.t_ns),), np.int32))
        n = len(self.t_ns)
        for f in ("pool", "bytes_", "is_write", "region", "weight", "host", "qos"):
            if len(getattr(self, f)) != n:
                raise ValueError(f"field {f} length mismatch")

    @property
    def n(self) -> int:
        return int(len(self.t_ns))

    @property
    def total_bytes(self) -> float:
        return float(self.bytes_.sum())

    def sorted_by_time(self) -> "MemEvents":
        # Monotone fast path: a stable argsort of a non-decreasing key is the
        # identity permutation, so an already-sorted trace (the tracer's
        # common case, and everything downstream of merge_host_traces) costs
        # one O(N) check instead of an argsort plus seven gathers.
        if self.n <= 1 or bool(np.all(self.t_ns[1:] >= self.t_ns[:-1])):
            return self
        order = np.argsort(self.t_ns, kind="stable")
        return self.take(order)

    def take(self, idx: np.ndarray) -> "MemEvents":
        return MemEvents(
            t_ns=self.t_ns[idx],
            pool=self.pool[idx],
            bytes_=self.bytes_[idx],
            is_write=self.is_write[idx],
            region=self.region[idx],
            weight=self.weight[idx],
            host=self.host[idx],
            qos=self.qos[idx],
        )

    def with_host(self, host: int) -> "MemEvents":
        """Copy with every event tagged as issued by ``host``."""
        return dataclasses.replace(
            self, host=np.full((self.n,), int(host), np.int32)
        )

    def with_qos(self, qos) -> "MemEvents":
        """Copy with events tagged as QoS class ``qos`` — a scalar (a
        tenant's whole trace usually shares one class) or a per-event
        array."""
        q = np.asarray(qos, np.int32)
        if q.ndim == 0:
            q = np.full((self.n,), int(q), np.int32)
        elif q.shape != (self.n,):
            raise ValueError(f"qos shape {q.shape} != ({self.n},)")
        return dataclasses.replace(self, qos=q)

    def sample(self, rate: float, seed: int = 0) -> "MemEvents":
        """PEBS-style sampling: keep each event with probability ``rate`` and
        scale bytes by 1/rate so aggregate traffic is preserved in expectation.
        """
        if not (0.0 < rate <= 1.0):
            raise ValueError("rate must be in (0, 1]")
        if rate == 1.0:
            return self
        rng = np.random.default_rng(seed)
        keep = rng.random(self.n) < rate
        out = self.take(np.nonzero(keep)[0])
        return dataclasses.replace(
            out, bytes_=out.bytes_ / rate, weight=out.weight / rate
        )

    @staticmethod
    def empty() -> "MemEvents":
        z = np.zeros((0,))
        return MemEvents(
            t_ns=z.astype(np.float64),
            pool=z.astype(np.int32),
            bytes_=z.astype(np.float64),
            is_write=z.astype(bool),
            region=z.astype(np.int32),
        )

    @staticmethod
    def build(
        t_ns: Iterable[float],
        pool: Iterable[int],
        bytes_: Iterable[float],
        is_write: Optional[Iterable[bool]] = None,
        region: Optional[Iterable[int]] = None,
        host: Optional[Iterable[int]] = None,
        qos: Optional[Iterable[int]] = None,
    ) -> "MemEvents":
        t = _as_column(t_ns, np.float64)
        p = _as_column(pool, np.int32)
        b = _as_column(bytes_, np.float64)
        w = (
            _as_column(is_write, bool)
            if is_write is not None
            else np.zeros(len(t), bool)
        )
        r = (
            _as_column(region, np.int32)
            if region is not None
            else np.zeros(len(t), np.int32)
        )
        h = (
            _as_column(host, np.int32)
            if host is not None
            else np.zeros(len(t), np.int32)
        )
        q = (
            _as_column(qos, np.int32)
            if qos is not None
            else np.zeros(len(t), np.int32)
        )
        return MemEvents(t, p, b, w, r, host=h, qos=q)


def _as_column(x, dtype) -> np.ndarray:
    """Coerce a build() input to a 1-D array without the list round-trip.

    ndarrays and plain sequences go straight to ``np.asarray`` (an O(copy)
    conversion, or free when dtype already matches); only true generators are
    materialized first.
    """
    if not isinstance(x, (np.ndarray, list, tuple)):
        x = list(x)
    return np.asarray(x, dtype)


def concat_events(traces: Sequence[MemEvents]) -> MemEvents:
    traces = [t for t in traces if t.n]
    if not traces:
        return MemEvents.empty()
    return MemEvents(
        t_ns=np.concatenate([t.t_ns for t in traces]),
        pool=np.concatenate([t.pool for t in traces]),
        bytes_=np.concatenate([t.bytes_ for t in traces]),
        is_write=np.concatenate([t.is_write for t in traces]),
        region=np.concatenate([t.region for t in traces]),
        weight=np.concatenate([t.weight for t in traces]),
        host=np.concatenate([t.host for t in traces]),
        qos=np.concatenate([t.qos for t in traces]),
    )


def merge_host_traces(
    traces: Sequence[MemEvents],
    hosts: Optional[Sequence[int]] = None,
) -> MemEvents:
    """Merge per-host epoch traces onto one shared fabric timeline.

    ``traces[i]`` is tagged with host ``hosts[i]`` (default: index ``i``) and
    the union is returned time-sorted, which is exactly the analyzer's staging
    contract: co-scheduled epochs start at the same fabric instant, so their
    epoch-relative times are directly comparable.
    """
    if hosts is None:
        hosts = range(len(traces))
    tagged = [tr.with_host(h) for tr, h in zip(traces, hosts)]
    return concat_events(tagged).sorted_by_time()


def split_by_host(trace: MemEvents, n_hosts: int) -> List[MemEvents]:
    """Inverse of :func:`merge_host_traces`: per-host sub-traces, order kept."""
    return [
        trace.take(np.nonzero(trace.host == h)[0]) for h in range(int(n_hosts))
    ]


# --------------------------------------------------------------------------- #
# Batched staging buffers — the analyzer's host-side feed path
# --------------------------------------------------------------------------- #


def _bucket_pow2(n: int, floor: int) -> int:
    v = max(int(floor), 1)
    while v < n:
        v *= 2
    return v


def _time_sorted(ev: "MemEvents") -> Tuple[np.ndarray, ...]:
    """``(t, pool, bytes, weight, host, qos)`` of a non-empty trace in time
    order: the columns themselves when the trace is monotone (one O(N)
    check), else gathered by one stable argsort."""
    cols = (ev.t_ns, ev.pool, ev.bytes_, ev.weight, ev.host, ev.qos)
    if np.all(ev.t_ns[1:] >= ev.t_ns[:-1]):
        return cols
    order = np.argsort(ev.t_ns, kind="stable")
    return tuple(c[order] for c in cols)


class EventStager:
    """Reusable host staging buffers for bucketed, batched epoch analysis.

    The epoch analyzer pads traces up to power-of-two buckets so repeated
    calls see the same shapes.  Doing that with ``np.pad`` allocates fresh
    arrays per epoch; the stager instead owns one buffer set per ``(batch,
    length)`` bucket and refills it in place — steady-state staging performs
    zero host allocations, and the float64 -> analyzer-dtype conversion
    happens once, during the fill.

    ``pin=True`` allocates every ``[B, N]`` plane as the numpy view of a
    page-locked torch tensor (``torch.zeros(..., pin_memory=True).numpy()``),
    once per bucket and slot, so the pipeline's H2D copies run
    asynchronously at pinned rates; it needs a card.  The stager itself
    stays host-only: a caller that copies a slot asynchronously hands it a
    fence (:meth:`fence`, anything with ``synchronize()``), and the stager
    waits on it before it fills that slot's planes again.

    The analyzer's default dispatch stages through :meth:`stage_compact`
    instead: only the real events, as flat 32-bit columns in one buffer of
    a ``slots``-deep ring sized by the batch's real events, page-locked
    when its copy goes to a card (its ``device``: ``pin`` here covers the
    ``[B, N]`` planes alone), and fenced by the copy that reads it.  The
    device writes the padded planes from it.

    Not thread-safe: every thread that stages must own its stager.  The
    shared :class:`~repro_torch.core.engine.AnalysisEngine` owns its stagers
    (all its staging happens on its one dispatcher thread); each
    :class:`~repro_torch.core.analyzer.EpochAnalyzer` keeps a private one for
    callers analyzing on their own thread — the two never share buffers.
    """

    _FIELDS = ("t", "pool", "bytes", "weight", "host", "qos", "valid")
    _COMPACT_DTYPES = {
        "t": np.float32, "pool": np.int32, "bytes": np.float32,
        "weight": np.float32, "host": np.int32, "qos": np.int32,
    }

    # dispatches a bucket's natural caps must sit at (or below) half the
    # sticky high-water mark before the sticky caps shrink to the recent
    # peak — a transient burst stops pinning peak-size staging planes (and
    # their dispatch-cache entries) after this many consecutive idle calls
    CAP_DECAY_CALLS = 8

    def __init__(
        self, time_dtype: object = np.float32, slots: int = 1, pin: bool = False
    ) -> None:
        self.time_dtype = np.dtype(time_dtype)
        # ``slots`` > 1 turns each bucket's buffer set into a ring: every
        # stage() call rotates to the next slot before filling, so a caller
        # overlapping H2D/compute of dispatch k with the staging of k+1
        # never overwrites host planes an in-flight transfer may still be
        # reading.
        self.slots = max(1, int(slots))
        self.pin = bool(pin)
        self._bufs: Dict[Tuple[int, int, int], Dict[str, np.ndarray]] = {}
        self._turn: Dict[Tuple[int, int], int] = {}
        self._pack_bufs: Dict[Tuple[int, int, int], Dict[str, np.ndarray]] = {}
        self._stack_bufs: Dict[Tuple[int, int, int], Dict[str, np.ndarray]] = {}
        self._stack_filled: Dict[Tuple[int, int, int], int] = {}
        self._cap_hwm: Dict[Tuple[int, int, int], Tuple[int, ...]] = {}
        # idle-decay state per cap key: consecutive calls whose natural caps
        # sat at <= half the sticky high-water mark, and the elementwise peak
        # of the natural caps observed during that streak
        self._cap_slack: Dict[Tuple[int, int, int], int] = {}
        self._cap_peak: Dict[Tuple[int, int, int], Tuple[int, ...]] = {}
        # the compact ring's slots, for the CPU and page-locked for a card
        # (stage_compact)
        self._compact: Dict[bool, List[Dict[str, object]]] = {}
        # per buffer set (by identity): the fence of its last asynchronous copy
        self._fences: Dict[int, object] = {}

    def _zeros(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        if not self.pin:
            return np.zeros(shape, dtype)
        # the numpy view keeps its pinned tensor alive
        return torch.zeros(
            shape, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype, pin_memory=True
        ).numpy()

    def fence(self, bufs: Sequence[Dict[str, np.ndarray]], done: object) -> None:
        """Mark buffer sets as read by an asynchronous copy that ``done``
        (anything with ``synchronize()``, such as a ``torch.cuda.Event``
        recorded after the copies) completes; the next fill of each waits
        on it."""
        for buf in bufs:
            self._fences[id(buf)] = done

    def _ready(self, buf: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        done = self._fences.pop(id(buf), None)
        if done is not None:
            done.synchronize()
        return buf

    def rotate(self, b_bucket: int, n_bucket: int) -> int:
        """Advance this bucket's ring and return the now-current slot."""
        key = (b_bucket, n_bucket)
        slot = (self._turn.get(key, self.slots - 1) + 1) % self.slots
        self._turn[key] = slot
        return slot

    def buffers(self, b_bucket: int, n_bucket: int) -> Dict[str, np.ndarray]:
        key = (b_bucket, n_bucket, self._turn.get((b_bucket, n_bucket), 0))
        buf = self._bufs.get(key)
        if buf is None:
            shape = (b_bucket, n_bucket)
            buf = {
                "t": self._zeros(shape, self.time_dtype),
                "pool": self._zeros(shape, np.int32),
                "bytes": self._zeros(shape, self.time_dtype),
                "weight": self._zeros(shape, self.time_dtype),
                "host": self._zeros(shape, np.int32),
                "qos": self._zeros(shape, np.int32),
                "valid": self._zeros(shape, bool),
                "span": np.zeros((b_bucket,), np.float64),
            }
            self._bufs[key] = buf
        return self._ready(buf)

    def stage(
        self,
        traces: Sequence["MemEvents"],
        b_bucket: int,
        n_bucket: int,
        qos: bool = True,
    ) -> Dict[str, np.ndarray]:
        """Fill (in place) and return the buffer set for this bucket.

        Every row is delivered **time-sorted** — the analyzer's one stable
        sort per epoch happens here, on the host, and only when a trace is
        not already monotone (the tracer emits sorted epochs, so the common
        case is a monotone check plus plain copies).  Rows beyond
        ``len(traces)`` — and the tail of every row beyond its trace's
        event count — are marked invalid; ``span`` holds each epoch's max
        issue time + 1 (0 for empty rows).  ``qos=False`` leaves the ``qos``
        plane as it was, for callers that do not read it (FIFO analyses).
        """
        if len(traces) > b_bucket:
            raise ValueError(f"{len(traces)} traces exceed batch bucket {b_bucket}")
        self.rotate(b_bucket, n_bucket)
        buf = self.buffers(b_bucket, n_bucket)
        self._fill_rows(buf, traces, b_bucket, qos)
        return buf

    def _pack_buffers(self, b_bucket: int, width: int) -> Dict[str, np.ndarray]:
        key = (b_bucket, width, self._turn.get((b_bucket, width), 0))
        buf = self._pack_bufs.get(key)
        if buf is None:
            buf = {
                "t": self._zeros((b_bucket, width), self.time_dtype),
                "idx": self._zeros((b_bucket, width), np.int32),
            }
            self._pack_bufs[key] = buf
        return self._ready(buf)

    def _drop_pack_width(self, b_bucket: int, width: int) -> None:
        """Free the packed buffer sets of a width that new caps superseded
        (after their last copies), unless a bucket still packs at it: held
        caps only change a few times, and page-locked sets must not pile up
        with each change."""
        if any(k[0] == b_bucket and sum(c) == width for k, c in self._cap_hwm.items()):
            return
        for key in [k for k in self._pack_bufs if k[:2] == (b_bucket, width)]:
            self._ready(self._pack_bufs.pop(key))

    def _hold_caps(
        self, cap_key: tuple, natural: Tuple[int, ...], cap_floor: int
    ) -> Tuple[Tuple[int, ...], Optional[Tuple[int, ...]]]:
        """Sticky capacities with idle decay; returns ``(held, previous)``.

        The held caps are the high-water mark of ``natural`` under
        ``cap_key``.  Once ``CAP_DECAY_CALLS`` consecutive calls need at most
        half the held caps, they shrink to the peak demand of that streak —
        a one-off burst stops pinning peak-size buffers forever, while a
        workload oscillating around the mark never shrinks (each touch of
        the high caps resets the streak, so decay costs at most one rebuild
        per genuine regime change)."""
        caps = natural
        prev = self._cap_hwm.get(cap_key)
        if prev is not None:
            # a stage held at the floor is idle only while its demand fits
            # the floor: the reference's ``p <= cap_floor`` alone keeps the
            # held caps when such a stage's demand grows, and that stage's
            # events then overrun its segment into the next one's
            idle = all(
                n <= p // 2 or n <= p <= cap_floor
                for n, p in zip(natural, prev)
            )
            if idle:
                peak = self._cap_peak.get(cap_key, natural)
                peak = tuple(max(a, b) for a, b in zip(peak, natural))
                streak = self._cap_slack.get(cap_key, 0) + 1
                if streak >= self.CAP_DECAY_CALLS:
                    caps = tuple(max(c, cap_floor) for c in peak)
                    self._cap_slack[cap_key] = 0
                    self._cap_peak.pop(cap_key, None)
                else:
                    caps = prev
                    self._cap_slack[cap_key] = streak
                    self._cap_peak[cap_key] = peak
            else:
                caps = tuple(max(c, p) for c, p in zip(natural, prev))
                self._cap_slack[cap_key] = 0
                self._cap_peak.pop(cap_key, None)
        self._cap_hwm[cap_key] = caps
        return caps, prev

    def stage_packed(
        self,
        traces: Sequence["MemEvents"],
        b_bucket: int,
        n_bucket: int,
        enter_stage: np.ndarray,
        n_stages: int,
        cap_floor: int = 16,
        qos: bool = True,
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], Tuple[int, ...]]:
        """Pipeline staging: the full planes of :meth:`stage` plus per-stage
        packed ``(t, idx)`` planes feeding the device-resident chain cascade.

        ``enter_stage[pool]`` gives the cascade stage position at which an
        event routed to ``pool`` first enters the fabric (-1 = local, never
        routed).  Because every staged row is time-sorted and extracting a
        per-stage subsequence preserves that order, each packed segment is
        already a sorted run — the merge into one fabric timeline happens on
        the device, with **zero host argsort** beyond the monotone check of
        :meth:`_fill_rows`.  Segment ``p`` occupies ``caps[p]`` slots (a
        power-of-two bucket of the batch-max count, shared across rows so
        the packed width is fixed per dispatch); pad slots carry
        ``t=+inf, idx=-1`` and sort harmlessly to every merge's tail.
        ``idx`` values are positions into the staged (sorted) full row.
        ``qos`` as for :meth:`stage`.  The caps are the reference's, call for
        call, but for one fault of its idle decay that the port repairs (a
        stage held at ``cap_floor`` whose demand grows ends the idle streak).
        """
        if len(traces) > b_bucket:
            raise ValueError(f"{len(traces)} traces exceed batch bucket {b_bucket}")
        self.rotate(b_bucket, n_bucket)
        buf = self.buffers(b_bucket, n_bucket)
        self._fill_rows(buf, traces, b_bucket, qos)
        enter = np.asarray(enter_stage, np.int32)
        n_stages = int(n_stages)
        counts = np.zeros((max(len(traces), 1), n_stages), np.int64)
        depth_rows: List[np.ndarray] = []
        for row, ev in enumerate(traces):
            d = enter[buf["pool"][row, : ev.n]]
            depth_rows.append(d)
            routed = d >= 0
            if routed.any():
                counts[row, :] = np.bincount(d[routed], minlength=n_stages)
        caps = tuple(
            _bucket_pow2(int(counts[:, p].max()), cap_floor)
            for p in range(n_stages)
        )
        # sticky caps: hold the high-water mark within a (batch, length)
        # bucket, so the packed width — and with it the dispatch-cache key —
        # stabilizes after the first few dispatches instead of flapping with
        # each epoch's depth distribution (zero steady-state rebuilds)
        caps, prev = self._hold_caps((b_bucket, n_bucket, n_stages), caps, cap_floor)
        width = int(sum(caps))
        if prev is not None and sum(prev) != width:
            self._drop_pack_width(b_bucket, int(sum(prev)))
        self._turn[(b_bucket, width)] = self._turn.get((b_bucket, n_bucket), 0)
        pack = self._pack_buffers(b_bucket, width)
        pack["t"].fill(np.inf)
        pack["idx"].fill(-1)
        for row, d in enumerate(depth_rows):
            off = 0
            for p in range(n_stages):
                sel = np.flatnonzero(d == p)
                m = sel.shape[0]
                pack["t"][row, off : off + m] = buf["t"][row, sel]
                pack["idx"][row, off : off + m] = sel
                off += caps[p]
        return buf, pack, caps

    @staticmethod
    def _fill_rows(
        buf: Dict[str, np.ndarray],
        traces: Sequence["MemEvents"],
        b_bucket: int,
        with_qos: bool = True,
    ) -> None:
        """Fill one ``[B, N]`` buffer view."""
        for row in range(b_bucket):
            ev = traces[row] if row < len(traces) else None
            n = ev.n if ev is not None else 0
            if n:
                t, pool, nbytes, weight, host, qos = _time_sorted(ev)
                buf["t"][row, :n] = t
                buf["pool"][row, :n] = pool
                buf["bytes"][row, :n] = nbytes
                buf["weight"][row, :n] = weight
                buf["host"][row, :n] = host
                if with_qos:
                    buf["qos"][row, :n] = qos
                buf["valid"][row, :n] = True
                buf["span"][row] = float(t[-1]) + 1.0
            else:
                buf["span"][row] = 0.0
            buf["t"][row, n:] = 0.0
            buf["pool"][row, n:] = 0
            buf["bytes"][row, n:] = 0.0
            buf["weight"][row, n:] = 0.0
            buf["host"][row, n:] = 0
            if with_qos:
                buf["qos"][row, n:] = 0
            buf["valid"][row, n:] = False

    def _compact_slot(self, words: int, pin: bool) -> Dict[str, object]:
        """The next slot of the compact ring (``slots`` buffers of ``words``
        32-bit words, page-locked with ``pin``), after its last copy.  A
        new size replaces every slot at once, each after its last copy, so
        a ring is allocated whole, in the dispatch that sizes it."""
        ring = self._compact.get(pin)
        if ring is None or ring[0]["words"].numel() != words:
            for old in ring or ():
                self._ready(old)
            ring = self._compact[pin] = [
                {"words": torch.empty(words, dtype=torch.int32, pin_memory=pin)}
                for _ in range(self.slots)
            ]
        turn = (self._turn.get(("compact", pin), self.slots - 1) + 1) % self.slots
        self._turn[("compact", pin)] = turn
        return self._ready(ring[turn])

    def stage_compact(
        self,
        traces: Sequence["MemEvents"],
        b_bucket: int,
        scale_width: int,
        hosts: bool = True,
        qos: bool = True,
        device: object = "cpu",
    ) -> Dict[str, object]:
        """Stage only the real events, in row order, into one flat buffer
        of 32-bit words: the default dispatch's compact staging.

        Returns the ring slot, filled in place: ``words`` (the slot's int32
        torch tensor, page-locked when ``device`` is a card, which its copy
        then reads asynchronously; its first ``n_words`` are this batch's)
        and numpy views into it — ``offsets`` ``[b_bucket +
        1]`` (row r's events are ``offsets[r]:offsets[r + 1]``; rows beyond
        ``len(traces)`` are empty), ``window`` ``[b_bucket]`` and ``scale``
        ``[b_bucket, scale_width]`` (for the caller to fill), then the
        ``[E]`` columns ``t``, ``pool``, ``bytes``, ``weight``, ``host``
        (with ``hosts``) and ``qos`` (with ``qos``) in that order — plus
        ``layout`` (each view's ``(start, stop)`` in words), ``longest``
        (the longest row's events) and ``span`` (a host-only f64 row, as
        :meth:`stage` gives it).  :meth:`compact_columns` views a copy of
        the words as these sections.  Each row is
        delivered time-sorted under :meth:`stage`'s contract, and the
        values are :meth:`stage`'s, bit for bit: expanding the columns to
        ``[b_bucket, n_bucket]`` with zeros in every pad slot
        (:func:`repro_torch.kernels.ops.expand_events`) gives its planes.
        No pad slot is written here.

        The slots form a ring of ``slots`` buffers sized by a power-of-two
        bucket of the batch's real events, held and decayed as
        :meth:`stage_packed` holds its caps; a caller that copies a slot
        asynchronously fences it (:meth:`fence`), and the slot's next fill
        waits on that fence."""
        if len(traces) > b_bucket:
            raise ValueError(f"{len(traces)} traces exceed batch bucket {b_bucket}")
        if self.time_dtype != np.float32:
            raise ValueError(f"compact staging packs 32-bit words, not {self.time_dtype}")
        n_events = sum(ev.n for ev in traces)
        if n_events >= 2**31:
            raise ValueError(f"{n_events} events exceed the int32 row offsets")
        columns = ("t", "pool", "bytes", "weight") + ("host",) * hosts + ("qos",) * qos
        sections = [
            ("offsets", np.int32, (b_bucket + 1,)),
            ("window", np.float32, (b_bucket,)),
            ("scale", np.float32, (b_bucket, scale_width)),
        ]
        header = sum(int(np.prod(shape)) for _, _, shape in sections)
        sections += [(c, self._COMPACT_DTYPES[c], (n_events,)) for c in columns]
        need = len(columns) * _bucket_pow2(n_events, 4096) + _bucket_pow2(header, 256)
        pin = torch.device(device).type == "cuda"
        (held,), _ = self._hold_caps(("compact", pin), (need,), 0)
        slot = self._compact_slot(held, pin)
        words = slot["words"].numpy()
        layout, start = {}, 0
        for name, dtype, shape in sections:
            stop = start + int(np.prod(shape))
            layout[name] = (start, stop)
            slot[name] = words[start:stop].view(dtype).reshape(shape)
            start = stop
        span = np.zeros((b_bucket,), np.float64)
        offsets = slot["offsets"]
        offsets[0] = pos = 0
        for row, ev in enumerate(traces):
            if ev.n:
                cols = dict(zip(self._FIELDS, _time_sorted(ev)))
                for c in columns:
                    slot[c][pos : pos + ev.n] = cols[c]
                pos += ev.n
                span[row] = float(cols["t"][-1]) + 1.0
            offsets[row + 1] = pos
        offsets[len(traces) + 1 :] = pos
        longest = max((ev.n for ev in traces), default=0)
        slot.update(span=span, layout=layout, n_words=start, longest=longest)
        return slot

    @staticmethod
    def compact_columns(slot: Dict[str, object], words: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The sections of a :meth:`stage_compact` slot as views of
        ``words``, a copy of its first ``n_words`` (on any device): each
        section of ``layout`` in its own dtype and shape."""
        out = {}
        for name, (a, b) in slot["layout"].items():
            view = slot[name]
            dtype = torch.from_numpy(np.zeros(0, view.dtype)).dtype
            out[name] = words[a:b].view(dtype).view(view.shape)
        return out

    def stack_buffers(
        self, k_bucket: int, b_bucket: int, n_bucket: int
    ) -> Dict[str, np.ndarray]:
        """The ``[K, B, N]`` buffer set of a stacked bucket (pinned with
        ``pin``), made on first use."""
        key = (k_bucket, b_bucket, n_bucket)
        buf = self._stack_bufs.get(key)
        if buf is None:
            shape = (k_bucket, b_bucket, n_bucket)
            dtypes = {"pool": np.int32, "host": np.int32, "qos": np.int32, "valid": bool}
            buf = {f: self._zeros(shape, dtypes.get(f, self.time_dtype)) for f in self._FIELDS}
            buf["span"] = np.zeros((k_bucket, b_bucket), np.float64)
            self._stack_bufs[key] = buf
        return buf

    def stage_stack(
        self,
        groups: Sequence[Sequence["MemEvents"]],
        k_bucket: int,
        b_bucket: int,
        n_bucket: int,
    ) -> Dict[str, np.ndarray]:
        """Fill (in place) and return ``[K, B, N]`` buffers: one plane per
        epoch batch, each staged under the exact :meth:`stage` contract —
        the shared engine's cross-session coalescing path.  Planes beyond
        ``len(groups)`` are all-invalid; only planes a previous (larger)
        fill dirtied are re-cleared, and clearing touches just the masks
        the analyzer reads (``valid``/``span``) — stale payload values
        under an invalid mask are never observable.  The stacked planes
        have one slot: their caller reads them back before it stages the
        next stack."""
        if len(groups) > k_bucket:
            raise ValueError(f"{len(groups)} groups exceed stack bucket {k_bucket}")
        for g in groups:
            if len(g) > b_bucket:
                raise ValueError(f"{len(g)} traces exceed batch bucket {b_bucket}")
        key = (k_bucket, b_bucket, n_bucket)
        buf = self.stack_buffers(*key)
        for k, traces in enumerate(groups):
            plane = {f: buf[f][k] for f in self._FIELDS + ("span",)}
            self._fill_rows(plane, traces, b_bucket)
        for k in range(len(groups), self._stack_filled.get(key, 0)):
            buf["valid"][k] = False
            buf["span"][k] = 0.0
        self._stack_filled[key] = len(groups)
        return buf


# --------------------------------------------------------------------------- #
# Region map — the eBPF allocation-trace analogue
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class Region:
    """A logical allocation (tensor class or individual buffer)."""

    rid: int
    name: str
    nbytes: int
    tensor_class: str  # 'param' | 'grad' | 'opt_state' | 'activation' | 'kvcache' | 'expert' | 'input' | 'other'
    pool: int = 0  # pool index; set by a placement policy
    access_count: float = 0.0  # running hotness statistic (per epoch window)


class RegionMap:
    """Maps logical regions to pools — the software analogue of the paper's
    eBPF-maintained address-range map.

    ``alloc`` corresponds to tracing mmap/sbrk/brk; ``free`` to munmap.
    Placement policies (:mod:`repro.core.policy`) mutate ``Region.pool``.
    """

    def __init__(self) -> None:
        self._regions: List[Region] = []
        self._by_name: Dict[str, Region] = {}

    def alloc(self, name: str, nbytes: int, tensor_class: str = "other", pool: int = 0) -> Region:
        if name in self._by_name:
            raise KeyError(f"region {name!r} already allocated")
        r = Region(rid=len(self._regions), name=name, nbytes=int(nbytes), tensor_class=tensor_class, pool=pool)
        self._regions.append(r)
        self._by_name[name] = r
        return r

    def free(self, name: str) -> None:
        r = self._by_name.pop(name)
        # keep rid slot (traces may still reference it); mark empty
        r.nbytes = 0

    def __getitem__(self, name: str) -> Region:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __iter__(self) -> Iterator[Region]:
        return iter(self._regions)

    def __len__(self) -> int:
        return len(self._regions)

    @property
    def regions(self) -> List[Region]:
        return list(self._regions)

    def by_class(self, tensor_class: str) -> List[Region]:
        return [r for r in self._regions if r.tensor_class == tensor_class]

    def pool_of(self, name: str) -> int:
        return self._by_name[name].pool

    def pool_vector(self) -> np.ndarray:
        """[n_regions] int32: region id -> pool id (dense lookup table)."""
        out = np.zeros((len(self._regions),), np.int32)
        for r in self._regions:
            out[r.rid] = r.pool
        return out

    def bytes_per_pool(self, n_pools: int) -> np.ndarray:
        out = np.zeros((n_pools,), np.float64)
        for r in self._regions:
            out[r.pool] += r.nbytes
        return out

    def total_bytes(self) -> int:
        return sum(r.nbytes for r in self._regions)


# --------------------------------------------------------------------------- #
# Synthetic traces (tests / microbenchmarks)
# --------------------------------------------------------------------------- #


def synthetic_trace(
    n_events: int,
    n_pools: int,
    epoch_ns: float = 1e6,
    granule_bytes: float = CACHELINE_BYTES,
    pool_probs: Optional[Sequence[float]] = None,
    write_frac: float = 0.3,
    seed: int = 0,
    burstiness: float = 0.0,
    n_qos_classes: int = 1,
    qos_probs: Optional[Sequence[float]] = None,
) -> MemEvents:
    """Random trace generator used by tests and the microbenchmark suite.

    ``burstiness`` in [0, 1): 0 => uniform issue times; near 1 => events
    clustered into bursts (stress for congestion/bandwidth modelling).
    ``n_qos_classes`` > 1 tags events with random QoS classes
    (``qos_probs`` weights the draw; uniform by default).
    """
    rng = np.random.default_rng(seed)
    if pool_probs is None:
        pool_probs = np.full((n_pools,), 1.0 / n_pools)
    pool_probs = np.asarray(pool_probs, np.float64)
    pool_probs = pool_probs / pool_probs.sum()
    if burstiness > 0:
        n_bursts = max(1, int(n_events * (1 - burstiness) / 16) + 1)
        centers = rng.uniform(0, epoch_ns, size=n_bursts)
        t = rng.choice(centers, size=n_events) + rng.exponential(
            scale=max(epoch_ns * (1 - burstiness) * _BURST_SPREAD_FRAC, 1.0),
            size=n_events
        )
        t = np.clip(t, 0, epoch_ns)
    else:
        t = rng.uniform(0, epoch_ns, size=n_events)
    if n_qos_classes > 1:
        qp = (
            np.asarray(qos_probs, np.float64)
            if qos_probs is not None
            else np.full((n_qos_classes,), 1.0 / n_qos_classes)
        )
        qos = rng.choice(n_qos_classes, size=n_events, p=qp / qp.sum())
        qos = qos.astype(np.int32)
    else:
        qos = np.zeros((n_events,), np.int32)
    return MemEvents(
        t_ns=np.sort(t),
        pool=rng.choice(n_pools, size=n_events, p=pool_probs).astype(np.int32),
        bytes_=np.full((n_events,), float(granule_bytes)),
        is_write=rng.random(n_events) < write_frac,
        region=np.zeros((n_events,), np.int32),
        qos=qos,
    )
