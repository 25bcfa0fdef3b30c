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

The stager's ring slots, packed and stacked planes come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

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


class EventStager:
    """Reusable host staging buffers for bucketed, batched epoch analysis.

    The epoch analyzer pads traces up to power-of-two buckets so repeated
    calls see the same shapes.  Doing that with ``np.pad`` allocates fresh
    arrays per epoch; the stager instead owns one buffer set per ``(batch,
    length)`` bucket and refills it in place — steady-state staging performs
    zero host allocations, and the float64 -> analyzer-dtype conversion
    happens once, during the fill.

    Not thread-safe: every thread that stages must own its stager.  Each
    :class:`~repro_torch.core.analyzer.EpochAnalyzer` keeps a private one.
    """

    def __init__(self, time_dtype: object = np.float32) -> None:
        self.time_dtype = np.dtype(time_dtype)
        self._bufs: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}

    def buffers(self, b_bucket: int, n_bucket: int) -> Dict[str, np.ndarray]:
        key = (b_bucket, n_bucket)
        buf = self._bufs.get(key)
        if buf is None:
            buf = {
                "t": np.zeros((b_bucket, n_bucket), self.time_dtype),
                "pool": np.zeros((b_bucket, n_bucket), np.int32),
                "bytes": np.zeros((b_bucket, n_bucket), self.time_dtype),
                "weight": np.zeros((b_bucket, n_bucket), self.time_dtype),
                "host": np.zeros((b_bucket, n_bucket), np.int32),
                "qos": np.zeros((b_bucket, n_bucket), np.int32),
                "valid": np.zeros((b_bucket, n_bucket), bool),
                "span": np.zeros((b_bucket,), np.float64),
            }
            self._bufs[key] = buf
        return buf

    def stage(
        self, traces: Sequence["MemEvents"], b_bucket: int, n_bucket: int
    ) -> Dict[str, np.ndarray]:
        """Fill (in place) and return the buffer set for this bucket.

        Every row is delivered **time-sorted** — the analyzer's one stable
        sort per epoch happens here, on the host, and only when a trace is
        not already monotone (the tracer emits sorted epochs, so the common
        case is a monotone check plus plain copies).  Rows beyond
        ``len(traces)`` — and the tail of every row beyond its trace's
        event count — are marked invalid; ``span`` holds each epoch's max
        issue time + 1 (0 for empty rows).
        """
        if len(traces) > b_bucket:
            raise ValueError(f"{len(traces)} traces exceed batch bucket {b_bucket}")
        buf = self.buffers(b_bucket, n_bucket)
        self._fill_rows(buf, traces, b_bucket)
        return buf

    @staticmethod
    def _fill_rows(
        buf: Dict[str, np.ndarray], traces: Sequence["MemEvents"], b_bucket: int
    ) -> None:
        """Fill one ``[B, N]`` buffer view."""
        for row in range(b_bucket):
            ev = traces[row] if row < len(traces) else None
            n = ev.n if ev is not None else 0
            if n:
                if np.all(ev.t_ns[1:] >= ev.t_ns[:-1]):
                    t, pool, nbytes, weight, host, qos = (
                        ev.t_ns, ev.pool, ev.bytes_, ev.weight, ev.host, ev.qos
                    )
                else:
                    order = np.argsort(ev.t_ns, kind="stable")
                    t, pool, nbytes, weight, host, qos = (
                        ev.t_ns[order], ev.pool[order], ev.bytes_[order],
                        ev.weight[order], ev.host[order], ev.qos[order],
                    )
                buf["t"][row, :n] = t
                buf["pool"][row, :n] = pool
                buf["bytes"][row, :n] = nbytes
                buf["weight"][row, :n] = weight
                buf["host"][row, :n] = host
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
            buf["qos"][row, n:] = 0
            buf["valid"][row, n:] = False


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
