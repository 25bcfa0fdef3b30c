"""Multi-host pool-sharing coherency model (paper §1: "evaluation of the
performance impact of CXL.mem pool coherency on applications that share
memory across multiple servers").  A copy of ``repro/core/coherency.py``
(numpy only).

CXL 3.0 back-invalidation semantics, modelled per epoch:

  * a write by host h to a shared region whose lines may be cached by other
    hosts triggers a back-invalidate (BI) message to each sharer;
  * BI traffic traverses each *sharer's* path to the pool, so it is injected
    into that sharer's event stream (charged congestion/bandwidth like any
    other transaction — on the sharer's route, which is where the message
    actually travels);
  * reads after a remote write pay a coherency miss penalty.

Two operating modes:

  * :meth:`CoherencyModel.fabric_traffic` — the shared-fabric session path.
    Sharer sets and write fractions are **derived from the actual per-host
    traces**: a region (matched by name across the tenants' region maps) is
    shared iff at least two hosts touch it in the epoch, its sharers are
    exactly the hosts that touched it, and each writer's BI fan-out goes to
    the *other* observed sharers.  No per-line directory is simulated — the
    epoch-granular summary is the same fidelity trade the paper's Timer
    makes — but nothing is assumed about who shares what: the traces decide.
  * :meth:`CoherencyModel.epoch_traffic` — the degenerate single-attach
    path, kept for programs attached outside a fabric session.  With only
    one host's trace there is nothing to derive sharers from, so it falls
    back to the analytic ``sharers = n_hosts - 1`` constant and injects the
    fan-out into the writer's own stream (total fabric BI traffic through
    the shared path).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .events import MemEvents, RegionMap, concat_events

__all__ = ["CoherencyConfig", "CoherencyModel"]


@dataclasses.dataclass(frozen=True)
class CoherencyConfig:
    n_hosts: int = 2  # analytic fallback sharer count (single-attach mode only)
    bi_message_bytes: float = 64.0  # back-invalidate packet (one line)
    coherency_miss_ns: float = 60.0  # extra latency for a post-invalidate read
    shared_classes: Tuple[str, ...] = ("kvcache", "param")  # shared tensor classes
    max_bi_events: int = 8192  # injected-event cap per stream (bytes preserved)


def _subsample_bi(
    trace: MemEvents,
    src_idx: np.ndarray,
    bi_bytes: float,
    cap: int,
    host: int,
    pool: int,
    region: int,
) -> MemEvents:
    """One BI packet per source write, subsampled to ``cap`` emitted events
    while preserving aggregate BI bytes — weight-aware, so PEBS-sampled
    writer traces keep unbiased BI traffic (the analyzer charges byte-
    proportional delays)."""
    w_total = float(trace.weight[src_idx].sum())
    emit = int(min(len(src_idx), cap))
    pick = src_idx[np.linspace(0, len(src_idx) - 1, emit).astype(np.int64)]
    # like MemEvents.sample: bytes carry their own 1/rate scaling and the
    # statistical multiplicity rides in weight, so both byte-proportional
    # (bandwidth) and weight-proportional (latency) charges stay unbiased
    return MemEvents(
        t_ns=trace.t_ns[pick],
        pool=np.full((emit,), pool, np.int32),
        bytes_=np.full((emit,), bi_bytes * w_total / emit),
        is_write=np.ones((emit,), bool),
        region=np.full((emit,), region, np.int32),
        weight=np.full((emit,), w_total / emit),
        host=np.full((emit,), host, np.int32),
        qos=trace.qos[pick],
    )


class CoherencyModel:
    """Back-invalidation traffic + coherency-miss latency, epoch-granular.

    ``regions`` is the attached program's map (single-attach mode); the
    fabric session passes its per-tenant maps to :meth:`fabric_traffic`
    directly.
    """

    def __init__(self, cfg: CoherencyConfig, regions: RegionMap = None):
        self.cfg = cfg
        self.regions = regions
        self.bi_messages_total = 0.0
        self.bi_bytes_total = 0.0
        self.coherency_delay_total_ns = 0.0

    # ------------------------------------------------------------------ #
    # Shared-fabric path: sharers derived from the traces themselves
    # ------------------------------------------------------------------ #

    def fabric_traffic(
        self,
        traces: Sequence[MemEvents],
        region_maps: Sequence[RegionMap],
    ) -> Tuple[List[MemEvents], np.ndarray]:
        """Coherency traffic for one co-scheduled epoch across all hosts.

        Args:
          traces: per-host epoch traces (``traces[h]`` is host ``h``'s; may
            be empty).  Region ids in each trace index that host's map.
          region_maps: per-host region maps; shared objects are matched by
            region *name* across maps.

        Returns ``(bi_per_host, miss_ns_per_host)``: the BI events to inject
        into each host's stream (already host-tagged) and each host's extra
        coherency-miss latency in ns.
        """
        H = len(traces)
        if len(region_maps) != H:
            raise ValueError("one region map per host trace required")
        bi_out: List[List[MemEvents]] = [[] for _ in range(H)]
        miss_ns = np.zeros((H,), np.float64)
        if H <= 1:
            return [MemEvents.empty() for _ in range(H)], miss_ns

        # shared-candidate regions, matched by name: name -> {host: Region}
        candidates = {}
        for h, rm in enumerate(region_maps):
            for r in rm:
                if r.tensor_class in self.cfg.shared_classes and r.pool != 0:
                    candidates.setdefault(r.name, {})[h] = r

        for name, by_host in candidates.items():
            if len(by_host) < 2:
                continue
            # trace-driven sharer set: hosts that actually touched the region
            acc_mask = {}
            for h, r in by_host.items():
                tr = traces[h]
                if tr.n == 0:
                    continue
                m = tr.region == r.rid
                if m.any():
                    acc_mask[h] = m
            sharers = sorted(acc_mask)
            if len(sharers) < 2:
                continue
            w_weight = {
                h: float((traces[h].weight[acc_mask[h] & traces[h].is_write]).sum())
                for h in sharers
            }
            total_weight = sum(
                float(traces[h].weight[acc_mask[h]].sum()) for h in sharers
            )
            for h in sharers:
                tr = traces[h]
                writes = acc_mask[h] & tr.is_write
                src_idx = np.nonzero(writes)[0]
                if len(src_idx):
                    # one BI packet per sharer per written granule, delivered
                    # on each target sharer's own route to the pool
                    for g in sharers:
                        if g == h:
                            continue
                        bi = _subsample_bi(
                            tr,
                            src_idx,
                            bi_bytes=self.cfg.bi_message_bytes,
                            cap=self.cfg.max_bi_events,
                            host=g,
                            pool=by_host[g].pool,
                            region=by_host[g].rid,
                        )
                        bi_out[g].append(bi)
                        self.bi_messages_total += w_weight[h]
                        self.bi_bytes_total += w_weight[h] * self.cfg.bi_message_bytes
                # coherency misses: host h's shared reads that race remote
                # writes — write fraction measured from the actual traces
                remote_w = sum(w_weight[g] for g in sharers if g != h)
                if remote_w <= 0:
                    continue
                reads_w = float(tr.weight[acc_mask[h] & ~tr.is_write].sum())
                frac = remote_w / max(total_weight, 1.0)
                extra = reads_w * frac * self.cfg.coherency_miss_ns
                miss_ns[h] += extra
                self.coherency_delay_total_ns += extra

        return (
            [concat_events(parts) if parts else MemEvents.empty() for parts in bi_out],
            miss_ns,
        )

    # ------------------------------------------------------------------ #
    # Single-attach fallback: analytic sharer count
    # ------------------------------------------------------------------ #

    def epoch_traffic(self, trace: MemEvents) -> Tuple[MemEvents, float]:
        """Returns (extra BI events, extra coherency latency ns) for one epoch.

        Analytic mode for a program attached outside a fabric session: the
        other ``n_hosts - 1`` sharers are assumed, and their aggregate BI
        traffic is charged to this host's shared path.
        """
        if trace.n == 0 or self.cfg.n_hosts <= 1:
            return MemEvents.empty(), 0.0
        if self.regions is None:
            raise ValueError("single-attach coherency requires a RegionMap")
        shared_rids = {
            r.rid for r in self.regions if r.tensor_class in self.cfg.shared_classes and r.pool != 0
        }
        if not shared_rids:
            return MemEvents.empty(), 0.0
        shared_mask = np.isin(trace.region, list(shared_rids))
        writes = shared_mask & trace.is_write
        n_writes = int(writes.sum())
        if n_writes == 0:
            return MemEvents.empty(), 0.0
        sharers = self.cfg.n_hosts - 1
        # BI packets: one per sharer per written line-granule
        n_bi = n_writes * sharers
        # subsample BI events (keep aggregate bytes) to bound trace growth
        emit = min(n_bi, self.cfg.max_bi_events)
        scale = n_bi / emit
        src_idx = np.nonzero(writes)[0]
        pick = src_idx[np.linspace(0, len(src_idx) - 1, emit).astype(np.int64)]
        # like _bi_for: subsampling scales bytes AND statistical multiplicity,
        # so both byte-proportional (bandwidth) and weight-proportional
        # (latency) charges stay unbiased under the event cap
        bi = MemEvents(
            t_ns=trace.t_ns[pick],
            pool=trace.pool[pick],
            bytes_=np.full((emit,), self.cfg.bi_message_bytes * scale),
            is_write=np.ones((emit,), bool),
            region=trace.region[pick],
            weight=np.full((emit,), scale),
            host=trace.host[pick],
            qos=trace.qos[pick],
        )
        # coherency-miss latency: reads of shared regions that follow a write
        reads = shared_mask & ~trace.is_write
        # fraction of reads that hit an invalidated line ~ writes/(reads+writes)
        frac = n_writes / max(int(shared_mask.sum()), 1)
        extra_lat = float(reads.sum()) * frac * self.cfg.coherency_miss_ns
        self.bi_messages_total += n_bi
        self.bi_bytes_total += n_bi * self.cfg.bi_message_bytes
        self.coherency_delay_total_ns += extra_lat
        return bi, extra_lat
