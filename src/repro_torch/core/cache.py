"""Expander-side device-DRAM cache model (CXL-DMSim-style, epoch-granular),
a copy of ``repro/core/cache.py`` for the port (host numpy, like the
reference: a stateful tag simulation that runs on the submitting thread).

Real CXL expanders front their media (cheap DRAM, NV media, far memory)
with an on-device DRAM cache; CXL-DMSim (arXiv 2411.02282) validates that
this cache materially shifts effective access latency.  This module models
it at the same fidelity the rest of the simulator operates at — per epoch,
vectorized, no per-access sequential state machine:

  1. **Addresses.**  Traces carry (region, bytes), not addresses, so each
     region is given a contiguous line-aligned address range and a running
     byte cursor: successive events of a region stream through its range
     (wrapping), which makes a region's cache footprint its working-set
     size — small hot regions fit, large streaming regions thrash.
  2. **Tag array.**  Each cached pool owns a ``n_sets``-set,
     ``ways``-way tag array (``ways = capacity / (line_bytes * n_sets)``).
     Per epoch, the distinct lines touched in each set are ranked by
     weighted access count and the top ``ways`` are the epoch's resident
     set; sets with spare ways keep previously-resident lines.  An access
     hits iff its line is resident this epoch and is not the line's first
     touch from a non-resident start (the fill miss).  This is the
     epoch-granular analogue of LRU: within-epoch ordering is collapsed,
     exactly the fidelity trade the Timer makes for every other delay.
  3. **Latency scaling.**  Hits are charged the device-DRAM hit latency
     instead of the media latency; switches/RC are still traversed (the
     cache lives on the expander), so congestion and bandwidth delays are
     unchanged.  The per-epoch per-(host, pool) weighted hit fractions
     lower to one ``[n_hosts * n_pools]`` latency-scale vector consumed by
     every analyzer implementation (the numpy oracle, the batched PyTorch
     analyzer and its CUDA cascade kernels on the card) — one kernel body
     serves cache and no-cache modes, and a zero-capacity cache yields the
     all-ones vector, reproducing the no-cache analysis bit-for-bit.

The top-``ways`` ranking gives a useful guarantee: growing capacity (more
ways over fixed sets) retains a superset of lines every epoch, so per-epoch
hit fractions are non-decreasing and simulated latency non-increasing —
held against the reference in ``tests/test_torch_migration_cache.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .events import MemEvents, RegionMap
from .topology import FlatTopology

__all__ = ["DeviceCacheConfig", "DeviceCacheModel"]


@dataclasses.dataclass(frozen=True)
class DeviceCacheConfig:
    """Per-pool expander-side DRAM cache parameters.

    ``ways`` is derived as ``capacity_bytes // (line_bytes * n_sets)``;
    sweeps that vary ``capacity_bytes`` over multiples of
    ``line_bytes * n_sets`` therefore vary associativity at fixed set
    count, which is the monotone axis (see module docstring).
    """

    capacity_bytes: float
    line_bytes: int = 4096  # device caches track page-ish granules
    n_sets: int = 64
    hit_latency_ns: float = 25.0  # on-device DRAM hit, vs pool media latency
    pools: Optional[Tuple[str, ...]] = None  # None => every non-local pool

    def __post_init__(self):
        if self.capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        if self.line_bytes <= 0 or self.n_sets <= 0:
            raise ValueError("line_bytes and n_sets must be positive")

    @property
    def ways(self) -> int:
        return int(self.capacity_bytes // (self.line_bytes * self.n_sets))


def _segment_starts(sorted_keys: np.ndarray):
    """(is_first_of_segment [N] bool, segment_start_index [N]) for a
    key-sorted array — the shared grouping idiom of the cursor and
    tag-array passes."""
    seg_first = np.empty(len(sorted_keys), bool)
    seg_first[:1] = True
    seg_first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    firsts = np.nonzero(seg_first)[0]
    return seg_first, firsts[np.cumsum(seg_first) - 1]


class DeviceCacheModel:
    """Stateful per-pool tag arrays + region cursors; see module docstring.

    ``region_maps`` is one map per host (a single-attach program passes
    ``[regions]``): region ids are per-host, so lines are keyed by the
    (host, region) pair — co-tenants' same-named regions are distinct
    address ranges (private replicas; the coherency model, not the cache,
    owns the shared-object semantics).

    Not thread-safe: ``observe`` mutates cursors and tag state, so callers
    run it on the trace-submitting thread (the attach pipeline's contract
    for every stateful per-epoch transform).
    """

    def __init__(
        self,
        cfg: DeviceCacheConfig,
        flat: FlatTopology,
        region_maps: Sequence[RegionMap],
    ):
        self.cfg = cfg
        self.flat = flat
        if len(region_maps) > flat.n_hosts:
            raise ValueError(
                f"{len(region_maps)} region maps for {flat.n_hosts} host(s)"
            )
        # fewer maps than hosts: a single program attached to a multi-host
        # topology only ever emits events for the hosts it covers, so the
        # remaining hosts get empty address spaces
        region_maps = list(region_maps) + [
            RegionMap() for _ in range(flat.n_hosts - len(region_maps))
        ]
        if cfg.pools is None:
            cached = list(range(1, flat.n_pools))
        else:
            cached = [flat.pool_names.index(n) for n in cfg.pools]
            if 0 in cached:
                raise ValueError("local DRAM has no device-side cache")
        self._cached_pools = tuple(cached)

        # global region id = host offset + per-host rid; contiguous
        # line-aligned address ranges per global region
        self._gid_off = np.zeros((flat.n_hosts,), np.int64)
        sizes: List[float] = []
        for h, rm in enumerate(region_maps):
            self._gid_off[h] = len(sizes)
            sizes.extend(float(r.nbytes) for r in rm)
        line = float(cfg.line_bytes)
        self._sizes = np.maximum(np.asarray(sizes, np.float64), line)
        lines_per = np.ceil(self._sizes / line).astype(np.int64)
        self._base_line = np.concatenate([[0], np.cumsum(lines_per)])[:-1]
        self._cursor = np.zeros((len(sizes),), np.float64)

        # per cached pool: sorted resident-line array (the tag state)
        self._resident: Dict[int, np.ndarray] = {
            p: np.zeros((0,), np.int64) for p in self._cached_pools
        }
        self.access_weight_total = 0.0
        self.hit_weight_total = 0.0

    @property
    def hit_fraction(self) -> float:
        """Running weighted hit fraction across every observed epoch."""
        if self.access_weight_total <= 0:
            return float("nan")
        return self.hit_weight_total / self.access_weight_total

    # ------------------------------------------------------------------ #

    def _event_lines(self, trace: MemEvents) -> np.ndarray:
        """[N] line id per event: streaming region cursors -> wrapped
        offsets -> global line addresses (advances the cursors)."""
        gid = trace.region.astype(np.int64) + self._gid_off[trace.host]
        order = np.argsort(gid, kind="stable")  # events stay in time order per gid
        gs, bs = gid[order], trace.bytes_[order]
        excl = np.cumsum(bs) - bs
        _, seg_start = _segment_starts(gs)
        within = excl - excl[seg_start]
        off_sorted = np.mod(self._cursor[gs] + within, self._sizes[gs])
        self._cursor += np.bincount(gid, weights=trace.bytes_, minlength=len(self._cursor))
        off = np.empty_like(off_sorted)
        off[order] = off_sorted
        return self._base_line[gid] + (off // self.cfg.line_bytes).astype(np.int64)

    def _update_pool(
        self, lines: np.ndarray, weight: np.ndarray, p: int
    ) -> np.ndarray:
        """One pool's epoch tag update; returns the per-event hit mask."""
        W, n_sets = self.cfg.ways, self.cfg.n_sets
        old = self._resident[p]
        if W == 0:
            return np.zeros(len(lines), bool)
        uniq, first_idx = np.unique(lines, return_index=True)
        counts = np.bincount(
            np.searchsorted(uniq, lines), weights=weight, minlength=len(uniq)
        )
        keep_old = old[~np.isin(old, uniq)]  # untouched residents keep spare ways
        cand = np.concatenate([uniq, keep_old])
        ccnt = np.concatenate([counts, np.zeros(len(keep_old))])
        cset = cand % n_sets
        order = np.lexsort((cand, -ccnt, cset))  # by set, hottest first
        _, seg_start = _segment_starts(cset[order])
        rank = np.arange(len(cand)) - seg_start
        resident = np.sort(cand[order][rank < W])

        first_mask = np.zeros(len(lines), bool)
        first_mask[first_idx] = True
        hit = np.isin(lines, resident) & (np.isin(lines, old) | ~first_mask)
        self._resident[p] = resident
        return hit

    def observe(self, trace: MemEvents) -> np.ndarray:
        """Simulate one epoch; returns [H, P] weighted hit fractions
        (0 where a (host, pool) cell saw no traffic or has no cache)."""
        H, P = self.flat.n_hosts, self.flat.n_pools
        frac = np.zeros((H, P), np.float64)
        if trace.n == 0:
            return frac
        lines = self._event_lines(trace)
        hit = np.zeros(trace.n, bool)
        for p in self._cached_pools:
            m = trace.pool == p
            if m.any():
                hit[m] = self._update_pool(lines[m], trace.weight[m], p)
        vp = trace.host.astype(np.int64) * P + trace.pool
        hw = np.bincount(vp, weights=trace.weight * hit, minlength=H * P)
        tw = np.bincount(vp, weights=trace.weight, minlength=H * P)
        np.divide(hw, tw, out=frac.reshape(-1), where=tw > 0)
        self.hit_weight_total += float(hw.sum())
        self.access_weight_total += float(
            tw.reshape(H, P)[:, list(self._cached_pools)].sum()
        ) if self._cached_pools else 0.0
        return frac

    def latency_scale(self, hit_frac: np.ndarray) -> np.ndarray:
        """Lower [H, P] hit fractions to the analyzer's [H*P] scale vector.

        A hit saves ``media_latency - hit_latency`` (clipped so the scaled
        added latency stays non-negative); a zero fraction yields exactly
        1.0, so no-cache and capacity-0 analyses are bitwise identical.
        """
        flat = self.flat
        added = np.maximum(flat.pool_latency_ns - flat.local_latency_ns, 0.0)
        saved = np.zeros((flat.n_pools,), np.float64)
        cp = list(self._cached_pools)
        saved[cp] = np.clip(
            flat.pool_media_latency_ns[cp] - self.cfg.hit_latency_ns, 0.0, None
        )
        saved_v = np.minimum(np.tile(saved, flat.n_hosts), added)
        scale = np.ones_like(added)
        nz = added > 0
        scale[nz] = 1.0 - hit_frac.reshape(-1)[nz] * saved_v[nz] / added[nz]
        return scale

    def observe_scale(self, trace: MemEvents) -> Optional[np.ndarray]:
        """``observe`` + ``latency_scale`` in one call; returns None for a
        hit-free epoch (callers then skip the scale row entirely)."""
        frac = self.observe(trace)
        if not frac.any():
            return None
        return self.latency_scale(frac)
