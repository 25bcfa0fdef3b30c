"""Hot/cold migration and prefetch simulation (paper §1 research uses:
"comparison of software and hardware memory prefetching and migration"),
a copy of ``repro/core/migration.py`` for the port (host numpy).

Both mechanisms are simulated **on top of the same trace**: given per-epoch
access statistics per region, a migration policy decides promotions
(pool -> local) and demotions (local -> pool); the migration traffic itself
is injected as extra events so the analyzer charges its latency/bandwidth
cost.

* software migration: decisions at epoch boundaries, page granularity —
  models an OS tiering daemon (e.g. TPP/HeMem-style).
* hardware migration: decisions applied mid-epoch after a short reaction
  time, cacheline granularity — models a device-side HW prefetcher.

The decision engine is **vectorized**: hotness EWMAs, the demotion mask,
and the budget-packed promotion prefix are pure array ops (bincount ->
EWMA update -> stable argsort + cumsum), so an epoch over ~1e5 regions
costs a few numpy passes instead of a Python loop per region.  The
pre-vectorization per-region loop survives as ``impl='loop'`` — the
decision oracle for the equivalence tests.

Policy semantics (both impls):

* hotness is a weight-aware EWMA: event counts are accumulated with their
  PEBS ``weight`` multiplicity, so sampled traces drive unbiased decisions;
* every cold region demotes (demotions only free budget).  Regions born
  local (``home == 0``) demote to ``MigrationConfig.demote_pool`` when one
  is configured — without it they can never demote, which pins the local
  budget forever and starves all future promotions;
* promotions are budget-packed hottest-first: the maximal hotness-ordered
  *prefix* of candidates whose cumulative size fits the remaining local
  budget is promoted (cumsum packing; an O(1)-decision daemon's rule, and
  the form that vectorizes).

Several simulators may share one :class:`LocalBudget` — the fabric
session's co-tenant mode, where every tenant's promotions draw on the same
local-DRAM capacity.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

from .events import PAGE_BYTES, MemEvents, RegionMap, concat_events
from .topology import FlatTopology
from .units import BYTES_PER_GIB

__all__ = ["LocalBudget", "MigrationConfig", "MigrationSimulator"]


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    mode: str = "software"  # 'software' | 'hardware' | 'off'
    promote_threshold: float = 64.0  # accesses/epoch to promote a region
    demote_threshold: float = 4.0  # accesses/epoch below which to demote
    local_budget_bytes: int = 16 * BYTES_PER_GIB
    reaction_ns: float = 0.0  # hardware mode: reaction latency before moves
    granularity_bytes: int = PAGE_BYTES  # sw: pages; hw typically cachelines
    # where cold regions whose home *is* local DRAM demote to (pool name or
    # index).  None preserves the home-pool-only rule: local-born regions
    # then never demote and permanently hold their budget share.
    demote_pool: Optional[Union[int, str]] = None

    def __post_init__(self):
        if self.mode not in ("software", "hardware", "off"):
            raise ValueError(self.mode)


class LocalBudget:
    """Mutable local-DRAM byte budget, shareable across simulators.

    A :class:`MigrationSimulator` owns a private one by default; a fabric
    session passes the same instance to every tenant's simulator so their
    promotions compete for one local tier.
    """

    def __init__(self, limit_bytes: float):
        self.limit = float(limit_bytes)
        self.used = 0.0


class MigrationSimulator:
    """Stateful across epochs: tracks region residency and hotness EWMA.

    ``host`` tags the emitted migration copy traffic (a fabric session
    creates one simulator per tenant, on that tenant's host index).
    ``impl='loop'`` selects the per-region Python reference path — same
    decisions, used as the vectorization oracle.
    """

    def __init__(
        self,
        cfg: MigrationConfig,
        regions: RegionMap,
        flat: FlatTopology,
        host: int = 0,
        budget: Optional[LocalBudget] = None,
        impl: str = "vector",
    ):
        if impl not in ("vector", "loop"):
            raise ValueError(impl)
        self.cfg = cfg
        self.regions = regions
        self.flat = flat
        self.host = int(host)
        self.impl = impl
        R = len(regions)
        self._region_list = list(regions)  # rid-indexed (rids are dense)
        self._pool = np.array([r.pool for r in regions], np.int32)
        self._nbytes = np.array([r.nbytes for r in regions], np.float64)
        self._home_pool = self._pool.copy()  # policy-assigned home, [R]
        self._hot_ewma = np.zeros((R,), np.float64)
        self._budget = budget if budget is not None else LocalBudget(cfg.local_budget_bytes)
        self._budget.used += float(self._nbytes[self._pool == 0].sum())
        self._synced = False  # first observe re-reads Region.pool (see below)
        self._demote_pool = self._resolve_demote_pool(cfg.demote_pool)
        self.moved_bytes_total = 0.0
        self.promotions = 0
        self.demotions = 0

    def _resolve_demote_pool(self, dp) -> int:
        if dp is None:
            return -1
        idx = self.flat.pool_names.index(dp) if isinstance(dp, str) else int(dp)
        if not (0 < idx < self.flat.n_pools):
            raise ValueError(f"demote_pool must be a non-local pool, got {dp!r}")
        return idx

    def _resync_residency(self) -> None:
        """Adopt ``Region.pool`` as current residency (first observe only).

        Simulators are often constructed before a placement policy runs
        (``CXLMemSim.attach`` places at attach time); homes stay the
        construction-time snapshot — the policy-assigned home contract —
        but residency and the budget's local-byte accounting must reflect
        where the regions actually ended up when migration starts.  After
        this point the simulator is the sole residency mutator and keeps
        the Region objects in sync eagerly.
        """
        self._nbytes = np.array([r.nbytes for r in self._region_list], np.float64)
        pools_now = np.array([r.pool for r in self._region_list], np.int32)
        self._budget.used += float(
            self._nbytes[pools_now == 0].sum() - self._nbytes[self._pool == 0].sum()
        )
        self._pool = pools_now

    # Region.access_count (the harvested-hotness input of e.g.
    # HotnessTieredPolicy) is refreshed every epoch up to this region count;
    # above it the O(R) Python attribute loop would swamp the vectorized
    # decision pass, so large maps refresh via sync_region_stats() instead.
    _SYNC_STATS_MAX = 4096

    def sync_region_stats(self) -> None:
        """Write the hotness EWMAs back onto ``Region.access_count``.

        Residency (``Region.pool``) is synced eagerly on every move and
        ``access_count`` automatically for maps up to ``_SYNC_STATS_MAX``
        regions; beyond that, call this before reading ``access_count``."""
        for r in self._region_list:
            r.access_count = float(self._hot_ewma[r.rid])

    # ------------------------------------------------------------------ #

    def observe_and_migrate(self, trace: MemEvents) -> Tuple[MemEvents, MemEvents]:
        """Update hotness from this epoch's trace; emit migration traffic.

        Returns ``(remapped_trace, migration_events)``: the input trace with
        pools rewritten to current residency, plus the extra copy traffic.
        Every untouched event column — PEBS ``weight``, fabric ``host``,
        bytes, write flags — rides through the remap unchanged.
        """
        if self.cfg.mode == "off" or trace.n == 0:
            return trace, MemEvents.empty()
        if not self._synced:
            self._resync_residency()
            self._synced = True

        R = len(self._pool)
        counts = np.bincount(
            trace.region, weights=trace.weight, minlength=R
        )[:R]
        self._hot_ewma = 0.5 * self._hot_ewma + 0.5 * counts
        if R <= self._SYNC_STATS_MAX:
            # one loop, both directions: publish hotness to the Region
            # objects and re-read sizes, so mid-run RegionMap.free() (which
            # zeroes nbytes in place) is honored like the old live-reading
            # loop did.  Large maps snapshot at first observe instead.
            for r in self._region_list:
                r.access_count = float(self._hot_ewma[r.rid])
                self._nbytes[r.rid] = float(r.nbytes)

        epoch_end = float(trace.t_ns.max())
        move_t = (
            min(self.cfg.reaction_ns, epoch_end)
            if self.cfg.mode == "hardware"
            else epoch_end  # software migrates at the epoch boundary
        )

        if self.impl == "loop":
            migration = self._migrate_loop(move_t)
        else:
            migration = self._migrate_vector(move_t)

        # remap trace events issued after the (hardware) move point
        if self.cfg.mode == "hardware":
            new_pool = self._pool[trace.region]
            applied = trace.t_ns >= move_t
            new_pool = np.where(applied, new_pool, trace.pool).astype(np.int32)
            remapped = dataclasses.replace(trace, pool=new_pool)
        else:
            remapped = trace  # software: remap takes effect next epoch
        return remapped, migration

    # ------------------------------------------------------------------ #
    # decision engines
    # ------------------------------------------------------------------ #

    def _migrate_vector(self, move_t: float) -> MemEvents:
        """Pure-array decision pass: one demotion mask, one argsort/cumsum
        promotion prefix, one batched copy-traffic build."""
        pool, home, hot, nb = self._pool, self._home_pool, self._hot_ewma, self._nbytes
        b = self._budget

        # demote cold local residents first (frees budget), then promote hot
        cold = (pool == 0) & (hot < self.cfg.demote_threshold)
        dem = cold & ((home != 0) | (self._demote_pool >= 0))
        dem_ids = np.nonzero(dem)[0]
        dem_dst = np.where(home[dem_ids] != 0, home[dem_ids], self._demote_pool)

        b.used -= float(nb[dem_ids].sum())
        pool[dem_ids] = dem_dst
        self.demotions += len(dem_ids)

        cand = np.nonzero((pool != 0) & (hot >= self.cfg.promote_threshold))[0]
        # stable sort on -hotness: ties keep rid order, matching the loop
        order = cand[np.argsort(-hot[cand], kind="stable")]
        fits = b.used + np.cumsum(nb[order]) <= b.limit
        pro_ids = order[fits]

        b.used += float(nb[pro_ids].sum())
        pro_src = pool[pro_ids].copy()
        pool[pro_ids] = 0
        self.promotions += len(pro_ids)

        movers = np.concatenate([dem_ids, pro_ids])
        if not len(movers):
            return MemEvents.empty()
        src = np.concatenate([np.zeros(len(dem_ids), np.int32), pro_src])
        dst = np.concatenate([dem_dst, np.zeros(len(pro_ids), np.int32)]).astype(np.int32)
        for rid in movers:  # eager residency sync; movers are few at steady state
            self._region_list[rid].pool = int(pool[rid])
        return self._copy_events_batch(movers, src, dst, move_t)

    def _migrate_loop(self, move_t: float) -> MemEvents:
        """Per-region Python reference (pre-vectorization shape): identical
        decisions, one :meth:`_copy_events` build per mover."""
        cfg = self.cfg
        b = self._budget
        migration: List[MemEvents] = []
        by_hot = sorted(self._region_list, key=lambda r: self._hot_ewma[r.rid])
        for r in by_hot:
            rid = r.rid
            if self._pool[rid] != 0 or self._hot_ewma[rid] >= cfg.demote_threshold:
                continue
            dst = int(self._home_pool[rid]) if self._home_pool[rid] != 0 else self._demote_pool
            if dst < 0:
                continue
            migration.append(self._copy_events(rid, src=0, dst=dst, t=move_t))
            self._pool[rid] = dst
            r.pool = dst
            b.used -= float(self._nbytes[rid])
            self.demotions += 1
        for r in sorted(self._region_list, key=lambda r: -self._hot_ewma[r.rid]):
            rid = r.rid
            if self._pool[rid] == 0 or self._hot_ewma[rid] < cfg.promote_threshold:
                continue
            if b.used + self._nbytes[rid] > b.limit:
                break  # budget packing is a hotness-ordered prefix
            migration.append(
                self._copy_events(rid, src=int(self._pool[rid]), dst=0, t=move_t)
            )
            self._pool[rid] = 0
            r.pool = 0
            b.used += float(self._nbytes[rid])
            self.promotions += 1
        return concat_events(migration)

    # ------------------------------------------------------------------ #
    # migration copy traffic
    # ------------------------------------------------------------------ #

    def _granules(self, nbytes: np.ndarray) -> np.ndarray:
        g = float(self.cfg.granularity_bytes)
        # batch granules into at most 4096 transactions per region
        return np.clip(np.ceil(nbytes / g), 1, 4096).astype(np.int64)

    def _copy_events_batch(
        self, rids: np.ndarray, src: np.ndarray, dst: np.ndarray, t: float
    ) -> MemEvents:
        """All movers' copy traffic as one build: each migration is a read
        stream from src plus a write stream to dst, carrying unit PEBS
        weight (copies are exact traffic) and this simulator's host tag."""
        nb = self._nbytes[rids]
        n = self._granules(nb)
        per = np.repeat(nb / n, n)
        reg = np.repeat(rids.astype(np.int32), n)
        pool = np.concatenate([np.repeat(src, n), np.repeat(dst, n)]).astype(np.int32)
        tot = 2 * len(per)
        self.moved_bytes_total += float(nb.sum())
        return MemEvents(
            t_ns=np.full((tot,), t, np.float64),
            pool=pool,
            bytes_=np.concatenate([per, per]),
            is_write=np.concatenate([np.zeros(len(per), bool), np.ones(len(per), bool)]),
            region=np.concatenate([reg, reg]),
            host=np.full((tot,), self.host, np.int32),
        )

    def _copy_events(self, rid: int, src: int, dst: int, t: float) -> MemEvents:
        ids = np.array([rid], np.int64)
        return self._copy_events_batch(
            ids, np.array([src], np.int32), np.array([dst], np.int32), t
        )
