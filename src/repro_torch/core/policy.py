"""Placement policies: which regions live in which memory pool.  Port of
``repro/core/policy.py`` (numpy only).

This is the research surface the paper says CXLMemSim enables ("memory
scheduling for complex applications", "comparison of cache-line and page
memory management").  A policy assigns every :class:`~repro_torch.core.events.Region`
a pool; the tracer then emits events against those pools.

Policies are deliberately simple, composable objects so experiments can sweep
them (see ``examples/topology_explorer.py``).

Two assignment surfaces per policy:

  * :meth:`PlacementPolicy.place` — the historical per-``Region`` Python
    loop that mutates ``Region.pool`` in place.  Kept as the **parity
    oracle**: it is the executable specification each vectorized path is
    regression-tested against (the reference's ``tests/test_scenario.py``).
  * :meth:`PlacementPolicy.assign` — vectorized assignment over a
    :class:`RegionArrays` snapshot, returning a ``[R]`` pool vector without
    touching any ``Region`` object; :func:`assign_batch` stacks K policies
    into the ``[K, R]`` placement matrix a scenario sweep places with.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from .events import CACHELINE_BYTES, PAGE_BYTES, Region, RegionMap
from .topology import FlatTopology
from .units import bytes_to_gib

# tie-break epsilon for byte-share deficits (NOT a unit conversion)
_EPS_BYTES = 1e-9


__all__ = [
    "PlacementPolicy",
    "LocalOnlyPolicy",
    "ClassMapPolicy",
    "InterleavePolicy",
    "HotnessTieredPolicy",
    "RegionArrays",
    "assign_batch",
    "bytes_per_pool_batch",
    "capacity_check",
]


@dataclasses.dataclass(frozen=True)
class RegionArrays:
    """Struct-of-arrays snapshot of a :class:`~repro_torch.core.events.RegionMap`.

    Policies' vectorized ``assign`` paths operate on these dense arrays so a
    K-scenario sweep pays one marshalling pass instead of K object walks.
    ``class_codes`` indexes ``class_names`` (the tensor-class vocabulary of
    this snapshot); ``names``/``access_count``/``nbytes`` are aligned by rid.
    """

    nbytes: np.ndarray  # [R] float64
    access_count: np.ndarray  # [R] float64 (hotness fallback input)
    class_codes: np.ndarray  # [R] int32 into class_names
    class_names: Tuple[str, ...]
    names: Tuple[str, ...]

    @property
    def n(self) -> int:
        return int(len(self.nbytes))

    @staticmethod
    def from_regions(regions: RegionMap) -> "RegionArrays":
        regs = list(regions)
        vocab: Dict[str, int] = {}
        codes = np.zeros((len(regs),), np.int32)
        for i, r in enumerate(regs):
            codes[i] = vocab.setdefault(r.tensor_class, len(vocab))
        return RegionArrays(
            nbytes=np.asarray([float(r.nbytes) for r in regs], np.float64),
            access_count=np.asarray([float(r.access_count) for r in regs], np.float64),
            class_codes=codes,
            class_names=tuple(vocab),
            names=tuple(r.name for r in regs),
        )

    def class_mask(self, classes) -> np.ndarray:
        """[R] bool: region's tensor class is in ``classes``."""
        in_vocab = np.asarray([c in classes for c in self.class_names], bool)
        return in_vocab[self.class_codes]


class PlacementPolicy:
    """Base: assigns pools to regions; granularity controls event batching.

    ``granularity_bytes`` is the transaction granule the tracer uses when it
    expands a logical access into events: 64 B cachelines model hardware
    (CXL-native) management; 4 KiB pages model software (OS) management.
    """

    name = "base"

    def __init__(self, granularity_bytes: int = CACHELINE_BYTES):
        if granularity_bytes <= 0:
            raise ValueError("granularity must be positive")
        self.granularity_bytes = int(granularity_bytes)

    def place(self, regions: RegionMap, flat: FlatTopology) -> None:
        """Loop parity oracle: mutate ``Region.pool`` in place."""
        raise NotImplementedError

    def assign(self, ra: RegionArrays, flat: FlatTopology) -> np.ndarray:
        """Vectorized assignment: ``[R]`` int32 pool vector, no mutation.

        Must agree exactly with :meth:`place` on the same inputs (the loop
        is the specification; the reference's ``tests/test_scenario.py`` locks
        the parity).
        """
        raise NotImplementedError

    def with_granularity(self, granularity_bytes: int) -> "PlacementPolicy":
        """Copy of this policy with a different management granule — the
        sweep engine's granularity axis (placement logic unchanged)."""
        if granularity_bytes <= 0:
            raise ValueError("granularity must be positive")
        out = copy.copy(self)
        out.granularity_bytes = int(granularity_bytes)
        return out

    def assign_key(self) -> Optional[tuple]:
        """Hashable fingerprint of everything ``assign`` reads, or None.

        ``assign_batch`` (the scenario sweep) dedups on it, so policies that differ only in
        granularity (``with_granularity`` copies — the granule shapes the
        trace, never the placement) share one placement computation.
        ``None`` disables content dedup for the policy (object-identity
        dedup still applies)."""
        return None

    def describe(self) -> str:
        gran = "cacheline" if self.granularity_bytes == CACHELINE_BYTES else (
            "page" if self.granularity_bytes == PAGE_BYTES else f"{self.granularity_bytes}B"
        )
        return f"{self.name}(granularity={gran})"


class LocalOnlyPolicy(PlacementPolicy):
    """Everything in local DRAM — the native-execution baseline."""

    name = "local_only"

    def place(self, regions: RegionMap, flat: FlatTopology) -> None:
        for r in regions:
            r.pool = 0

    def assign(self, ra: RegionArrays, flat: FlatTopology) -> np.ndarray:
        return np.zeros((ra.n,), np.int32)

    def assign_key(self):
        return (self.name,)


class ClassMapPolicy(PlacementPolicy):
    """Static mapping from tensor class to pool (by name).

    The canonical CXL experiments: ``{'opt_state': 'cxl_pool'}`` (optimizer
    offload), ``{'kvcache': 'cxl_pool'}`` (KV-cache offload),
    ``{'expert': 'cxl_pool'}`` (cold-expert offload for MoE).
    """

    name = "class_map"

    def __init__(
        self,
        class_to_pool: Mapping[str, str],
        granularity_bytes: int = CACHELINE_BYTES,
    ):
        super().__init__(granularity_bytes)
        self.class_to_pool = dict(class_to_pool)

    def place(self, regions: RegionMap, flat: FlatTopology) -> None:
        name_to_idx = {n: i for i, n in enumerate(flat.pool_names)}
        for r in regions:
            target = self.class_to_pool.get(r.tensor_class)
            r.pool = name_to_idx[target] if target is not None else 0

    def assign(self, ra: RegionArrays, flat: FlatTopology) -> np.ndarray:
        name_to_idx = {n: i for i, n in enumerate(flat.pool_names)}
        table = np.zeros((len(ra.class_names),), np.int32)
        for ci, cname in enumerate(ra.class_names):
            target = self.class_to_pool.get(cname)
            table[ci] = name_to_idx[target] if target is not None else 0
        return table[ra.class_codes]

    def assign_key(self):
        return (self.name, tuple(sorted(self.class_to_pool.items())))


class InterleavePolicy(PlacementPolicy):
    """Round-robin regions across a set of pools (weighted).

    Models NUMA-style interleaving across CXL expanders to spread bandwidth.

    Selection rule (deterministic): regions are visited in declaration
    order; each goes to the pool with the largest byte-share *deficit*
    ``w_k - placed_k / total_placed``.  **Ties resolve to the earliest pool
    in the declared ``pools`` sequence** — so the very first placement (all
    deficits equal to the normalized weights) seeds the max-weight pool,
    first-declared among equals, and an equal-weight, equal-size stream
    round-robins exactly in declaration order.  This contract is shared by
    the loop and vectorized paths and locked by the reference's
    ``tests/test_scenario.py``.
    """

    name = "interleave"

    def __init__(
        self,
        pools: Sequence[str],
        weights: Optional[Sequence[float]] = None,
        classes: Optional[Sequence[str]] = None,  # None => every class
        granularity_bytes: int = CACHELINE_BYTES,
    ):
        super().__init__(granularity_bytes)
        self.pools = list(pools)
        self.weights = list(weights) if weights is not None else [1.0] * len(self.pools)
        if len(self.weights) != len(self.pools):
            raise ValueError("weights/pools length mismatch")
        self.classes = set(classes) if classes is not None else None

    @staticmethod
    def _pick(deficit: np.ndarray) -> int:
        # np.argmax returns the FIRST maximum: ties deliberately resolve to
        # the earliest *declared* pool (deficit is indexed in declaration
        # order), which is the documented tie-breaking contract.
        return int(np.argmax(deficit))

    def place(self, regions: RegionMap, flat: FlatTopology) -> None:
        name_to_idx = {n: i for i, n in enumerate(flat.pool_names)}
        idxs = [name_to_idx[p] for p in self.pools]
        w = np.asarray(self.weights, np.float64)
        w = w / w.sum()
        # deterministic weighted round-robin by cumulative byte share
        placed_bytes = np.zeros((len(idxs),), np.float64)
        for r in regions:
            if self.classes is not None and r.tensor_class not in self.classes:
                r.pool = 0
                continue
            total = placed_bytes.sum() + _EPS_BYTES
            deficit = w - placed_bytes / total
            k = self._pick(deficit)
            r.pool = idxs[k]
            placed_bytes[k] += r.nbytes

    def assign(self, ra: RegionArrays, flat: FlatTopology) -> np.ndarray:
        """Deficit round-robin without ``Region`` traffic.

        The deficit recurrence is inherently sequential in regions (each
        choice feeds the next deficit), so the vectorization here is across
        *pools* per step — and across whole scenarios in
        ``assign_batch``, where K interleave variants share one pass.
        """
        name_to_idx = {n: i for i, n in enumerate(flat.pool_names)}
        idxs = np.asarray([name_to_idx[p] for p in self.pools], np.int32)
        w = np.asarray(self.weights, np.float64)
        w = w / w.sum()
        out = np.zeros((ra.n,), np.int32)
        sel = (
            np.flatnonzero(ra.class_mask(self.classes))
            if self.classes is not None
            else np.arange(ra.n)
        )
        placed_bytes = np.zeros((len(idxs),), np.float64)
        for i in sel:
            total = placed_bytes.sum() + _EPS_BYTES
            deficit = w - placed_bytes / total
            k = self._pick(deficit)
            out[i] = idxs[k]
            placed_bytes[k] += ra.nbytes[i]
        return out

    def assign_key(self):
        return (
            self.name,
            tuple(self.pools),
            tuple(self.weights),
            tuple(sorted(self.classes)) if self.classes is not None else None,
        )


class HotnessTieredPolicy(PlacementPolicy):
    """Hottest regions local until local capacity is exhausted; rest to the
    fallback pool — a static tiering oracle given access statistics.

    ``hotness`` maps region name -> access count (e.g. harvested from a prior
    profiled run via :class:`~repro_torch.core.attach.CXLMemSim`).

    Packing is greedy **first-fit** in hotness-density order: a region that
    does not fit leaves the budget untouched, so a later (colder but
    smaller) region may still land local.
    """

    name = "hotness_tiered"

    def __init__(
        self,
        fallback_pool: str,
        hotness: Optional[Mapping[str, float]] = None,
        local_budget_bytes: Optional[int] = None,
        granularity_bytes: int = PAGE_BYTES,
    ):
        super().__init__(granularity_bytes)
        self.fallback_pool = fallback_pool
        self.hotness = dict(hotness or {})
        self.local_budget_bytes = local_budget_bytes

    def _budget(self, flat: FlatTopology) -> float:
        return (
            self.local_budget_bytes
            if self.local_budget_bytes is not None
            else int(flat.pool_capacity[0])
        )

    def place(self, regions: RegionMap, flat: FlatTopology) -> None:
        name_to_idx = {n: i for i, n in enumerate(flat.pool_names)}
        fb = name_to_idx[self.fallback_pool]
        budget = self._budget(flat)
        # hotness density = accesses per byte; hottest-per-byte goes local first
        def density(r: Region) -> float:
            h = self.hotness.get(r.name, r.access_count)
            return h / max(r.nbytes, 1)

        used = 0
        for r in sorted(regions, key=density, reverse=True):
            if used + r.nbytes <= budget:
                r.pool = 0
                used += r.nbytes
            else:
                r.pool = fb

    def assign(self, ra: RegionArrays, flat: FlatTopology) -> np.ndarray:
        name_to_idx = {n: i for i, n in enumerate(flat.pool_names)}
        fb = np.int32(name_to_idx[self.fallback_pool])
        budget = self._budget(flat)
        if self.hotness:
            h = np.asarray(
                [self.hotness.get(nm, ac) for nm, ac in zip(ra.names, ra.access_count)],
                np.float64,
            )
        else:
            h = ra.access_count
        density = h / np.maximum(ra.nbytes, 1)
        # stable sort on -density == sorted(..., reverse=True): density ties
        # keep declaration (rid) order, matching the loop oracle
        order = np.argsort(-density, kind="stable")
        b = ra.nbytes[order]
        accept = np.zeros((ra.n,), bool)
        # greedy first-fit: vectorized in runs — each pass accepts the
        # longest prefix that fits and skips the first overflowing region,
        # so the pass count is 1 + number of rejections (worst case O(R)
        # passes on adversarial big/small alternations; real region lists
        # reject a handful of tail regions)
        used, start = 0.0, 0
        while start < ra.n:
            csum = used + np.cumsum(b[start:])
            fit = csum <= budget
            if fit.all():
                accept[start:] = True
                break
            first_bad = int(np.argmin(fit))  # first False
            accept[start : start + first_bad] = True
            if first_bad > 0:
                used = float(csum[first_bad - 1])
            start += first_bad + 1
        out = np.full((ra.n,), fb, np.int32)
        out[order[accept]] = 0
        return out

    def assign_key(self):
        return (
            self.name,
            self.fallback_pool,
            tuple(sorted(self.hotness.items())),
            self.local_budget_bytes,
        )


# --------------------------------------------------------------------------- #
# Batched placement + capacity accounting (the sweep engine's feed path)
# --------------------------------------------------------------------------- #


def assign_batch(
    policies: Sequence[PlacementPolicy],
    ra: RegionArrays,
    flat: FlatTopology,
) -> np.ndarray:
    """``[K, R]`` placement matrix: row k is ``policies[k].assign(ra, flat)``.

    Rows dedup on :meth:`PlacementPolicy.assign_key` (falling back to
    object identity when a policy returns None), so a cartesian sweep that
    reuses one policy across every topology/cache/granularity variant —
    including ``with_granularity`` copies, whose placement is identical by
    construction — computes each distinct placement once and broadcasts.
    """
    out = np.empty((len(policies), ra.n), np.int32)
    computed: Dict[object, np.ndarray] = {}
    for k, p in enumerate(policies):
        key = p.assign_key()
        if key is None:
            key = id(p)
        row = computed.get(key)
        if row is None:
            row = p.assign(ra, flat)
            computed[key] = row
        out[k] = row
    return out


def bytes_per_pool_batch(assign: np.ndarray, nbytes: np.ndarray, n_pools: int) -> np.ndarray:
    """``[K, P]`` bytes placed per pool for a ``[K, R]`` placement matrix."""
    K = assign.shape[0]
    out = np.zeros((K, n_pools), np.float64)
    np.add.at(out, (np.arange(K)[:, None], assign), nbytes[None, :])
    return out


def capacity_check(regions: RegionMap, flat: FlatTopology) -> Dict[str, float]:
    """Bytes placed per pool vs capacity; raises on overflow."""
    per_pool = regions.bytes_per_pool(flat.n_pools)
    report = {}
    for i, name in enumerate(flat.pool_names):
        cap = float(flat.pool_capacity[i])
        report[name] = per_pool[i] / cap if cap > 0 else 0.0
        if per_pool[i] > cap:
            raise ValueError(
                f"pool {name} over capacity: {bytes_to_gib(per_pool[i]):.1f} GiB "
                f"placed, {bytes_to_gib(cap):.1f} GiB available"
            )
    return report
