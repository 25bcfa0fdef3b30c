"""Dispatch cache for the device-resident epoch pipeline (the counterpart
of ``repro/core/aot.py``).

The reference compiles one XLA executable per dispatch key ahead of time,
so a serving loop never stalls on a compile mid-stream.  PyTorch runs
eagerly and compiles nothing here, so :class:`AotDispatchCache` keeps the
reference's name, keys and counters but holds, per key, the **device side
of the staging ring** that dispatch runs from: preallocated device buffers
for every staged plane of its ``(batch, length)`` bucket (the full planes,
the window and scale rows) and, on the chain path, room for its packed
``(t, idx)``.  Keys of one bucket share the bucket's full planes, so a new
set of segment capacities adds no full-plane buffers.  A dispatch key is
the reference's — ``("chain", b, n, caps)`` or ``("batch", b, n)`` — so

  * a hit is a dict lookup and no device allocation, observable through
    the ``lowerings`` (builds) and ``hits`` counters: the steady-state
    invariant is that ``lowerings`` stops growing;
  * a miss can be taken ahead of time
    (:meth:`~repro_torch.core.analyzer.EpochAnalyzer.warmup`);
  * a build's cost is measured where it happens and reported as
    ``compile_s`` in :class:`~repro_torch.core.analyzer.DispatchStats`.

A session's :meth:`~repro_torch.core.analyzer.EpochAnalyzer.warmup` at
attach (the caller's thread) and the analysis engine's dispatcher can reach
one cache, so :meth:`AotDispatchCache.get` takes a lock around the lookup
and the insertion, as the reference's does; the build runs outside it, so
other keys never queue behind one.  As in the reference, every live cache
sits in a weak class registry, so :meth:`AotDispatchCache.total_lowerings`
gives the process-wide build count that
:class:`~repro_torch.analysis.sanitize.RecompileSanitizer` diffs across a
steady-state scope, and :meth:`AotDispatchCache.warm` takes a miss ahead of
time.  Left out: ``install_persistent_cache`` (XLA's on-disk compilation
cache has no counterpart; there is nothing compiled to keep).
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, Hashable, Tuple

__all__ = ["AotDispatchCache"]


class AotDispatchCache:
    """Thread-safe map from dispatch key to the device buffers it runs from.

    ``get`` returns ``(entry, hit)``; ``lowerings`` counts how many times a
    build actually ran, ``hits`` counts lookups served without one.
    """

    # every live cache, so RecompileSanitizer can snapshot and diff the
    # process-wide build count without threading a handle everywhere
    _instances: "weakref.WeakSet[AotDispatchCache]" = weakref.WeakSet()
    _instances_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cache: Dict[Hashable, Any] = {}
        self.lowerings = 0
        self.hits = 0
        with AotDispatchCache._instances_lock:
            AotDispatchCache._instances.add(self)

    @classmethod
    def total_lowerings(cls) -> int:
        """Sum of ``lowerings`` across every live cache (sanitizer probe)."""
        with cls._instances_lock:
            caches = list(cls._instances)
        return sum(c.lowerings for c in caches)

    def __len__(self) -> int:
        return len(self._cache)

    def get(self, key: Hashable, build: Callable[[], Any]) -> Tuple[Any, bool]:
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                self.hits += 1
                return entry, True
        # build outside the lock: an allocation can take a while, and other
        # dispatch keys must not queue behind it
        entry = build()
        with self._lock:
            won = self._cache.setdefault(key, entry)
            if won is entry:
                self.lowerings += 1
            else:
                self.hits += 1
            return won, won is not entry

    def warm(self, key: Hashable, build: Callable[[], Any]) -> bool:
        """Ensure ``key`` is built; returns True if this call built it."""
        _, hit = self.get(key, build)
        return not hit
