"""Runtime sanitizers — the dynamic half of the port's simlint (the port's
copy of ``repro/analysis/sanitize.py``).

Three context managers, all usable standalone or as test fixtures (see
:mod:`repro_torch.analysis.pytest_plugin`, gated by ``SIMLINT_SANITIZE=1``):

* :class:`RecompileSanitizer` — fails a scope that builds in steady state.
  Eager PyTorch compiles no graphs, so its two signals are the port's
  counterparts of the reference's: the
  :class:`~repro_torch.core.aot.AotDispatchCache` ``lowerings`` counters
  (every live cache, via the class registry: new dispatch-cache entries —
  device rings, staged sweep planes — that should have been cache hits),
  and :mod:`repro_torch.kernels.build`'s process-wide ``nvcc_runs`` (a
  kernel library compiled inside the scope), the counterpart of JAX's
  compile log.
* :class:`LockOrderSanitizer` — wraps ``threading.Lock``/``threading.RLock``
  creation for the scope's duration, records every *blocking* acquisition
  against the acquiring thread's currently-held set, aggregates edges by
  lock **creation site**, and reports any cycle in the resulting lock-order
  graph as a potential deadlock.  Non-blocking probe acquires (e.g.
  ``Condition._is_owned``) are tracked for held-set bookkeeping but add no
  edges — a ``try``-acquire cannot deadlock.  Entered inside another
  lock-order sanitizer (the reference's), it wraps that one's factories and
  restores them on exit.
* :class:`AxisSanitizer` — arms run-time validation of the
  :func:`repro_torch.annotations.axes` shape contracts.  While the scope is
  active, every call to an ``@axes``-annotated function unifies the
  declared named axes against the actual ``.shape`` tuples and raises
  :class:`~repro_torch.annotations.AxisContractError` on a transposed or
  mismatched dispatch, before the function runs (so before any kernel
  launches).  Outside the scope the wrappers check one module-global
  integer and call straight through.

The lock/recompile sanitizers only observe objects *created inside* their
scope: an engine constructed before ``__enter__`` keeps its raw locks.
That is the intended test shape — construct the system under test inside
the scope.  The axis sanitizer has no such restriction (contracts live on
the functions, not on instances), and it checks calls from every thread,
the engine's dispatcher included.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "AxisSanitizer",
    "LockOrderError",
    "LockOrderSanitizer",
    "RecompileError",
    "RecompileSanitizer",
]


class RecompileError(AssertionError):
    """A scope built more than its budget allows."""


class LockOrderError(AssertionError):
    """The scope's lock-order graph contains a cycle (potential deadlock)."""


# --------------------------------------------------------------------------- #
# RecompileSanitizer
# --------------------------------------------------------------------------- #


class RecompileSanitizer:
    """Fail (or record) builds happening inside the scope.

    Args:
      allowed_lowerings: dispatch-cache builds the scope may perform (0 for
        a steady-state scope that was warmed beforehand).
      allowed_builds: budget for ``nvcc`` runs
        (:data:`repro_torch.kernels.build.nvcc_runs`); ``None`` disables
        that check (the counter is process-wide, as the reference's compile
        log is, so a build on another thread would count too — keep it
        ``None`` unless the scope owns the process).
      record_only: never raise; just expose the counters.

    After exit: ``aot_lowerings``, ``builds`` (``nvcc`` runs) and
    ``library_loads`` describe what happened.
    """

    def __init__(
        self,
        allowed_lowerings: int = 0,
        allowed_builds: Optional[int] = None,
        record_only: bool = False,
    ):
        self.allowed_lowerings = int(allowed_lowerings)
        self.allowed_builds = allowed_builds
        self.record_only = bool(record_only)
        self.aot_lowerings = 0
        self.builds = 0
        self.library_loads = 0
        self._aot0 = 0
        self._builds0 = 0
        self._loads0 = 0

    def __enter__(self) -> "RecompileSanitizer":
        from ..core.aot import AotDispatchCache
        from ..kernels import build

        self._aot0 = AotDispatchCache.total_lowerings()
        self._builds0, self._loads0 = build.nvcc_runs, build.library_loads
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        from ..core.aot import AotDispatchCache
        from ..kernels import build

        self.aot_lowerings = AotDispatchCache.total_lowerings() - self._aot0
        self.builds = build.nvcc_runs - self._builds0
        self.library_loads = build.library_loads - self._loads0
        if self.record_only or exc_type is not None:
            return  # never mask the body's own failure
        problems = []
        if self.aot_lowerings > self.allowed_lowerings:
            problems.append(
                f"{self.aot_lowerings} dispatch-cache build(s) (allowed "
                f"{self.allowed_lowerings}) — a steady-state scope should be "
                "served from AotDispatchCache"
            )
        if self.allowed_builds is not None and self.builds > self.allowed_builds:
            problems.append(
                f"{self.builds} nvcc run(s) (allowed {self.allowed_builds}) — "
                "a steady-state scope should launch libraries already built"
            )
        if problems:
            raise RecompileError("recompile sanitizer: " + "; ".join(problems))


# --------------------------------------------------------------------------- #
# LockOrderSanitizer
# --------------------------------------------------------------------------- #


def _creation_site() -> str:
    """``file:line`` of the frame that called the patched lock factory."""
    f = sys._getframe(2)
    # skip interpreter-internal threading frames (Condition() building its
    # own lock, etc.) so the site names user code when possible
    while f is not None and f.f_globals.get("__name__", "").startswith(
        "threading"
    ):
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{f.f_code.co_filename}:{f.f_lineno}"


class _TrackedLock:
    """Wrapper around a raw lock that reports acquisitions to the sanitizer.

    Keeps working (as a plain pass-through) after the sanitizer scope ends,
    since threads started inside the scope may outlive it.
    """

    __slots__ = ("_raw", "site", "_san", "_reentrant", "_owner", "_count")

    def __init__(self, raw, site: str, san: "LockOrderSanitizer", reentrant: bool):
        self._raw = raw
        self.site = site
        self._san = san
        self._reentrant = reentrant
        self._owner: Optional[int] = None  # reentrant bookkeeping only
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            self._count += 1
            return self._raw.acquire(blocking, timeout)
        if blocking and self._san._active:
            # record the *intent* before blocking: a deadlocked acquire
            # never returns, but the edge that caused it must still exist
            self._san._note_edges(self, me)
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            if self._reentrant:
                self._owner, self._count = me, 1
            self._san._push(self, me)
        return ok

    def release(self) -> None:
        if self._reentrant and self._owner == threading.get_ident():
            self._count -= 1
            if self._count > 0:
                self._raw.release()
                return
            self._owner = None
        self._san._pop(self, threading.get_ident())
        self._raw.release()

    def locked(self) -> bool:
        return self._raw.locked()

    # Condition() integration: threading.Condition looks these up on its
    # lock (real RLocks provide them; its probe-based fallbacks misread a
    # reentrant wrapper as un-owned).  They must also keep the sanitizer's
    # held-set bookkeeping consistent across a wait()'s release/reacquire.

    def _is_owned(self) -> bool:
        if self._reentrant:
            return self._raw._is_owned()
        if self._raw.acquire(False):  # plain-lock probe, bookkeeping-free
            self._raw.release()
            return False
        return True

    def _release_save(self):
        me = threading.get_ident()
        if self._reentrant:
            count, owner = self._count, self._owner
            self._count, self._owner = 0, None
            self._san._pop(self, me)
            return (count, owner, self._raw._release_save())
        self._san._pop(self, me)
        self._raw.release()
        return None

    def _acquire_restore(self, state) -> None:
        me = threading.get_ident()
        if self._san._active:
            # waking from wait() reacquires while possibly holding other
            # locks — a real ordering edge, recorded like any acquire
            self._san._note_edges(self, me)
        if self._reentrant:
            count, owner, raw_state = state
            self._raw._acquire_restore(raw_state)
            self._count, self._owner = count, owner
        else:
            self._raw.acquire()
        self._san._push(self, me)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # shows up in deadlock reports
        return f"<TrackedLock {self.site}>"


class LockOrderSanitizer:
    """Build a creation-site lock-order graph for the scope; cycles raise.

    The classic report: thread A acquires lock₁ then lock₂ while thread B
    acquires lock₂ then lock₁ — each order is an edge, the pair is a cycle,
    and the scope ends with a :class:`LockOrderError` naming both sites and
    the witnessing threads, whether or not the timing actually deadlocked
    on this run.
    """

    def __init__(self, record_only: bool = False):
        self.record_only = bool(record_only)
        self._active = False
        self._orig_lock = None
        self._orig_rlock = None
        # raw (never wrapped) lock protecting the sanitizer's own state
        self._struct = threading.Lock()
        self._held: Dict[int, List[_TrackedLock]] = {}
        # (site_from, site_to) -> first witness description
        self.edges: Dict[Tuple[str, str], str] = {}
        self.locks_created = 0

    # -- tracking hooks (called from _TrackedLock) ---------------------- #

    def _note_edges(self, lock: _TrackedLock, thread_id: int) -> None:
        # NOT threading.current_thread(): from a not-yet-registered thread
        # it constructs a _DummyThread whose Event acquires a wrapped lock,
        # recursing straight back here.  The registry read has no side
        # effects; unregistered threads report their ident.
        t = getattr(threading, "_active", {}).get(thread_id)
        tname = t.name if t is not None else f"tid={thread_id}"
        with self._struct:
            for held in self._held.get(thread_id, ()):
                # same-site edges are skipped: sites aggregate every lock a
                # line creates (lock striping, per-session locks), and the
                # graph cannot see an ordering *within* one site — flagging
                # them would make ordered same-site acquisition cry wolf
                if held is lock or held.site == lock.site:
                    continue
                edge = (held.site, lock.site)
                if edge not in self.edges:
                    self.edges[edge] = (
                        f"thread {tname!r} acquired {lock.site} while "
                        f"holding {held.site}"
                    )

    def _push(self, lock: _TrackedLock, thread_id: int) -> None:
        with self._struct:
            self._held.setdefault(thread_id, []).append(lock)

    def _pop(self, lock: _TrackedLock, thread_id: int) -> None:
        with self._struct:
            stack = self._held.get(thread_id)
            if stack and lock in stack:
                stack.reverse()
                stack.remove(lock)
                stack.reverse()
                return
            # released from a different thread than the acquirer (legal for
            # plain Locks): find and drop it wherever it is held
            for other in self._held.values():
                if lock in other:
                    other.remove(lock)
                    return

    # -- lifecycle ------------------------------------------------------ #

    def __enter__(self) -> "LockOrderSanitizer":
        self._orig_lock = threading.Lock
        self._orig_rlock = threading.RLock
        san = self

        def make_lock():  # noqa: ANN202 - threading factory signature
            san.locks_created += 1
            return _TrackedLock(san._orig_lock(), _creation_site(), san, False)

        def make_rlock():
            san.locks_created += 1
            return _TrackedLock(san._orig_rlock(), _creation_site(), san, True)

        threading.Lock = make_lock  # type: ignore[misc]
        threading.RLock = make_rlock  # type: ignore[misc]
        self._active = True
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._active = False
        threading.Lock = self._orig_lock  # type: ignore[misc]
        threading.RLock = self._orig_rlock  # type: ignore[misc]
        if exc_type is not None:  # never mask the body's own failure
            return
        cycle = self.find_cycle()
        if cycle and not self.record_only:
            raise LockOrderError(self.format_cycle(cycle))

    # -- reporting ------------------------------------------------------ #

    def find_cycle(self) -> Optional[List[str]]:
        """A list of sites forming a cycle in the order graph, or None."""
        with self._struct:
            adj: Dict[str, List[str]] = {}
            for a, b in self.edges:
                adj.setdefault(a, []).append(b)
        WHITE, GREY, BLACK = 0, 1, 2
        color: Dict[str, int] = {}
        parent: Dict[str, str] = {}

        def dfs(start: str) -> Optional[List[str]]:
            stack = [(start, iter(adj.get(start, ())))]
            color[start] = GREY
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    c = color.get(nxt, WHITE)
                    if c == GREY:  # back edge: unwind the cycle
                        cyc = [nxt, node]
                        cur = node
                        while cur != nxt:
                            cur = parent[cur]
                            cyc.append(cur)
                        cyc.reverse()
                        return cyc
                    if c == WHITE:
                        parent[nxt] = node
                        color[nxt] = GREY
                        stack.append((nxt, iter(adj.get(nxt, ()))))
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
            return None

        for site in list(adj):
            if color.get(site, WHITE) == WHITE:
                cyc = dfs(site)
                if cyc:
                    return cyc
        return None

    def format_cycle(self, cycle: List[str]) -> str:
        lines = ["lock-order cycle (potential deadlock):"]
        with self._struct:
            for a, b in zip(cycle, cycle[1:]):
                witness = self.edges.get((a, b), "")
                lines.append(f"  {a} -> {b}    [{witness}]")
        return "\n".join(lines)


# --------------------------------------------------------------------------- #
# AxisSanitizer
# --------------------------------------------------------------------------- #


class AxisSanitizer:
    """Arm run-time checking of ``@axes`` named-axis contracts for a scope.

    A lifecycle wrapper around :class:`repro_torch.annotations.axes_validation`
    that matches the other sanitizers' shape.  Default mode raises
    :class:`~repro_torch.annotations.AxisContractError` at the violating
    call; ``record_only=True`` collects violation messages into
    ``self.violations`` and, on a clean body exit, raises nothing — the
    caller inspects the list.  After exit ``checks`` is the number of
    contract checks made while the scope was armed (from every thread).
    """

    def __init__(self, record_only: bool = False):
        self.record_only = bool(record_only)
        self.violations: List[str] = []
        self.checks = 0
        self._checks0 = 0
        self._scope = None

    def __enter__(self) -> "AxisSanitizer":
        from .. import annotations

        sink = self.violations if self.record_only else None
        self._checks0 = annotations.checks
        self._scope = annotations.axes_validation(sink=sink).__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        from .. import annotations

        if self._scope is not None:
            self._scope.__exit__(exc_type, exc, tb)
            self._scope = None
        self.checks = annotations.checks - self._checks0
