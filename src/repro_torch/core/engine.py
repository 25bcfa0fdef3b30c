"""Shared asynchronous analysis engine — one dispatcher for every attached
session (port of ``repro/core/engine.py``).

The paper's central claim is *low-overhead attach*: the Timing Analyzer must
hide behind the attached program's own execution.  :class:`AnalysisEngine`
is one dispatcher thread that serves every session that asks for
asynchronous analysis: ``CXLMemSim`` and ``FabricSession`` by default, as
in the reference, or either with ``engine=``; ``async_analysis=False``
asks for the synchronous path.

  * **Sessions register** (:meth:`AnalysisEngine.register`) and get an
    :class:`EngineHandle`; ``handle.submit(traces, scales, fold=...)``
    enqueues one epoch batch and returns a
    :class:`concurrent.futures.Future` resolving to the batch's
    :class:`~repro_torch.core.analyzer.DelayBreakdown`.
  * **Backpressure**: each handle allows ``max_inflight`` outstanding
    batches (default 2); ``submit`` blocks past that.
  * **Cross-session coalescing**: while the dispatcher is busy, submissions
    from *different* sessions accumulate; sessions with equal
    :func:`dispatch_key` are coalesced into one
    :meth:`~repro_torch.core.analyzer.EpochAnalyzer.analyze_batch_multi`
    dispatch — on the card one cascade launch over all K·B epoch rows — with
    per-session totals.  Two batches of the *same* session are never
    coalesced: each handle's submissions run FIFO, one dispatch each, so a
    solo session's asynchronous results are bitwise its synchronous ones.
  * **Depth-1 software pipeline**: the dispatcher launches batch k+1
    (staging, H2D, kernels) before it finishes batch k (the D2H copy, the
    folds, the futures), so a solo pipeline session's host staging
    overlaps its previous batch's device work.
  * **Its own CUDA stream**: the dispatcher thread makes one
    ``torch.cuda.Stream`` per device it serves and makes it the thread's
    current stream, so its kernels and copies never queue behind — or in
    front of — the attached programs' work on their own streams.
  * **Thread-safe folding**: the optional ``fold(breakdown, analyzer_s)``
    callback runs on the dispatcher thread; sessions fold under their own
    report lock.
  * **Dropped-batch accounting**: a failing batch is recorded
    (``handle.dropped_batches`` / ``dropped_epochs``) before its error is
    re-raised, once, from ``handle.flush()``.
  * **Lifecycle**: ``handle.close()`` drains and releases a session;
    ``engine.close()`` (or the context manager) drains everything and joins
    the thread.  The lazily-created process-default engine
    (:meth:`AnalysisEngine.default`) keeps one daemon dispatcher for the
    whole process.

Staging buffers: the engine owns its :class:`~repro_torch.core.events.EventStager`
set — one ``slots=2`` ring per dtype, pinned when it stages for a CUDA
pipeline analyzer — so the dispatcher never shares mutable host buffers
with a session's own synchronous calls, and every batch it dispatches is
staged through that ring only.

``mesh=`` (a ``('data',)`` :class:`~repro_torch.launch.mesh.Mesh`) splits
every coalesced dispatch's session axis over its entries, as the
reference's does; the dispatcher makes its own stream current on each
CUDA device of the mesh as on the analyzer's.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..annotations import guarded_by, single_threaded
from ..launch.mesh import mesh_devices, resolve_device
from .analyzer import (
    DelayBreakdown,
    DispatchStats,
    EpochAnalyzer,
    PendingBatch,
    analyze_any,
)
from .events import EventStager, MemEvents
from .spans import span

__all__ = [
    "AnalysisEngine",
    "EngineClient",
    "EngineHandle",
    "dispatch_key",
    "fold_dispatch_stats",
]


def dispatch_key(analyzer) -> Optional[Tuple]:
    """Coalescing signature: submissions from handles with equal keys may
    share one stacked dispatch.  ``None`` means "never coalesce" (analyzers
    that are not an :class:`EpochAnalyzer`, such as the DES).  The key
    hashes the topology's numeric leaves, not object identity, so distinct
    sessions on equal topologies batch together.

    It is the reference's key plus what the stacked dispatch runs every
    session under but the reference's key leaves out: the device, each
    switch's arbitration discipline, the class-weight table and the class
    count.  Sessions that differ only in arbitration therefore never
    coalesce (the reference's would, and analyze one under the other's
    arbitration).
    """
    if not isinstance(analyzer, EpochAnalyzer):
        return None
    flat = analyzer.flat
    return (
        bool(analyzer.pipeline),
        bool(analyzer.fused),
        int(analyzer.n_windows),
        str(analyzer.dtype),
        float(analyzer.bw_window_ns),
        analyzer._stage_order,
        analyzer._merge_plan,
        int(flat.n_hosts),
        np.asarray(flat.route).tobytes(),
        np.asarray(flat.pool_latency_ns).tobytes(),
        float(flat.local_latency_ns),
        np.asarray(flat.switch_stt_ns).tobytes(),
        np.asarray(flat.switch_bandwidth_gbps).tobytes(),
        str(analyzer.device),
        np.asarray(flat.discipline_codes()).tobytes(),
        np.asarray(flat.class_weight_table()).tobytes(),
        int(flat.n_qos_classes),
    )


def fold_dispatch_stats(report, stats, group_size: int) -> None:
    """Fold one dispatch's observability record into a report.

    ``report`` is any object with ``devices_used`` / ``shard_rows`` /
    ``padded_waste`` / ``coalesced_group_size`` and the timing-split fields
    (:class:`~repro_torch.core.attach.SimReport`,
    :class:`~repro_torch.core.fabric.FabricReport`).  Device counts, shard
    widths and group sizes keep their maxima; padded waste keeps the worst
    fraction seen; the timing split and ``h2d_bytes`` accumulate (coalesced
    dispatches report zero timing and bytes on every member, so sharing
    never double-counts).  Callers hold their report lock.
    """
    if stats is not None:
        report.devices_used = max(report.devices_used, stats.devices_used)
        report.shard_rows = max(report.shard_rows, stats.shard_rows)
        report.padded_waste = max(report.padded_waste, stats.padded_fraction)
        report.stage_s += stats.stage_s
        report.transfer_s += stats.transfer_s
        report.compile_s += stats.compile_s
        report.compute_s += stats.compute_s
        report.h2d_bytes += stats.h2d_bytes
        if stats.donated:
            report.donated_dispatches += 1
        if stats.aot_cache_hit:
            report.aot_cache_hits += 1
    if group_size:
        report.coalesced_group_size = max(
            report.coalesced_group_size, int(group_size)
        )


@dataclasses.dataclass
class _Submission:
    handle: "EngineHandle"
    traces: List[MemEvents]
    scales: Optional[List]
    fold: Optional[Callable[[DelayBreakdown, float], None]]
    future: Future


@dataclasses.dataclass
class _Launched:
    """One launched-but-unresolved dispatch in the worker's depth-1
    pipeline.  Exactly one of ``pending`` (overlapped solo launch) or
    ``bds`` (synchronously computed results) is set when ``error`` is
    None.  ``stats`` is the dispatch's own record, taken when ``bds`` is
    computed: by the time the group is finished, the analyzer's
    ``last_dispatch`` may belong to a later dispatch of the same analyzer."""

    group: List[_Submission]
    live: List[_Submission]
    pending: Optional[PendingBatch]
    bds: Optional[List[DelayBreakdown]]
    launch_s: float
    error: Optional[BaseException]
    stats: Optional[DispatchStats] = None


class EngineHandle:
    """One session's port into the engine; created by
    :meth:`AnalysisEngine.register`.  Not constructed directly."""

    # handle state is shared between the submitting thread and the
    # dispatcher; everything mutable rides under the engine's one lock
    _simlint_guards = guarded_by(
        "_cv",
        "_inflight",
        "_error",
        "_closed",
        "dropped_batches",
        "dropped_epochs",
        "_pending",
        "_broken",
    )

    def __init__(
        self,
        engine: "AnalysisEngine",
        analyzer,
        key: Optional[Tuple],
        max_inflight: int,
    ):
        self.engine = engine
        self.analyzer = analyzer
        self.key = key
        if int(max_inflight) < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight} — a 0-depth "
                "handle could never admit a submission"
            )
        self.max_inflight = int(max_inflight)
        self._inflight = 0  # guarded by engine._cv
        self._error: Optional[BaseException] = None
        self._closed = False
        self.dropped_batches = 0
        self.dropped_epochs = 0
        # dispatch observability, written by the dispatcher thread before
        # fold callbacks run (sessions copy these into their reports)
        self.last_dispatch = None  # Optional[DispatchStats]
        self.last_group_size = 0

    # -- session-facing API -------------------------------------------------- #

    def submit(
        self,
        traces: Sequence[MemEvents],
        scales: Optional[Sequence] = None,
        fold: Optional[Callable[[DelayBreakdown, float], None]] = None,
    ) -> Future:
        """Enqueue one epoch batch; returns a Future of its breakdown.

        Blocks while ``max_inflight`` batches of this handle are already in
        flight (backpressure).  ``fold(breakdown, analyzer_s)`` runs on the
        dispatcher thread after analysis, before the future resolves;
        ``analyzer_s`` is this batch's share of the dispatch's seconds
        (attributed by epoch count when coalesced)."""
        eng = self.engine
        with eng._cv:
            self._check_open_locked()
            eng._ensure_thread_locked()
            with span("engine.submit_wait"):
                while self._inflight >= self.max_inflight:
                    self._check_open_locked()
                    eng._cv.wait(1.0)
            self._check_open_locked()
            self._inflight += 1
            fut: Future = Future()
            eng._pending.append(
                _Submission(
                    self, list(traces), None if scales is None else list(scales), fold, fut
                )
            )
            eng._cv.notify_all()
        return fut

    def flush(self) -> None:
        """Block until every submitted batch of this handle is folded, then
        re-raise the first recorded error (once).  Dropped-batch counters
        persist."""
        eng = self.engine
        with eng._cv:
            with span("engine.flush_wait"):
                while self._inflight > 0:
                    if eng._broken:
                        raise RuntimeError("analysis engine dispatcher died")
                    eng._cv.wait(1.0)
            err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self) -> None:
        """Drain and release the handle (idempotent).  The engine — and its
        dispatcher thread — stays up for other sessions."""
        try:
            with self.engine._cv:
                closed = self._closed
            if not closed:
                self.flush()
        finally:
            with self.engine._cv:
                self._closed = True
                self.engine._cv.notify_all()

    # -- dispatcher-side helpers -------------------------------------------- #

    def _check_open_locked(self) -> None:
        if self._closed:
            raise RuntimeError(
                "engine handle is closed — submit() after close() would "
                "enqueue work no dispatcher will ever drain"
            )
        if self.engine._closed:
            raise RuntimeError("analysis engine is closed")
        if self.engine._broken:
            raise RuntimeError("analysis engine dispatcher died")

    def _analyze(self, traces, scales, stager) -> DelayBreakdown:
        """Solo analysis of one batch (coalesced groups go through
        :meth:`EpochAnalyzer.analyze_batch_multi` instead)."""
        return analyze_any(self.analyzer, traces, scales, stager=stager)

    def _record_error_locked(self, err: BaseException, n_epochs: int) -> None:
        self.dropped_batches += 1
        self.dropped_epochs += int(n_epochs)
        if self._error is None:
            self._error = err


class EngineClient:
    """Handle lifecycle shared by every session type that folds through the
    engine (``AttachedProgram``, ``FabricSession``).

    Subclasses provide ``_handle`` (an :class:`EngineHandle`, or ``None``
    for synchronous sessions, whose ``flush`` and ``close`` return at once),
    ``_report_lock`` and ``_report`` (any object with ``dropped_batches`` /
    ``dropped_epochs`` fields)."""

    _handle: Optional[EngineHandle] = None
    # the report belongs to the session's lock; the handle's drop counters
    # belong to the engine's — _sync_dropped bridges them (never nested)
    _simlint_guards = guarded_by("_report_lock", "_report") | guarded_by(
        "_cv", "_handle.dropped_batches", "_handle.dropped_epochs"
    )

    def flush(self) -> None:
        """Block until every submitted batch has been analyzed and folded.

        Re-raises the first analyzer failure (once); the failed batch's
        epochs stay recorded as ``report.dropped_batches`` /
        ``dropped_epochs``."""
        if self._handle is None:
            return
        try:
            self._handle.flush()
        finally:
            self._sync_dropped()

    def close(self) -> None:
        """Flush and release the engine handle (idempotent).  The shared
        engine's dispatcher thread stays up for other sessions."""
        if self._handle is None:
            return
        try:
            self._handle.close()
        finally:
            self._sync_dropped()

    def _sync_dropped(self) -> None:
        # the drop counters are dispatcher-written under the *engine's*
        # lock; snapshot them there, then publish under the report lock
        # (two disjoint critical sections — no nesting, no lock-order edge)
        with self._handle.engine._cv:
            dropped_batches = self._handle.dropped_batches
            dropped_epochs = self._handle.dropped_epochs
        with self._report_lock:
            self._report.dropped_batches = dropped_batches
            self._report.dropped_epochs = dropped_epochs

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AnalysisEngine:
    """One dispatcher thread serving any number of attached sessions; see
    the module docstring.  ``mesh`` splits every coalesced dispatch over its
    entries (None: each analyzer's own mesh, if any)."""

    _simlint_guards = guarded_by(
        "_cv",
        "_pending",
        "_thread",
        "_closed",
        "_broken",
        "_active",
        "_stagers",
        "_streams",
        "dispatches",
        "coalesced_dispatches",
        "max_coalesced_sessions",
        "_inflight",
    ) | guarded_by("_default_lock", "_default")

    def __init__(
        self,
        name: str = "cxlmemsim-engine",
        mesh=None,
    ):
        self.name = name
        if mesh is not None:
            mesh_devices(mesh)  # a Mesh with devices, or raise here
        self.mesh = mesh
        self._cv = threading.Condition(threading.Lock())
        self._pending: Deque[_Submission] = deque()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._broken = False
        self._active = 0  # dispatches currently executing (guarded by _cv)
        self._stagers: Dict[Tuple[np.dtype, bool], EventStager] = {}
        # the dispatcher thread's own stream per CUDA device it has served
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        # observability (read-only; updated under _cv)
        self.dispatches = 0
        self.coalesced_dispatches = 0
        self.max_coalesced_sessions = 1

    # -- lifecycle ----------------------------------------------------------- #

    _default_lock = threading.Lock()
    _default: Optional["AnalysisEngine"] = None

    @classmethod
    def default(cls) -> "AnalysisEngine":
        """The lazily-created process-wide engine: one daemon dispatcher
        shared by every session that doesn't bring its own engine.  A
        closed — or crashed — default engine is replaced (already-registered
        handles keep raising; new sessions get a fresh engine)."""
        with cls._default_lock:
            d = cls._default
            # reading another engine's _closed/_broken without ITS _cv is a
            # benign race: a stale value only defers replacement by one call
            if d is None or d._closed or d._broken:  # simlint: ignore[lock-discipline] -- benign race: stale _closed/_broken only delays replacing the default engine one call
                cls._default = cls()
            return cls._default

    def register(self, analyzer, max_inflight: int = 2) -> EngineHandle:
        """Attach a session's analyzer; returns its :class:`EngineHandle`.

        ``analyzer`` is an :class:`~repro_torch.core.analyzer.EpochAnalyzer`
        (coalescible) or any object with ``.flat`` and ``.simulate``
        (dispatched solo)."""
        with self._cv:
            if self._closed:
                raise RuntimeError("analysis engine is closed")
        return EngineHandle(self, analyzer, dispatch_key(analyzer), max_inflight)

    def flush(self) -> None:
        """Block until the queue is empty and no dispatch is running.
        Per-handle errors stay with their handles (``handle.flush``)."""
        with self._cv:
            while self._pending or self._active:
                if self._broken:
                    raise RuntimeError("analysis engine dispatcher died")
                self._cv.wait(1.0)

    def close(self) -> None:
        """Drain outstanding work, stop the dispatcher, join it (idempotent)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
            thread = self._thread
        if (
            thread is not None
            and thread.is_alive()
            and thread is not threading.current_thread()
        ):
            thread.join()

    def __enter__(self) -> "AnalysisEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stream(self, device) -> Optional["torch.cuda.Stream"]:
        """The dispatcher's own stream on ``device`` (None until it has
        dispatched there)."""
        dev = torch.device(device)
        if dev.type == "cuda" and torch.cuda.is_available():
            dev = resolve_device(dev)
        with self._cv:
            return self._streams.get(dev)

    # -- dispatcher ---------------------------------------------------------- #

    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker, name=self.name, daemon=True
            )
            self._thread.start()

    @single_threaded("dispatcher-thread only: called from _launch, and the "
                     "engine runs exactly one dispatcher")
    def _stager_for(self, analyzer) -> Optional[EventStager]:
        if not isinstance(analyzer, EpochAnalyzer):
            return None
        dt = np.dtype(str(analyzer.dtype).replace("torch.", ""))
        # pinned [B, N] planes only where an asynchronous copy reads them, as
        # the analyzer's own stager (the compact slots of the default path
        # are pinned by the dispatch's device)
        pin = analyzer.pipeline and analyzer.device.type == "cuda"
        st = self._stagers.get((dt, pin))
        if st is None:
            # slots=2: the dispatcher stages batch k+1 while batch k's
            # planes may still back an in-flight copy
            st = self._stagers[(dt, pin)] = EventStager(dt, slots=2, pin=pin)
        return st

    def _enter_device(self, analyzer) -> None:
        """Make the dispatcher's own stream current on the analyzer's CUDA
        device and on every CUDA device of the mesh its coalesced
        dispatches split over (each stream created on first use there).  A
        thread's current stream is its own, so this changes nothing for the
        sessions' threads; the kernels, the ring's copies and its events all
        follow it, and a shard on another card never queues on that card's
        default stream."""
        dev = getattr(analyzer, "device", None)
        devices = [] if dev is None else [dev]
        mesh = self.mesh if self.mesh is not None else getattr(analyzer, "mesh", None)
        if mesh is not None:
            devices += mesh_devices(mesh)
        for d in dict.fromkeys(resolve_device(d) for d in devices if d.type == "cuda"):
            with self._cv:
                stream = self._streams.get(d)
                if stream is None:
                    # the default priority, the attached programs' own: a
                    # higher one moved neither the step's native time nor
                    # the wall time beyond the spread on the card (PERF.md,
                    # PR 22)
                    stream = self._streams[d] = torch.cuda.Stream(d)
            if torch.cuda.current_stream(d) != stream:
                torch.cuda.set_stream(stream)

    def _pop_group_locked(self) -> List[_Submission]:
        """FIFO head plus the first pending submission of every *other*
        same-key handle.  Same-handle batches never share a
        dispatch (bit-stability of the solo path; per-handle FIFO order)."""
        first = self._pending.popleft()
        group = [first]
        if first.handle.key is not None:
            taken = {id(first.handle)}
            kept: Deque[_Submission] = deque()
            while self._pending:
                sub = self._pending.popleft()
                if sub.handle.key == first.handle.key and id(sub.handle) not in taken:
                    taken.add(id(sub.handle))
                    group.append(sub)
                else:
                    kept.append(sub)
            self._pending = kept
        return group

    def _worker(self) -> None:
        # Depth-1 software pipeline: after launching a dispatch, the worker
        # does NOT block on its result — it first pops and launches the next
        # group, so batch k+1's host work overlaps batch k's device work.
        # The previous dispatch is finished (D2H, folds, futures) only once
        # the next one is in flight, or at once when the queue drains, so a
        # lone submission never waits on a successor.
        pend: Optional[_Launched] = None
        try:
            while True:
                group = None
                with self._cv:
                    if pend is None:
                        while not self._pending and not self._closed:
                            self._cv.wait(1.0)
                    if self._pending:
                        group = self._pop_group_locked()
                        self._active += 1
                    elif pend is None and self._closed:
                        return  # closed and drained
                if group is not None:
                    with span("engine.launch"):
                        launched = self._launch(group)
                    if pend is not None:
                        with span("engine.finish"):
                            self._finish(pend)
                    pend = launched
                else:
                    with span("engine.finish"):
                        self._finish(pend)
                    pend = None
        except BaseException:
            with self._cv:
                self._broken = True
                self._cv.notify_all()
            raise

    def _launch(self, group: List[_Submission]) -> "_Launched":
        """Stage, transfer and launch one group without blocking on results.

        Solo :class:`EpochAnalyzer` submissions launch asynchronously
        (:meth:`EpochAnalyzer.launch_batch`); DES analyzers and coalesced
        stacks compute synchronously here and carry finished breakdowns.
        Never raises — a launch failure is carried in the returned record
        and surfaced by :meth:`_finish`."""
        live = group
        t0 = time.perf_counter()
        try:
            self._enter_device(group[0].handle.analyzer)
            stager = self._stager_for(group[0].handle.analyzer)
            if len(group) > 1:
                # per-session validation BEFORE stacking: one session's bad
                # trace (unreachable route, scales mismatch) must drop only
                # that session's batch, never its coalesced peers'
                live = []
                for sub in group:
                    try:
                        sub.handle.analyzer._clean_pairs(sub.traces, sub.scales)
                    except BaseException as e:
                        with self._cv:
                            sub.handle._record_error_locked(e, len(sub.traces))
                        self._resolve(sub.future, error=e)
                    else:
                        live.append(sub)
            pending: Optional[PendingBatch] = None
            bds: Optional[List[DelayBreakdown]] = None
            analyzer = live[0].handle.analyzer if live else None
            if not live:
                bds = []
            elif (
                len(live) == 1
                and isinstance(live[0].handle.analyzer, EpochAnalyzer)
                and type(live[0].handle.analyzer).analyze_batch
                is EpochAnalyzer.analyze_batch
            ):
                # the overlapped fast path talks to launch_batch directly;
                # subclasses that override analyze_batch (tests inject
                # failures there) keep the synchronous route
                sub = live[0]
                pending = sub.handle.analyzer.launch_batch(
                    sub.traces, sub.scales, stager=stager
                )
            elif len(live) == 1:
                sub = live[0]
                bds = [sub.handle._analyze(sub.traces, sub.scales, stager)]
            else:
                bds = live[0].handle.analyzer.analyze_batch_multi(
                    [s.traces for s in live],
                    [s.scales for s in live],
                    stager=stager,
                    mesh=self.mesh,
                )
            # a coalesced or synchronous dispatch's record, read before the
            # next launch (or the pending batch's finish) overwrites it
            stats = None if pending is not None else getattr(analyzer, "last_dispatch", None)
            return _Launched(
                group, live, pending, bds, time.perf_counter() - t0, None, stats
            )
        except BaseException as e:
            return _Launched(group, live, None, None, time.perf_counter() - t0, e)

    def _finish(self, launched: "_Launched") -> None:
        """Resolve one launched group: block on the device result if it was
        an overlapped launch, run folds, resolve futures, release inflight
        slots."""
        group, live = launched.group, launched.live
        try:
            if launched.error is not None:
                raise launched.error
            t0 = time.perf_counter()
            stats = launched.stats
            if launched.pending is not None:
                bds: List[DelayBreakdown] = [launched.pending.finish()]
                stats = launched.pending.stats  # final once finished
            else:
                bds = launched.bds
            # launch work + exposed finish wait; the overlap gap (spent
            # launching the NEXT group) is deliberately excluded
            elapsed = launched.launch_s + (time.perf_counter() - t0)
            if live:
                # written before the fold loop so fold callbacks see this
                # dispatch's stats on their own handle, even when a peer's
                # analyzer ran the stacked dispatch
                for sub in live:
                    sub.handle.last_dispatch = stats
                    sub.handle.last_group_size = len(live)
            total_epochs = sum(len(s.traces) for s in live)
            with self._cv:
                if live:
                    self.dispatches += 1
                if len(live) > 1:
                    self.coalesced_dispatches += 1
                    self.max_coalesced_sessions = max(
                        self.max_coalesced_sessions, len(live)
                    )
            for sub, bd in zip(live, bds):
                # the dispatch's seconds are attributed across the coalesced
                # group by epoch share (evenly when all batches are empty)
                if len(live) == 1:
                    share = elapsed
                elif total_epochs:
                    share = elapsed * len(sub.traces) / total_epochs
                else:
                    share = elapsed / len(live)
                try:
                    if sub.fold is not None:
                        sub.fold(bd, share)
                    self._resolve(sub.future, result=bd)
                except BaseException as e:  # analyzed but not folded: dropped
                    with self._cv:
                        sub.handle._record_error_locked(e, len(sub.traces))
                    self._resolve(sub.future, error=e)
        except BaseException as e:  # whole dispatch failed: every live batch
            with self._cv:  # dropped (validation failures already recorded)
                for sub in live:
                    sub.handle._record_error_locked(e, len(sub.traces))
            for sub in live:
                self._resolve(sub.future, error=e)
        finally:
            with self._cv:
                self._active -= 1
                for sub in group:
                    sub.handle._inflight -= 1
                self._cv.notify_all()

    @staticmethod
    def _resolve(fut: Future, result=None, error=None) -> None:
        """Resolve a submission future, tolerating callers that cancelled
        it while pending — an externally-cancelled future must not take
        down the dispatcher."""
        try:
            if error is None:
                fut.set_result(result)
            else:
                fut.set_exception(error)
        except InvalidStateError:
            pass

    def stats(self) -> Dict[str, int]:
        with self._cv:
            return {
                "dispatches": self.dispatches,
                "coalesced_dispatches": self.coalesced_dispatches,
                "max_coalesced_sessions": self.max_coalesced_sessions,
                "pending": len(self._pending),
            }
