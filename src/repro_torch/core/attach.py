"""CXLMemSim.attach — the user-facing simulator (paper Figure 2, assembled),
ported from ``repro/core/attach.py``.

Wraps any PyTorch step function.  Per step:

  1. cut the step's structural trace into epochs (Timer), then on the host,
     in the reference's order: apply migration (remap the epoch to current
     residency and inject the copy traffic), inject coherency traffic, and
     run the device cache's tag simulation over the final epoch, whose hit
     fractions become the epoch's latency-scale row;
  2. asynchronously (the default for the epoch analyzer without delay
     injection, as in the reference; ``async_analysis=False`` asks for the
     synchronous path), submit the step's epoch batch to the shared
     :class:`~repro_torch.core.engine.AnalysisEngine` *before* the native
     step, so the analyzer works on its own thread and CUDA stream while
     the step executes;
  3. dispatch the real step and measure native wall time (the paper's
     "execution of the attached program"), waiting for the card only on
     the streams the step's outputs were produced on (the caller's current
     stream), never on the engine's;
  4. without an engine, analyze the step's epoch batch now with the Timing
     Analyzer — one :meth:`EpochAnalyzer.analyze_batch` call with the scale
     rows, one host transfer per step — and fold the delays into the report
     (the engine folds them from its thread);
  5. optionally ``time.sleep`` the computed delay — the paper's delay
     injection, making the host observe simulated-topology speed (this
     forces synchronous analysis: the delay must exist before it can be
     injected).

Two clocks are reported:

  * ``native_s``    — measured host execution time,
  * ``simulated_s`` — native + Σ delays (what the topology would impose),

plus the per-component delay decomposition, per-pool/switch.  ``analyzer_s``
is the analyzer's own seconds (the paper's overhead accounting).

``coherency=CoherencyModel(...)`` adds the analytic single-attach
back-invalidation traffic and coherency-miss latency, ``migration=`` (a
:class:`~repro_torch.core.migration.MigrationSimulator` over the program's
region map) hot/cold migration, and ``cache=`` (a
:class:`~repro_torch.core.cache.DeviceCacheConfig`) the expander-side device
cache; both run on the submitting thread, as the reference's do, so the
asynchronous and synchronous reports agree.  ``pipeline=True`` analyzes
through the device-resident epoch pipeline (pinned staging, the dispatch
cache's device buffers, the chain cascade on chain topologies), and
``warmup=True`` builds its dispatch-cache entry at attach.  Reading
:attr:`AttachedProgram.report` flushes in-flight asynchronous work first; a
batch lost to an analyzer failure is re-raised once from ``flush()`` and
recorded in ``dropped_batches`` / ``dropped_epochs``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .analyzer import (
    DelayBreakdown,
    EpochAnalyzer,
    FineGrainedSimulator,
    _check_device,
    analyze_any,
)
from ..annotations import guarded_by
from .cache import DeviceCacheConfig, DeviceCacheModel
from .coherency import CoherencyModel
from .engine import AnalysisEngine, EngineClient, EngineHandle, fold_dispatch_stats
from .events import MemEvents, RegionMap, concat_events
from .migration import MigrationSimulator
from .policy import PlacementPolicy, capacity_check
from .spans import span
from .timer import EpochSchedule
from .topology import Topology
from .tracer import H100_SXM, HardwareModel, Phase, synthesize_step_trace
from .units import ns_to_s

__all__ = ["CXLMemSim", "AttachedProgram", "SimReport"]


@dataclasses.dataclass
class SimReport:
    steps: int = 0
    epochs: int = 0
    native_s: float = 0.0
    simulated_s: float = 0.0
    latency_s: float = 0.0
    congestion_s: float = 0.0
    bandwidth_s: float = 0.0
    coherency_s: float = 0.0
    injected_sleep_s: float = 0.0
    analyzer_s: float = 0.0  # simulator's own cost (overhead accounting)
    per_pool_latency_ns: Optional[np.ndarray] = None
    per_switch_congestion_ns: Optional[np.ndarray] = None
    per_switch_bandwidth_ns: Optional[np.ndarray] = None
    qos_classes: int = 1  # arbitration classes of the attached fabric
    per_class_congestion_ns: Optional[np.ndarray] = None  # [qos_classes]
    migration_moved_bytes: float = 0.0
    cache_hit_fraction: float = float("nan")  # device-cache running hit rate
    dropped_batches: int = 0  # analysis batches lost to analyzer failures
    dropped_epochs: int = 0  # their epochs: totals exclude exactly these
    # sharded-dispatch observability (maxima over this session's dispatches)
    devices_used: int = 1  # devices the stacked dispatch sharded over
    shard_rows: int = 0  # per-device rows of the padded leading axis (0=unsharded)
    padded_waste: float = 0.0  # worst padding fraction of the leading axis
    coalesced_group_size: int = 1  # sessions stacked into one dispatch
    # pipeline-phase timing (sums over this session's dispatches)
    stage_s: float = 0.0  # host staging-plane pack time
    transfer_s: float = 0.0  # explicit H2D device_put time
    compile_s: float = 0.0  # AOT lowering time (first dispatch per shape only)
    compute_s: float = 0.0  # exposed device compute (post-overlap)
    donated_dispatches: int = 0  # dispatches whose input planes were donated
    aot_cache_hits: int = 0  # dispatches served from the AOT executable cache
    # bytes the dispatches copied host to device (DispatchStats.h2d_bytes);
    # the port's own, so not in summary(), whose keys are the reference's
    h2d_bytes: int = 0

    @property
    def slowdown(self) -> float:
        """Simulated time / native time — the paper's headline metric."""
        return self.simulated_s / self.native_s if self.native_s > 0 else float("nan")

    @property
    def overhead(self) -> float:
        """(native + analyzer + injected) / native: host-side cost of simulating."""
        if self.native_s <= 0:
            return float("nan")
        return (self.native_s + self.analyzer_s + self.injected_sleep_s) / self.native_s

    def qos_delay_shares(self) -> List[float]:
        """Fraction of switch queueing delay charged to each QoS class."""
        pcc = self.per_class_congestion_ns
        if pcc is None:
            return [1.0]
        total = float(pcc.sum())
        if total <= 0.0:
            return [0.0] * len(pcc)
        return [float(x) / total for x in pcc]

    def summary(self) -> Dict[str, float]:
        """The full report contract — every scalar a benchmark JSON consumer
        needs; the same key set as the reference's report."""
        return {
            "steps": self.steps,
            "epochs": self.epochs,
            "native_s": self.native_s,
            "simulated_s": self.simulated_s,
            "slowdown": self.slowdown,
            "latency_s": self.latency_s,
            "congestion_s": self.congestion_s,
            "bandwidth_s": self.bandwidth_s,
            "coherency_s": self.coherency_s,
            "injected_sleep_s": self.injected_sleep_s,
            "analyzer_s": self.analyzer_s,
            "overhead": self.overhead,
            "migration_moved_bytes": self.migration_moved_bytes,
            "cache_hit_fraction": self.cache_hit_fraction,
            "dropped_batches": self.dropped_batches,
            "dropped_epochs": self.dropped_epochs,
            "devices_used": self.devices_used,
            "shard_rows": self.shard_rows,
            "padded_waste": self.padded_waste,
            "coalesced_group_size": self.coalesced_group_size,
            "stage_s": self.stage_s,
            "transfer_s": self.transfer_s,
            "compile_s": self.compile_s,
            "compute_s": self.compute_s,
            "donated_dispatches": self.donated_dispatches,
            "aot_cache_hits": self.aot_cache_hits,
            "qos_classes": self.qos_classes,
            "qos_delay_shares": self.qos_delay_shares(),
        }


class CXLMemSim:
    """Configure once, attach to any number of step functions.

    ``device`` is where the analyzer runs: ``"cuda"`` (the default; raises
    when no card is present) or ``"cpu"`` (the plain PyTorch versions).
    ``async_analysis=True`` analyzes through ``engine`` (the process-wide
    :meth:`AnalysisEngine.default` when None); ``None``, the default, is
    asynchronous for the epoch analyzer without delay injection, as in the
    reference; ``async_analysis=False`` asks for the synchronous path.
    ``inject_delays`` always forces synchronous analysis."""

    def __init__(
        self,
        topology: Topology,
        policy: PlacementPolicy,
        epoch: EpochSchedule = EpochSchedule("step"),
        hw: HardwareModel = H100_SXM,
        inject_delays: bool = False,
        sample_rate: float = 1.0,
        migration: Optional[MigrationSimulator] = None,
        cache: Optional[DeviceCacheConfig] = None,
        coherency: Optional[CoherencyModel] = None,
        analyzer: str = "epoch",  # 'epoch' (paper) | 'fine' (Gem5-like baseline)
        n_windows: int = 128,
        check_capacity: bool = True,
        max_events_per_access: int = 64,  # trace fidelity (higher = finer)
        async_analysis: Optional[bool] = None,  # None: asynchronous for 'epoch' without inject_delays
        engine: Optional[AnalysisEngine] = None,  # None: the shared default
        pipeline: bool = False,  # device-resident epoch pipeline (dispatch cache + pinned staging)
        warmup: bool = False,  # build the pipeline's dispatch-cache entry at attach
        device="cuda",
    ):
        if analyzer not in ("epoch", "fine"):
            raise ValueError(f"unknown analyzer {analyzer!r} (use 'epoch' or 'fine')")
        self.topology = topology
        self.flat = topology.flatten()
        self.policy = policy
        self.epoch = epoch
        self.hw = hw
        self.inject_delays = inject_delays
        self.sample_rate = sample_rate
        self.migration = migration
        self.cache = cache
        self.coherency = coherency
        self.analyzer_kind = analyzer
        self.n_windows = n_windows
        self.check_capacity = check_capacity
        self.max_events_per_access = max_events_per_access
        self.engine = engine
        self.pipeline = pipeline
        self.warmup = warmup
        self.device = _check_device(device)
        # asynchronous analysis overlaps the analyzer with the native step;
        # delay injection needs the delay before the step returns, so it
        # forces the synchronous path
        if async_analysis is None:
            async_analysis = analyzer == "epoch" and not inject_delays
        self.async_analysis = bool(async_analysis) and not inject_delays

    def attach(
        self,
        step_fn: Callable[..., Any],
        phases: Sequence[Phase],
        regions: RegionMap,
        calibration: float = 1.0,
    ) -> "AttachedProgram":
        self.policy.place(regions, self.flat)
        if self.check_capacity:
            capacity_check(regions, self.flat)
        return AttachedProgram(self, step_fn, list(phases), regions, calibration)


def _synchronize_outputs(out: Any) -> None:
    """Wait for the card if any tensor in ``out`` (nested tuples, lists and
    dicts) lies on it — the counterpart of ``jax.block_until_ready``.  It
    waits on the calling thread's current stream of each such device, the
    stream the outputs were produced on, and not on the whole device: the
    analysis engine's stream must not bill its work to the native clock."""
    stack = [out]
    devices = set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class AttachedProgram(EngineClient):
    # the report is folded from the engine's dispatcher thread while the
    # submitting thread accumulates native clocks — every touch locks
    _simlint_guards = guarded_by("_report_lock", "_report")

    def __init__(
        self,
        sim: CXLMemSim,
        step_fn: Callable[..., Any],
        phases: List[Phase],
        regions: RegionMap,
        calibration: float,
    ):
        self.sim = sim
        self.step_fn = step_fn
        self.phases = phases
        self.regions = regions
        self.calibration = calibration
        if sim.analyzer_kind == "epoch":
            self._analyzer = EpochAnalyzer(
                sim.flat, n_windows=sim.n_windows, device=sim.device,
                pipeline=sim.pipeline,
            )
        else:
            self._analyzer = FineGrainedSimulator(sim.flat, bandwidth_mode="per_txn")
        self._cache = (
            DeviceCacheModel(sim.cache, sim.flat, [regions])
            if sim.cache is not None
            else None
        )
        self._report = SimReport(
            per_pool_latency_ns=np.zeros((sim.flat.n_pools,)),
            per_switch_congestion_ns=np.zeros((sim.flat.n_switches,)),
            per_switch_bandwidth_ns=np.zeros((sim.flat.n_switches,)),
            qos_classes=sim.flat.n_qos_classes,
            per_class_congestion_ns=np.zeros((sim.flat.n_qos_classes,)),
        )
        self._report_lock = threading.Lock()
        self._trace_cache: Optional[tuple] = None
        if sim.async_analysis:
            eng = sim.engine if sim.engine is not None else AnalysisEngine.default()
            self._handle: Optional[EngineHandle] = eng.register(self._analyzer)
        else:
            self._handle = None
        if sim.warmup and isinstance(self._analyzer, EpochAnalyzer):
            # build the pipeline's dispatch-cache entry on this step's trace
            # shapes so the first real dispatch is a cache hit
            self._analyzer.warmup(self._traces()[0])

    # ------------------------------------------------------------------ #

    @property
    def report(self) -> SimReport:
        """The accumulated report; flushes in-flight asynchronous analysis
        first (``flush``/``close``/context-manager semantics come from
        :class:`~repro_torch.core.engine.EngineClient`)."""
        self.flush()
        return self._report  # simlint: ignore[lock-discipline] -- post-flush read: no in-flight fold can race the caller's view

    # ------------------------------------------------------------------ #

    def _traces(self):
        """Structural traces are shape-static per step; cache across steps,
        but recompute when migration has changed residency."""
        if self._trace_cache is None or self.sim.migration is not None:
            mode = "layer" if self.sim.epoch.mode == "layer" else "step"
            traces, native_ns, names = synthesize_step_trace(
                self.phases,
                self.regions,
                hw=self.sim.hw,
                granularity_bytes=self.sim.policy.granularity_bytes,
                max_events_per_access=self.sim.max_events_per_access,
                calibration=self.calibration,
                epoch_mode=mode,
            )
            if self.sim.epoch.mode == "quantum":
                cut: List[MemEvents] = []
                for tr in traces:
                    cut.extend(self.sim.epoch.slices(tr))
                traces = cut
                native_ns = [self.sim.epoch.quantum_ns] * len(traces)
                names = [f"q{i}" for i in range(len(traces))]
            if self.sim.sample_rate < 1.0:
                traces = [t.sample(self.sim.sample_rate, seed=i) for i, t in enumerate(traces)]
            self._trace_cache = (traces, native_ns, names)
        return self._trace_cache

    def epoch_traces(self) -> List[MemEvents]:
        """One step's structural epoch traces (before migration, coherency
        and the cache), as the tracer emits them."""
        return list(self._traces()[0])

    def _epoch_batch(self) -> Tuple[List[MemEvents], float, Optional[List]]:
        """One step's epoch traces with migration, coherency and the cache
        applied, in the reference's order; returns ``(batch, the step's
        coherency-miss latency in ns, per-epoch latency-scale rows or None
        without a cache)``.  The device cache observes the final epoch, so
        injected copy and BI traffic warm and pollute it like any other
        access."""
        traces = self._traces()[0]
        batch: List[MemEvents] = []
        scales: Optional[List] = [] if self._cache is not None else None
        coh_ns_total = 0.0
        for tr in traces:
            if self.sim.migration is not None:
                tr, extra = self.sim.migration.observe_and_migrate(tr)
                if extra.n:
                    tr = concat_events([tr, extra])
            if self.sim.coherency is not None:
                bi, coh_ns = self.sim.coherency.epoch_traffic(tr)
                coh_ns_total += coh_ns
                if bi.n:
                    tr = concat_events([tr, bi])
            if self._cache is not None:
                scales.append(self._cache.observe_scale(tr))
            batch.append(tr)
        if self.sim.migration is not None or self._cache is not None:
            # running-statistic snapshots; written under the report lock —
            # the dispatcher folds breakdowns under the same lock
            with self._report_lock:
                if self.sim.migration is not None:
                    self._report.migration_moved_bytes = (
                        self.sim.migration.moved_bytes_total
                    )
                if self._cache is not None:
                    self._report.cache_hit_fraction = self._cache.hit_fraction
        return batch, coh_ns_total, scales

    def _fold(
        self, bd: DelayBreakdown, coh_ns: float, analyzer_s: float, n_epochs: int
    ) -> float:
        """Fold one analyzed batch into the report (any thread; locks).
        Returns its total delay in ns; ``analyzer_s`` accumulates the
        analyzer's own seconds whether or not they overlapped the step."""
        delay_ns = bd.total_ns + coh_ns
        with self._report_lock:
            r = self._report
            r.epochs += n_epochs
            r.latency_s += ns_to_s(bd.latency_ns)
            r.congestion_s += ns_to_s(bd.congestion_ns)
            r.bandwidth_s += ns_to_s(bd.bandwidth_ns)
            r.coherency_s += ns_to_s(coh_ns)
            r.per_pool_latency_ns += bd.per_pool_latency_ns
            r.per_switch_congestion_ns += bd.per_switch_congestion_ns
            r.per_switch_bandwidth_ns += bd.per_switch_bandwidth_ns
            if bd.per_class_congestion_ns is not None:
                pcc = np.asarray(bd.per_class_congestion_ns, np.float64)
                if len(pcc) == len(r.per_class_congestion_ns):
                    r.per_class_congestion_ns += pcc
                else:  # qos-off breakdown on a multi-class fabric: all class 0
                    r.per_class_congestion_ns[0] += float(pcc.sum())
            r.simulated_s += ns_to_s(delay_ns)
            r.analyzer_s += analyzer_s
            if self._handle is not None:
                fold_dispatch_stats(
                    r, self._handle.last_dispatch, self._handle.last_group_size
                )
            else:
                fold_dispatch_stats(
                    r, getattr(self._analyzer, "last_dispatch", None), 1
                )
        return delay_ns

    def _analyze_and_accumulate(
        self, batch: List[MemEvents], coh_ns: float, scales: Optional[List] = None
    ) -> float:
        """Analyze one step's epoch batch and fold it; returns the step's
        total delay in ns.  A failed batch is recorded as dropped before the
        error propagates."""
        a0 = time.perf_counter()
        try:
            bd = analyze_any(self._analyzer, batch, scales)
        except BaseException:
            with self._report_lock:
                self._report.dropped_batches += 1
                self._report.dropped_epochs += len(batch)
            raise
        elapsed = time.perf_counter() - a0
        return self._fold(bd, coh_ns, elapsed, len(batch))

    def step(self, *args, **kwargs):
        """Run one real step under simulation; returns the step's outputs.

        Asynchronously, the step's epoch batch is submitted *before* the
        native step, so the analyzer works while the step executes; totals
        become visible through :attr:`report` (which flushes)."""
        with span("attach.batch"):
            batch, coh_ns, scales = self._epoch_batch()
        if self._handle is not None:
            n_epochs = len(batch)
            self._handle.submit(
                batch,
                scales,
                fold=lambda bd, elapsed: self._fold(bd, coh_ns, elapsed, n_epochs),
            )

        with span("attach.native"):
            t0 = time.perf_counter()
            out = self.step_fn(*args, **kwargs)
            _synchronize_outputs(out)
            native = time.perf_counter() - t0
        with self._report_lock:
            self._report.native_s += native
            self._report.simulated_s += native
            self._report.steps += 1

        if self._handle is None:
            delay_ns = self._analyze_and_accumulate(batch, coh_ns, scales)
            if self.sim.inject_delays and delay_ns > 0:
                # the paper's delay injection: the host program observes the
                # simulated-topology execution speed
                time.sleep(ns_to_s(delay_ns))
                with self._report_lock:
                    self._report.injected_sleep_s += ns_to_s(delay_ns)
        return out

    def run(self, n_steps: int, *args, **kwargs) -> SimReport:
        for _ in range(n_steps):
            self.step(*args, **kwargs)
        self.flush()
        return self._report  # simlint: ignore[lock-discipline] -- post-flush read: no in-flight fold can race the caller's view
