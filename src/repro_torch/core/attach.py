"""CXLMemSim.attach — the user-facing simulator (paper Figure 2, assembled),
ported from ``repro/core/attach.py`` in synchronous mode.

Wraps any PyTorch step function.  Per step:

  1. cut the step's structural trace into epochs (Timer);
  2. dispatch the real step and measure native wall time (the paper's
     "execution of the attached program"), synchronizing the card when the
     step's outputs are CUDA tensors;
  3. analyze the step's epoch batch with the Timing Analyzer — one
     :meth:`EpochAnalyzer.analyze_batch` call, one host transfer per step —
     and fold the delays into the report;
  4. optionally ``time.sleep`` the computed delay — the paper's delay
     injection, making the host observe simulated-topology speed.

Two clocks are reported:

  * ``native_s``    — measured host execution time,
  * ``simulated_s`` — native + Σ delays (what the topology would impose),

plus the per-component delay decomposition, per-pool/switch.  ``analyzer_s``
is the analyzer's own seconds (the paper's overhead accounting).

``coherency=CoherencyModel(...)`` adds the analytic single-attach
back-invalidation traffic and coherency-miss latency.  Asynchronous analysis
(the reference's shared engine, slice 4 of the port), migration and the
device cache (slice 3) raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .analyzer import (
    DelayBreakdown,
    EpochAnalyzer,
    FineGrainedSimulator,
    _check_device,
    analyze_any,
)
from .coherency import CoherencyModel
from .engine import EngineClient, fold_dispatch_stats
from .events import MemEvents, RegionMap, concat_events
from .policy import PlacementPolicy, capacity_check
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


def _unsupported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with {where} of the port")


class CXLMemSim:
    """Configure once, attach to any number of step functions.

    ``device`` is where the analyzer runs: ``"cuda"`` (the default; raises
    when no card is present) or ``"cpu"`` (the plain PyTorch versions)."""

    def __init__(
        self,
        topology: Topology,
        policy: PlacementPolicy,
        epoch: EpochSchedule = EpochSchedule("step"),
        hw: HardwareModel = H100_SXM,
        inject_delays: bool = False,
        sample_rate: float = 1.0,
        migration=None,
        cache=None,
        coherency: Optional[CoherencyModel] = None,
        analyzer: str = "epoch",  # 'epoch' (paper) | 'fine' (Gem5-like baseline)
        n_windows: int = 128,
        check_capacity: bool = True,
        max_events_per_access: int = 64,  # trace fidelity (higher = finer)
        async_analysis: Optional[bool] = None,  # None: synchronous
        device="cuda",
    ):
        if migration is not None:
            raise _unsupported("migration", "slice 3")
        if cache is not None:
            raise _unsupported("the device cache", "slice 3")
        if async_analysis:
            raise _unsupported("asynchronous analysis (the shared engine)", "slice 4")
        if analyzer not in ("epoch", "fine"):
            raise ValueError(f"unknown analyzer {analyzer!r} (use 'epoch' or 'fine')")
        self.topology = topology
        self.flat = topology.flatten()
        self.policy = policy
        self.epoch = epoch
        self.hw = hw
        self.inject_delays = inject_delays
        self.sample_rate = sample_rate
        self.coherency = coherency
        self.analyzer_kind = analyzer
        self.n_windows = n_windows
        self.check_capacity = check_capacity
        self.max_events_per_access = max_events_per_access
        self.device = _check_device(device)

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
    dicts) lies on it — the counterpart of ``jax.block_until_ready``."""
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
        torch.cuda.synchronize(dev)


class AttachedProgram(EngineClient):
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
                sim.flat, n_windows=sim.n_windows, device=sim.device
            )
        else:
            self._analyzer = FineGrainedSimulator(sim.flat, bandwidth_mode="per_txn")
        self._report = SimReport(
            per_pool_latency_ns=np.zeros((sim.flat.n_pools,)),
            per_switch_congestion_ns=np.zeros((sim.flat.n_switches,)),
            per_switch_bandwidth_ns=np.zeros((sim.flat.n_switches,)),
            qos_classes=sim.flat.n_qos_classes,
            per_class_congestion_ns=np.zeros((sim.flat.n_qos_classes,)),
        )
        self._trace_cache: Optional[tuple] = None

    # ------------------------------------------------------------------ #

    @property
    def report(self) -> SimReport:
        """The accumulated report."""
        return self._report

    # ------------------------------------------------------------------ #

    def _traces(self):
        """Structural traces are shape-static per step; cache across steps."""
        if self._trace_cache is None:
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
        """One step's epoch traces, as the analyzer receives them."""
        return list(self._traces()[0])

    def _epoch_batch(self):
        """One step's epoch traces with coherency traffic applied, and the
        step's coherency-miss latency in ns."""
        traces = self._traces()[0]
        if self.sim.coherency is None:
            return list(traces), 0.0
        batch: List[MemEvents] = []
        coh_ns_total = 0.0
        for tr in traces:
            bi, coh_ns = self.sim.coherency.epoch_traffic(tr)
            coh_ns_total += coh_ns
            batch.append(concat_events([tr, bi]) if bi.n else tr)
        return batch, coh_ns_total

    def _fold(
        self, bd: DelayBreakdown, coh_ns: float, analyzer_s: float, n_epochs: int
    ) -> float:
        """Fold one analyzed batch into the report; returns its total delay
        in ns."""
        delay_ns = bd.total_ns + coh_ns
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
            r.per_class_congestion_ns += np.asarray(
                bd.per_class_congestion_ns, np.float64
            )
        r.simulated_s += ns_to_s(delay_ns)
        r.analyzer_s += analyzer_s
        fold_dispatch_stats(r, getattr(self._analyzer, "last_dispatch", None), 1)
        return delay_ns

    def _analyze_and_accumulate(self, batch: List[MemEvents], coh_ns: float) -> float:
        """Analyze one step's epoch batch and fold it; returns the step's
        total delay in ns.  A failed batch is recorded as dropped before the
        error propagates."""
        a0 = time.perf_counter()
        try:
            bd = analyze_any(self._analyzer, batch)
        except BaseException:
            self._report.dropped_batches += 1
            self._report.dropped_epochs += len(batch)
            raise
        elapsed = time.perf_counter() - a0
        return self._fold(bd, coh_ns, elapsed, len(batch))

    def step(self, *args, **kwargs):
        """Run one real step under simulation; returns the step's outputs."""
        batch, coh_ns = self._epoch_batch()
        t0 = time.perf_counter()
        out = self.step_fn(*args, **kwargs)
        _synchronize_outputs(out)
        native = time.perf_counter() - t0
        self._report.native_s += native
        self._report.simulated_s += native
        self._report.steps += 1

        delay_ns = self._analyze_and_accumulate(batch, coh_ns)
        if self.sim.inject_delays and delay_ns > 0:
            # the paper's delay injection: the host program observes the
            # simulated-topology execution speed
            time.sleep(ns_to_s(delay_ns))
            self._report.injected_sleep_s += ns_to_s(delay_ns)
        return out

    def run(self, n_steps: int, *args, **kwargs) -> SimReport:
        for _ in range(n_steps):
            self.step(*args, **kwargs)
        return self._report
