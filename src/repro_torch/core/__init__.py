"""CXLMemSim core, ported to PyTorch: the single-host Timing Analyzer and
synchronous attach (slice 1 of the port of :mod:`repro.core`).

Components (paper Figure 2):
  Tracer  -> :mod:`repro_torch.core.tracer` (+ :mod:`.events` region map)
  Timer   -> :mod:`repro_torch.core.timer`
  Timing Analyzer -> :mod:`repro_torch.core.analyzer` (batched PyTorch; the
  congestion cascade is a hand-written CUDA kernel on the card) and the
  fine-grained DES baseline
  Topology -> :mod:`repro_torch.core.topology`
  Placement -> :mod:`repro_torch.core.policy`
"""

from .analyzer import (
    DelayBreakdown,
    EpochAnalyzer,
    FineGrainedSimulator,
    analyze_ref,
    bucket_pow2,
    plan_cascade,
)
from .attach import AttachedProgram, CXLMemSim, SimReport
from .events import (
    CACHELINE_BYTES,
    PAGE_BYTES,
    EventStager,
    MemEvents,
    Region,
    RegionMap,
    concat_events,
    synthetic_trace,
)
from .policy import (
    ClassMapPolicy,
    HotnessTieredPolicy,
    InterleavePolicy,
    LocalOnlyPolicy,
    PlacementPolicy,
    RegionArrays,
    capacity_check,
)
from .timer import EpochSchedule, slice_by_quantum
from .topology import (
    FlatTopology,
    Pool,
    Switch,
    Topology,
    chained_topology,
    figure1_topology,
    local_only_topology,
    pooled_topology,
    two_tier_topology,
)
from .tracer import (
    H100_SXM,
    TPU_V5E,
    Access,
    HardwareModel,
    Phase,
    TraceSkeleton,
    skeleton_to_events,
    synthesize_skeleton,
    synthesize_step_trace,
)

__all__ = [
    "Access",
    "AttachedProgram",
    "CACHELINE_BYTES",
    "CXLMemSim",
    "ClassMapPolicy",
    "DelayBreakdown",
    "EpochAnalyzer",
    "EpochSchedule",
    "EventStager",
    "FineGrainedSimulator",
    "FlatTopology",
    "H100_SXM",
    "HardwareModel",
    "HotnessTieredPolicy",
    "InterleavePolicy",
    "LocalOnlyPolicy",
    "MemEvents",
    "PAGE_BYTES",
    "Phase",
    "PlacementPolicy",
    "Pool",
    "Region",
    "RegionArrays",
    "RegionMap",
    "SimReport",
    "Switch",
    "TPU_V5E",
    "Topology",
    "TraceSkeleton",
    "analyze_ref",
    "bucket_pow2",
    "capacity_check",
    "chained_topology",
    "concat_events",
    "figure1_topology",
    "local_only_topology",
    "plan_cascade",
    "pooled_topology",
    "skeleton_to_events",
    "slice_by_quantum",
    "synthesize_skeleton",
    "synthesize_step_trace",
    "synthetic_trace",
    "two_tier_topology",
]
