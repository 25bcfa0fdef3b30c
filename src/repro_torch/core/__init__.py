"""CXLMemSim core, ported to PyTorch: the Timing Analyzer, attach, the
shared multi-host fabric, migration, the expander-side device cache, the
device-resident pipeline, the shared analysis engine, scenario sweeps and
the rack-scale fleet (the port of :mod:`repro.core`; ``mesh=`` splits
the stacked dispatches' leading axis over several devices, as in the
reference: :mod:`repro_torch.launch.mesh`, :mod:`repro_torch.distributed.sharding`).

Components (paper Figure 2):
  Tracer  -> :mod:`repro_torch.core.tracer` (+ :mod:`.events` region map)
  Timer   -> :mod:`repro_torch.core.timer`
  Timing Analyzer -> :mod:`repro_torch.core.analyzer` (batched PyTorch; the
  congestion cascade is a hand-written CUDA kernel on the card; the
  device-resident pipeline's dispatch cache in :mod:`repro_torch.core.aot`)
  and the fine-grained DES baseline
  Topology -> :mod:`repro_torch.core.topology`
  Placement -> :mod:`repro_torch.core.policy`
  Pooling  -> :mod:`repro_torch.core.fabric` (co-attached tenants on one
  shared fabric) and :mod:`repro_torch.core.coherency`
  Migration and caching -> :mod:`repro_torch.core.migration` and
  :mod:`repro_torch.core.cache` (host numpy, like the reference's)
  Asynchronous analysis -> :mod:`repro_torch.core.engine` (one dispatcher
  thread on its own CUDA stream, cross-session coalescing)
  Roofline -> :mod:`repro_torch.core.roofline` (the three terms of a step)
  Exploration -> :mod:`repro_torch.core.scenario` (K placement, topology,
  cache, granularity and QoS scenarios in one stacked dispatch) and
  :mod:`repro_torch.core.fleet` (tenants scheduled over R pooled racks, the
  stranding frontier)
"""

from .analyzer import (
    ChainPlan,
    DelayBreakdown,
    EpochAnalyzer,
    FineGrainedSimulator,
    PendingBatch,
    analyze_ref,
    bucket_pow2,
    plan_cascade,
    plan_chain,
)
from .aot import AotDispatchCache
from .attach import AttachedProgram, CXLMemSim, SimReport
from .cache import DeviceCacheConfig, DeviceCacheModel
from .coherency import CoherencyConfig, CoherencyModel
from .engine import AnalysisEngine, EngineHandle, dispatch_key
from .events import (
    CACHELINE_BYTES,
    PAGE_BYTES,
    EventStager,
    MemEvents,
    Region,
    RegionMap,
    concat_events,
    merge_host_traces,
    split_by_host,
    synthetic_trace,
)
from .fabric import FabricReport, FabricSession, HostClock, Tenant
from .fleet import (
    FleetPoint,
    FleetReport,
    FleetSim,
    TenantPlacement,
    TenantSpec,
    model_zoo_tenant,
    synthetic_tenant,
)
from .migration import LocalBudget, MigrationConfig, MigrationSimulator
from .policy import (
    ClassMapPolicy,
    HotnessTieredPolicy,
    InterleavePolicy,
    LocalOnlyPolicy,
    PlacementPolicy,
    RegionArrays,
    assign_batch,
    bytes_per_pool_batch,
    capacity_check,
)
from .roofline import RooflineTerms, roofline_terms
from .scenario import Scenario, ScenarioSuite, SweepResult
from .timer import EpochSchedule, slice_by_quantum
from .topology import (
    FlatTopology,
    FlatTopologyStack,
    Pool,
    QosSpec,
    Switch,
    Topology,
    TopologyOverride,
    chained_topology,
    figure1_topology,
    flatten_stack,
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
    "AnalysisEngine",
    "AotDispatchCache",
    "AttachedProgram",
    "CACHELINE_BYTES",
    "CXLMemSim",
    "ChainPlan",
    "ClassMapPolicy",
    "CoherencyConfig",
    "CoherencyModel",
    "DelayBreakdown",
    "DeviceCacheConfig",
    "DeviceCacheModel",
    "EngineHandle",
    "EpochAnalyzer",
    "EpochSchedule",
    "EventStager",
    "FabricReport",
    "FabricSession",
    "FineGrainedSimulator",
    "FlatTopology",
    "FlatTopologyStack",
    "FleetPoint",
    "FleetReport",
    "FleetSim",
    "H100_SXM",
    "HardwareModel",
    "HostClock",
    "HotnessTieredPolicy",
    "InterleavePolicy",
    "LocalBudget",
    "LocalOnlyPolicy",
    "MemEvents",
    "MigrationConfig",
    "MigrationSimulator",
    "PAGE_BYTES",
    "PendingBatch",
    "Phase",
    "PlacementPolicy",
    "Pool",
    "QosSpec",
    "Region",
    "RegionArrays",
    "RegionMap",
    "RooflineTerms",
    "Scenario",
    "ScenarioSuite",
    "SimReport",
    "SweepResult",
    "Switch",
    "TPU_V5E",
    "Tenant",
    "TenantPlacement",
    "TenantSpec",
    "Topology",
    "TopologyOverride",
    "TraceSkeleton",
    "analyze_ref",
    "assign_batch",
    "bucket_pow2",
    "bytes_per_pool_batch",
    "capacity_check",
    "chained_topology",
    "concat_events",
    "dispatch_key",
    "figure1_topology",
    "flatten_stack",
    "local_only_topology",
    "merge_host_traces",
    "model_zoo_tenant",
    "plan_cascade",
    "plan_chain",
    "pooled_topology",
    "roofline_terms",
    "skeleton_to_events",
    "slice_by_quantum",
    "split_by_host",
    "synthesize_skeleton",
    "synthesize_step_trace",
    "synthetic_tenant",
    "synthetic_trace",
    "two_tier_topology",
]
