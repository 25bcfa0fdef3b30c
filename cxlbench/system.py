"""The system under test, built from a configuration's description: the
port's topology, placement policies, model config and pacing model.  The
only module of the benchmark besides the drivers that imports the port."""

from __future__ import annotations

import torch

from repro_torch.core import (
    ClassMapPolicy,
    HotnessTieredPolicy,
    InterleavePolicy,
    LocalOnlyPolicy,
    Pool,
    Switch,
    Topology,
    TopologyOverride,
)
from repro_torch.core.tracer import HardwareModel
from repro_torch.models import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def model_config(m: dict) -> ModelConfig:
    """The port's ``ModelConfig`` of a configuration's ``model`` entry
    (every key but ``source`` and ``dtype``/``cache_dtype`` by name)."""
    kw = {k: v for k, v in m.items() if k not in ("dtype", "cache_dtype")}
    for k in ("dtype", "cache_dtype"):
        if k in m:
            kw[k] = _DTYPES[m[k]]
    return ModelConfig(**kw)


def topology(t: dict) -> Topology:
    pools = [Pool(p["name"], p["latency_ns"], p["bandwidth_gbps"], int(p["capacity_bytes"]),
                  parent=p.get("parent"), is_local=bool(p.get("is_local", False)))
             for p in t["pools"]]
    switches = [Switch(s["name"], latency_ns=s["latency_ns"], bandwidth_gbps=s["bandwidth_gbps"],
                       stt_ns=s["stt_ns"], parent=s.get("parent")) for s in t.get("switches", [])]
    return Topology(pools, switches, rc_latency_ns=t["rc_latency_ns"],
                    rc_bandwidth_gbps=t["rc_bandwidth_gbps"], rc_stt_ns=t["rc_stt_ns"],
                    local_dram_latency_ns=t["local_dram_latency_ns"],
                    n_hosts=int(t.get("n_hosts", 1)))


def override(o: dict) -> TopologyOverride:
    return TopologyOverride(pools=o.get("pools", {}), switches=o.get("switches", {}),
                            rc_stt_ns=o.get("rc_stt_ns"), rc_latency_ns=o.get("rc_latency_ns"),
                            rc_bandwidth_gbps=o.get("rc_bandwidth_gbps"),
                            local_dram_latency_ns=o.get("local_dram_latency_ns"))


def policy(p: dict, program_bytes: int = 0):
    """A placement policy; ``hotness_tiered`` budgets ``budget_share`` of
    ``program_bytes`` for local DRAM."""
    kind = p["kind"]
    if kind == "local_only":
        pol = LocalOnlyPolicy()
    elif kind == "class_map":
        pol = ClassMapPolicy(p["map"])
    elif kind == "interleave":
        pol = InterleavePolicy(p["pools"], weights=p["weights"])
    elif kind == "hotness_tiered":
        pol = HotnessTieredPolicy(p["fallback"],
                                  local_budget_bytes=int(p["budget_share"] * program_bytes))
    else:
        raise ValueError(f"unknown policy {kind!r}")
    return pol.with_granularity(int(p["granularity"])) if "granularity" in p else pol


def pacing(h: dict) -> HardwareModel:
    return HardwareModel(name=h["name"], peak_flops=h["peak_flops"], hbm_gbps=h["hbm_gbps"],
                         ici_gbps=h["ici_gbps"])
