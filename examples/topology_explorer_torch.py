"""Topology explorer on the PyTorch port: evaluate CXL.mem pool hierarchies
*before procurement* (the counterpart of ``examples/topology_explorer.py``).

Sweeps a grid of candidate topologies (pool count, switch depth, link
bandwidth) against a fixed training workload and reports the simulated
step-time for each — the purchasing decision table.  *Structural* axes
(pool count, switch depth) pick a base topology per suite; everything
numeric (link bandwidth × placement policy) stacks into ONE dispatch per
structure (on the card, one congestion-cascade launch per STT row), and a
successive-halving refinement then hillclimbs the bandwidth axis around
the grid winner, still one dispatch per round.

The workload's native step time and its trace's timing come from the
suite's hardware model: ``H100_SXM`` here by default, ``TPU_V5E`` in
``repro``.  So at the two packages' defaults the slowdowns, and with them
the "buy this one" row, may differ; ``run(hw=TPU_V5E)`` gives ``repro``'s
table.

    PYTHONPATH=src python examples/topology_explorer_torch.py [--device cpu]
"""

import argparse
import dataclasses

import torch

import repro_torch.configs as cfgs
from repro_torch.core import (
    H100_SXM,
    ClassMapPolicy,
    Pool,
    Scenario,
    ScenarioSuite,
    Switch,
    Topology,
    TopologyOverride,
)
from repro_torch.core.units import ns_to_ms
from repro_torch.launch.mesh import resolve_device
from repro_torch.models.phases import build_regions_and_phases


def candidate(n_pools: int, depth: int, bw: float) -> Topology:
    """n_pools expanders behind a switch chain of `depth`."""
    switches = []
    parent = None
    for d in range(depth):
        switches.append(
            Switch(f"sw{d}", latency_ns=70.0, bandwidth_gbps=bw, stt_ns=2.0, parent=parent)
        )
        parent = f"sw{d}"
    pools = [Pool("local_dram", 88.9, 76.8, 96 << 30, is_local=True)]
    for i in range(n_pools):
        pools.append(Pool(f"cxl{i}", 170.0, bw, 256 << 30, parent=parent))
    return Topology(pools=pools, switches=switches)


def bw_override(topo: Topology, bw: float) -> TopologyOverride:
    """Set every CXL link (switches + expander leaves) to ``bw`` GB/s."""
    return TopologyOverride(
        pools={p.name: {"bandwidth_gbps": bw} for p in topo.pools if not p.is_local},
        switches={s.name: {"bandwidth_gbps": bw} for s in topo.switches},
    )


def run(device="cuda", hw=H100_SXM):
    """The grid (one :class:`SweepResult` per structure), the best
    candidate, and the refinement's last ``(SweepResult, best index)``
    with the winner's suite's ``dispatch_count``."""
    device = resolve_device(device)  # raises without a card, unless "cpu"
    cfg = dataclasses.replace(cfgs.get_smoke("chatglm3-6b"), dtype=torch.float32)
    regions, phases = build_regions_and_phases(cfg, "train", batch=8, seq=256)

    grid = []
    best = None
    best_ctx = None
    for n_pools in (1, 2, 4):
        for depth in (1, 2):
            # one base structure; the bandwidth axis stacks as overrides
            topo = candidate(n_pools, depth, 32.0)
            suite = ScenarioSuite(topo, regions, phases, hw=hw, device=device)
            pol = ClassMapPolicy(
                {"opt_state": "cxl0", "grad": "cxl0" if n_pools == 1 else "cxl1"}
            )
            scens = [
                Scenario(policy=pol, topology=bw_override(topo, bw), name=f"{bw:g}GBps")
                for bw in (16.0, 32.0, 64.0)
            ]
            res = suite.run(scens)  # ONE dispatch for the whole bandwidth axis
            grid.append((n_pools, depth, res))
            for s, slow in zip(res.scenarios, res.slowdowns()):
                bw = float(s.topology.switches["sw0"]["bandwidth_gbps"])
                if best is None or slow < best[0]:
                    best = (float(slow), n_pools, depth, bw)
                    best_ctx = (suite, pol)

    # hillclimb-style refinement of the bandwidth axis around the winner:
    # each round is one stacked dispatch over survivors + their neighbors
    b = best[3]
    suite, pol = best_ctx
    topo = suite.topology

    def mk(bw: float) -> Scenario:
        return Scenario(policy=pol, topology=bw_override(topo, bw), name=f"{bw:.4g}GBps")

    def refine(sc: Scenario, rnd: int):
        bw = float(sc.topology.switches["sw0"]["bandwidth_gbps"])
        step = 1.0 + 0.25 / (rnd + 1)
        return [mk(bw * step), mk(bw / step)]

    refined = suite.successive_halving([mk(b / 1.5), mk(b), mk(b * 1.5)], refine, rounds=2)
    return {"grid": grid, "best": best, "refined": refined,
            "dispatch_count": suite.dispatch_count}


def report_lines(out):
    """The lines ``examples/topology_explorer.py`` prints, for ``run``'s result."""
    lines = ["pools,switch_depth,link_GBps,native_ms,delay_ms,slowdown"]
    for n_pools, depth, res in out["grid"]:
        native_ms = ns_to_ms(res.native_ns)
        for s, bd, slow in zip(res.scenarios, res.breakdowns, res.slowdowns()):
            bw = float(s.topology.switches["sw0"]["bandwidth_gbps"])
            lines.append(
                f"{n_pools},{depth},{bw:.0f},{native_ms:.2f},"
                f"{bd.total_ns/1e6:.2f},{slow:.3f}"
            )
    s, n, d, b = out["best"]
    lines.append(
        f"\nbest candidate: {n} pool(s) behind {d} switch level(s) at {b:.0f} GB/s "
        f"-> {s:.3f}x slowdown (buy this one)"
    )
    res, idx = out["refined"]
    lines.append(
        f"refined: {res.scenarios[idx].label()} -> "
        f"{res.slowdowns()[idx]:.3f}x slowdown "
        f"({out['dispatch_count']} stacked dispatches total)"
    )
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    print("\n".join(report_lines(run(device=args.device))))


if __name__ == "__main__":
    main()
