"""Migration policies x device caching on the PyTorch port (the
counterpart of ``examples/migration_caching.py``): the paper's headline
research use ("data migration strategies and caching techniques that were
previously infeasible to evaluate at scale"), on one serving-shaped
workload.

Sweeps three tiering configurations (static placement, software migration,
software migration with a demote_pool escape hatch) against three
expander-cache capacities, and prints the simulated slowdown grid.  The
migration daemon and the cache's tag update run on the host, as in
``repro``; each step's analysis runs the congestion cascade on the card.

    PYTHONPATH=src python examples/migration_caching_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core import (
    H100_SXM,
    Access,
    CXLMemSim,
    ClassMapPolicy,
    DeviceCacheConfig,
    MigrationConfig,
    MigrationSimulator,
    Phase,
    RegionMap,
    figure1_topology,
)
from repro_torch.core.units import s_to_ms
from repro_torch.launch.mesh import resolve_device

PAGE = 4096
TOPO = figure1_topology()
STEPS = 10  # enough steps to amortize the one-time copies


def build_workload():
    """A decode-ish step: hot KV pages remote, weights warm local, and a
    large optimizer region that is local-born but never touched while
    serving — the classic budget-pinning cold resident."""
    rm = RegionMap()
    rm.alloc("w", 64 << 20, "param")  # local (unmapped class)
    rm.alloc("opt", 128 << 20, "opt_state")  # local-born, idle during decode
    rm.alloc("kv_hot", 256 * PAGE, "kvcache")  # small, re-read every step
    rm.alloc("kv_cold", 64 << 20, "kvcache")  # long-tail cache, rarely touched
    phases = [
        Phase(
            "decode",
            flops=2e9,
            accesses=(
                Access("w", 16 << 20),
                Access("kv_hot", 64 << 20, True),  # heavy reuse of few pages
                Access("kv_cold", 1 << 20),
            ),
        )
    ]
    return rm, phases


def toy_step(x):
    return (x @ x.T).sum()


# budget (96 MiB) < w + opt (192 MiB): with the plain policy the idle opt
# region can never leave local DRAM (home == local), so nothing can ever
# promote; demote_pool breaks the dead-end.  1 MiB granules model a daemon
# that batches its copies (page-granular bursts queue 4096 transactions at
# one instant and the STT congestion charge dwarfs the steady-state win).
MIGRATIONS = {
    "static": None,
    "sw-migrate": MigrationConfig(
        mode="software", promote_threshold=8, demote_threshold=2,
        local_budget_bytes=96 << 20, granularity_bytes=1 << 20,
    ),
    "sw+demote_pool": MigrationConfig(
        mode="software", promote_threshold=8, demote_threshold=2,
        local_budget_bytes=96 << 20, granularity_bytes=1 << 20,
        demote_pool="cxl_pool2",
    ),
}
CACHES = {"no cache": 0, "256 MiB": 256 << 20, "1 GiB": 1 << 30}


def run(device="cuda", hw=H100_SXM, steps=STEPS):
    """Every cell of the grid, ``steps`` attached steps each; returns
    ``{migration name: {cache name: (SimReport, promotions or None)}}``.
    A migration simulator and a device cache keep state, so each cell
    builds its own."""
    device = resolve_device(device)  # raises without a card, unless "cpu"
    x = torch.ones((128, 128), device=device)
    toy_step(x)  # the first call's set-up stays outside the measured steps
    grid = {}
    for mig_name, mig_cfg in MIGRATIONS.items():
        row = grid[mig_name] = {}
        for cap_name, cap in CACHES.items():
            rm, phases = build_workload()
            migration = (
                MigrationSimulator(mig_cfg, rm, TOPO.flatten()) if mig_cfg is not None else None
            )
            sim = CXLMemSim(
                TOPO,
                ClassMapPolicy({"kvcache": "cxl_pool1"}),
                hw=hw,
                migration=migration,
                cache=DeviceCacheConfig(capacity_bytes=cap, line_bytes=PAGE) if cap else None,
                device=device,
            )
            with sim.attach(toy_step, phases, rm) as prog:
                rep = prog.run(steps, x)
            row[cap_name] = (rep, migration.promotions if migration is not None else None)
    return grid


def report_lines(grid):
    """The lines ``examples/migration_caching.py`` prints, for ``run``'s result."""
    lines = [TOPO.describe(), f"\n{'policy':>16} | " + " | ".join(f"{c:>18}" for c in CACHES)]
    for mig_name, row in grid.items():
        cells = []
        for rep, promotions in row.values():
            hit = rep.cache_hit_fraction
            # the simulated delay is the quantity migration/caching reshape;
            # wall-clock slowdown also rides on the (noisy, µs-scale) toy step
            delay_ms = s_to_ms(rep.latency_s + rep.congestion_s + rep.bandwidth_s)
            cells.append(
                f"{delay_ms:7.2f} ms"
                + (f" hit {hit:4.0%}" if hit == hit else "         ")
                + (f" p{promotions}" if promotions is not None else "   ")
            )
        lines.append(f"{mig_name:>16} | " + " | ".join(f"{c:>20}" for c in cells))
    lines.append(
        "\nReading the grid: with the plain policy the idle local-born opt"
        "\nregion pins the 96 MiB budget, so nothing ever promotes (p0) and"
        "\nsw-migrate == static; demote_pool evicts it and the hot KV pages go"
        "\nlocal (p1), cutting the steady-state delay.  The expander cache"
        "\ntrims the *latency* component of whatever stays remote (hit %);"
        "\nMB-sized transactions are bandwidth-dominated here, so its effect"
        "\nis visible but small — benchmarks/migration_scaling.py sweeps the"
        "\nlatency-bound regime where it is decisive."
    )
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    print("\n".join(report_lines(run(device=args.device))))


if __name__ == "__main__":
    main()
