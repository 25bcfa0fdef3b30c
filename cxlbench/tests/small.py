"""Small versions of the benchmark's cells for the CPU tests: the same
configurations and traffic at a few layers, narrow widths and short
sequences, so that a whole run fits in a few seconds."""

from __future__ import annotations

import copy

from cxlbench import run

SMALL_DENSE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_head": 16,
               "d_ff": 128, "vocab_size": 512}
SMALL_MOE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_head": 16,
             "d_ff": 64, "moe_d_ff": 64, "vocab_size": 512, "n_experts": 8, "top_k": 2}


def small(cell: str) -> dict:
    """The resolved cell, cut down; its limits are the cell's own."""
    r = copy.deepcopy(run.resolve(cell))
    cfg, traffic = r["config"], r["traffic"]
    kind = traffic["kind"]
    if kind == "fabric_rounds":
        cfg["model"].update(SMALL_MOE)
        cfg["tenants"]["hosts"] = cfg["topology"]["n_hosts"] = 3
        cfg["tenants"]["batch"] = 4
        cfg["events_per_access"] = 256
        traffic["cache_len"] = {"low": 64, "high": 128, "step": 16}
    else:
        cfg["model"].update(SMALL_DENSE)
        cfg["events_per_access"] = 64
    if kind == "attached_prefill":
        traffic.update(batch=2, seq=32, check_rows=1000)  # every row
    if kind == "scenario_sweep":
        traffic["program"].update(batch=2, seq=32)
    return r
