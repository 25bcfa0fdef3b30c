"""What two runs of an example must agree on, and at which bars.

``tests/test_torch_examples.py`` holds each ``*_torch.py`` example on the
CPU against the same scenario in ``repro``; ``chip_smoke.py`` holds each
example's run on the card against its run on the CPU.  Both read the bars,
the example loader and the comparison from here, so the two checks cannot
drift apart.  This file imports only numpy.

Bars (the attach and fabric tests' own):
- latency, bandwidth, coherency, per-pool latency, the sweep's delays and
  slowdowns: rel 1e-5;
- congestion: rel 1e-4, abs 1e-12 (seconds);
- equal: epochs, rounds, BI messages, promotions, cache hit fractions, the
  sweep's best candidate, refined label and ``dispatch_count``;
- the quickstart's and train_100m's losses: rtol 1e-4.
"""

import importlib.util
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

REL = 1e-5  # latency, bandwidth, coherency, per-pool latency, sweep delays
CONG_REL, CONG_ABS = 1e-4, 1e-12  # congestion, in seconds
FLOOR = 1e-12  # the absolute floor of a rel bar, in its number's unit
LOSS_RTOL = 1e-4


def load_example(name: str):
    """``examples/{name}.py`` imported from its path."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def report_numbers(tag: str, r, coherency=True, pools=False) -> dict:
    """A ``SimReport``'s, ``HostClock``'s or ``FabricReport``'s simulated
    numbers by key, each with its bar: 'rel', 'cong', 'equal' or 'pools'."""
    nums = {
        f"{tag}.latency_s": (r.latency_s, "rel"),
        f"{tag}.bandwidth_s": (r.bandwidth_s, "rel"),
        f"{tag}.congestion_s": (r.congestion_s, "cong"),
    }
    if coherency:
        nums[f"{tag}.coherency_s"] = (r.coherency_s, "rel")
    if pools:
        nums[f"{tag}.epochs"] = (r.epochs, "equal")
        nums[f"{tag}.per_pool_latency_ns"] = (np.asarray(r.per_pool_latency_ns), "pools")
    return nums


def example_numbers(name: str, out) -> dict:
    """The simulated numbers of an example's ``run()`` result, by key, each
    with its bar (train_100m's are its loop's: not held here)."""
    nums = {}
    if name == "quickstart":
        nums.update(report_numbers("report", out["report"], pools=True))
    elif name == "serve_offload":
        for policy, r in out["reports"].items():
            nums.update(report_numbers(policy, r, pools=True))
    elif name == "fabric_pooling":
        r = out["report"]
        for k in ("rounds", "epochs", "bi_messages"):
            nums[k] = (getattr(r, k), "equal")
        nums.update(report_numbers("fabric", r))
        for hc in r.hosts:
            nums.update(report_numbers(f"host{hc.host}", hc))
    elif name == "migration_caching":
        for mig, row in out.items():
            for cap, (r, promotions) in row.items():
                nums.update(report_numbers(f"{mig}/{cap}", r, pools=True))
                nums[f"{mig}/{cap}.promotions"] = (promotions, "equal")
                hit = r.cache_hit_fraction
                nums[f"{mig}/{cap}.cache_hit_fraction"] = (None if hit != hit else hit, "equal")
    elif name == "topology_explorer":
        for n_pools, depth, res in out["grid"]:
            for s, bd, slow in zip(res.scenarios, res.breakdowns, res.slowdowns()):
                tag = f"{n_pools},{depth},{s.name}"
                nums[f"{tag}.delay_ns"] = (bd.total_ns, "rel")
                nums[f"{tag}.slowdown"] = (float(slow), "rel")
        nums["best"] = (out["best"][1:], "equal")
        res, idx = out["refined"]
        nums["refined"] = (res.scenarios[idx].label(), "equal")
        nums["dispatch_count"] = (out["dispatch_count"], "equal")
    return nums


def mismatches(got: dict, want: dict):
    """``(the keys whose numbers miss their bar, the largest rel difference
    of a scalar)`` for two dicts of ``report_numbers``/``example_numbers``."""
    bad = sorted(set(got) ^ set(want))
    worst = 0.0
    for key in sorted(set(got) & set(want)):
        (g, kind), w = got[key], want[key][0]
        if kind == "equal":
            ok = g == w
        elif kind == "pools":
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            atol = REL * max(float(np.abs(w).max(initial=0.0)), 1.0)
            ok = g.shape == w.shape and bool(np.all(np.abs(g - w) <= atol + REL * np.abs(w)))
        else:
            rel, floor = (REL, FLOOR) if kind == "rel" else (CONG_REL, CONG_ABS)
            err = abs(g - w)
            ok = err <= max(rel * abs(w), floor)
            if w:
                worst = max(worst, err / abs(w))
        if not ok:
            bad.append(f"{key}: {g!r} against {w!r} ({kind} bar)")
    return bad, worst
