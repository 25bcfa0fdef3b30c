"""Traffic kind ``scenario_sweep``: back-to-back ``ScenarioSuite.run``
calls over a configuration's model program, each sweep its own
``len(policies) x stt_rows x variants_per_row`` scenarios: the traffic's
placement policies at its granularity, crossed with topology overrides
drawn from the seed for that sweep (distinct switch service-time rows, each
with the same pool-latency and switch-bandwidth variants).  The skeleton is
staged at set-up (the warm-up sweep).  One unit is one sweep; the
end-to-end rate counts scenarios.  The check prices every scenario of a
sample of sweeps with the plain reference."""

from __future__ import annotations

import gc

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import EpochSchedule, Scenario, ScenarioSuite
from repro_torch.models import build_regions_and_phases

from .. import inputs, roofline, system
from ..reference import pricing, program

KEYS = ("latency", "congestion", "bandwidth")


def _policies(traffic: dict) -> list:
    return [dict(p, granularity=traffic["granularity"]) for p in traffic["policies"]]


def _ref_program(cfg: dict, traffic: dict):
    p = traffic["program"]
    regions, phases = program.memory_program(cfg["model"], p["kind"], p["batch"], p["seq"])
    skel = program.skeleton(regions, phases, cfg["pacing"], traffic["granularity"],
                            cfg["events_per_access"])
    return regions, skel


def reference_totals(cfg: dict, traffic: dict, seed: int, sweep: int, control: bool = False,
                     rebuilt=None) -> np.ndarray:
    """``[K, 3]`` latency, congestion and bandwidth ns of every scenario of
    sweep ``sweep``, priced by the plain reference."""
    regions, skel = rebuilt or _ref_program(cfg, traffic)
    out = []
    for o in inputs.sweep_overrides(seed, sweep, traffic):
        flat = program.flatten(program.with_override(cfg["topology"], o))
        for pol in _policies(traffic):
            eps = program.epochs(skel, program.place(pol, regions, flat))
            tot = pricing.price_epochs(flat, eps, cfg["n_windows"], control=control)
            out.append([tot[k] for k in KEYS])
    return np.asarray(out, np.float64)


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    return {f"{k}_rel": float(rel[:, i].max()) for i, k in enumerate(KEYS)}


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        p = traffic["program"]
        mcfg = system.model_config(cfg["model"])
        self.regions, phases = build_regions_and_phases(mcfg, p["kind"], batch=p["batch"],
                                                        seq=p["seq"])
        total = int(sum(r.nbytes for r in self.regions))
        self.policies = [system.policy(q, total) for q in _policies(traffic)]
        self.suite = ScenarioSuite(
            system.topology(cfg["topology"]), self.regions, phases, hw=system.pacing(cfg["pacing"]),
            max_events_per_access=cfg["events_per_access"], n_windows=cfg["n_windows"],
            epoch_mode=EpochSchedule(cfg["epoch"]).mode, device=self.device)
        self.sweeps = 0
        self.totals = []
        self.transfer_s = self.compute_s = 0.0
        self.scenarios_per_sweep = len(self.policies) * traffic["stt_rows"] * traffic["variants_per_row"]

    def _scenarios(self, sweep: int) -> list:
        return [Scenario(policy=pol, topology=system.override(o), name=f"s{i}.{j}")
                for i, o in enumerate(inputs.sweep_overrides(self.seed, sweep, self.traffic))
                for j, pol in enumerate(self.policies)]

    def warmup(self) -> None:
        with record_function("cxlbench.warmup"):
            self.suite.run(self._scenarios(-1))

    def step(self) -> None:
        with record_function("cxlbench.sweep"):
            res = self.suite.run(self._scenarios(self.sweeps))
        self.totals.append(np.asarray([[b.latency_ns, b.congestion_ns, b.bandwidth_ns]
                                       for b in res.breakdowns], np.float64))
        self.transfer_s += res.transfer_s
        self.compute_s += res.compute_s
        self.sweeps += 1

    def finish(self) -> None:
        pass

    def counters(self) -> dict:
        return {"units": self.sweeps, "scenarios": self.sweeps * self.scenarios_per_sweep,
                "transfer_s": self.transfer_s, "compute_s": self.compute_s}

    def release(self) -> None:
        del self.suite
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        rebuilt = _ref_program(self.cfg, self.traffic)
        picks = inputs.sample(self.seed, self.sweeps, self.traffic["check_sweeps"], salt=2)
        got = np.concatenate([self.totals[i] for i in picks])
        want = np.concatenate([reference_totals(self.cfg, self.traffic, self.seed, i,
                                                rebuilt=rebuilt) for i in picks])
        return compare(got, want)

    def work(self) -> dict:
        """A sweep's unique cascades (distinct placement and service-time
        rows) and their bound on the card."""
        regions, skel = _ref_program(self.cfg, self.traffic)
        rows = len(skel["ptr"]) - 1
        valid = queued = n_cas = 0
        seen = set()
        for o in inputs.sweep_overrides(self.seed, 0, self.traffic):
            flat = program.flatten(program.with_override(self.cfg["topology"], o))
            for pol in _policies(self.traffic):
                pools = program.place(pol, regions, flat)
                key = (pools.tobytes(), flat["stt_ns"].tobytes())
                if key in seen:
                    continue
                seen.add(key)
                n_cas += 1
                valid += len(skel["t"])
                vp = pools[skel["region"]]
                queued += int((flat["route"][vp][:, flat["stt_ns"] > 0] > 0).sum())
        S = flat["n_switches"]
        bound = roofline.cascade_bound_s(valid, queued, S, rows * n_cas, S,
                                         roofline.CASCADE_BYTES_PER_EVENT)
        return {"unique_cascades": n_cas, "cascade_bound_s_per_unit": bound,
                "cascade_kernel": "cascade_kernel<false>"}


class _ControlTotals:
    """Each sweep's ``[K, 3]`` totals as the control gives them, priced
    when the check reads them."""

    def __init__(self, drv):
        self.drv, self.rebuilt = drv, None

    def __getitem__(self, sweep: int) -> np.ndarray:
        d = self.drv
        self.rebuilt = self.rebuilt or _ref_program(d.cfg, d.traffic)
        return reference_totals(d.cfg, d.traffic, d.seed, sweep, control=True,
                                rebuilt=self.rebuilt)


class Control(Driver):
    """The control in the program's place, read through the run's own
    check: the pricing with bfloat16 event times and f32 sums for every
    scenario.  Nothing of the program runs."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.sweeps = 0
        self.totals = _ControlTotals(self)
        self.transfer_s = self.compute_s = 0.0
        self.scenarios_per_sweep = (len(traffic["policies"]) * traffic["stt_rows"]
                                    * traffic["variants_per_row"])

    def warmup(self) -> None:
        pass

    def step(self) -> None:
        self.sweeps += 1

    def release(self) -> None:
        pass
