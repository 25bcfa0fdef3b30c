"""Traffic kind ``fabric_rounds``: back-to-back ``FabricSession.round``
calls on a shared fabric of trace-only decode tenants, under the session's
default (rounds overlapped on the shared ``AnalysisEngine``).  Each
tenant's KV-cache length is drawn from the seed.  One unit is one round.
The check compares the report's latency and congestion totals, each
host's latency and congestion, and each host's whole delay (bandwidth and
coherency misses with them) with the plain pricing of the rebuilt merged
round times the rounds.  Bandwidth and coherency are compared inside the
hosts' whole delays only: every window of the shared switch is saturated,
so the bandwidth total is the bytes over the rate less the span whatever
the event times, and the bytes and the misses sum exactly in f32, so that
neither moves under the control on its own (PERF.md, Cells)."""

from __future__ import annotations

import gc

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import CoherencyConfig, EpochSchedule, FabricSession, Tenant
from repro_torch.models import build_regions_and_phases

from .. import inputs, roofline, system
from ..reference import pricing, program

NS_PER_S = 1e9


def _lens(cfg: dict, traffic: dict, seed: int):
    c = traffic["cache_len"]
    return inputs.cache_lens(seed, cfg["tenants"]["hosts"], c["low"], c["high"], c["step"])


def rebuild(cfg: dict, lens, dt=np.float64) -> tuple:
    """The reference's merged round, its per-host miss ns (summed in
    ``dt``) and flat topology."""
    t, m = cfg["tenants"], cfg["model"]
    flat = program.flatten(cfg["topology"])
    maps, pools_of, per_host = [], [], []
    for h, cl in enumerate(lens):
        regions, phases = program.memory_program(m, t["kind"], t["batch"], t["seq"], cache_len=cl)
        pools = program.place(cfg["placement"], regions, flat)
        skel = program.skeleton(regions, phases, cfg["pacing"], cfg["placement"]["granularity"],
                                cfg["events_per_access"])
        maps.append(regions)
        pools_of.append(pools)
        per_host.append(program.epochs(skel, pools, host=h))
    merged, miss = program.merged_round(per_host, maps, pools_of, cfg.get("coherency"), dt)
    return merged, miss, flat


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.lens = _lens(cfg, traffic, seed)
        t = cfg["tenants"]
        mcfg = system.model_config(cfg["model"])
        tenants = []
        for h, cl in enumerate(self.lens):
            regions, phases = build_regions_and_phases(mcfg, t["kind"], batch=t["batch"],
                                                       seq=t["seq"], cache_len=cl)
            tenants.append(Tenant(f"tenant{h}", phases, regions, system.policy(cfg["placement"])))
        coh = cfg.get("coherency")
        self.session = FabricSession(
            system.topology(cfg["topology"]), tenants, epoch=EpochSchedule(cfg["epoch"]),
            hw=system.pacing(cfg["pacing"]),
            coherency=None if coh is None else CoherencyConfig(
                shared_classes=tuple(coh["shared_classes"]),
                bi_message_bytes=coh["bi_message_bytes"],
                coherency_miss_ns=coh["coherency_miss_ns"], max_bi_events=coh["max_bi_events"]),
            max_events_per_access=cfg["events_per_access"], n_windows=cfg["n_windows"],
            device=self.device)
        self.rounds = 0
        self._rebuilt = None

    def warmup(self) -> None:
        with record_function("cxlbench.warmup"):
            self.session.round()
            self.session.flush()
        self.before = self.session.report.analyzer_s

    def step(self) -> None:
        with record_function("cxlbench.round"):
            self.session.round()
        self.rounds += 1

    def finish(self) -> None:
        with record_function("cxlbench.flush"):
            self.session.flush()

    def counters(self) -> dict:
        return {"units": self.rounds, "analyzer_s": self.session.report.analyzer_s - self.before}

    def release(self) -> None:
        rep = self.session.report
        self.report = {
            # the rounds this driver ran (the warm-up's too), not the report's count
            "rounds": self.rounds + 1, "latency_s": rep.latency_s, "congestion_s": rep.congestion_s,
            "bandwidth_s": rep.bandwidth_s, "coherency_s": rep.coherency_s,
            "host_latency_s": np.array([h.latency_s for h in rep.hosts]),
            "host_congestion_s": np.array([h.congestion_s for h in rep.hosts]),
            "host_delay_s": np.array([h.delay_s for h in rep.hosts]),
        }
        self.session.close()
        del self.session
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self):
        if self._rebuilt is None:
            merged, miss, flat = rebuild(self.cfg, self.lens)
            self._rebuilt = (merged, miss, flat,
                             pricing.price_epochs(flat, merged, self.cfg["n_windows"]))
        return self._rebuilt

    def check(self) -> dict:
        _, miss, _, ref = self._reference()
        return compare(self.report, ref, miss)

    def work(self) -> dict:
        """A round's events (the merged epochs' real ones) and its cascade's
        bound on the card."""
        merged, _, flat, _ = self._reference()
        valid = sum(len(ev["t"]) for ev in merged)
        queued = 0
        for ev in merged:
            vp = ev["host"].astype(np.int64) * flat["n_pools"] + ev["pool"].astype(np.int64)
            queued += int((flat["route"][vp][:, flat["stt_ns"] > 0] > 0).sum())
        S, H = flat["n_switches"], flat["n_hosts"]
        bound = roofline.cascade_bound_s(valid, queued, S, len(merged), S * H,
                                         roofline.HOSTS_CASCADE_BYTES_PER_EVENT)
        return {"events_per_unit": valid, "cascade_bound_s_per_unit": bound,
                "cascade_kernel": "cascade_kernel<true>"}


def compare(report: dict, ref: dict, miss: np.ndarray) -> dict:
    n = report["rounds"]

    def rel(got_s, want_ns):
        got_ns = np.asarray(got_s, np.float64) * NS_PER_S
        want_ns = n * np.asarray(want_ns, np.float64)
        return float(np.max(np.abs(got_ns - want_ns) / np.maximum(np.abs(want_ns), 1.0)))

    host_delay = ref["host_latency"] + ref["host_congestion"] + ref["host_bandwidth"] + miss
    return {
        "latency_rel": rel(report["latency_s"], ref["latency"]),
        "congestion_rel": rel(report["congestion_s"], ref["congestion"]),
        "host_latency_rel": rel(report["host_latency_s"], ref["host_latency"]),
        "host_congestion_rel": rel(report["host_congestion_s"], ref["host_congestion"]),
        "host_delay_rel": rel(report["host_delay_s"], host_delay),
    }


class Control(Driver):
    """The control in the program's place, read through the run's own
    check: the pricing with bfloat16 event times and f32 sums, and the
    coherency misses summed in f32, for every round.  Nothing of the
    program runs."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.lens = _lens(cfg, traffic, seed)
        self.rounds = 0
        self._rebuilt = None

    def warmup(self) -> None:
        pass

    def step(self) -> None:
        self.rounds += 1

    def finish(self) -> None:
        pass

    def counters(self) -> dict:
        return {"units": self.rounds, "analyzer_s": 0.0}

    def release(self) -> None:
        merged, _, flat, _ = self._reference()
        _, miss32, _ = rebuild(self.cfg, self.lens, np.float32)
        ctl = pricing.price_epochs(flat, merged, self.cfg["n_windows"], control=True)
        n = self.rounds + 1  # as many as the program's report would hold
        self.report = {"rounds": n}
        for k in ("latency", "congestion"):
            self.report[f"{k}_s"] = n * ctl[k] / NS_PER_S
            self.report[f"host_{k}_s"] = n * ctl[f"host_{k}"] / NS_PER_S
        delay32 = (ctl["host_latency"] + ctl["host_congestion"] + ctl["host_bandwidth"]
                   ).astype(np.float32) + miss32.astype(np.float32)
        self.report["host_delay_s"] = n * delay32.astype(np.float64) / NS_PER_S
