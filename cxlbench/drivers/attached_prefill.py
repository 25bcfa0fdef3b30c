"""Traffic kind ``attached_prefill``: back-to-back prefills of ``batch x
seq`` tokens (drawn anew each step from the seed), each through
``AttachedProgram.step`` on a program attached to CXLMemSim under the
asynchronous default (the shared ``AnalysisEngine``).  One unit is one
attached step.  The check compares a sample of the timed prefills' last
logits with the plain f32 forward (every row of one step drawn from the
seed, so that each batch slot is compared, and rows drawn from the other
steps, ``check_rows`` in all), and the report's three delay totals with
the plain pricing of the step's epochs times the steps.  ``Control`` puts
the reference one precision down in the program's place."""

from __future__ import annotations

import gc

import torch
from torch.profiler import record_function

from repro_torch.core import CXLMemSim, EpochSchedule
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import Model, build_regions_and_phases

from .. import inputs, system
from ..reference import model as ref_model
from ..reference import pricing, program

NS_PER_S = 1e9
KEYS = ("latency", "congestion", "bandwidth")


def picks(seed: int, steps: int, batch: int, rows: int) -> list:
    """The rows compared (``step * batch + slot``): every slot of one step
    drawn from the seed, then rows drawn from the other steps."""
    whole = inputs.sample(seed, steps, 1, salt=1)[0]
    rest = [i for i in range(steps * batch) if i // batch != whole]
    more = inputs.sample(seed, len(rest), max(rows - batch, 0), salt=3)
    return sorted([whole * batch + b for b in range(batch)] + [rest[j] for j in more])


def step_pricing(cfg: dict, traffic: dict, control: bool = False) -> dict:
    """One step's delay totals (ns) by the plain pricing, in f64, or one
    precision down with ``control``."""
    m = cfg["model"]
    flat = program.flatten(cfg["topology"])
    regions, phases = program.memory_program(m, "prefill", traffic["batch"], traffic["seq"])
    pools = program.place(cfg["placement"], regions, flat)
    skel = program.skeleton(regions, phases, cfg["pacing"], cfg["placement"]["granularity"],
                            cfg["events_per_access"])
    return pricing.price_epochs(flat, program.epochs(skel, pools), cfg["n_windows"],
                                control=control)


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        m = cfg["model"]
        self.batch, self.seq = traffic["batch"], traffic["seq"]
        self.weights = inputs.dense_weights(m, seed, self.device)
        mcfg = system.model_config(m)
        self.model = Model(mcfg, device="meta")
        self.model.load_state_dict(self.weights, assign=True)
        regions, phases = build_regions_and_phases(mcfg, "prefill", batch=self.batch, seq=self.seq)
        sim = CXLMemSim(system.topology(cfg["topology"]), system.policy(cfg["placement"]),
                        epoch=EpochSchedule(cfg["epoch"]), hw=system.pacing(cfg["pacing"]),
                        max_events_per_access=cfg["events_per_access"],
                        n_windows=cfg["n_windows"], device=self.device)
        self.prog = sim.attach(make_prefill_step(mcfg), phases, regions)
        self.logits = []
        self.steps = 0
        self.before = None

    def _tokens(self, step: int) -> torch.Tensor:
        return inputs.step_tokens(self.seed, step, self.batch, self.seq,
                                  self.cfg["model"]["vocab_size"], self.device)

    def warmup(self) -> None:
        with record_function("cxlbench.warmup"):
            self.prog.step(self.model, {"tokens": self._tokens(-1)})
            self.prog.flush()
        rep = self.prog.report
        self.before = (rep.native_s, rep.analyzer_s)

    def step(self) -> None:
        with record_function("cxlbench.attached_step"):
            tok = self._tokens(self.steps)
            logits, caches, _ = self.prog.step(self.model, {"tokens": tok})
            del caches
        self.logits.append(logits)
        self.steps += 1

    def finish(self) -> None:
        with record_function("cxlbench.flush"):
            self.prog.flush()

    def counters(self) -> dict:
        rep = self.prog.report
        return {"units": self.steps, "native_s": rep.native_s - self.before[0],
                "analyzer_s": rep.analyzer_s - self.before[1]}

    def release(self) -> None:
        rep = self.prog.report
        # the steps this driver ran (the warm-up's too), not the report's count
        self.report = {"steps": self.steps + 1, "latency_s": rep.latency_s,
                       "congestion_s": rep.congestion_s, "bandwidth_s": rep.bandwidth_s}
        self.prog.close()
        del self.prog, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The numbers compared: ``logit_err`` (the sampled rows' widest
        logit gap to the reference, over the reference row's standard
        deviation) and the report's totals' relative gaps."""
        m, B = self.cfg["model"], self.batch
        rows = picks(self.seed, self.steps, B, self.traffic["check_rows"])
        toks = torch.stack([self._tokens(i // B)[i % B] for i in rows])
        got = torch.stack([self.logits[i // B][i % B] for i in rows]).float()
        self.logits = None
        want = ref_model.last_logits(self.weights, m, toks)
        err = ((got - want).abs().amax(dim=1) / want.std(dim=1)).max()
        out = {"logit_err": float(err)}
        ref = step_pricing(self.cfg, self.traffic)
        n = self.report["steps"]
        for k in KEYS:
            got_ns, want_ns = self.report[f"{k}_s"] * NS_PER_S, n * ref[k]
            out[f"{k}_rel"] = abs(got_ns - want_ns) / max(abs(want_ns), 1.0)
        return out

    def work(self) -> dict:
        return {}


class _Fp8Rows:
    """A step's last logits as the control gives them: the plain forward
    with float8 products, one row at a time, when the check reads it."""

    def __init__(self, drv, tokens: torch.Tensor):
        self.drv, self.tokens = drv, tokens

    def __getitem__(self, b: int) -> torch.Tensor:
        return ref_model.last_logits(self.drv.weights, self.drv.cfg["model"],
                                     self.tokens[b:b + 1], fp8=True)[0]


class Control(Driver):
    """The control in the program's place, read through the run's own
    check: float8 products for the bfloat16 model, and bfloat16 event
    times with f32 sums for the simulator (which states f32 times and f64
    sums).  Nothing of the program runs."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.batch, self.seq = traffic["batch"], traffic["seq"]
        self.weights = inputs.dense_weights(cfg["model"], seed, self.device)
        self.logits = []
        self.steps = 0

    def warmup(self) -> None:
        pass

    def step(self) -> None:
        self.logits.append(_Fp8Rows(self, self._tokens(self.steps)))
        self.steps += 1

    def finish(self) -> None:
        pass

    def counters(self) -> dict:
        return {"units": self.steps, "native_s": 0.0, "analyzer_s": 0.0}

    def release(self) -> None:
        ctl = step_pricing(self.cfg, self.traffic, control=True)
        n = self.steps + 1  # as many as the program's report would hold
        self.report = {"steps": n, **{f"{k}_s": n * ctl[k] / NS_PER_S for k in KEYS}}
