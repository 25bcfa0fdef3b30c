"""What decides ``correct`` can fail: the control (the reference one
precision down, put in the program's place) is over a limit of its cell,
and a whole run with the timed path broken underneath comes out not
correct, for each fault a one-card cell can have: a step that leaves its
state unchanged, half of the batch left out with the mean taken over the
rest, and an answer altered where it is produced.  (No cell exchanges
anything between cards.)  Small sizes, on the CPU, the cells' own limits."""

import dataclasses

import numpy as np
import pytest
import torch

from cxlbench import control, run
from cxlbench.tests.small import small
from repro_torch.core import attach, fabric, scenario
from repro_torch.kernels import ops
from repro_torch.models import model as pmodel

CELLS = ["starcoder2-3b.fig1.prefill", "granite-moe-3b-a800m.pool8.rounds",
         "starcoder2-3b.fig1.sweep"]
SEED = 2147483993


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_over_a_limit(cell):
    # the control goes through the run's own check in the program's place; a
    # sweep's pricing is host numpy and cheap at the cell's own size, where
    # its epochs span what bfloat16 times cannot resolve; the others are cut
    r = run.resolve(cell) if "sweep" in cell else small(cell)
    out = control.read(r, SEED, "cpu", units=3)
    assert out["correct"] is False, out["checks"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _every_other(fn):
    calls = {"n": 0}

    def skip(self, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] % 2 == 0:
            return 0.0  # this step's analysis never reaches the report
        return fn(self, *args, **kwargs)
    return skip


def _state_unchanged(monkeypatch, kind):
    if kind == "attached_prefill":
        monkeypatch.setattr(attach.AttachedProgram, "_fold", _every_other(attach.AttachedProgram._fold))
    elif kind == "fabric_rounds":
        monkeypatch.setattr(fabric.FabricSession, "_fold_round",
                            _every_other(fabric.FabricSession._fold_round))
    else:
        run_ = scenario.ScenarioSuite.run
        first = {}

        def stale(self, scenarios, **kw):  # every sweep returns the first one's result
            if "res" not in first or len(first) < 2:
                first["res"] = run_(self, scenarios, **kw)
                first["n"] = first.get("n", 0) + 1
            return dataclasses.replace(first["res"], scenarios=list(scenarios))
        monkeypatch.setattr(scenario.ScenarioSuite, "run", stale)


def _half_batch(monkeypatch, kind):
    if kind == "attached_prefill":
        prefill = pmodel.Model.prefill

        def half(self, tokens, pad_to=None):
            logits, caches, n = prefill(self, tokens, pad_to)
            h = logits.shape[0] // 2
            logits = torch.cat([logits[:h], logits[:h].mean(dim=0, keepdim=True).expand_as(
                logits[h:])])
            return logits, caches, n
        monkeypatch.setattr(pmodel.Model, "prefill", half)
    elif kind == "fabric_rounds":
        merged_round = fabric.FabricSession._merged_round

        def half(self):
            merged, miss, scales = merged_round(self)
            h = (len(merged) + 1) // 2  # the first half, each counted twice
            return ([dataclasses.replace(e, weight=e.weight * 2, bytes_=e.bytes_ * 2)
                     for e in merged[:h]], miss, scales)
        monkeypatch.setattr(fabric.FabricSession, "_merged_round", half)
    else:
        run_ = scenario.ScenarioSuite.run

        def half(self, scenarios, **kw):
            h = len(scenarios) // 2
            res = run_(self, scenarios[:h], **kw)
            mean = res.breakdowns[0]
            for b in res.breakdowns[1:]:
                mean = mean + b
            mean = dataclasses.replace(mean, latency_ns=mean.latency_ns / h,
                                       congestion_ns=mean.congestion_ns / h,
                                       bandwidth_ns=mean.bandwidth_ns / h)
            return dataclasses.replace(res, scenarios=list(scenarios),
                                       breakdowns=res.breakdowns + [mean] * (len(scenarios) - h))
        monkeypatch.setattr(scenario.ScenarioSuite, "run", half)


def _answer_altered(monkeypatch, kind):
    cascade = ops.congestion_cascade

    def doubled(*args, **kwargs):  # the cascade reports twice the queueing
        t_end, slot_idx, psd = cascade(*args, **kwargs)
        return t_end, slot_idx, psd * 2
    monkeypatch.setattr(ops, "congestion_cascade", doubled)
    if kind == "attached_prefill":
        prefill = pmodel.Model.prefill

        def altered(self, tokens, pad_to=None):
            logits, caches, n = prefill(self, tokens, pad_to)
            logits = logits.clone()
            logits[:, 7] += logits.float().std(dim=1).to(logits.dtype)
            return logits, caches, n
        monkeypatch.setattr(pmodel.Model, "prefill", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    r = small(cell)
    fault(monkeypatch, r["traffic"]["kind"])
    out = run.run_cell(r, SEED, 0.3, False, "cpu")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_path_is_correct(cell):
    out = run.run_cell(small(cell), SEED, 0.3, False, "cpu")
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and np.isfinite(list(out["metrics"].values())[0]["value"])
