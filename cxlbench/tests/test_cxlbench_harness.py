"""The harness finds every cell's and metric's files by name, finds a new
mix without an edit, checks its own contract, and refuses to run without
a card."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cxlbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    r = run.resolve(cell)
    assert run.driver_module(r["traffic"]["kind"]).Driver
    assert {m["name"] for m in r["end_to_end"]} >= {"setup_s"}
    assert len(r["end_to_end"]) >= 2 and r["per_layer"]
    for m in r["end_to_end"] + r["per_layer"]:
        assert callable(run.metric_reader(m["name"]))
    assert set(r["limits"]) and all(v > 0 for v in r["limits"].values())


def test_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("cxlbench/")
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m.get("workloads", []):
            assert cell in run.resolve(cell)["cell"]["name"]
            assert m["moves"] in {x["name"] for x in run.resolve(cell)["end_to_end"]}


def test_a_new_mix_is_found_without_an_edit(tmp_path):
    for d in ("configs", "limits"):
        shutil.copytree(run.HERE / d, tmp_path / d)
    (tmp_path / "traffic").mkdir()
    mix = json.loads((run.HERE / "traffic" / "prefill.json").read_text())
    mix.update(batch=4, seq=2048)
    (tmp_path / "traffic" / "prefill-short.json").write_text(json.dumps(mix))
    shutil.copy(tmp_path / "limits" / "starcoder2-3b.fig1.prefill.json",
                tmp_path / "limits" / "starcoder2-3b.fig1.prefill-short.json")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "starcoder2-3b.fig1.prefill-short",
                               "config": "starcoder2-3b.fig1", "traffic": "prefill-short",
                               "chips": 1, "why": "shorter prefills"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "starcoder2-3b.fig1.prefill" in m.get("workloads", []):
            m["workloads"].append("starcoder2-3b.fig1.prefill-short")
    r = run.resolve("starcoder2-3b.fig1.prefill-short", bench, base=tmp_path)
    assert r["traffic"]["seq"] == 2048
    assert {m["name"] for m in r["end_to_end"]} == {"attached_step_s", "setup_s"}


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "cxlbench.run", "--workload", "starcoder2-3b.fig1.sweep",
         "--seed", "2147483905", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr and "never falls back to the CPU" in out.stderr
