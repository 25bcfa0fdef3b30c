"""The per-layer metrics read from the program's spans: every one is in a
small traced run of its cell on the CPU, the analyzer's spans add up to
``analyzer_ms`` a round, and a reader gives nothing without a trace or
without the program's span record (the parent of a program that has one)."""

import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from cxlbench import run
from cxlbench.tests.small import small
from repro_torch.core import spans

SEED = 2147484011
SPAN_METRICS = {
    "granite-moe-3b-a800m.pool8.rounds": ["engine_stage_ms.pool8", "engine_transfer_ms.pool8",
                                          "engine_wait_ms.pool8", "submit_wait_ms.pool8",
                                          "idle_in_staging.pool8"],
    "starcoder2-3b.fig1.sweep": ["sweep_prepare_ms.sweep"],
}
ALL = [m for names in SPAN_METRICS.values() for m in names]


def _ms(recorded, name, units):
    return 1e-6 * sum(s.end_ns - s.start_ns for s in recorded if s.name == name) / units


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_run_reports_every_span_metric(cell):
    r = small(cell)
    assert {m["name"] for m in r["per_layer"]} >= set(SPAN_METRICS[cell])
    t0 = time.time_ns()
    out = run.run_cell(r, SEED, 0.3, True, "cpu")
    got = [s for s in spans.recorded() if s.start_ns >= t0]
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"] is True, out["checks"]
    units = out["attempted"]
    for name in SPAN_METRICS[cell]:
        assert name in metrics and np.isfinite(metrics[name]) and metrics[name] >= 0, name
    if "pool8" in cell:
        parts = [metrics["engine_stage_ms.pool8"], metrics["engine_transfer_ms.pool8"],
                 _ms(got, "analyzer.launch", units), metrics["engine_wait_ms.pool8"]]
        assert all(p > 0 for p in parts)
        assert sum(parts) == pytest.approx(metrics["analyzer_ms.pool8"], rel=0.1)
        # no device on the CPU: every staging instant is idle
        assert 0 < metrics["idle_in_staging.pool8"] <= metrics["idle_share.pool8"]
        # the session's thread waits on the engine inside the benchmark's span
        labels = [label for label, _ in out["breakdown"]["idle_gaps"]]
        assert any(spans.PREFIX in label for label in labels), labels
    else:
        assert metrics["sweep_prepare_ms.sweep"] == pytest.approx(
            _ms(got, "sweep.prepare", units))


@pytest.mark.parametrize("name", ALL)
def test_a_reader_gives_nothing_without_a_trace(name):
    ctx = {"trace": None, "counters": {"units": 3}, "window_s": 1.0}
    assert run.metric_reader(name)(ctx) is None


def _trace(lo, hi, busy):
    return SimpleNamespace(host=np.array([[lo, hi]], np.int64), busy=busy)


@pytest.mark.parametrize("name", ALL)
def test_a_reader_gives_nothing_without_the_span_record(name, monkeypatch):
    # as in a program without the module: its import fails
    monkeypatch.delattr(sys.modules["repro_torch.core"], "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    ctx = {"trace": _trace(0, 2**62, []), "counters": {"units": 3}, "window_s": 1.0}
    assert run.metric_reader(name)(ctx) is None


def test_idle_in_staging_counts_the_idle_part_of_open_staging(monkeypatch):
    base = 10**18
    rec = [spans.Span("analyzer.stage", "engine", base + 0, base + 100),
           spans.Span("analyzer.transfer", "engine", base + 100, base + 200),
           spans.Span("analyzer.stage", "engine", base + 150, base + 300),  # overlaps
           spans.Span("analyzer.launch", "engine", base + 300, base + 900),  # not staging
           spans.Span("analyzer.stage", "engine", base + 5000, base + 5100)]  # outside the trace
    monkeypatch.setattr(spans, "recorded", lambda: rec)
    busy = [[base + 50, base + 120], [base + 250, base + 400]]
    ctx = {"trace": _trace(base, base + 1000, busy), "counters": {"units": 1},
           "window_s": 1e-6}
    # staging open over [0, 300]; the card busy over [50, 120] and [250, 300] of it
    assert run.metric_reader("idle_in_staging.pool8")(ctx) == pytest.approx(100.0 * 180 / 1000)
    assert run.metric_reader("engine_stage_ms.pool8")(ctx) == pytest.approx(250e-6)
