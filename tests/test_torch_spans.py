"""Program spans (``repro_torch.core.spans``): nothing at all without a
profiler; under one, every thread's spans in the process record, on the
profiler's clock, with their thread's name; the engine, the analyzer, the
fabric round, the attach step and the sweep open theirs; and the default
dispatch path fills the reports' stage / transfer / compute split."""

import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import core as T
from repro_torch.core import spans

torch.set_num_threads(2)

MS = 1_000_000  # ns


def _profiled(fn):
    """``fn()`` under a CPU profiler; returns the profiler and the spans
    recorded meanwhile."""
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, [s for s in spans.recorded() if s.start_ns >= t0]


def _named(recorded, name, thread=None):
    return [s for s in recorded if s.name == name and (thread is None or s.thread == thread)]


def _within(inner, outer):
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


def _regions():
    rm = T.RegionMap()
    rm.alloc("w", 1 << 22, "param")
    rm.alloc("kv", 1 << 22, "kvcache")
    phases = [T.Phase("fwd", flops=5e8, accesses=(T.Access("w", 1 << 22),
                                                  T.Access("kv", 1 << 22, True)))]
    return rm, phases


def _fabric(n_hosts=2, **kw):
    tenants = []
    for h in range(n_hosts):
        rm, phases = _regions()
        tenants.append(T.Tenant(f"t{h}", phases, rm, T.ClassMapPolicy({"kvcache": "shared_pool"})))
    return T.FabricSession(T.pooled_topology(n_hosts=n_hosts), tenants, device="cpu", **kw)


def _attached(**kw):
    rm, phases = _regions()
    sim = T.CXLMemSim(T.figure1_topology(), T.ClassMapPolicy({"kvcache": "cxl_pool2"}),
                      device="cpu", **kw)
    return sim.attach(lambda x: (x * x).sum(), phases, rm)


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    def forbidden(*_args, **_kwargs):
        raise AssertionError("a span without a profiler reached the profiler or the clock")

    monkeypatch.setattr(spans, "record_function", forbidden)
    monkeypatch.setattr(spans, "time_ns", forbidden)
    assert not torch.autograd.profiler._is_profiler_enabled
    before = spans.recorded()
    first = spans.span("test.off")
    assert first is spans.span("test.other")
    with first, spans.span("test.nested"):
        pass
    assert spans.recorded() == before


def test_spans_of_another_thread_record_with_its_name_nested_in_order():
    def work():
        with spans.span("test.outer"):
            with spans.span("test.inner"):
                torch.ones(64).sum()
            with spans.span("test.inner"):
                torch.ones(64).sum()

    def run():
        th = threading.Thread(target=work, name="span-side")
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()

    prof, got = _profiled(run)
    side = [s for s in got if s.thread == "span-side"]
    assert [s.name for s in side] == ["test.inner", "test.inner", "test.outer"]
    first, second, outer = side
    assert first.start_ns <= first.end_ns <= second.start_ns <= second.end_ns
    assert _within(first, outer) and _within(second, outer)
    # the profiler traces only the thread that started it; the record has
    # every thread's spans
    assert not _named(got, "test.outer", "MainThread")


def test_many_threads_lose_no_span():
    n_threads, per_thread = 16, 200

    def work():
        for _ in range(per_thread):
            with spans.span("test.stress"):
                pass

    def run():
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, name=f"stress-{i}") for i in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(interval)

    _, got = _profiled(run)
    counts = {}
    for s in _named(got, "test.stress"):
        counts[s.thread] = counts.get(s.thread, 0) + 1
    assert counts == {f"stress-{i}": per_thread for i in range(n_threads)}


def test_a_main_thread_span_lies_on_the_profiler_clock():
    def run():
        with spans.span("test.main"):
            time.sleep(0.005)

    prof, got = _profiled(run)
    (rec,) = _named(got, "test.main", "MainThread")
    events = [k for k in prof.profiler.kineto_results.events()
              if k.name() == spans.PREFIX + "test.main"]
    assert len(events) == 1
    start = events[0].start_ns()
    end = start + events[0].duration_ns()
    assert abs(rec.start_ns - start) <= MS and abs(rec.end_ns - end) <= MS
    assert rec.end_ns - rec.start_ns >= 5 * MS


def test_the_engine_and_the_fabric_round_open_their_spans():
    t0 = time.time_ns()
    with T.AnalysisEngine(name="span-engine") as eng:
        sess = _fabric(engine=eng)
        prof, _ = _profiled(lambda: sess.run(3))
        sess.close()
    # read once the engine's thread has ended: the flush returns when the
    # last round's finish has folded, before that thread closes its
    # engine.finish span
    got = [s for s in spans.recorded() if s.start_ns >= t0]
    for name in ("engine.launch", "engine.finish", "analyzer.stage", "analyzer.transfer",
                 "analyzer.launch", "analyzer.finish"):
        assert len(_named(got, name, "span-engine")) == 3, name
    for name in ("fabric.merge", "fabric.native"):
        assert len(_named(got, name, "MainThread")) == 3, name
    assert _named(got, "engine.flush_wait", "MainThread")
    launches = _named(got, "engine.launch", "span-engine")
    finishes = _named(got, "engine.finish", "span-engine")
    for name in ("analyzer.stage", "analyzer.transfer", "analyzer.launch"):
        for s in _named(got, name, "span-engine"):
            assert any(_within(s, outer) for outer in launches), name
    for s in _named(got, "analyzer.finish", "span-engine"):
        assert any(_within(s, outer) for outer in finishes)
    # the session's thread's spans show in the profiler's own trace too
    names = {k.name() for k in prof.profiler.kineto_results.events()}
    assert {spans.PREFIX + "fabric.merge", spans.PREFIX + "fabric.native"} <= names


def test_the_attach_step_opens_its_spans():
    with _attached(async_analysis=False) as prog:
        _, got = _profiled(lambda: prog.run(2, torch.ones(8)))
    for name in ("attach.batch", "attach.native", "analyzer.stage", "analyzer.transfer",
                 "analyzer.launch", "analyzer.finish"):
        assert len(_named(got, name, "MainThread")) == 2, name


def test_the_sweep_opens_its_spans_in_order():
    rm, phases = _regions()
    suite = T.ScenarioSuite(T.figure1_topology(), rm, phases, hw=T.TPU_V5E, device="cpu")
    scenarios = [T.Scenario(policy=T.ClassMapPolicy({"kvcache": pool}))
                 for pool in ("cxl_pool1", "cxl_pool2")]
    _, got = _profiled(lambda: suite.run(scenarios))
    order = ["sweep.prepare", "sweep.stage", "sweep.transfer", "sweep.launch", "sweep.d2h"]
    seen = [s for s in got if s.name.startswith("sweep.")]
    assert [s.name for s in seen] == order
    assert all(a.end_ns <= b.start_ns for a, b in zip(seen, seen[1:]))


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_the_default_path_fills_the_reports_timing_split(mode):
    kw = {"async_analysis": mode == "async"}
    with _fabric(**kw) as sess:
        fab = sess.run(2)
    with _attached(**kw) as prog:
        att = prog.run(2, torch.ones(8))
    for rep in (fab, att):
        assert rep.stage_s > 0 and rep.transfer_s > 0 and rep.compute_s > 0
        assert rep.compile_s == 0.0
