"""Port parity: synchronous ``CXLMemSim.attach(...).run()`` on the qwen3
smoke memory program against the reference's synchronous attach.  Native
step times differ by design (a torch step against a jitted JAX step) and are
not compared; every simulated delay is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.configs import qwen3_0_6b as r_qwen
from repro.models.phases import build_regions_and_phases as r_build
from repro_torch import core as T
from repro_torch.configs import qwen3_0_6b as t_qwen
from repro_torch.core.units import ns_to_s
from repro_torch.models import build_regions_and_phases as t_build

torch.set_num_threads(2)

POLICY = {"opt_state": "cxl_pool2", "grad": "cxl_pool1"}
KW = dict(epoch="layer", max_events_per_access=256, check_capacity=False)


def _reference_report(steps):
    regions, phases = r_build(r_qwen.SMOKE, "train", batch=2, seq=64)
    sim = R.CXLMemSim(
        R.figure1_topology(), R.ClassMapPolicy(POLICY),
        epoch=R.EpochSchedule(KW["epoch"]), hw=R.TPU_V5E,
        max_events_per_access=KW["max_events_per_access"],
        check_capacity=KW["check_capacity"],
    )
    x = jnp.ones((16, 16))
    with sim.attach(jax.jit(lambda a: (a @ a.T).sum()), phases, regions) as prog:
        return prog.run(steps, x)


def _port_program(**over):
    regions, phases = t_build(t_qwen.SMOKE, "train", batch=2, seq=64)
    kw = dict(
        epoch=T.EpochSchedule(KW["epoch"]), hw=T.TPU_V5E,
        max_events_per_access=KW["max_events_per_access"],
        check_capacity=KW["check_capacity"], device="cpu",
    )
    kw.update(over)
    sim = T.CXLMemSim(T.figure1_topology(), T.ClassMapPolicy(POLICY), **kw)
    return sim.attach(lambda a: (a @ a.T).sum(), phases, regions)


def test_attach_run_matches_reference():
    want = _reference_report(2)
    with _port_program() as prog:
        got = prog.run(2, torch.ones(16, 16))
    assert got.steps == want.steps == 2 and got.epochs == want.epochs
    for f in ("latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-5), f
    assert got.congestion_s > 0 and got.latency_s > 0
    tol = dict(rtol=1e-5, atol=1e-2)  # ns
    for f in ("per_pool_latency_ns", "per_switch_congestion_ns",
              "per_switch_bandwidth_ns", "per_class_congestion_ns"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **tol)
    delay_s = got.latency_s + got.congestion_s + got.bandwidth_s
    assert got.simulated_s == pytest.approx(got.native_s + delay_s, rel=1e-9)
    assert set(got.summary()) == set(want.summary())
    assert got.padded_waste == want.padded_waste and got.analyzer_s > 0


def test_attach_epochs_equal_the_analyzer_on_its_traces():
    with _port_program() as prog:
        rep = prog.run(1, torch.ones(4, 4))
    bd = T.EpochAnalyzer(prog.sim.flat, device="cpu").analyze_batch(prog.epoch_traces())
    assert rep.congestion_s == pytest.approx(ns_to_s(bd.congestion_ns), rel=1e-12)
    assert rep.epochs == len(prog.epoch_traces())


def test_fine_grained_analyzer_matches_reference():
    regions, phases = r_build(r_qwen.SMOKE, "train", batch=2, seq=64)
    sim = R.CXLMemSim(
        R.figure1_topology(), R.ClassMapPolicy(POLICY), hw=R.TPU_V5E,
        analyzer="fine", max_events_per_access=64, check_capacity=False,
    )
    with sim.attach(lambda: jnp.zeros(()), phases, regions) as prog:
        want = prog.run(1)
    with _port_program(
        analyzer="fine", epoch=T.EpochSchedule("step"), max_events_per_access=64
    ) as prog:
        got = prog.run(1, torch.ones(2, 2))
    for f in ("latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12), f


def test_local_only_has_no_delay():
    regions, phases = t_build(t_qwen.SMOKE, "train", batch=2, seq=64)
    sim = T.CXLMemSim(T.local_only_topology(), T.LocalOnlyPolicy(), device="cpu")
    with sim.attach(lambda: None, phases, regions) as prog:
        rep = prog.run(2)
    assert rep.latency_s == rep.congestion_s == rep.bandwidth_s == 0.0
    assert rep.slowdown == pytest.approx(1.0)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.CXLMemSim(T.figure1_topology(), T.ClassMapPolicy(POLICY))


# migration= and cache= (tests/test_torch_migration_cache.py) and
# asynchronous analysis (slice 4, tests/test_torch_engine.py) are ported.
# The test keeps its name and cases: each case now runs asynchronously, with
# the option it names, and matches the reference's asynchronous attach (the
# reference's default) at this file's bars
@pytest.mark.parametrize("kw, slice_name", [
    (dict(async_analysis=True, migration=True), "slice 4"),
    (dict(async_analysis=True, cache=1 << 20), "slice 4"),
    (dict(async_analysis=True), "slice 4"),
])
def test_unported_options_name_their_slice(kw, slice_name):
    reports = {}
    for pkg, build in ((R, r_build), (T, t_build)):
        regions, phases = build((r_qwen if pkg is R else t_qwen).SMOKE, "train", batch=2, seq=64)
        opts = dict(async_analysis=kw["async_analysis"])
        if "migration" in kw:
            opts["migration"] = pkg.MigrationSimulator(
                pkg.MigrationConfig(mode="software", promote_threshold=1,
                                    local_budget_bytes=1 << 30),
                regions, pkg.figure1_topology().flatten())
        if "cache" in kw:
            opts["cache"] = pkg.DeviceCacheConfig(capacity_bytes=kw["cache"])
        if pkg is T:
            opts["device"] = "cpu"
            step, x = (lambda a: (a @ a.T).sum()), torch.ones(16, 16)
        else:
            step, x = jax.jit(lambda a: (a @ a.T).sum()), jnp.ones((16, 16))
        with pkg.AnalysisEngine() as eng:
            sim = pkg.CXLMemSim(
                pkg.figure1_topology(), pkg.ClassMapPolicy(POLICY),
                epoch=pkg.EpochSchedule(KW["epoch"]), hw=pkg.TPU_V5E,
                max_events_per_access=KW["max_events_per_access"],
                check_capacity=KW["check_capacity"], engine=eng, **opts,
            )
            with sim.attach(step, phases, regions) as prog:
                assert prog._handle is not None and prog._handle.engine is eng
                reports[pkg] = prog.run(2, x)
    got, want = reports[T], reports[R]
    assert got.steps == want.steps == 2 and got.epochs == want.epochs
    for f in ("latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-5), f
    for f in ("per_pool_latency_ns", "per_switch_congestion_ns", "per_switch_bandwidth_ns"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-5, atol=1e-2)
    assert got.migration_moved_bytes == want.migration_moved_bytes
    if "migration" in kw:
        assert got.migration_moved_bytes > 0
    if "cache" in kw:
        assert got.cache_hit_fraction == want.cache_hit_fraction
    assert got.dropped_batches == want.dropped_batches == 0
