"""Port parity for the shared analysis engine: every case of
``tests/test_engine.py`` run against the port (cross-session coalescing,
lifecycle, dropped-batch accounting, the report race, the attach and fabric
rewiring), plus the port held to the reference on the same inputs: the
stacked staging bitwise, ``analyze_batch_multi`` and the asynchronous
attach and fabric reports at the port's bars, and the coalescing key, which
in the port separates sessions that differ only in arbitration."""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import events as r_ev
from repro.core.engine import dispatch_key as r_dispatch_key
from repro_torch import core as T
from repro_torch.core import events as t_ev
from repro_torch.core.engine import dispatch_key, fold_dispatch_stats
from repro_torch.interop import flat_topology_from_arrays, mem_events_from_arrays

torch.set_num_threads(2)


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _port_events(tr):
    return mem_events_from_arrays(_fields(tr))


class _SlowAnalyzer:
    """Non-coalescible stub that parks the dispatcher so later submissions
    from other handles pile up and coalesce (either package)."""

    def __init__(self, pkg, flat, sleep_s=0.25):
        self.pkg, self.flat, self.sleep_s = pkg, flat, sleep_s

    def simulate(self, tr, lat_scale=None):
        time.sleep(self.sleep_s)
        return self.pkg.DelayBreakdown.zero(
            self.flat.n_pools, self.flat.n_switches, self.flat.n_hosts
        )


class _FlakyAnalyzer(T.EpochAnalyzer):
    """Raises on one specific analyze_batch call (per-batch failure stub)."""

    def __init__(self, *args, fail_on=2, **kwargs):
        super().__init__(*args, device="cpu", **kwargs)
        self.calls = 0
        self.fail_on = fail_on

    def analyze_batch(self, traces, lat_scales=None, stager=None):
        self.calls += 1
        if self.calls == self.fail_on:
            raise RuntimeError("injected analyzer failure")
        return super().analyze_batch(traces, lat_scales, stager=stager)


def _toy_attach(pkg=T, engine=None, async_mode=True, **sim_kw):
    regions = pkg.RegionMap()
    regions.alloc("w", 1 << 22, "param")
    regions.alloc("opt", 1 << 23, "opt_state")
    phases = [
        pkg.Phase("fwd", flops=1e8, accesses=(pkg.Access("w", 1 << 22),)),
        pkg.Phase("opt", flops=1e7, accesses=(pkg.Access("opt", 1 << 23, True),)),
    ]
    if pkg is T:
        step, sim_kw = (lambda x: (x * x).sum()), dict(sim_kw, device="cpu")
    else:
        step = jax.jit(lambda x: (x * x).sum())
    sim = pkg.CXLMemSim(
        pkg.two_tier_topology(),
        pkg.ClassMapPolicy({"opt_state": "cxl_pool"}),
        async_analysis=async_mode,
        engine=engine,
        **sim_kw,
    )
    return sim.attach(step, phases, regions)


def _tenants(n=2, mults=None, step=False, pkg=T):
    out = []
    for i in range(n):
        mult = 1 if mults is None else mults[i]
        rm = pkg.RegionMap()
        rm.alloc("w", 1 << 22, "param")
        rm.alloc("kv", 1 << 22, "kvcache")
        phases = [
            pkg.Phase(
                "fwd",
                flops=5e8,
                accesses=(
                    pkg.Access("w", mult * (1 << 22)),
                    pkg.Access("kv", mult * (1 << 22), True),
                ),
            )
        ]
        step_fn = (lambda x: (x @ x.T).sum()) if step else None
        args = (torch.ones((32, 32)),) if step else ()
        out.append(
            pkg.Tenant(
                f"t{i}", phases, rm, pkg.ClassMapPolicy({"kvcache": "shared_pool"}),
                step_fn=step_fn, step_args=args,
            )
        )
    return out


def _session(tenants, **kw):
    return T.FabricSession(T.pooled_topology(n_hosts=len(tenants)), tenants, device="cpu", **kw)


def _close_to(got, want, lat=1e-6, rest=1e-5):
    """``tests/test_engine.py``'s coalescing bars."""
    assert got.latency_ns == pytest.approx(want.latency_ns, rel=lat)
    assert got.congestion_ns == pytest.approx(want.congestion_ns, rel=rest, abs=1e-3)
    assert got.bandwidth_ns == pytest.approx(want.bandwidth_ns, rel=rest, abs=1e-3)


def _bitwise(got, want):
    assert got.latency_ns == want.latency_ns
    assert got.congestion_ns == want.congestion_ns
    assert got.bandwidth_ns == want.bandwidth_ns
    for f in ("per_pool_latency_ns", "per_switch_congestion_ns", "per_switch_bandwidth_ns"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


# --------------------------------------------------------------------------- #
# engine core: futures, coalescing, lifecycle
# --------------------------------------------------------------------------- #


def test_engine_solo_submit_matches_sync_bitwise():
    """A solo submission runs the exact analyze_batch path: identical bits."""
    flat = T.pooled_topology(n_hosts=1).flatten()
    an = T.EpochAnalyzer(flat, device="cpu")
    traces = [T.synthetic_trace(700, flat.n_pools, seed=3, burstiness=0.6)]
    ref = an.analyze_batch(traces)
    with T.AnalysisEngine() as eng:
        h = eng.register(an)
        got = h.submit(traces).result(timeout=60)
        h.flush()
    _bitwise(got, ref)


def test_dispatch_key_groups_equal_topologies_only():
    flat = T.pooled_topology(n_hosts=1).flatten()
    a = T.EpochAnalyzer(flat, device="cpu")
    b = T.EpochAnalyzer(T.pooled_topology(n_hosts=1).flatten(), device="cpu")
    assert dispatch_key(a) == dispatch_key(b)
    c = T.EpochAnalyzer(T.pooled_topology(n_hosts=1, cxl_bandwidth_gbps=1.0).flatten(),
                        device="cpu")
    assert dispatch_key(a) != dispatch_key(c)
    d = T.EpochAnalyzer(flat, n_windows=64, device="cpu")
    assert dispatch_key(a) != dispatch_key(d)
    e = T.EpochAnalyzer(flat, pipeline=True, device="cpu")
    assert dispatch_key(a) != dispatch_key(e)
    # the DES never coalesces (the reference's Pallas impls have no
    # counterpart in the port: its analyzer is the one inline path)
    assert dispatch_key(T.FineGrainedSimulator(flat)) is None
    assert r_dispatch_key(R.FineGrainedSimulator(R.pooled_topology(n_hosts=1).flatten())) is None


def test_engine_coalesces_cross_session_not_same_session():
    """While the dispatcher is parked, submissions from K distinct handles
    coalesce into ONE stacked dispatch; two batches of the same handle never
    share a dispatch."""
    flat = T.pooled_topology(n_hosts=1).flatten()
    analyzers = [T.EpochAnalyzer(flat, device="cpu") for _ in range(4)]
    traces = [
        [T.synthetic_trace(300 + 41 * i, flat.n_pools, seed=i, burstiness=0.5)]
        for i in range(4)
    ]
    solo = [a.analyze_batch(tr) for a, tr in zip(analyzers, traces)]
    with T.AnalysisEngine() as eng:
        park = eng.register(_SlowAnalyzer(T, flat))
        handles = [eng.register(a) for a in analyzers]
        park.submit([T.synthetic_trace(8, flat.n_pools)])
        futs = [h.submit(tr) for h, tr in zip(handles, traces)]
        # a second batch on handle 0 must NOT join the same stacked dispatch
        futs.append(handles[0].submit(traces[0]))
        results = [f.result(timeout=60) for f in futs]
        for h in handles:
            h.flush()
        stats = eng.stats()
        assert [h.last_group_size for h in handles] == [1, 4, 4, 4]
    assert stats["coalesced_dispatches"] >= 1
    assert stats["max_coalesced_sessions"] == 4
    for ref, got in zip(solo + [solo[0]], results):
        _close_to(got, ref)
    _bitwise(results[-1], solo[0])  # the same-handle batch ran solo


class _GatedLaunch(T.EpochAnalyzer):
    """Holds its first ``launch_batch`` until ``gate`` is set, and keeps
    the batches it launched, so a test can queue a coalescible group
    behind its pending solo batch."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, device="cpu", **kwargs)
        self.entered, self.gate, self.launched = threading.Event(), threading.Event(), []

    def launch_batch(self, traces, lat_scales=None, stager=None):
        if not self.launched:
            self.entered.set()
            assert self.gate.wait(60)
        pending = super().launch_batch(traces, lat_scales, stager=stager)
        self.launched.append(pending)
        return pending


def test_coalesced_fold_sees_its_own_dispatch_stats():
    """Session A's solo batch is still pending when A's next batch
    coalesces with B's; finishing the solo batch rewrites A's analyzer's
    ``last_dispatch``.  Each report must fold the split of its own
    dispatches only: A the solo batch's, B none but the stacked one's
    (which carries no timing)."""
    flat = T.pooled_topology(n_hosts=1).flatten()
    # pipeline analyzers: their solo dispatches time the split on the CPU too
    a, b = _GatedLaunch(flat, pipeline=True), T.EpochAnalyzer(flat, pipeline=True, device="cpu")
    assert dispatch_key(a) == dispatch_key(b)
    tr = [T.synthetic_trace(300 + 50 * i, flat.n_pools, seed=i) for i in range(3)]
    reps = {"a": T.SimReport(), "b": T.SimReport()}
    seen = {"a": [], "b": []}
    with T.AnalysisEngine() as eng:
        handles = {"a": eng.register(a), "b": eng.register(b)}

        def fold(name):
            def run(bd, analyzer_s):
                h = handles[name]
                seen[name].append((h.last_dispatch, h.last_group_size))
                fold_dispatch_stats(reps[name], h.last_dispatch, h.last_group_size)
            return run

        fut = handles["a"].submit([tr[0]], fold=fold("a"))
        assert a.entered.wait(60)  # the dispatcher holds A's solo launch
        futs = [handles["a"].submit([tr[1]], fold=fold("a")),
                handles["b"].submit([tr[2]], fold=fold("b"))]
        a.gate.set()
        for f in [fut] + futs:
            f.result(timeout=60)
        assert eng.stats()["max_coalesced_sessions"] == 2
    solo = a.launched[0].stats
    assert solo.rows == 1 and solo.stage_s > 0
    assert [s for s, _ in seen["a"]] == [solo, seen["b"][0][0]]
    stacked, size = seen["b"][0]
    assert size == 2 and stacked is not solo
    assert stacked.rows == 2 and stacked.stage_s == 0.0 and stacked.compute_s == 0.0
    assert reps["a"].stage_s == solo.stage_s and reps["a"].compute_s == solo.compute_s
    assert reps["a"].transfer_s == solo.transfer_s
    assert reps["b"].stage_s == 0.0 and reps["b"].compute_s == 0.0
    assert reps["a"].coalesced_group_size == reps["b"].coalesced_group_size == 2


def _multi_groups(pkg, flat):
    g0 = [
        pkg.synthetic_trace(500, flat.n_pools, seed=0, burstiness=0.7).with_host(0),
        pkg.synthetic_trace(200, flat.n_pools, seed=1).with_host(1),
    ]
    g1 = [pkg.synthetic_trace(333, flat.n_pools, seed=2).with_host(1)]
    scale = np.full((flat.n_hosts * flat.n_pools,), 0.5)
    return [g0, [], g1], [[None, scale], None, [scale]]


def test_analyze_batch_multi_matches_solo():
    """The stacked [K, B, N] entry point returns each session's own totals,
    matching per-session analyze_batch, including host decomposition,
    device-cache scales, ragged batch sizes, and empty groups."""
    flat = T.pooled_topology(n_hosts=2).flatten()
    an = T.EpochAnalyzer(flat, device="cpu")
    groups, scales = _multi_groups(T, flat)
    multi = an.analyze_batch_multi(groups, scales)
    assert an.last_dispatch.rows == 2 and an.last_dispatch.padded_fraction == 0.0
    assert len(multi) == 3
    assert multi[1].total_ns == 0.0
    for got, k in zip((multi[0], multi[2]), (0, 2)):
        ref = an.analyze_batch(groups[k], scales[k])
        _close_to(got, ref)
        np.testing.assert_allclose(got.per_host_latency_ns, ref.per_host_latency_ns, rtol=1e-5)


def test_analyze_batch_multi_edge_cases():
    """No live group: zero breakdowns and no dispatch; one live group: the
    plain batched path, bitwise."""
    flat = T.pooled_topology(n_hosts=1).flatten()
    an = T.EpochAnalyzer(flat, device="cpu")
    assert an.analyze_batch_multi([]) == []
    zeros = an.analyze_batch_multi([[], [T.MemEvents.empty()]])
    assert [z.total_ns for z in zeros] == [0.0, 0.0]
    tr = [T.synthetic_trace(300, flat.n_pools, seed=5, burstiness=0.5)]
    one = an.analyze_batch_multi([[], tr])
    _bitwise(one[1], an.analyze_batch(tr))
    with pytest.raises(ValueError, match="lat_scale_groups"):
        an.analyze_batch_multi([tr, tr], [None])


def test_analyze_batch_multi_rejects_mesh():
    """The counterpart of the reference's refusal of Pallas impls: the
    port's one unsupported option here is ``mesh=`` (slice 6)."""
    flat = T.pooled_topology(n_hosts=1).flatten()
    an = T.EpochAnalyzer(flat, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 6"):
        an.analyze_batch_multi([[T.synthetic_trace(16, flat.n_pools)]], mesh=object())
    with pytest.raises(NotImplementedError, match="slice 6"):
        T.AnalysisEngine(mesh=object())


def test_invalid_batch_does_not_poison_coalesced_peers():
    """A session submitting an unreachable-route trace into a coalesced
    group drops ONLY its own batch; peers' results and error state are
    untouched."""
    flat = T.pooled_topology(n_hosts=1).flatten()
    good_an, bad_an = T.EpochAnalyzer(flat, device="cpu"), T.EpochAnalyzer(flat, device="cpu")
    good_tr = [T.synthetic_trace(200, flat.n_pools, seed=0)]
    bad_tr = [T.synthetic_trace(200, flat.n_pools, seed=1).with_host(3)]  # no such host
    ref = good_an.analyze_batch(good_tr)
    with T.AnalysisEngine() as eng:
        park = eng.register(_SlowAnalyzer(T, flat))
        good, bad = eng.register(good_an), eng.register(bad_an)
        park.submit([T.synthetic_trace(8, flat.n_pools)])
        fut_bad = bad.submit(bad_tr)
        fut_good = good.submit(good_tr)
        got = fut_good.result(timeout=60)
        with pytest.raises(ValueError, match="host id 3"):
            fut_bad.result(timeout=60)
        good.flush()  # innocent peer: no error, nothing dropped
        assert good.dropped_batches == 0
        with pytest.raises(ValueError, match="host id 3"):
            bad.flush()
        assert bad.dropped_batches == 1 and bad.dropped_epochs == 1
    assert got.latency_ns == pytest.approx(ref.latency_ns, rel=1e-6)


def test_cancelled_future_does_not_kill_dispatcher():
    """A caller cancelling a pending submission future must not crash the
    dispatcher or corrupt drop accounting."""
    flat = T.pooled_topology(n_hosts=1).flatten()
    with T.AnalysisEngine() as eng:
        park = eng.register(_SlowAnalyzer(T, flat, sleep_s=0.2))
        h = eng.register(T.EpochAnalyzer(flat, device="cpu"))
        park.submit([T.synthetic_trace(8, flat.n_pools)])
        fut = h.submit([T.synthetic_trace(64, flat.n_pools)])
        assert fut.cancel()  # still queued behind the parked batch
        h.flush()  # batch was analyzed + folded regardless; no error
        assert h.dropped_batches == 0
        bd = h.submit([T.synthetic_trace(64, flat.n_pools)]).result(timeout=60)
        assert bd.total_ns >= 0
        assert not eng._broken


def test_default_engine_replaced_after_break():
    eng = T.AnalysisEngine.default()
    assert T.AnalysisEngine.default() is eng  # stable while healthy
    try:
        eng._broken = True
        fresh = T.AnalysisEngine.default()
        assert fresh is not eng
        assert T.AnalysisEngine.default() is fresh
    finally:
        eng._broken = False  # other tests' handles may still point here


def test_engine_lifecycle_and_backpressure():
    flat = T.pooled_topology(n_hosts=1).flatten()
    eng = T.AnalysisEngine()
    h = eng.register(T.EpochAnalyzer(flat, device="cpu"), max_inflight=2)
    for _ in range(5):  # more batches than inflight: submit must backpressure
        h.submit([T.synthetic_trace(64, flat.n_pools)])
    h.flush()
    h.close()
    with pytest.raises(RuntimeError, match="closed"):
        h.submit([T.synthetic_trace(8, flat.n_pools)])
    with pytest.raises(ValueError, match="max_inflight"):
        eng.register(T.EpochAnalyzer(flat, device="cpu"), max_inflight=0)
    eng.close()
    eng.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        eng.register(T.EpochAnalyzer(flat, device="cpu"))
    assert eng.stats()["dispatches"] == 5


def test_engine_stages_through_its_own_ring_and_stays_off_the_card_on_cpu():
    """The engine's stager is one slots=2 ring, unpinned for CPU analyzers,
    and it makes no CUDA stream for them."""
    flat = T.pooled_topology(n_hosts=1).flatten()
    with T.AnalysisEngine() as eng:
        h = eng.register(T.EpochAnalyzer(flat, device="cpu"))
        for seed in range(3):
            h.submit([T.synthetic_trace(64, flat.n_pools, seed=seed)])
        h.flush()
        (key, st), = eng._stagers.items()
        assert st.slots == 2 and not st.pin and key[1] is False
        assert eng.stream("cuda") is None


# --------------------------------------------------------------------------- #
# the report race (attach): writes under the report lock
# --------------------------------------------------------------------------- #


def test_report_race_step_vs_report_two_threads():
    """Hammer step() and report reads concurrently with migration + cache
    active: every running-statistic write happens under the report lock,
    so totals stay consistent and nothing raises."""
    regions = T.RegionMap()
    regions.alloc("w", 1 << 22, "param")
    regions.alloc("kv", 1 << 22, "kvcache")
    phases = [
        T.Phase(
            "fwd",
            flops=1e8,
            accesses=(T.Access("w", 1 << 22), T.Access("kv", 1 << 22, True)),
        )
    ]
    topo = T.two_tier_topology()
    mig = T.MigrationSimulator(
        T.MigrationConfig(mode="software", promote_threshold=1, local_budget_bytes=1 << 30),
        regions,
        topo.flatten(),
    )
    sim = T.CXLMemSim(
        topo,
        T.ClassMapPolicy({"kvcache": "cxl_pool"}),
        migration=mig,
        cache=T.DeviceCacheConfig(capacity_bytes=1 << 26),
        check_capacity=False,
        async_analysis=True,
        device="cpu",
    )
    x = torch.ones((64, 64))
    errors = []
    with sim.attach(lambda a: (a * a).sum(), phases, regions) as prog:

        def reader():
            try:
                for _ in range(40):
                    _ = prog.report.migration_moved_bytes
                    _ = prog._report.cache_hit_fraction
            except BaseException as e:  # pragma: no cover - failure path
                errors.append(e)

        t = threading.Thread(target=reader)
        t.start()
        for _ in range(25):
            prog.step(x)
        t.join()
        rep = prog.report
        assert not errors
        assert rep.steps == 25 and rep.epochs == 25
        assert rep.migration_moved_bytes > 0
        assert np.isfinite(rep.cache_hit_fraction)


# --------------------------------------------------------------------------- #
# lifecycle: no thread growth across attach/close cycles
# --------------------------------------------------------------------------- #


def test_no_thread_growth_across_attach_close_cycles():
    x = torch.ones((8, 8))
    # warm-up creates the process-default engine's single dispatcher thread
    with _toy_attach() as prog:
        prog.run(1, x)
    base = threading.active_count()
    for _ in range(50):
        with _toy_attach() as prog:
            prog.run(1, x)
    assert threading.active_count() <= base


def test_no_thread_growth_across_fabric_sessions():
    with _session(_tenants(2), async_analysis=True) as sess:
        sess.run(1)
    base = threading.active_count()
    for _ in range(10):
        with _session(_tenants(2), async_analysis=True) as sess:
            sess.run(1)
    assert threading.active_count() <= base


def test_private_engine_thread_joined_on_close():
    base = threading.active_count()
    with T.AnalysisEngine() as eng:
        prog = _toy_attach(engine=eng)
        prog.run(2, torch.ones((8, 8)))
        prog.close()
    assert threading.active_count() <= base


# --------------------------------------------------------------------------- #
# dropped-batch accounting
# --------------------------------------------------------------------------- #


def test_dropped_batches_recorded_and_error_raised_once():
    """Batch 2 of 5 fails: flush raises once, the report records exactly
    the failed batch's epochs as dropped, and the other 4 batches' totals
    are present."""
    prog = _toy_attach()
    flaky = _FlakyAnalyzer(prog.sim.flat, fail_on=2)
    prog._analyzer = prog._handle.analyzer = flaky
    x = torch.ones((8, 8))
    for _ in range(5):
        prog.step(x)
    with pytest.raises(RuntimeError, match="injected analyzer failure"):
        prog.flush()
    rep = prog.report  # second flush: error already surfaced, no re-raise
    assert rep.steps == 5
    assert rep.dropped_batches == 1
    assert rep.epochs + rep.dropped_epochs == 5  # one epoch per step here
    assert rep.dropped_epochs == 1
    assert rep.latency_s > 0  # surviving batches were folded
    prog.close()


def test_dropped_batches_sync_path():
    prog = _toy_attach(async_mode=False)
    prog._analyzer = _FlakyAnalyzer(prog.sim.flat, fail_on=1)
    with pytest.raises(RuntimeError, match="injected analyzer failure"):
        prog.step(torch.ones((8, 8)))
    assert prog._report.dropped_batches == 1
    assert prog._report.dropped_epochs == 1


def test_fabric_dropped_round_recorded():
    sess = _session(_tenants(2), async_analysis=True)
    flaky = _FlakyAnalyzer(sess.flat, fail_on=2)
    sess._analyzer = sess._handle.analyzer = flaky
    for _ in range(4):
        sess.round()
    with pytest.raises(RuntimeError, match="injected analyzer failure"):
        sess.flush()
    rep = sess.report
    assert rep.rounds == 3 and rep.dropped_batches == 1
    assert rep.dropped_epochs == 1
    sess.close()


# --------------------------------------------------------------------------- #
# summary key sets locked
# --------------------------------------------------------------------------- #


def test_sim_report_summary_keys_locked():
    assert set(T.SimReport().summary()) == {
        "steps", "epochs", "native_s", "simulated_s", "slowdown",
        "latency_s", "congestion_s", "bandwidth_s", "coherency_s",
        "injected_sleep_s", "analyzer_s", "overhead",
        "migration_moved_bytes", "cache_hit_fraction",
        "dropped_batches", "dropped_epochs",
        "devices_used", "shard_rows", "padded_waste", "coalesced_group_size",
        "stage_s", "transfer_s", "compile_s", "compute_s",
        "donated_dispatches", "aot_cache_hits",
        "qos_classes", "qos_delay_shares",
    } == set(R.SimReport().summary())


def test_fabric_report_summary_keys_locked():
    rep = T.FabricReport(hosts=[T.HostClock(0, "a"), T.HostClock(1, "b")])
    base = {
        "rounds", "epochs", "latency_s", "congestion_s", "bandwidth_s",
        "coherency_s", "bi_messages", "analyzer_s",
        "migration_moved_bytes", "cache_hit_fraction",
        "dropped_batches", "dropped_epochs",
        "devices_used", "shard_rows", "padded_waste", "coalesced_group_size",
        "stage_s", "transfer_s", "compile_s", "compute_s",
        "donated_dispatches", "aot_cache_hits",
        "qos_classes", "qos_delay_shares",
    }
    per_host = {
        f"host{h}_{k}" for h in (0, 1)
        for k in ("native_s", "simulated_s", "slowdown")
    }
    assert set(rep.summary()) == base | per_host


# --------------------------------------------------------------------------- #
# async-vs-sync FabricSession equivalence (bit-equal)
# --------------------------------------------------------------------------- #


def _fabric_variants(pkg):
    mig = dict(mode="software", promote_threshold=1, local_budget_bytes=1 << 30)
    return {
        "replay": {},  # stateless: round replay cache active
        "migration": dict(migration=pkg.MigrationConfig(**mig)),
        "cache": dict(cache=pkg.DeviceCacheConfig(capacity_bytes=1 << 26)),
        "migration+cache": dict(
            migration=pkg.MigrationConfig(**mig),
            cache=pkg.DeviceCacheConfig(capacity_bytes=1 << 26),
        ),
    }


@pytest.mark.parametrize("variant", sorted(_fabric_variants(T)))
def test_fabric_async_matches_sync_bit_equal(variant):
    """Overlapped rounds fold the SAME analyses in the SAME order as
    synchronous rounds — per-host clocks and fabric totals are bit-equal
    (trace-only tenants: native clocks are roofline-paced).  Stateful
    transforms run on the submitting thread in both modes."""
    kw = _fabric_variants(T)[variant]
    topo = lambda: T.pooled_topology(n_hosts=2, cxl_bandwidth_gbps=8.0)
    sync = T.FabricSession(topo(), _tenants(2, mults=(1, 4)), device="cpu", **kw)
    sync.run(3)
    with T.AnalysisEngine() as eng:  # private engine: no cross-test coalescing
        with T.FabricSession(topo(), _tenants(2, mults=(1, 4)), engine=eng, device="cpu",
                             **kw) as asy:
            asy.run(3)
    a, b = sync.report, asy.report
    for f in (
        "rounds", "epochs", "latency_s", "congestion_s", "bandwidth_s",
        "coherency_s", "bi_messages", "migration_moved_bytes",
    ):
        assert getattr(a, f) == getattr(b, f), f
    if variant in ("cache", "migration+cache"):
        assert a.cache_hit_fraction == b.cache_hit_fraction
    np.testing.assert_array_equal(a.per_pool_latency_ns, b.per_pool_latency_ns)
    np.testing.assert_array_equal(a.per_switch_congestion_ns, b.per_switch_congestion_ns)
    np.testing.assert_array_equal(a.per_switch_bandwidth_ns, b.per_switch_bandwidth_ns)
    for ha, hb in zip(a.hosts, b.hosts):
        for f in (
            "steps", "native_s", "simulated_s", "latency_s", "congestion_s",
            "bandwidth_s", "coherency_s", "slowdown",
        ):
            assert getattr(ha, f) == getattr(hb, f), f


# --------------------------------------------------------------------------- #
# submission precedes native dispatch (the overlap contract)
# --------------------------------------------------------------------------- #


def test_fabric_round_submits_before_native_steps():
    order = []
    with T.AnalysisEngine() as eng:
        tenants = _tenants(2, step=True)
        for t in tenants:
            inner = t.step_fn

            def stepper(x, _inner=inner, _name=t.name):
                order.append(f"native:{_name}")
                return _inner(x)

            t.step_fn = stepper
        sess = _session(tenants, engine=eng)
        orig_submit = sess._handle.submit

        def recording_submit(*args, **kwargs):
            order.append("submit")
            return orig_submit(*args, **kwargs)

        sess._handle.submit = recording_submit
        sess.round()
        sess.close()
    assert order == ["submit", "native:t0", "native:t1"]


def test_attach_step_submits_before_native_step():
    order = []
    with T.AnalysisEngine() as eng:
        prog = _toy_attach(engine=eng)
        inner = prog.step_fn
        prog.step_fn = lambda x: (order.append("native"), inner(x))[1]
        orig_submit = prog._handle.submit
        prog._handle.submit = lambda *a, **k: (order.append("submit"), orig_submit(*a, **k))[1]
        prog.step(torch.ones((4, 4)))
        prog.close()
    assert order == ["submit", "native"]


def test_fabric_round_returns_breakdown_only_in_sync_mode():
    sync = _session(_tenants(2), async_analysis=False)
    assert sync.round() is not None
    with _session(_tenants(2), async_analysis=True) as asy:
        assert asy.round() is None
        # the report property flushes pending folds: never a partial read
        assert asy.report.rounds == 1


def test_attach_async_still_matches_sync():
    """The engine-backed attach path keeps the synchronous totals."""
    x = torch.ones((32, 32))
    reports = {}
    for mode in (False, True):
        with _toy_attach(async_mode=mode) as prog:
            prog.run(3, x)
            reports[mode] = prog.report
    a, b = reports[False], reports[True]
    assert a.epochs == b.epochs == 3
    assert b.latency_s == pytest.approx(a.latency_s, rel=1e-6)
    assert b.congestion_s == pytest.approx(a.congestion_s, rel=1e-6, abs=1e-12)
    assert b.analyzer_s > 0


def test_defaults_stay_synchronous():
    """The port's defaults are the reference's: attach is asynchronous for
    the epoch analyzer without delay injection and a fabric overlaps its
    rounds, both on the shared default engine; ``async_analysis=False``
    asks for the synchronous path, ``engine=`` for that engine, and delay
    injection and the fine-grained analyzer always run synchronously."""
    for pkg in (R, T):
        prog = _toy_attach(pkg=pkg, async_mode=None)
        assert prog.sim.async_analysis and prog._handle is not None
        assert prog._handle.engine is pkg.AnalysisEngine.default()
        prog.close()
        dev = dict(device="cpu") if pkg is T else {}
        topo = pkg.pooled_topology(n_hosts=2)
        with pkg.FabricSession(topo, _tenants(2, pkg=pkg), **dev) as sess:
            assert sess._handle is not None
        sync = pkg.FabricSession(topo, _tenants(2, pkg=pkg), async_analysis=False, **dev)
        assert sync._handle is None
        assert _toy_attach(pkg=pkg, async_mode=False)._handle is None
        assert not _toy_attach(pkg=pkg, async_mode=None, inject_delays=True).sim.async_analysis
        assert not _toy_attach(pkg=pkg, async_mode=None, analyzer="fine").sim.async_analysis
    with T.AnalysisEngine() as eng:
        prog = _toy_attach(engine=eng, async_mode=None)
        assert prog._handle is not None and prog._handle.engine is eng
        prog.close()
        forced = _toy_attach(engine=eng, inject_delays=True)
        assert not forced.sim.async_analysis and forced._handle is None


# --------------------------------------------------------------------------- #
# the port against the reference
# --------------------------------------------------------------------------- #


def test_stage_stack_bitwise_reference():
    """Stacked planes, valid and span are the reference's bit for bit, call
    for call, including the re-clearing of planes a larger fill dirtied."""
    flat = R.pooled_topology(n_hosts=2).flatten()
    trs = [
        R.synthetic_trace(n, flat.n_pools, seed=s, burstiness=0.5).with_host(s % 2)
        for s, n in enumerate((90, 40, 128, 7, 64, 100))
    ]
    shuffled = trs[2]
    order = np.random.default_rng(0).permutation(shuffled.n)  # an unsorted epoch
    trs[2] = dataclasses.replace(shuffled, **{
        f: getattr(shuffled, f)[order] for f in (
            "t_ns", "pool", "bytes_", "is_write", "region", "weight", "host", "qos")})
    calls = [
        ([trs[:2], [trs[2]], trs[3:5], [trs[5]]], 4),
        ([[trs[5]], trs[:2]], 4),  # planes 2-3 were dirtied by the larger fill
        ([trs[3:6]], 1),
        ([[], [trs[0]], []], 4),
    ]
    r_st, t_st = r_ev.EventStager(np.float32), t_ev.EventStager(np.float32)
    for groups, k_bucket in calls:
        want = r_st.stage_stack(groups, k_bucket, 4, 128)
        got = t_st.stage_stack([[_port_events(tr) for tr in g] for g in groups], k_bucket, 4, 128)
        assert set(got) == set(want)
        for f in want:
            assert got[f].dtype == want[f].dtype and got[f].shape == want[f].shape, f
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    with pytest.raises(ValueError, match="exceed stack bucket"):
        t_st.stage_stack([[], [], []], 2, 4, 128)
    with pytest.raises(ValueError, match="exceed batch bucket"):
        t_st.stage_stack([[_port_events(trs[0])] * 5], 1, 4, 128)


def test_analyze_batch_multi_matches_reference():
    """The port's coalesced dispatch against the reference's on the same
    groups, at ``tests/test_engine.py``'s coalescing bars."""
    r_flat = R.pooled_topology(n_hosts=2).flatten()
    groups, scales = _multi_groups(R, r_flat)
    want = R.EpochAnalyzer(r_flat).analyze_batch_multi(groups, scales)
    t_flat = flat_topology_from_arrays(_fields(r_flat))
    got = T.EpochAnalyzer(t_flat, device="cpu").analyze_batch_multi(
        [[_port_events(tr) for tr in g] for g in groups], scales
    )
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close_to(g, w)
        for f in ("per_host_latency_ns", "per_host_congestion_ns", "per_pool_latency_ns"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=1e-5, atol=1e-3)


def test_async_attach_matches_reference_async():
    """The port's asynchronous attach against the reference's (its default
    mode), at the port's attach bars, on the reference's hardware model."""
    x_r, x_t = jnp.ones((32, 32)), torch.ones((32, 32))
    with R.AnalysisEngine() as r_eng, _toy_attach(R, engine=r_eng) as r_prog:
        want = r_prog.run(3, x_r)
    with T.AnalysisEngine() as t_eng, _toy_attach(T, engine=t_eng, hw=T.TPU_V5E) as t_prog:
        got = t_prog.run(3, x_t)
    assert got.steps == want.steps == 3 and got.epochs == want.epochs
    for f in ("latency_s", "congestion_s", "bandwidth_s"):  # native clocks differ by design
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-5, abs=1e-12), f
    for f in ("per_pool_latency_ns", "per_switch_congestion_ns", "per_switch_bandwidth_ns"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-5, atol=1e-2)
    assert got.coalesced_group_size == want.coalesced_group_size == 1


def test_async_fabric_matches_reference_async():
    """Overlapped rounds in both packages (the reference's default), at the
    port's fabric bars."""
    kw = dict(cxl_bandwidth_gbps=8.0)
    with R.AnalysisEngine() as r_eng:
        with R.FabricSession(R.pooled_topology(n_hosts=2, **kw), _tenants(2, (1, 4), pkg=R),
                             engine=r_eng) as r_sess:
            want = r_sess.run(3)
    with T.AnalysisEngine() as t_eng:
        with T.FabricSession(T.pooled_topology(n_hosts=2, **kw), _tenants(2, (1, 4)),
                             engine=t_eng, hw=T.TPU_V5E, device="cpu") as t_sess:
            got = t_sess.run(3)
    assert (got.rounds, got.epochs) == (want.rounds, want.epochs) == (3, got.epochs)
    assert got.latency_s == pytest.approx(want.latency_s, rel=1e-5)
    assert got.congestion_s == pytest.approx(want.congestion_s, rel=1e-4, abs=1e-12)
    assert got.bandwidth_s == pytest.approx(want.bandwidth_s, rel=1e-5, abs=1e-12)
    for g, w in zip(got.hosts, want.hosts):
        assert g.native_s == w.native_s and g.steps == w.steps == 3
        assert g.latency_s == pytest.approx(w.latency_s, rel=1e-5)
        assert g.congestion_s == pytest.approx(w.congestion_s, rel=1e-4, abs=1e-12)


def _fig1_qos(pkg, discipline, weights=None, n_classes=2):
    """The paper's Figure 1 with every switch under one discipline."""
    fig = pkg.figure1_topology()
    switches = [
        dataclasses.replace(s, discipline=discipline,
                            class_weights=weights if discipline == "wfq" else None)
        for s in fig.switches
    ]
    return pkg.Topology(fig.pools, switches, fig.rc_latency_ns, fig.rc_bandwidth_gbps,
                        fig.rc_stt_ns, fig.local_dram_latency_ns, n_qos_classes=n_classes)


ARBITRATIONS = {
    "priority-vs-wfq": (("priority", None), ("wfq", (4.0, 1.0))),
    "wfq-weights": (("wfq", (4.0, 1.0)), ("wfq", (1.0, 4.0))),
}


def _coalesced_pair(pkg, analyzers, traces, **an_kw):
    """Park the dispatcher, submit session A's then session B's batch, and
    return both results and the engine's stats."""
    with pkg.AnalysisEngine() as eng:
        park = eng.register(_SlowAnalyzer(pkg, analyzers[0].flat))
        handles = [eng.register(a) for a in analyzers]
        park.submit([pkg.MemEvents.empty()])
        futs = [h.submit(tr) for h, tr in zip(handles, traces)]
        got = [f.result(timeout=120) for f in futs]
        return got, eng.stats()


@pytest.mark.parametrize("case", sorted(ARBITRATIONS))
def test_dispatch_key_separates_arbitration_where_the_reference_coalesces(case):
    """The key witness.  Two sessions on Figure 1 whose switches differ only
    in arbitration: the reference's key leaves the disciplines and weights
    out, coalesces them and analyzes session B under A's arbitration, so
    B's coalesced result differs from its solo one; the port's key keeps
    them apart, and each result is its solo one, bitwise."""
    (da, wa), (db, wb) = ARBITRATIONS[case]
    r_flats = [_fig1_qos(R, da, wa).flatten(), _fig1_qos(R, db, wb).flatten()]
    traces = [
        [R.synthetic_trace(3000, r_flats[0].n_pools, seed=10 + i, burstiness=0.9,
                           n_qos_classes=2)]
        for i in range(2)
    ]
    r_an = [R.EpochAnalyzer(f) for f in r_flats]
    assert r_dispatch_key(r_an[0]) == r_dispatch_key(r_an[1])
    r_solo = [a.analyze_batch(tr) for a, tr in zip(r_an, traces)]
    r_got, r_stats = _coalesced_pair(R, r_an, traces)
    assert r_stats["max_coalesced_sessions"] == 2
    _close_to(r_got[0], r_solo[0])  # A ran under its own arbitration
    gap = abs(r_got[1].congestion_ns - r_solo[1].congestion_ns) / r_solo[1].congestion_ns
    assert gap > 1e-3, f"the reference's coalesced B moved only {gap:.3e}"
    assert not np.allclose(r_got[1].per_class_congestion_ns, r_solo[1].per_class_congestion_ns,
                           rtol=1e-3)

    t_an = [T.EpochAnalyzer(flat_topology_from_arrays(_fields(f)), device="cpu")
            for f in r_flats]
    assert dispatch_key(t_an[0]) != dispatch_key(t_an[1])
    t_traces = [[_port_events(tr) for tr in g] for g in traces]
    t_solo = [a.analyze_batch(tr) for a, tr in zip(t_an, t_traces)]
    t_got, t_stats = _coalesced_pair(T, t_an, t_traces)
    assert t_stats["coalesced_dispatches"] == 0
    for g, s, w in zip(t_got, t_solo, r_solo):
        _bitwise(g, s)
        np.testing.assert_array_equal(g.per_class_congestion_ns, s.per_class_congestion_ns)
        _close_to(g, w, lat=1e-5, rest=1e-4)  # the reference's own solo result


def test_dispatch_key_separates_class_counts():
    fifo2, fifo3 = (T.EpochAnalyzer(_fig1_qos(T, "fifo", n_classes=c).flatten(), device="cpu")
                    for c in (2, 3))
    assert dispatch_key(fifo2) != dispatch_key(fifo3)
    plain = T.EpochAnalyzer(T.figure1_topology().flatten(), device="cpu")
    assert dispatch_key(plain) != dispatch_key(fifo2)
