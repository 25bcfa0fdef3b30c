"""Port parity for the shared multi-host fabric: host tagging and merging,
the host-segmented analyzer (fused, and the unfused per-stage loop that
wide fabrics take), synchronous ``FabricSession`` rounds and single-attach
coherency, each against the reference on the same inputs.

Against the reference analyzer (``impl='inline'``) totals and per-host
arrays agree to rel 1e-5 (both sum f32 per-event delays, in different
orders).  Against the f64 oracle ``analyze_ref`` the bars are those of
``tests/test_fabric.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import analyzer as r_an
from repro.core import events as r_ev
from repro.core import topology as r_topo
from repro_torch import core as T
from repro_torch.core import analyzer as t_an
from repro_torch.core import events as t_ev
from repro_torch.interop import flat_topology_from_arrays, mem_events_from_arrays
from repro_torch.kernels import congestion as t_kernel
from repro_torch.kernels import ops as t_ops

torch.set_num_threads(2)

COLUMNS = ("t_ns", "pool", "bytes_", "is_write", "region", "weight", "host", "qos")
PER_HOST = ("per_host_latency_ns", "per_host_congestion_ns", "per_host_bandwidth_ns")


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _port_flat(flat):
    return flat_topology_from_arrays(_fields(flat))


def _port_events(tr):
    return mem_events_from_arrays(_fields(tr))


def _figure1_hosts(n_hosts):
    """The paper's Figure 1 re-declared for several hosts: two shared
    switches, one private RC per host."""
    topo = r_topo.figure1_topology()
    return r_topo.Topology(
        topo.pools, topo.switches, topo.rc_latency_ns, topo.rc_bandwidth_gbps,
        topo.rc_stt_ns, topo.local_dram_latency_ns, n_hosts=n_hosts,
    )


FABRICS = {
    "figure1x3": lambda: _figure1_hosts(3),
    "pooled2": lambda: r_topo.pooled_topology(n_hosts=2, cxl_bandwidth_gbps=4.0),
    "pooled4": lambda: r_topo.pooled_topology(n_hosts=4, cxl_bandwidth_gbps=4.0),
}


def _merged(flat, n=500, seed=0, burst=0.8):
    """Two co-scheduled epochs of every host's bursty trace, merged."""
    return [
        r_ev.merge_host_traces([
            r_ev.synthetic_trace(
                n, flat.n_pools, epoch_ns=2e5, seed=seed + 10 * k + h,
                burstiness=burst, granule_bytes=4096,
            )
            for h in range(flat.n_hosts)
        ])
        for k in range(2)
    ]


def _assert_matches_reference(got, want, rel=1e-5, atol=1e-2):
    assert got.latency_ns == pytest.approx(want.latency_ns, rel=rel)
    assert got.congestion_ns == pytest.approx(want.congestion_ns, rel=rel)
    assert got.bandwidth_ns == pytest.approx(want.bandwidth_ns, rel=rel, abs=atol)
    for f in ("per_pool_latency_ns", "per_switch_congestion_ns",
              "per_switch_bandwidth_ns") + PER_HOST:
        g, w = getattr(got, f), getattr(want, f)
        assert g.shape == w.shape, f
        np.testing.assert_allclose(g, w, rtol=rel, atol=atol, err_msg=f)


def _assert_matches_oracle(got, ref):
    """The bars of tests/test_fabric.py (fused fabric vs analyze_ref)."""
    assert got.latency_ns == pytest.approx(ref.latency_ns, rel=1e-4)
    assert got.congestion_ns == pytest.approx(ref.congestion_ns, rel=1e-3, abs=1e-3)
    np.testing.assert_allclose(got.per_host_congestion_ns, ref.per_host_congestion_ns, rtol=5e-3)
    np.testing.assert_allclose(got.per_host_latency_ns, ref.per_host_latency_ns, rtol=1e-4)


def _oracle(an, flat, tr):
    """analyze_ref with the analyzer's effective (span-scaled) window."""
    span = max(float(tr.t_ns.max()) + 1.0, an.bw_window_ns)
    return t_an.analyze_ref(
        flat, tr, bw_window_ns=max(span / an.n_windows, 1.0), n_windows=an.n_windows
    )


def _assert_decomposition_closes(bd, rel=1e-5):
    assert bd.per_host_latency_ns.sum() == pytest.approx(bd.latency_ns, rel=rel)
    assert bd.per_host_congestion_ns.sum() == pytest.approx(bd.congestion_ns, rel=rel)
    assert bd.per_host_bandwidth_ns.sum() == pytest.approx(bd.bandwidth_ns, rel=rel, abs=1e-2)


# --------------------------------------------------------------------------- #
# events: host tagging, merge/split
# --------------------------------------------------------------------------- #


def test_merge_split_match_reference():
    traces = [r_ev.synthetic_trace(200 + 50 * h, 2, epoch_ns=1e5, seed=h) for h in range(3)]
    want = r_ev.merge_host_traces(traces, hosts=[2, 0, 1])
    got = t_ev.merge_host_traces([_port_events(t) for t in traces], hosts=[2, 0, 1])
    for c in COLUMNS:
        np.testing.assert_array_equal(getattr(got, c), getattr(want, c), err_msg=c)
    assert (np.diff(got.t_ns) >= 0).all()
    for g, w in zip(t_ev.split_by_host(got, 3), r_ev.split_by_host(want, 3)):
        for c in COLUMNS:
            np.testing.assert_array_equal(getattr(g, c), getattr(w, c), err_msg=c)
    tagged = got.with_qos(1)
    assert (tagged.qos == 1).all() and (got.with_host(5).host == 5).all()
    with pytest.raises(ValueError, match="qos shape"):
        got.with_qos(np.zeros(3, np.int32))


def test_stager_stages_host_column():
    a = t_ev.synthetic_trace(20, 2, seed=0).with_host(1)
    buf = t_ev.EventStager().stage([a], 1, 32)
    assert (buf["host"][0, :20] == 1).all() and (buf["host"][0, 20:] == 0).all()


# --------------------------------------------------------------------------- #
# analyzer: the host-segmented fused path
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_fabric_analyzer_matches_reference_analyzer(fabric):
    flat = FABRICS[fabric]().flatten()
    merged = _merged(flat)
    want = r_an.EpochAnalyzer(flat, impl="inline").analyze_batch(merged)
    an = t_an.EpochAnalyzer(_port_flat(flat), device="cpu")
    got = an.analyze_batch([_port_events(m) for m in merged])
    assert an.fused
    _assert_matches_reference(got, want)
    assert got.per_pool_latency_ns.shape == (flat.n_pools,)  # physical, not [H*P]
    assert got.per_host_congestion_ns.shape == (flat.n_hosts,)
    assert (got.per_host_congestion_ns > 0).all() and got.bandwidth_ns > 0
    _assert_decomposition_closes(got)


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_fabric_analyzer_matches_f64_oracle(fabric):
    flat = FABRICS[fabric]().flatten()
    t_flat = _port_flat(flat)
    an = t_an.EpochAnalyzer(t_flat, device="cpu")
    for tr in _merged(flat, seed=5):
        tr = _port_events(tr)
        _assert_matches_oracle(an.analyze(tr), _oracle(an, t_flat, tr))


def test_fabric_analyzer_runs_the_plain_hosts_cascade_on_cpu():
    flat = T.pooled_topology(n_hosts=2).flatten()
    tr = t_ev.merge_host_traces([t_ev.synthetic_trace(300, 2, seed=h) for h in range(2)])
    counts0 = (t_ops.plain_launches, t_kernel.launches, t_kernel.hosts_launches)
    t_an.EpochAnalyzer(flat, device="cpu").analyze_batch([tr, tr])
    assert t_ops.plain_launches == counts0[0] + 1  # one batched call per batch
    assert (t_kernel.launches, t_kernel.hosts_launches) == counts0[1:]


def test_analyzer_rejects_unreachable_and_out_of_range_hosts():
    flat = T.pooled_topology(n_hosts=2, host_ports={1: ()}).flatten()
    traces = [t_ev.synthetic_trace(50, 2, seed=h) for h in range(3)]
    an = t_an.EpochAnalyzer(flat, device="cpu")
    with pytest.raises(ValueError, match="cannot reach"):
        an.analyze(t_ev.merge_host_traces(traces[:2]))
    with pytest.raises(ValueError, match="host id 2"):
        an.analyze(t_ev.merge_host_traces(traces))


# --------------------------------------------------------------------------- #
# analyzer: the unfused per-stage loop
# --------------------------------------------------------------------------- #


def test_wide_fabric_falls_back_to_unfused():
    """31 hosts: one shared switch plus 31 RCs = 32 stages, over the 31-bit
    route word.  The port degrades to the unfused loop, as the reference
    does, and meets the reference and the oracle (tests/test_fabric.py's
    rack-scale bar)."""
    H = 31
    flat = r_topo.pooled_topology(n_hosts=H, cxl_bandwidth_gbps=4.0).flatten()
    merged = r_ev.merge_host_traces([
        r_ev.synthetic_trace(40, flat.n_pools, epoch_ns=1e5, seed=i, granule_bytes=4096)
        for i in range(H)
    ])
    ref_an = r_an.EpochAnalyzer(flat, impl="inline")
    assert not ref_an.fused
    want = ref_an.analyze(merged)
    t_flat = _port_flat(flat)
    an = t_an.EpochAnalyzer(t_flat, device="cpu")
    assert not an.fused
    tr = _port_events(merged)
    plain0 = t_ops.plain_launches
    got = an.analyze(tr)
    assert t_ops.plain_launches == plain0 + flat.n_switches  # one scan per stage
    _assert_matches_reference(got, want)
    ref = t_an.analyze_ref(t_flat, tr)
    assert got.latency_ns == pytest.approx(ref.latency_ns, rel=1e-4)
    assert got.congestion_ns == pytest.approx(ref.congestion_ns, rel=1e-3, abs=1e-3)
    assert got.per_host_latency_ns.shape == (H,)
    _assert_decomposition_closes(got)


@pytest.mark.parametrize("fabric", ["figure1x3", "pooled2"])
def test_unfused_loop_matches_reference_and_fused(fabric):
    """fused=False on a narrow fabric: the same loop, held against the
    reference's unfused inline path and against the port's fused path."""
    flat = FABRICS[fabric]().flatten()
    merged = _merged(flat, seed=3)
    want = r_an.EpochAnalyzer(flat, impl="inline", fused=False).analyze_batch(merged)
    t_flat = _port_flat(flat)
    t_merged = [_port_events(m) for m in merged]
    got = t_an.EpochAnalyzer(t_flat, device="cpu", fused=False).analyze_batch(t_merged)
    _assert_matches_reference(got, want)
    fused = t_an.EpochAnalyzer(t_flat, device="cpu").analyze_batch(t_merged)
    assert got.congestion_ns == pytest.approx(fused.congestion_ns, rel=1e-3)
    np.testing.assert_allclose(
        got.per_host_congestion_ns, fused.per_host_congestion_ns, rtol=5e-3
    )


def test_unfused_single_host_matches_reference():
    flat = r_topo.figure1_topology().flatten()
    traces = [
        r_ev.synthetic_trace(800, flat.n_pools, epoch_ns=2e5, seed=s, burstiness=0.8,
                             granule_bytes=4096)
        for s in range(2)
    ]
    want = r_an.EpochAnalyzer(flat, impl="inline", fused=False).analyze_batch(traces)
    got = t_an.EpochAnalyzer(_port_flat(flat), device="cpu", fused=False).analyze_batch(
        [_port_events(t) for t in traces]
    )
    _assert_matches_reference(got, want)
    np.testing.assert_allclose(got.per_host_congestion_ns, [got.congestion_ns])


# --------------------------------------------------------------------------- #
# FabricSession end to end
# --------------------------------------------------------------------------- #


def _tenant(pkg, name, traffic_mult=1, policy=None):
    """tests/test_fabric.py's tenant, trace-only, built in either package."""
    rm = pkg.RegionMap()
    rm.alloc("w", 1 << 22, "param")
    rm.alloc("kv", 1 << 22, "kvcache")
    rm.alloc("act", 1 << 20, "activation")
    phases = [
        pkg.Phase(
            "fwd",
            flops=5e8,
            accesses=(
                pkg.Access("w", traffic_mult * (1 << 22)),
                pkg.Access("kv", traffic_mult * (1 << 22), True),
                pkg.Access("act", 1 << 20, True),
            ),
        ),
    ]
    return pkg.Tenant(name, phases, rm, pkg.ClassMapPolicy(policy or {"kvcache": "shared_pool"}))


def _sessions(n_tenants, epoch, coherency=True, **kw):
    common = dict(max_events_per_access=128, **kw)
    coh = dict(shared_classes=("kvcache",)) if coherency else None
    want = R.FabricSession(
        R.pooled_topology(n_hosts=n_tenants, cxl_bandwidth_gbps=8.0),
        [_tenant(R, f"t{h}", traffic_mult=1 + 3 * h) for h in range(n_tenants)],
        epoch=R.EpochSchedule(epoch), hw=R.TPU_V5E, async_analysis=False,
        coherency=R.CoherencyConfig(**coh) if coh else None, **common,
    )
    got = T.FabricSession(
        T.pooled_topology(n_hosts=n_tenants, cxl_bandwidth_gbps=8.0),
        [_tenant(T, f"t{h}", traffic_mult=1 + 3 * h) for h in range(n_tenants)],
        epoch=T.EpochSchedule(epoch), hw=T.TPU_V5E, device="cpu",
        coherency=T.CoherencyConfig(**coh) if coh else None, **common,
    )
    return got, want


@pytest.mark.parametrize("n_tenants, epoch", [(2, "step"), (3, "quantum")])
def test_fabric_session_matches_reference(n_tenants, epoch):
    got_s, want_s = _sessions(n_tenants, epoch)
    want = want_s.run(2)
    got = got_s.run(2)
    assert (got.rounds, got.epochs) == (want.rounds, want.epochs) == (2, got.epochs)
    assert got.bi_messages == want.bi_messages > 0
    assert got.coherency_s == pytest.approx(want.coherency_s, rel=1e-12)
    assert got.latency_s == pytest.approx(want.latency_s, rel=1e-5)
    assert got.congestion_s == pytest.approx(want.congestion_s, rel=1e-4, abs=1e-12)
    assert got.bandwidth_s == pytest.approx(want.bandwidth_s, rel=1e-5, abs=1e-12)
    for g, w in zip(got.hosts, want.hosts):
        assert (g.host, g.name, g.steps) == (w.host, w.name, w.steps)
        assert g.native_s == w.native_s  # trace-only: the roofline clock
        assert g.latency_s == pytest.approx(w.latency_s, rel=1e-5)
        assert g.congestion_s == pytest.approx(w.congestion_s, rel=1e-4, abs=1e-12)
        assert g.bandwidth_s == pytest.approx(w.bandwidth_s, rel=1e-5, abs=1e-12)
        assert g.coherency_s == pytest.approx(w.coherency_s, rel=1e-12)
        assert g.simulated_s >= g.native_s
    for f in ("per_pool_latency_ns", "per_switch_congestion_ns", "per_switch_bandwidth_ns"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-4, atol=1e-2)
    # per-host decomposition closes against the fabric totals
    assert sum(h.latency_s for h in got.hosts) == pytest.approx(got.latency_s, rel=1e-5)
    assert sum(h.congestion_s for h in got.hosts) == pytest.approx(
        got.congestion_s, rel=1e-4, abs=1e-12
    )


def test_fabric_summary_keys_match_reference():
    got_s, want_s = _sessions(2, "step", coherency=False)
    got, want = got_s.run(1), want_s.run(1)
    assert set(got.summary()) == set(want.summary())
    assert got.summary()["rounds"] == 1 and got.bi_messages == 0.0


def test_single_tenant_session_equals_attach():
    """One tenant on the fabric == the port's CXLMemSim attach."""
    def regions():
        rm = T.RegionMap()
        rm.alloc("w", 1 << 22, "param")
        rm.alloc("opt", 1 << 23, "opt_state")
        return rm

    phases = [T.Phase("fwd", flops=5e8, accesses=(T.Access("w", 1 << 22),
                                                  T.Access("opt", 1 << 23, True)))]
    step = lambda x: (x * 2).sum()  # noqa: E731
    x = torch.ones(32)
    policy = {"opt_state": "cxl_pool"}
    sess = T.FabricSession(
        T.two_tier_topology(),
        [T.Tenant("solo", phases, regions(), T.ClassMapPolicy(policy),
                  step_fn=step, step_args=(x,))],
        device="cpu",
    )
    sess.run(1)
    sim = T.CXLMemSim(T.two_tier_topology(), T.ClassMapPolicy(policy), device="cpu")
    rep = sim.attach(step, phases, regions()).run(1, x)
    assert sess.report.latency_s == pytest.approx(rep.latency_s, rel=1e-6)
    assert sess.report.congestion_s == pytest.approx(rep.congestion_s, rel=1e-5, abs=1e-12)
    assert sess.report.bandwidth_s == pytest.approx(rep.bandwidth_s, rel=1e-5, abs=1e-12)
    assert sess.report.hosts[0].steps == 1 and sess.report.hosts[0].native_s > 0


def test_fabric_session_configuration_errors():
    two = [_tenant(T, "a"), _tenant(T, "b")]
    with pytest.raises(ValueError, match="single-tenant"):
        T.FabricSession(T.pooled_topology(n_hosts=1), two[:1], device="cpu",
                        coherency=T.CoherencyConfig(shared_classes=("kvcache",)))
    with pytest.raises(ValueError, match="4 hosts but 2 tenants"):
        T.FabricSession(T.pooled_topology(n_hosts=4), two, device="cpu")
    with pytest.raises(ValueError, match="cannot reach"):
        T.FabricSession(T.pooled_topology(n_hosts=2, host_ports={1: ()}), two, device="cpu")
    small = T.pooled_topology(n_hosts=2, cxl_capacity_gib=0.005)  # ~5 MiB shared
    with pytest.raises(ValueError, match="oversubscribed"):
        T.FabricSession(small, [_tenant(T, "a"), _tenant(T, "b")], device="cpu")
    # with coherency the two name-matched 4 MiB 'kv' regions are one object
    T.FabricSession(small, [_tenant(T, "a"), _tenant(T, "b")], device="cpu",
                    coherency=T.CoherencyConfig(shared_classes=("kvcache",)))


@pytest.mark.parametrize("kw, slice_name", [
    (dict(async_analysis=True), "slice 4"),
    (dict(engine=object()), "slice 4"),
    (dict(pipeline=True), "slice 4"),
    (dict(migration=object()), "slice 3"),
    (dict(cache=object()), "slice 3"),
])
def test_unported_fabric_options_name_their_slice(kw, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        T.FabricSession(T.pooled_topology(n_hosts=2), [_tenant(T, "a"), _tenant(T, "b")],
                        device="cpu", **kw)


def test_fabric_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.FabricSession(T.pooled_topology(n_hosts=2), [_tenant(T, "a"), _tenant(T, "b")])


# --------------------------------------------------------------------------- #
# single-attach coherency
# --------------------------------------------------------------------------- #


def test_attach_with_coherency_matches_reference():
    """CXLMemSim(coherency=CoherencyModel(...)): the analytic n_hosts-1
    fallback injects BI traffic into the attached program's own stream."""
    reports = []
    for pkg, kw in ((R, dict(async_analysis=False)), (T, dict(device="cpu"))):
        # shared weights are read, the shared KV cache written: BI fan-out
        # and coherency misses both
        tenant = _tenant(pkg, "solo", policy={"kvcache": "cxl_pool", "param": "cxl_pool"})
        model = pkg.CoherencyModel(
            pkg.CoherencyConfig(n_hosts=3, shared_classes=("kvcache", "param")),
            tenant.regions,
        )
        sim = pkg.CXLMemSim(pkg.two_tier_topology(), tenant.policy, hw=pkg.TPU_V5E,
                            coherency=model, max_events_per_access=128, **kw)
        rep = sim.attach(lambda: None, tenant.phases, tenant.regions).run(2)
        reports.append((rep, model))
    (want, want_m), (got, got_m) = reports
    assert got_m.bi_messages_total == want_m.bi_messages_total > 0
    assert got.coherency_s == want.coherency_s > 0
    for f in ("latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-5, abs=1e-12), f
    delay_s = got.latency_s + got.congestion_s + got.bandwidth_s + got.coherency_s
    assert got.simulated_s == pytest.approx(got.native_s + delay_s, rel=1e-9)
