"""Port parity for the rack-scale fleet (``repro_torch.core.fleet``): the
scheduler's placements bitwise ``repro``'s, ``simulate`` and ``frontier``
against ``repro``'s ``FleetSim`` under JAX on the CPU (the port with
``device="cpu"``: the kernels' plain versions), heterogeneous fleets
(``rack_overrides``, ``rack_qos``) and ``_analyze_fleet``'s grouping of
racks into cascade calls."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import fleet as r_fleet
from repro.core import topology as r_topo
from repro_torch.core import fleet as t_fleet
from repro_torch.core import topology as t_topo
from repro_torch.core.tracer import TPU_V5E
from repro_torch.kernels import ops as t_ops
from repro_torch.launch.mesh import make_abstract_mesh

torch.set_num_threads(2)

N_TENANTS = 24


@pytest.fixture(scope="module")
def tenants():
    """The same 24 synthetic tenants in either package."""
    return {
        pkg: [pkg.synthetic_tenant(f"t{i}", seed=i, gib=8.0) for i in range(N_TENANTS)]
        for pkg in (r_fleet, t_fleet)
    }


def mini_fleet(pkg, **kw):
    """``tests/test_fleet_sharding.py``'s 4-rack fleet of 4 hosts each."""
    kw.setdefault("granularity_bytes", 65536)
    kw.setdefault("max_events_per_access", 16)
    if pkg is t_fleet:
        kw.setdefault("hw", TPU_V5E)  # the reference's default
        kw.setdefault("device", "cpu")
    kw.setdefault("n_racks", 4)
    return pkg.FleetSim(hosts_per_rack=4, **kw)


def assert_reports_close(got, want, tag="", cong_abs=1e-3):
    """Per-host delays at the fabric bars (latency rtol 1e-4, congestion
    5e-3 with ``cong_abs`` ns of slack), bandwidth and totals alike, the
    rest exact."""
    assert got.n_racks == want.n_racks and got.hosts_per_rack == want.hosts_per_rack
    assert got.stranded_recovered_bytes == want.stranded_recovered_bytes
    np.testing.assert_array_equal(got.native_ns, want.native_ns)
    assert set(got.summary()) == set(want.summary())
    for g, w in zip(got.breakdowns, want.breakdowns):
        np.testing.assert_allclose(g.per_host_latency_ns, w.per_host_latency_ns,
                                   rtol=1e-4, err_msg=f"{tag} latency")
        np.testing.assert_allclose(g.per_host_congestion_ns, w.per_host_congestion_ns,
                                   rtol=5e-3, atol=cong_abs, err_msg=f"{tag} congestion")
        np.testing.assert_allclose(g.per_host_bandwidth_ns, w.per_host_bandwidth_ns,
                                   rtol=1e-3, atol=1.0, err_msg=f"{tag} bandwidth")
        assert g.latency_ns == pytest.approx(w.latency_ns, rel=1e-4)
        assert g.congestion_ns == pytest.approx(w.congestion_ns, rel=5e-3,
                                                abs=cong_abs * len(g.per_host_congestion_ns))
    np.testing.assert_allclose(got.delay_ns, want.delay_ns, rtol=5e-3, atol=3 * cong_abs)
    assert got.p99_slowdown() == pytest.approx(want.p99_slowdown(), rel=1e-6)
    assert got.mean_slowdown() == pytest.approx(want.mean_slowdown(), rel=1e-6)


# --------------------------------------------------------------------------- #
# scheduling + placement
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded", "first_fit"])
@pytest.mark.parametrize("fraction", [0.0, 0.4, 1.0])
def test_place_bitwise_the_reference(tenants, policy, fraction):
    want = mini_fleet(r_fleet).place(tenants[r_fleet], policy, fraction)
    got = mini_fleet(t_fleet).place(tenants[t_fleet], policy, fraction)
    assert len(got) == len(want) == N_TENANTS
    for g, w in zip(got, want):
        assert g.tenant.name == w.tenant.name
        assert (g.rack, g.host) == (w.rack, w.host)
        assert g.local_bytes == w.local_bytes and g.pooled_bytes == w.pooled_bytes
        assert g.pool_of_region.dtype == w.pool_of_region.dtype
        assert np.array_equal(g.pool_of_region, w.pool_of_region)


def test_place_errors_match_the_reference(tenants):
    msgs = {}
    for pkg in (r_fleet, t_fleet):
        fleet = mini_fleet(pkg)
        t0 = tenants[pkg][0]
        errs = []
        for call in (
            lambda: fleet.place([t0, t0]),
            lambda: fleet.place([]),
            lambda: fleet.place([t0], policy="random"),
            lambda: fleet.place([t0], offload_fraction=1.5),
            lambda: mini_fleet(pkg, n_racks=1).place(
                [pkg.synthetic_tenant("huge", seed=1, gib=500.0)], offload_fraction=0.0),
            lambda: fleet.place([dataclasses.replace(t0, qos_class=3)]),
        ):
            with pytest.raises(ValueError) as e:
                call()
            errs.append(str(e.value))
        msgs[pkg] = errs
    assert msgs[t_fleet] == msgs[r_fleet]
    assert "unique" in msgs[t_fleet][0] and "local DRAM" in msgs[t_fleet][4]


def test_synthetic_and_model_zoo_tenants_match_the_reference():
    for make in (
        lambda pkg: pkg.synthetic_tenant("a", seed=3, gib=2.0, read_intensity=0.05),
        lambda pkg: pkg.model_zoo_tenant("z", arch="starcoder2-3b", mode="train"),
        lambda pkg: pkg.model_zoo_tenant("q", arch="qwen3-0.6b", mode="decode", batch=1),
    ):
        a, b = make(t_fleet), make(r_fleet)
        assert a.name == b.name and a.qos_class == b.qos_class
        assert a.demand_bytes() == b.demand_bytes()
        assert [(r.name, r.nbytes, r.tensor_class) for r in a.regions.regions] == [
            (r.name, r.nbytes, r.tensor_class) for r in b.regions.regions]
        assert [(p.name, p.flops, [(x.region, x.bytes_, x.is_write) for x in p.accesses])
                for p in a.phases] == [
            (p.name, p.flops, [(x.region, x.bytes_, x.is_write) for x in p.accesses])
            for p in b.phases]


# --------------------------------------------------------------------------- #
# simulate + frontier
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("policy", ["least_loaded", "round_robin"])
def test_simulate_matches_the_reference(tenants, policy):
    rf, tf = mini_fleet(r_fleet), mini_fleet(t_fleet)
    want = rf.simulate(tenants[r_fleet], policy=policy, offload_fraction=1.0)
    before = t_ops.plain_launches
    got = tf.simulate(tenants[t_fleet], policy=policy, offload_fraction=1.0)
    assert tf.dispatch_count == 1
    assert t_ops.plain_launches - before == 1  # a homogeneous fleet: one cascade call
    assert_reports_close(got, want, policy)
    assert got.summary()["devices_used"] == 1 and got.summary()["shard_rows"] == 0
    assert got.padded_fraction == want.padded_fraction == 0.0
    assert got.tenant_slowdowns().shape == (N_TENANTS,)
    assert got.p99_slowdown() >= got.mean_slowdown() >= 1.0
    st = tf.last_dispatch
    assert st.rows == 4 and st.compute_s > 0 and st.qos_classes == 1


def test_frontier_matches_the_reference(tenants):
    fracs = (0.0, 0.5, 1.0)
    rf, tf = mini_fleet(r_fleet), mini_fleet(t_fleet)
    want = rf.frontier(tenants[r_fleet], offload_fractions=fracs)
    before = t_ops.plain_launches
    got = tf.frontier(tenants[t_fleet], offload_fractions=fracs)
    # F*R = 12 planes, ONE dispatch, one cascade call
    assert tf.dispatch_count == 1 and t_ops.plain_launches - before == 1
    # the stack bucket of 16 planes: the reference's padded share
    assert tf.last_dispatch.padded_fraction == rf.last_dispatch.padded_fraction == 0.25
    assert [p.offload_fraction for p in got] == list(fracs)
    for g, w in zip(got, want):
        assert g.stranded_recovered_gb == w.stranded_recovered_gb
        assert g.p99_slowdown == pytest.approx(w.p99_slowdown, rel=1e-6)
        assert g.mean_slowdown == pytest.approx(w.mean_slowdown, rel=1e-6)
        assert_reports_close(g.report, w.report, f"fraction {g.offload_fraction}")
    gb = [p.stranded_recovered_gb for p in got]
    assert gb[0] == 0.0 and all(b >= a for a, b in zip(gb, gb[1:]))
    # the frontier's end point is a standalone simulate at that fraction
    rep = tf.simulate(tenants[t_fleet], offload_fraction=1.0)
    np.testing.assert_allclose(got[-1].report.delay_ns, rep.delay_ns, rtol=1e-6)
    with pytest.raises(ValueError):
        tf.frontier(tenants[t_fleet], offload_fractions=())


def test_layer_epochs_and_a_single_host_rack_match_the_reference(tenants):
    """Layer epochs stack several rows a rack; a one-host rack runs the
    single-host cascade."""
    for kw in ({"epoch_mode": "layer"}, {"rack_topology": "one_host"}):
        runs = {}
        for pkg, topo in ((r_fleet, r_topo), (t_fleet, t_topo)):
            k = dict(kw)
            if k.get("rack_topology") == "one_host":
                k["rack_topology"] = topo.pooled_topology(n_hosts=1)
            fleet = mini_fleet(pkg, **k)
            runs[pkg] = fleet.simulate(tenants[pkg][:12], offload_fraction=0.5)
        assert_reports_close(runs[t_fleet], runs[r_fleet], str(kw))


# --------------------------------------------------------------------------- #
# heterogeneous fleets
# --------------------------------------------------------------------------- #


def test_heterogeneous_rack_overrides(tenants):
    """``tests/test_fleet_sharding.py``'s case: round_robin gives equal
    placements, so the racks' deltas isolate the topology; and the mixed
    fleet against the reference's."""
    out = {}
    for pkg, topo in ((r_fleet, r_topo), (t_fleet, t_topo)):
        slow = topo.TopologyOverride(pools={"shared_pool": {"latency_ns": 400.0}})
        uniform = mini_fleet(pkg)
        mixed = mini_fleet(pkg, rack_overrides=[None, None, slow, slow])
        a = uniform.simulate(tenants[pkg], policy="round_robin", offload_fraction=1.0)
        b = mixed.simulate(tenants[pkg], policy="round_robin", offload_fraction=1.0)
        np.testing.assert_allclose(b.delay_ns[:2], a.delay_ns[:2], rtol=1e-6)
        assert (b.delay_ns[2:] > a.delay_ns[2:]).all()
        out[pkg] = b
    assert_reports_close(out[t_fleet], out[r_fleet], "mixed")
    with pytest.raises(ValueError, match="rack_overrides"):
        mini_fleet(t_fleet, rack_overrides=[None])


def _qos_fleet(pkg, topo, tenants_of):
    rq = [topo.QosSpec(discipline="wfq", class_weights=(4.0, 1.0)),
          topo.QosSpec(discipline="priority", class_weights=(1.0, 1.0))] * 2
    ovs = [None, topo.TopologyOverride(pools={"shared_pool": {"latency_ns": 400.0}},
                                       switches={"fabric_sw": {"stt_ns": 4.0}})] * 2
    fleet = mini_fleet(pkg, rack_qos=rq, rack_overrides=ovs)
    ten = [dataclasses.replace(t, qos_class=i % 2) for i, t in enumerate(tenants_of)]
    return fleet, ten


def test_rack_qos_matches_the_reference(tenants):
    fleets = {}
    for pkg, topo in ((r_fleet, r_topo), (t_fleet, t_topo)):
        fleets[pkg] = _qos_fleet(pkg, topo, tenants[pkg])
    (rf, rt), (tf, tt) = fleets[r_fleet], fleets[t_fleet]
    assert tf.qos_on and rf.qos_on and tf.n_qos_classes == rf.n_qos_classes == 2
    for a, b in ((tf._disc_stack, rf._disc_stack), (tf._weights_stack, rf._weights_stack)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    want = rf.simulate(rt, policy="round_robin", offload_fraction=1.0)
    before = t_ops.plain_launches
    got = tf.simulate(tt, policy="round_robin", offload_fraction=1.0)
    # two (STT, discipline, weights) rows: two QoS cascade calls
    assert t_ops.plain_launches - before == 2
    assert got.qos_classes == want.qos_classes == 2
    # step epochs reach 4.2e7 ns, where the f32 ulp is 4 ns: the reference's
    # max-plus QoS scan and the port's closed-form per-class scans round a
    # start apart by an ulp (a start can even fall an ulp before its
    # arrival), so the fleet's zero congestion reads as a few ulps a host
    ulp = float(np.spacing(np.float32(4.2e7)))
    assert_reports_close(got, want, "rack_qos", cong_abs=4 * ulp)
    for g, w in zip(got.breakdowns, want.breakdowns):
        np.testing.assert_allclose(g.per_class_congestion_ns, w.per_class_congestion_ns,
                                   rtol=5e-3, atol=4 * ulp * len(g.per_host_congestion_ns))
    with pytest.raises(ValueError, match="rack_qos"):
        mini_fleet(t_fleet, rack_qos=[None])


def test_racks_group_by_their_service_times(tenants):
    """Racks that share their STT row are one cascade call whatever their
    latency and bandwidth; each distinct STT row is one more."""
    ovs = [None,
           t_topo.TopologyOverride(pools={"shared_pool": {"latency_ns": 300.0}}),
           t_topo.TopologyOverride(switches={"fabric_sw": {"bandwidth_gbps": 8.0}}),
           t_topo.TopologyOverride(switches={"fabric_sw": {"stt_ns": 3.0}})]
    fleet = mini_fleet(t_fleet, rack_overrides=ovs)
    before = t_ops.plain_launches
    rep = fleet.simulate(tenants[t_fleet], policy="round_robin")
    assert t_ops.plain_launches - before == 2
    # each rack against its own solo analysis on its own topology
    stack = t_topo.flatten_stack(fleet.topology, ovs)
    from repro_torch.core.analyzer import EpochAnalyzer

    traces, _ = fleet._rack_timelines(fleet.place(tenants[t_fleet], "round_robin"))
    for r, rows in enumerate(traces):
        solo = EpochAnalyzer(stack.member(r), n_windows=fleet.n_windows,
                             device="cpu").analyze_batch(rows)
        b = rep.breakdowns[r]
        assert b.latency_ns == pytest.approx(solo.latency_ns, rel=1e-6)
        assert b.congestion_ns == pytest.approx(solo.congestion_ns, rel=1e-6)
        assert b.bandwidth_ns == pytest.approx(solo.bandwidth_ns, rel=1e-6, abs=1e-3)
        np.testing.assert_allclose(b.per_host_latency_ns, solo.per_host_latency_ns,
                                   rtol=1e-6)


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #


def test_mesh_raises(tenants):
    """``mesh=`` takes a ``Mesh`` of the fleet's device type (the split
    itself: ``tests/test_torch_sharding.py``)."""
    with pytest.raises(TypeError, match="Mesh"):
        mini_fleet(t_fleet, mesh=object())
    fleet = mini_fleet(t_fleet)
    with pytest.raises(TypeError, match="Mesh"):
        fleet.simulate(tenants[t_fleet][:4], mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        fleet.frontier(tenants[t_fleet][:4], mesh=object())
    with pytest.raises(ValueError, match="abstract mesh"):
        fleet.simulate(tenants[t_fleet][:4], mesh=make_abstract_mesh((2,), ("data",)))


def test_fleet_constructor_errors_match_the_reference():
    for call, match in (
        (lambda pkg: mini_fleet(pkg, n_racks=0), "at least one rack"),
        (lambda pkg: mini_fleet(pkg, epoch_mode="bogus"), "bogus"),
    ):
        for pkg in (r_fleet, t_fleet):
            with pytest.raises(ValueError, match=match):
                call(pkg)
    topo = t_topo.local_only_topology()
    with pytest.raises(ValueError, match="no shared pool"):
        mini_fleet(t_fleet, rack_topology=topo)
