"""Port parity for the split over several devices
(``repro_torch.distributed.sharding``, ``repro_torch.launch.mesh`` and the
``mesh=`` of the analyzer, the engine, the sweep and the fleet).

``tests/test_fleet_sharding.py``'s sharding cases run through the port on a
virtual mesh of 8 CPU entries (``make_data_mesh(8, "cpu", virtual=True)``)
beside ``repro``'s on conftest's 8 virtual XLA devices, with the same
inputs.  The bars: the dispatch records equal ``repro``'s; each port result
bitwise its own unsharded run where the reference's test is bitwise (the
analyzer, the engine) and at rel 1e-6 where it is not (the sweep, the
fleet); against ``repro``'s sharded results at the bars its unsharded ones
meet.  Then ``tests/test_sharding.py``'s rules for all ten configurations on
the abstract 16 x 16 and 2 x 16 x 16 meshes, ``param_pspecs`` and
``input_pspecs`` equal to ``repro``'s.
"""

import dataclasses
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.configs as r_cfgs
import repro.core as R
from repro.distributed import sharding as r_shr
from repro.launch.mesh import make_abstract_mesh as r_abstract_mesh
from repro.models import Model as RModel
from repro.models.phases import build_regions_and_phases as r_build
from repro_torch import configs as t_cfgs
from repro_torch import core as T
from repro_torch.core.analyzer import DispatchStats
from repro_torch.core.engine import fold_dispatch_stats
from repro_torch.distributed import sharding as t_shr
from repro_torch.interop import (
    flat_topology_from_arrays,
    mem_events_from_arrays,
    reference_leaf,
)
from repro_torch.kernels import ops as t_ops
from repro_torch.launch.mesh import (
    Mesh,
    make_abstract_mesh,
    make_data_mesh,
    make_local_mesh,
)
from repro_torch.models import Model as TModel
from repro_torch.models import build_regions_and_phases as t_build

torch.set_num_threads(2)

BREAKDOWN_ARRAYS = (
    "per_pool_latency_ns", "per_switch_congestion_ns", "per_switch_bandwidth_ns",
    "per_host_latency_ns", "per_host_congestion_ns", "per_host_bandwidth_ns",
    "per_class_congestion_ns",
)


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Drop this file's XLA executables when it ends, so the worker that
    ran it keeps no memory mappings of them."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def vmesh():
    """The port's counterpart of conftest's ``data_mesh``: 8 entries, all
    the one CPU."""
    return make_data_mesh(8, "cpu", virtual=True)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _session_groups(flat, k, b=3, n=300):
    """``tests/test_fleet_sharding.py``'s groups, the reference's traces."""
    return [
        [
            R.synthetic_trace(n, flat.n_pools, epoch_ns=1e6, seed=7 * i + j)
            .with_host(i % flat.n_hosts)
            for j in range(b)
        ]
        for i in range(k)
    ]


def _port_groups(groups):
    return [[mem_events_from_arrays(_fields(tr)) for tr in g] for g in groups]


def _port_flat(r_flat):
    return flat_topology_from_arrays(_fields(r_flat))


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert (g.latency_ns, g.congestion_ns, g.bandwidth_ns) == (
            w.latency_ns, w.congestion_ns, w.bandwidth_ns)
        for f in BREAKDOWN_ARRAYS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)


def _close_to_reference(got, want):
    """The port's coalesced dispatch against the reference's
    (``tests/test_torch_engine.py``'s bars)."""
    for g, w in zip(got, want):
        assert g.latency_ns == pytest.approx(w.latency_ns, rel=1e-5)
        assert g.congestion_ns == pytest.approx(w.congestion_ns, rel=1e-5, abs=1e-3)
        assert g.bandwidth_ns == pytest.approx(w.bandwidth_ns, rel=1e-5, abs=1e-3)
        for f in ("per_host_latency_ns", "per_host_congestion_ns", "per_pool_latency_ns"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=1e-5, atol=1e-3)


def _falls_back(fn):
    """``fn()`` under recorded warnings; returns (its result, whether the
    reference's fallback warning was raised)."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, any("falling back" in str(x.message) for x in w)


# --------------------------------------------------------------------------- #
# meshes, the resolver's errors and fallback, pad_to_multiple
# --------------------------------------------------------------------------- #


def test_virtual_mesh_counts_its_entries(vmesh, data_mesh):
    assert vmesh.shape == dict(data_mesh.shape) == {"data": 8}
    assert vmesh.size == 8 and vmesh.axis_names == ("data",)
    assert {str(d) for d in vmesh.devices} == {"cpu"}


def test_meshes_clamp_to_the_devices_present():
    # one CPU: make_data_mesh and make_local_mesh clamp as the reference's
    assert make_data_mesh(8, "cpu").shape == {"data": 1}
    assert make_local_mesh(4, 2, device="cpu").shape == {"data": 1, "model": 1}
    abstract = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert abstract.devices is None and abstract.size == 512
    assert abstract.shape == dict(r_abstract_mesh((2, 16, 16), ("pod", "data", "model")).shape)
    with pytest.raises(ValueError, match="length mismatch"):
        make_abstract_mesh((2, 4), ("data",))
    with pytest.raises(ValueError, match="n >= 1"):
        make_data_mesh(0, "cpu", virtual=True)


def test_cuda_meshes_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_data_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_data_mesh(4, "cuda:0", virtual=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mesh(["cuda:3"], ("data",))


def test_resolve_rejects_mesh_without_data_axis():
    grid = np.empty((2, 4), dtype=object)
    grid[...] = torch.device("cpu")
    with pytest.raises(ValueError, match="data"):
        t_shr.resolve_data_mesh(Mesh(grid, ("a", "b")), 8)
    model = np.empty((4, 2), dtype=object)
    model[...] = torch.device("cpu")
    with pytest.raises(ValueError, match="'model' has size 2"):
        t_shr.resolve_data_mesh(Mesh(model, ("data", "model")), 8)


def test_resolve_falls_back_when_devices_exceed_rows(vmesh, data_mesh):
    for rows in (5, 3):
        with warnings.catch_warnings(record=True) as w_t:
            warnings.simplefilter("always")
            sub, n = t_shr.resolve_data_mesh(vmesh, rows)
        with warnings.catch_warnings(record=True) as w_r:
            warnings.simplefilter("always")
            r_sub, r_n = r_shr.resolve_data_mesh(data_mesh, rows)
        assert n == r_n == rows and sub.shape == dict(r_sub.shape)
        assert [str(x.message) for x in w_t] == [str(x.message) for x in w_r]
        assert any("falling back" in str(x.message) for x in w_t)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert t_shr.resolve_data_mesh(vmesh, 1) == (None, 1)
    assert t_shr.resolve_data_mesh(None, 8) == (None, 1)
    assert t_shr.resolve_data_mesh(vmesh, 0) == (None, 1)
    assert t_shr.resolve_data_mesh(make_data_mesh(1, "cpu", virtual=True), 8) == (None, 1)
    assert t_shr.resolve_data_mesh(vmesh, 16) == (vmesh, 8)


@pytest.mark.parametrize("n,k", [(16, 8), (17, 8), (5, 1), (5, 0), (1, 8), (24, 6)])
def test_pad_to_multiple(n, k):
    assert t_shr.pad_to_multiple(n, k) == r_shr.pad_to_multiple(n, k)


def test_shard_rows_and_replicated(vmesh):
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    parts = t_shr.shard_rows(vmesh, x)
    assert len(parts) == 8 and all(p.shape == (2, 2) for p in parts)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    assert t_shr.shard_rows(None, x) is x
    with pytest.raises(ValueError, match="do not split"):
        t_shr.shard_rows(vmesh, x[:12])
    t = torch.ones(3)
    copies = t_shr.replicated(vmesh, t)
    assert len(copies) == 8 and all(c is copies[0] for c in copies)  # one device, one copy
    placed, seconds = t_shr.timed_device_put(
        {"a": x}, vmesh, t_shr.PartitionSpec("data", None))
    assert len(placed["a"]) == 8 and seconds >= 0.0


# --------------------------------------------------------------------------- #
# analyzer: the coalesced multi-session dispatch, split (bitwise)
# --------------------------------------------------------------------------- #


def test_analyze_batch_multi_sharded_bitwise_parity(vmesh, data_mesh):
    r_flat = R.pooled_topology(n_hosts=4).flatten()
    groups = _session_groups(r_flat, 11)  # bucket(11) = 16 -> 2 rows an entry
    flat = _port_flat(r_flat)
    plain = T.EpochAnalyzer(flat, n_windows=64, device="cpu")
    sharded = T.EpochAnalyzer(flat, n_windows=64, device="cpu", mesh=vmesh)
    a = plain.analyze_batch_multi(_port_groups(groups))
    b = sharded.analyze_batch_multi(_port_groups(groups))
    _bitwise(b, a)
    want = DispatchStats(devices_used=8, shard_rows=2, rows=11, padded_fraction=5 / 16)
    assert sharded.last_dispatch == want
    assert plain.last_dispatch.devices_used == 1 and plain.last_dispatch.shard_rows == 0
    assert sharded.sharded_dispatches == 1 and plain.sharded_dispatches == 0
    ref = R.EpochAnalyzer(r_flat, n_windows=64, mesh=data_mesh)
    r_out = ref.analyze_batch_multi(groups)
    # the reference's record, and the port's own h2d_bytes, 0 on a coalesced dispatch
    assert _fields(sharded.last_dispatch) == {**_fields(ref.last_dispatch), "h2d_bytes": 0}
    _close_to_reference(b, r_out)


def test_analyze_batch_multi_per_call_mesh_overrides_constructor(vmesh, data_mesh):
    r_flat = R.pooled_topology(n_hosts=2).flatten()
    groups = _session_groups(r_flat, 8, b=2, n=128)
    plain = T.EpochAnalyzer(_port_flat(r_flat), n_windows=64, device="cpu")
    a = plain.analyze_batch_multi(_port_groups(groups))
    b = plain.analyze_batch_multi(_port_groups(groups), mesh=vmesh)
    _bitwise(b, a)
    assert plain.last_dispatch.devices_used == 8 and plain.sharded_dispatches == 1
    ref = R.EpochAnalyzer(r_flat, n_windows=64)
    r_out = ref.analyze_batch_multi(groups, mesh=data_mesh)
    assert _fields(plain.last_dispatch) == {**_fields(ref.last_dispatch), "h2d_bytes": 0}
    _close_to_reference(b, r_out)


def test_analyze_batch_multi_fewer_rows_than_devices_warns_and_matches(vmesh, data_mesh):
    r_flat = R.pooled_topology(n_hosts=2).flatten()
    groups = _session_groups(r_flat, 5, b=2, n=128)
    flat = _port_flat(r_flat)
    a = T.EpochAnalyzer(flat, n_windows=64, device="cpu").analyze_batch_multi(
        _port_groups(groups))
    sharded = T.EpochAnalyzer(flat, n_windows=64, device="cpu", mesh=vmesh)
    b, warned = _falls_back(lambda: sharded.analyze_batch_multi(_port_groups(groups)))
    assert warned
    _bitwise(b, a)
    assert sharded.last_dispatch.devices_used == 5
    ref = R.EpochAnalyzer(r_flat, n_windows=64, mesh=data_mesh)
    r_out, r_warned = _falls_back(lambda: ref.analyze_batch_multi(groups))
    assert r_warned
    assert _fields(sharded.last_dispatch) == {**_fields(ref.last_dispatch), "h2d_bytes": 0}
    _close_to_reference(b, r_out)


def test_analyze_batch_multi_sharded_qos_bitwise(vmesh):
    """A QoS fabric's sessions: the host-segmented QoS cascade a shard."""
    flat = T.pooled_topology(n_hosts=2, discipline="wfq", class_weights=(3.0, 1.0)).flatten()
    groups = _port_groups(_session_groups(R.pooled_topology(n_hosts=2).flatten(), 6, n=200))
    groups = [[tr.with_qos(np.arange(tr.n) % 2) for tr in g] for g in groups]
    a = T.EpochAnalyzer(flat, device="cpu").analyze_batch_multi(groups)
    mesh = make_data_mesh(3, "cpu", virtual=True)
    sharded = T.EpochAnalyzer(flat, device="cpu")
    b = sharded.analyze_batch_multi(groups, mesh=mesh)
    _bitwise(b, a)
    assert sharded.last_dispatch.devices_used == 3 and sharded.last_dispatch.qos_classes == 2
    assert all(bd.per_class_congestion_ns.shape == (2,) for bd in b)


def test_mesh_of_another_device_type_is_refused():
    flat = T.pooled_topology(n_hosts=2).flatten()
    cuda_like = Mesh.__new__(Mesh)  # a mesh naming a card, built without one
    cuda_like.axis_names, cuda_like._dims = ("data",), (2,)
    cuda_like.devices = np.empty((2,), dtype=object)
    cuda_like.devices[:] = [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="own type"):
        T.EpochAnalyzer(flat, device="cpu", mesh=cuda_like)
    with pytest.raises(ValueError, match="own type"):
        T.ScenarioSuite(T.figure1_topology(), T.RegionMap(), [], device="cpu", mesh=cuda_like)
    with pytest.raises(ValueError, match="own type"):
        T.FleetSim(2, device="cpu", mesh=cuda_like)


# --------------------------------------------------------------------------- #
# scenario suite: the sweep split (<= 1e-6), shown in table()
# --------------------------------------------------------------------------- #


def _sweep_fixtures(pkg, build, n_scen):
    cfg = (r_cfgs if pkg is R else t_cfgs).get_smoke("starcoder2-3b")
    regions, phases = build(cfg, "train", batch=2, seq=64)
    scens = []
    for i in range(n_scen):
        ov = pkg.TopologyOverride(pools={"cxl_pool1": {"latency_ns": 150 + 25 * i}})
        pol = (
            pkg.ClassMapPolicy({"opt_state": "cxl_pool2", "grad": "cxl_pool1"})
            if i % 2
            else pkg.InterleavePolicy(["cxl_pool1", "cxl_pool2"])
        )
        scens.append(pkg.Scenario(pol, ov, name=f"s{i}"))
    return pkg.figure1_topology(), regions, phases, scens


def _t_suite(topo, regions, phases, **kw):
    return T.ScenarioSuite(topo, regions, phases, hw=T.TPU_V5E, device="cpu", **kw)


def _sweep_pair(n_scen, vmesh, data_mesh):
    topo, regions, phases, scens = _sweep_fixtures(T, t_build, n_scen)
    ra = _t_suite(topo, regions, phases).run(scens)
    rb, warned = _falls_back(
        lambda: _t_suite(topo, regions, phases, mesh=vmesh).run(scens))
    r_topo, r_regions, r_phases, r_scens = _sweep_fixtures(R, r_build, n_scen)
    want, r_warned = _falls_back(
        lambda: R.ScenarioSuite(r_topo, r_regions, r_phases, mesh=data_mesh).run(r_scens))
    assert warned == r_warned
    return ra, rb, want, warned


def _sweep_close(got, want, rel):
    for a, b in zip(got.breakdowns, want.breakdowns):
        assert a.total_ns == pytest.approx(b.total_ns, rel=rel)
        assert a.latency_ns == pytest.approx(b.latency_ns, rel=rel)
        assert a.congestion_ns == pytest.approx(b.congestion_ns, rel=rel, abs=1e-3)
        assert a.bandwidth_ns == pytest.approx(b.bandwidth_ns, rel=rel, abs=1e-3)


def test_scenario_sweep_sharded_parity(vmesh, data_mesh):
    ra, rb, want, warned = _sweep_pair(8, vmesh, data_mesh)
    assert not warned
    _sweep_close(rb, ra, 1e-6)
    _sweep_close(rb, want, 1e-5)
    assert ra.devices_used == 1 and rb.devices_used == 8 == want.devices_used
    assert rb.shard_rows == want.shard_rows == 1
    assert rb.padded_fraction == want.padded_fraction == 0.0
    row = rb.table()[0]
    assert (row["devices_used"], row["shard_rows"], row["padded_fraction"]) == (8, 1, 0.0)
    assert set(row) == set(want.table()[0])


def test_scenario_sweep_uneven_k_falls_back(vmesh, data_mesh):
    ra, rb, want, warned = _sweep_pair(6, vmesh, data_mesh)
    assert warned
    _sweep_close(rb, ra, 1e-6)
    _sweep_close(rb, want, 1e-5)
    assert rb.devices_used == 6 == want.devices_used
    assert (rb.shard_rows, rb.padded_fraction) == (want.shard_rows, want.padded_fraction)


def test_scenario_sweep_pads_k_by_repeating_scenario_0():
    """Ten scenarios over a mesh of 4: K padded to 12 (scenario 0 twice
    more), each entry 3 rows; the padded rows are dropped and the cascade
    launches are the unsharded run's."""
    topo, regions, phases, scens = _sweep_fixtures(T, t_build, 10)
    plain = _t_suite(topo, regions, phases)
    ra = plain.run(scens)
    mesh = make_data_mesh(4, "cpu", virtual=True)
    n0 = t_ops.plain_launches
    plain.run(scens)
    n_plain = t_ops.plain_launches - n0
    n0 = t_ops.plain_launches
    rb = _t_suite(topo, regions, phases).run(scens, mesh=mesh)
    assert t_ops.plain_launches - n0 == n_plain
    assert len(rb.breakdowns) == 10
    assert (rb.devices_used, rb.shard_rows, rb.padded_fraction) == (4, 3, 2 / 12)
    _sweep_close(rb, ra, 1e-6)


# --------------------------------------------------------------------------- #
# engine: the mesh on every coalesced dispatch; report observability
# --------------------------------------------------------------------------- #


class _Park:
    """Non-coalescible stub that parks the dispatcher, so the sessions'
    submissions queue behind it and coalesce."""

    def __init__(self, flat, sleep_s=0.3):
        self.flat, self.sleep_s = flat, sleep_s

    def simulate(self, tr, lat_scale=None):
        time.sleep(self.sleep_s)
        return T.DelayBreakdown.zero(self.flat.n_pools, self.flat.n_switches, self.flat.n_hosts)


def test_engine_mesh_parity_and_handle_stats(vmesh, data_mesh):
    r_flat = R.pooled_topology(n_hosts=4).flatten()
    groups = _session_groups(r_flat, 4, b=2, n=200)
    flat = _port_flat(r_flat)
    ref = T.EpochAnalyzer(flat, n_windows=64, device="cpu").analyze_batch_multi(
        _port_groups(groups))
    with T.AnalysisEngine("sharding-test", mesh=vmesh) as eng:
        handles = [eng.register(T.EpochAnalyzer(flat, n_windows=64, device="cpu"))
                   for _ in groups]
        park = eng.register(_Park(flat))
        park.submit([T.MemEvents.empty()])
        futs = [h.submit(g) for h, g in zip(handles, _port_groups(groups))]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # 4 coalesced rows fall back to 4 entries
            got = [f.result(60) for f in futs]
        park.close()
    _bitwise(got, ref)
    assert all(h.last_group_size == 4 for h in handles)
    st = handles[0].last_dispatch
    assert (st.devices_used, st.shard_rows, st.rows) == (4, 1, 4)
    with R.AnalysisEngine("sharding-test", mesh=data_mesh) as r_eng:
        r_handles = [r_eng.register(R.EpochAnalyzer(r_flat, n_windows=64)) for _ in groups]
        r_futs = [h.submit(g) for h, g in zip(r_handles, groups)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = [f.result(60) for f in r_futs]
    _close_to_reference(got, want)


def test_engine_folds_the_split_into_session_reports():
    """A split dispatch's record folds into a session's report: its
    entries, shard rows and padding, as the reference's reports keep them."""
    rep = T.SimReport()
    fold_dispatch_stats(rep, DispatchStats(devices_used=8, shard_rows=2, rows=11,
                                             padded_fraction=5 / 16), 11)
    s = rep.summary()
    assert (s["devices_used"], s["shard_rows"], s["padded_waste"]) == (8, 2, 5 / 16)
    assert s["coalesced_group_size"] == 11


def test_sim_report_summary_carries_dispatch_observability():
    s = T.SimReport().summary()
    assert s["devices_used"] == 1
    assert s["shard_rows"] == 0
    assert s["padded_waste"] == 0.0
    assert s["coalesced_group_size"] == 1
    assert set(s) == set(R.SimReport().summary())


# --------------------------------------------------------------------------- #
# FleetSim: simulate and frontier split, with their fallbacks
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def fleet_tenants():
    return {
        pkg: [pkg.synthetic_tenant(f"t{i}", seed=i, gib=8.0) for i in range(24)]
        for pkg in (R, T)
    }


def _mini_fleet(pkg, **kw):
    kw.setdefault("granularity_bytes", 65536)
    kw.setdefault("max_events_per_access", 16)
    if pkg is T:
        kw.setdefault("hw", T.TPU_V5E)  # the reference's default
        kw.setdefault("device", "cpu")
    return pkg.FleetSim(n_racks=4, hosts_per_rack=4, **kw)


def _fleet_close(got, want):
    """``tests/test_torch_fleet.py``'s fabric bars on the per-host delays."""
    np.testing.assert_array_equal(got.native_ns, want.native_ns)
    np.testing.assert_allclose(got.delay_ns, want.delay_ns, rtol=5e-3, atol=3e-3)
    for g, w in zip(got.breakdowns, want.breakdowns):
        np.testing.assert_allclose(g.per_host_latency_ns, w.per_host_latency_ns, rtol=1e-4)


def test_fleet_simulate_sharded_parity(vmesh, data_mesh, fleet_tenants):
    a = _mini_fleet(T).simulate(fleet_tenants[T], offload_fraction=1.0)
    b, warned = _falls_back(lambda: _mini_fleet(T, mesh=vmesh).simulate(
        fleet_tenants[T], offload_fraction=1.0))
    assert warned  # 4 racks < 8 entries
    np.testing.assert_allclose(b.delay_ns, a.delay_ns, rtol=1e-6)
    np.testing.assert_array_equal(b.native_ns, a.native_ns)
    assert b.devices_used == 4 and a.devices_used == 1
    want, _ = _falls_back(lambda: _mini_fleet(R, mesh=data_mesh).simulate(
        fleet_tenants[R], offload_fraction=1.0))
    assert (b.devices_used, b.shard_rows, b.padded_fraction) == (
        want.devices_used, want.shard_rows, want.padded_fraction)
    assert b.summary()["devices_used"] == want.summary()["devices_used"] == 4
    _fleet_close(b, want)


def test_fleet_frontier_sharded_one_dispatch(vmesh, data_mesh, fleet_tenants):
    fracs = (0.0, 0.5, 1.0)
    plain = _mini_fleet(T)
    pts = plain.frontier(fleet_tenants[T], offload_fractions=fracs)
    sharded = _mini_fleet(T, mesh=vmesh)
    pts_m, warned = _falls_back(
        lambda: sharded.frontier(fleet_tenants[T], offload_fractions=fracs))
    assert not warned  # 12 planes over 8 entries: K padded to 16, 2 an entry
    assert sharded.dispatch_count == 1
    for a, b in zip(pts, pts_m):
        np.testing.assert_allclose(b.report.delay_ns, a.report.delay_ns, rtol=1e-6)
        assert (b.report.devices_used, b.report.shard_rows, b.report.padded_fraction) == (
            8, 2, 0.25)
    r_pts = _mini_fleet(R, mesh=data_mesh).frontier(fleet_tenants[R], offload_fractions=fracs)
    for b, w in zip(pts_m, r_pts):
        assert (b.report.devices_used, b.report.shard_rows, b.report.padded_fraction) == (
            w.report.devices_used, w.report.shard_rows, w.report.padded_fraction)
        _fleet_close(b.report, w.report)
    # a per-call mesh overrides the fleet's, and 3 entries pad 12 planes to 18
    pts_3 = plain.frontier(fleet_tenants[T], offload_fractions=fracs,
                           mesh=make_data_mesh(3, "cpu", virtual=True))
    assert (pts_3[0].report.devices_used, pts_3[0].report.shard_rows) == (3, 6)
    for a, b in zip(pts, pts_3):
        np.testing.assert_allclose(b.report.delay_ns, a.report.delay_ns, rtol=1e-6)


def test_fleet_hetero_qos_sharded_parity(vmesh, fleet_tenants):
    """Racks on two STT rows and two arbitrations: a launch per row and
    shard, the same numbers."""
    tenants = [dataclasses.replace(t, qos_class=i % 2)
               for i, t in enumerate(fleet_tenants[T])]
    kw = dict(
        rack_overrides=[None, T.TopologyOverride(switches={"fabric_sw": {"stt_ns": 4.0}})] * 2,
        rack_qos=[T.QosSpec(discipline="wfq", class_weights=(4.0, 1.0)),
                  T.QosSpec(discipline="priority")] * 2,
    )
    a = _mini_fleet(T, **kw).simulate(tenants, policy="round_robin")
    b = _mini_fleet(T, mesh=make_data_mesh(2, "cpu", virtual=True), **kw).simulate(
        tenants, policy="round_robin")
    np.testing.assert_allclose(b.delay_ns, a.delay_ns, rtol=1e-6)
    for g, w in zip(b.breakdowns, a.breakdowns):
        np.testing.assert_allclose(g.per_class_congestion_ns, w.per_class_congestion_ns,
                                   rtol=1e-6)
    assert (b.devices_used, b.shard_rows) == (2, 2)


# --------------------------------------------------------------------------- #
# the rules: param_pspecs / input_pspecs against the reference's
# --------------------------------------------------------------------------- #

STRATEGIES = ("dp_tp", "fsdp_tp", "fsdp_tp+moe_dp", "dp_tp+gqa_fix", "fsdp_tp+ep_data")
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}

_shapes_cache = {}


def _shapes(arch):
    """The reference's parameter shapes (``jax.eval_shape``) and the port's
    (a ``meta`` model), once per configuration."""
    if arch not in _shapes_cache:
        r_cfg = r_cfgs.get_config(arch)
        r_shapes = jax.eval_shape(lambda: RModel(r_cfg).init(jax.random.PRNGKey(0)))
        t_cfg = t_cfgs.get_config(arch)
        _shapes_cache[arch] = (r_cfg, r_shapes, t_cfg, TModel(t_cfg, device="meta"))
    return _shapes_cache[arch]


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


def _check_divisibility(shapes, specs, mesh):
    for name, spec in specs.items():
        shape = tuple(shapes[name].shape)
        assert len(spec) == len(shape), name
        for dim, axis in zip(shape, spec):
            if axis is None:
                continue
            size = 1
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                size *= mesh.shape[a]
            assert dim % size == 0, f"{name} {shape} not divisible by {axis}={size}"


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", t_cfgs.ARCH_IDS)
def test_param_pspecs_equal_the_reference(arch, strategy, mesh_name):
    shape, axes = MESHES[mesh_name]
    r_cfg, r_shapes, t_cfg, model = _shapes(arch)
    want = _ref_leaves(r_shr.param_pspecs(r_shapes, r_cfg, r_abstract_mesh(shape, axes),
                                          strategy))
    mesh = make_abstract_mesh(shape, axes)
    got = t_shr.param_pspecs(model, t_cfg, mesh, strategy)
    seen = set()
    for name, spec in got.items():
        key, g = reference_leaf(name)
        ref = tuple(want[key])
        # a per-group slice drops the reference's stacked n_groups entry
        assert tuple(spec) == (ref if g is None else ref[1:]), (name, spec, ref)
        seen.add(key)
    assert seen == set(want)
    _check_divisibility(dict(model.named_parameters()), got, mesh)


def test_model_axis_actually_used():
    """TP shards the big matmuls for every arch (not silently replicated)."""
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    for arch in t_cfgs.ARCH_IDS:
        _, _, cfg, model = _shapes(arch)
        specs = t_shr.param_pspecs(model, cfg, mesh, "dp_tp")
        assert any("model" in str(s) for s in specs.values()), arch


def test_fsdp_shards_more_than_dp():
    _, _, cfg, model = _shapes("mistral-large-123b")
    mesh = make_abstract_mesh((16, 16), ("data", "model"))

    def sharded_fraction(specs):
        return sum("data" in str(s) for s in specs.values()) / len(specs)

    dp = t_shr.param_pspecs(model, cfg, mesh, "dp_tp")
    fs = t_shr.param_pspecs(model, cfg, mesh, "fsdp_tp")
    assert sharded_fraction(fs) > sharded_fraction(dp)
    opt = t_shr.opt_pspecs(fs)
    assert opt["mu"] is fs and opt["nu"] is fs and opt["step"] == t_shr.PartitionSpec()


def _input_leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_input_leaves(v, path + (str(k),)))
        return out
    return {".".join(path): tree}


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", t_cfgs.ARCH_IDS)
def test_input_pspecs_equal_the_reference(arch, shape_name):
    shape, axes = MESHES["2x16x16"]
    r_ins = r_cfgs.input_specs(r_cfgs.get_config(arch), r_cfgs.SHAPES[shape_name])
    want = _ref_leaves(r_shr.input_pspecs(r_ins, r_abstract_mesh(shape, axes)))
    t_ins = t_cfgs.input_specs(t_cfgs.get_config(arch), t_cfgs.SHAPES[shape_name])
    mesh = make_abstract_mesh(shape, axes)
    got = _input_leaves(t_shr.input_pspecs(t_ins, mesh))
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    _check_divisibility(_input_leaves(t_ins), got, mesh)
    if shape_name == "train_4k":
        first = "tokens" if "tokens" in got else "embeds"
        assert got[first][0] == ("pod", "data")


def test_batch_axes():
    assert t_shr.batch_axes(make_abstract_mesh((16, 16), ("data", "model"))) == ("data",)
    assert t_shr.batch_axes(
        make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))) == ("pod", "data")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_named_gives_the_placements_each_spec_says(mesh_name):
    from torch.distributed.tensor import Replicate, Shard

    shape, axes = MESHES[mesh_name]
    mesh = make_abstract_mesh(shape, axes)
    _, _, cfg, model = _shapes("qwen3-0.6b")
    specs = t_shr.param_pspecs(model, cfg, mesh, "fsdp_tp")
    placements = t_shr.tree_named(mesh, specs)
    for name, spec in specs.items():
        got = placements[name]
        assert len(got) == len(axes)
        for axis, p in zip(axes, got):
            dims = [i for i, a in enumerate(spec)
                    if a == axis or (isinstance(a, tuple) and axis in a)]
            assert p == (Shard(dims[0]) if dims else Replicate()), (name, axis, p)
    ins = t_shr.input_pspecs(
        t_cfgs.input_specs(cfg, t_cfgs.SHAPES["train_4k"]), mesh)
    tok = t_shr.named(mesh, ins["tokens"])
    want = [Shard(0) if a in ("pod", "data") else Replicate() for a in axes]
    assert tok == want
