"""Port parity for the scenario sweep (``repro_torch.core.scenario``) and
what it stands on: the stacked topology lowering (``flatten_stack``), the
batched placement (``assign_batch``), the per-row topology leaves of the
analyzer's pricing, and ``_analyze_sweep``'s grouping and chunking.  Each
sweep runs the same workload through ``repro``'s ``ScenarioSuite`` under
JAX on the CPU and the port's with ``device="cpu"`` (the kernels' plain
versions)."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro_torch import core as T
from repro_torch.core import analyzer as t_an
from repro_torch.core.units import ms_to_ns
from repro_torch.kernels import ops as t_ops

torch.set_num_threads(2)

CLASSES = ["param", "grad", "opt_state", "kvcache", "activation"]
C3 = 3  # QoS classes of the qos-axis workload

# --------------------------------------------------------------------------- #
# workloads, built the same way in either package
# --------------------------------------------------------------------------- #


def random_regions(pkg, rng, n, max_bytes=1 << 22):
    rm = pkg.RegionMap()
    for i in range(n):
        r = rm.alloc(
            f"r{i}", int(rng.integers(1, max_bytes)), CLASSES[int(rng.integers(0, 5))]
        )
        r.access_count = float(rng.integers(0, 100))
    return rm


def random_policies(pkg, rng, rm):
    total = int(sum(r.nbytes for r in rm))
    return [
        pkg.LocalOnlyPolicy(),
        pkg.ClassMapPolicy({"opt_state": "cxl_pool2", "kvcache": "cxl_pool1"}),
        pkg.ClassMapPolicy({}),
        pkg.InterleavePolicy(["cxl_pool2", "cxl_pool3"]),
        pkg.InterleavePolicy(
            ["cxl_pool3", "cxl_pool1"],
            weights=[float(rng.integers(1, 5)), float(rng.integers(1, 5))],
            classes=["param", "grad"],
        ),
        pkg.HotnessTieredPolicy(
            "cxl_pool1", local_budget_bytes=int(rng.integers(1, total + 1))
        ),
        pkg.HotnessTieredPolicy(
            "cxl_pool2",
            hotness={f"r{i}": float(rng.integers(0, 50)) for i in range(0, len(rm), 2)},
            local_budget_bytes=total // 3,
        ),
    ]


def workload(pkg, seed=0, n_regions=10, n_phases=4):
    """``tests/test_scenario.py``'s random workload in ``pkg``."""
    rng = np.random.default_rng(seed)
    rm = random_regions(pkg, rng, n_regions)
    phases = [
        pkg.Phase(
            f"ph{p}",
            float(rng.integers(1e10, 8e10)),
            tuple(
                pkg.Access(
                    f"r{int(j)}", float(rng.integers(1e5, 3e6)), bool(rng.random() < 0.4)
                )
                for j in rng.choice(n_regions, size=4, replace=False)
            ),
        )
        for p in range(n_phases)
    ]
    return rm, phases


def suite(pkg, rm, phases, **kw):
    if pkg is T:
        kw.setdefault("hw", T.TPU_V5E)  # the reference's default
        kw.setdefault("device", "cpu")
    return pkg.ScenarioSuite(kw.pop("topology", pkg.figure1_topology()), rm, phases, **kw)


def grid(pkg, rm):
    """``tests/test_scenario.py``'s 48-scenario grid: 4 policies x 3
    overrides x 2 caches x 2 granularities."""
    total = int(sum(r.nbytes for r in rm))
    policies = {
        "local": pkg.LocalOnlyPolicy(),
        "off": pkg.ClassMapPolicy({"opt_state": "cxl_pool2", "kvcache": "cxl_pool1"}),
        "il": pkg.InterleavePolicy(["cxl_pool2", "cxl_pool3"], weights=[1, 3]),
        "hot": pkg.HotnessTieredPolicy("cxl_pool1", local_budget_bytes=total // 2),
    }
    overrides = {
        "base": None,
        "slow": pkg.TopologyOverride(
            pools={"cxl_pool2": {"latency_ns": 420.0}},
            switches={"switch1": {"stt_ns": 30.0}},
        ),
        "thin": pkg.TopologyOverride(
            switches={"switch0": {"bandwidth_gbps": 1.0}, "switch1": {"bandwidth_gbps": 0.5}}
        ),
    }
    caches = {
        "nc": None,
        "c": pkg.DeviceCacheConfig(capacity_bytes=4 << 20, line_bytes=4096, n_sets=64),
    }
    return pkg.ScenarioSuite.cartesian(
        policies, overrides, caches, granularities=[pkg.CACHELINE_BYTES, pkg.PAGE_BYTES]
    )


BREAKDOWN_ARRAYS = (
    "per_pool_latency_ns", "per_switch_congestion_ns", "per_switch_bandwidth_ns",
    "per_host_latency_ns", "per_host_congestion_ns", "per_host_bandwidth_ns",
    "per_class_congestion_ns",
)
TOTAL_OF = {
    "per_pool_latency_ns": "latency_ns", "per_host_latency_ns": "latency_ns",
    "per_switch_congestion_ns": "congestion_ns", "per_host_congestion_ns": "congestion_ns",
    "per_class_congestion_ns": "congestion_ns",
    "per_switch_bandwidth_ns": "bandwidth_ns", "per_host_bandwidth_ns": "bandwidth_ns",
}


def assert_breakdowns_close(got, want, rel=1e-5, tag="", abs_ns=None):
    """Totals within ``rel`` (floor 1 ns); every decomposed array entry
    within ``rel`` of its delay class's total.  The reference sums a
    scenario's per-pool latency in one f32 einsum over ``[B, N, P]``; on
    the layer-mode grid that misses ``analyze_ref``'s f64 sum by 1.0e-5 on
    one entry, where the port (per-epoch products, then the epochs' sum)
    misses it by 1.4e-6, so entries are held against the class total.
    ``abs_ns`` adds an absolute slack per delay class (totals and their
    entries)."""
    abs_ns = abs_ns or {}
    for f in ("latency_ns", "congestion_ns", "bandwidth_ns"):
        g, w = getattr(got, f), getattr(want, f)
        bar = max(rel * max(abs(w), 1.0), abs_ns.get(f, 0.0))
        assert abs(g - w) <= bar, f"{tag} {f}: {g} vs {w}"
    for f in BREAKDOWN_ARRAYS:
        scale = max(abs(getattr(want, TOTAL_OF[f])), 1.0)
        np.testing.assert_allclose(
            getattr(got, f), getattr(want, f), rtol=rel,
            atol=max(rel * scale, abs_ns.get(TOTAL_OF[f], 0.0)), err_msg=f"{tag} {f}",
        )


def solo_ref(pkg, rm, phases, scenario, flat_k, epoch_mode, n_windows=128, hw=None):
    """``analyze_ref`` (f64) over a scenario's own placed trace, epoch by
    epoch with the sweep's effective windows and cache scales (the port's
    oracle; ``tests/test_scenario.py``'s construction)."""
    scenario.policy.place(rm, flat_k)
    traces, _, _ = pkg.synthesize_step_trace(
        phases, rm, hw=hw or T.TPU_V5E, granularity_bytes=scenario.policy.granularity_bytes,
        epoch_mode=epoch_mode,
    )
    model = (
        pkg.DeviceCacheModel(scenario.cache, flat_k, [rm])
        if scenario.cache is not None else None
    )
    ref = None
    for tr in traces:
        span = max(float(tr.t_ns.max()) + 1.0 if tr.n else 0.0, 10_000.0)
        scale = model.observe_scale(tr) if model is not None else None
        bd = pkg.analyze_ref(
            flat_k, tr, bw_window_ns=max(span / n_windows, 1.0), lat_scale=scale,
            n_windows=n_windows,
        )
        ref = bd if ref is None else ref + bd
    return ref


# --------------------------------------------------------------------------- #
# flatten_stack
# --------------------------------------------------------------------------- #

STACK_FIELDS = (
    "pool_latency_ns", "pool_bandwidth_gbps", "pool_media_latency_ns",
    "local_latency_ns", "switch_stt_ns", "switch_bandwidth_gbps",
)


def _overrides(pkg, topo_name):
    if topo_name == "figure1":
        return [
            None,
            pkg.TopologyOverride(
                pools={"cxl_pool1": {"latency_ns": 310.0, "bandwidth_gbps": 12.0}},
                switches={"switch1": {"stt_ns": 9.0, "bandwidth_gbps": 10.0, "latency_ns": 95.0}},
                rc_latency_ns=25.0,
                local_dram_latency_ns=70.0,
            ),
            pkg.TopologyOverride(switches={"switch0": {"bandwidth_gbps": 0.0}}, rc_stt_ns=1.5),
        ]
    return [  # pooled, two hosts, two ECMP replicas of the shared switch
        pkg.TopologyOverride(pools={"shared_pool": {"latency_ns": 400.0}},
                             switches={"fabric_sw": {"stt_ns": 4.0}}),
        None,
        pkg.TopologyOverride(rc_bandwidth_gbps=16.0, rc_latency_ns=3.0),
    ]


def _topology(pkg, name):
    if name == "figure1":
        return pkg.figure1_topology()
    return pkg.pooled_topology(n_hosts=2, multipath=2)


@pytest.mark.parametrize("topo_name", ["figure1", "pooled2_multipath"])
def test_flatten_stack_arrays_bitwise_the_reference(topo_name):
    want = R.flatten_stack(_topology(R, topo_name), _overrides(R, topo_name))
    got = T.flatten_stack(_topology(T, topo_name), _overrides(T, topo_name))
    assert got.k == want.k == 3
    for f in STACK_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    np.testing.assert_array_equal(got.base.route, want.base.route)
    for k in range(3):
        m, w = got.member(k), want.member(k)
        for f in ("pool_latency_ns", "pool_bandwidth_gbps", "switch_stt_ns",
                  "switch_bandwidth_gbps"):
            assert np.array_equal(getattr(m, f), getattr(w, f)), (k, f)
        assert m.local_latency_ns == w.local_latency_ns
    # the Topology method is the same lowering
    meth = _topology(T, topo_name).flatten_stack(_overrides(T, topo_name))
    for f in STACK_FIELDS:
        assert np.array_equal(getattr(meth, f), getattr(got, f))


def test_flatten_stack_base_row_matches_flatten():
    t = T.figure1_topology()
    st = T.flatten_stack(t, [None, None])
    flat = t.flatten()
    for k in range(2):
        np.testing.assert_array_equal(st.pool_latency_ns[k], flat.pool_latency_ns)
        np.testing.assert_array_equal(st.pool_bandwidth_gbps[k], flat.pool_bandwidth_gbps)
        np.testing.assert_array_equal(st.switch_stt_ns[k], flat.switch_stt_ns)
        np.testing.assert_array_equal(st.switch_bandwidth_gbps[k], flat.switch_bandwidth_gbps)
        assert st.local_latency_ns[k] == flat.local_latency_ns


def test_flatten_stack_member_matches_rebuilt_tree():
    t = T.figure1_topology()
    ov = T.TopologyOverride(
        pools={"cxl_pool1": {"latency_ns": 310.0, "bandwidth_gbps": 12.0}},
        switches={"switch1": {"stt_ns": 9.0, "bandwidth_gbps": 10.0, "latency_ns": 95.0}},
        rc_latency_ns=25.0,
        local_dram_latency_ns=70.0,
    )
    st = T.flatten_stack(t, [None, ov])
    pools = [
        dataclasses.replace(p, latency_ns=310.0, bandwidth_gbps=12.0)
        if p.name == "cxl_pool1" else p
        for p in t.pools
    ]
    sws = [
        dataclasses.replace(s, stt_ns=9.0, bandwidth_gbps=10.0, latency_ns=95.0)
        if s.name == "switch1" else s
        for s in t.switches
    ]
    ref = T.Topology(
        pools, sws, rc_latency_ns=25.0, rc_bandwidth_gbps=t.rc_bandwidth_gbps,
        rc_stt_ns=t.rc_stt_ns, local_dram_latency_ns=70.0,
    ).flatten()
    m = st.member(1)
    np.testing.assert_allclose(m.pool_latency_ns, ref.pool_latency_ns)
    np.testing.assert_allclose(m.pool_bandwidth_gbps, ref.pool_bandwidth_gbps)
    np.testing.assert_allclose(m.switch_stt_ns, ref.switch_stt_ns)
    np.testing.assert_allclose(m.switch_bandwidth_gbps, ref.switch_bandwidth_gbps)
    assert m.local_latency_ns == 70.0
    np.testing.assert_array_equal(m.route, ref.route)  # structure untouched


@pytest.mark.parametrize("ov", [
    {"pools": {"nope": {"latency_ns": 1.0}}},
    {"pools": {"cxl_pool": {"capacity_bytes": 1}}},
    {"switches": {"sw": {"latency_ns": -1.0}}},
    {"switches": {"ghost": {"stt_ns": 1.0}}},
])
def test_flatten_stack_rejects_structural_overrides(ov):
    for pkg in (R, T):
        with pytest.raises(ValueError):
            pkg.flatten_stack(pkg.two_tier_topology(), [pkg.TopologyOverride(**ov)])
    with pytest.raises(ValueError):
        T.flatten_stack(T.two_tier_topology(), [])


def test_override_describe_matches_the_reference():
    for a, b in zip(_overrides(T, "figure1"), _overrides(R, "figure1")):
        if a is not None:
            assert a.describe() == b.describe()
    assert T.TopologyOverride().describe() == "base"


# --------------------------------------------------------------------------- #
# batched placement
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(8))
def test_assign_batch_bitwise_the_reference(seed):
    n = int(np.random.default_rng(100 + seed).integers(1, 60))
    rm_r = random_regions(R, np.random.default_rng(seed), n)
    rm_t = random_regions(T, np.random.default_rng(seed), n)
    pols_r = random_policies(R, np.random.default_rng(seed + 50), rm_r)
    pols_t = random_policies(T, np.random.default_rng(seed + 50), rm_t)
    flat_r, flat_t = R.figure1_topology().flatten(), T.figure1_topology().flatten()
    want = R.assign_batch(pols_r + pols_r[:2], R.RegionArrays.from_regions(rm_r), flat_r)
    ra = T.RegionArrays.from_regions(rm_t)
    got = T.assign_batch(pols_t + pols_t[:2], ra, flat_t)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    by_r = R.bytes_per_pool_batch(want, R.RegionArrays.from_regions(rm_r).nbytes, 4)
    by_t = T.bytes_per_pool_batch(got, ra.nbytes, 4)
    assert by_t.dtype == by_r.dtype and np.array_equal(by_t, by_r)
    # each row is the policy's own place() loop
    for k, pol in enumerate(pols_t):
        pol.place(rm_t, flat_t)
        np.testing.assert_array_equal(got[k], rm_t.pool_vector())


def _count_assign_calls(pkg, policies, ra, flat, cls):
    calls = []
    orig = cls.assign
    try:
        cls.assign = lambda self, ra, flat: (calls.append(1), orig(self, ra, flat))[1]
        mat = pkg.assign_batch(policies, ra, flat)
    finally:
        cls.assign = orig
    return mat, len(calls)


def test_assign_batch_dedup_counts_match_the_reference():
    """Repeated policies and ``with_granularity`` copies run the policy's
    ``assign`` once (``tests/test_scenario.py``'s two dedup cases)."""
    counts = {}
    for pkg in (R, T):
        rm = random_regions(pkg, np.random.default_rng(1), 12)
        ra = pkg.RegionArrays.from_regions(rm)
        flat = pkg.figure1_topology().flatten()
        cm = pkg.ClassMapPolicy({"opt_state": "cxl_pool2"})
        il = pkg.InterleavePolicy(["cxl_pool2", "cxl_pool3"], weights=[1, 2])
        a, n_cm = _count_assign_calls(pkg, [cm, pkg.LocalOnlyPolicy(), cm], ra, flat,
                                      pkg.ClassMapPolicy)
        b, n_il = _count_assign_calls(pkg, [il, il.with_granularity(pkg.PAGE_BYTES)], ra,
                                      flat, pkg.InterleavePolicy)
        np.testing.assert_array_equal(a[0], a[2])
        assert (a[1] == 0).all()
        np.testing.assert_array_equal(b[0], b[1])
        counts[pkg.__name__] = (n_cm, n_il, a, b)
    (r_cm, r_il, ra_, rb_), (t_cm, t_il, ta_, tb_) = counts.values()
    assert (t_cm, t_il) == (r_cm, r_il) == (1, 1)
    assert np.array_equal(ta_, ra_) and np.array_equal(tb_, rb_)


# --------------------------------------------------------------------------- #
# per-row topology leaves in the analyzer's pricing
# --------------------------------------------------------------------------- #


def test_per_row_leaves_repeating_one_row_are_bitwise_the_shared_form():
    rng = np.random.default_rng(0)
    B, N, H, P, S, W = 5, 257, 2, 3, 4, 16
    V = H * P
    pool64 = torch.from_numpy(rng.integers(0, P, (B, N)))
    host64 = torch.from_numpy(rng.integers(0, H, (B, N)))
    vp = host64 * P + pool64
    weight = torch.from_numpy(rng.uniform(0.5, 2.0, (B, N)).astype(np.float32))
    valid = torch.from_numpy(rng.random((B, N)) < 0.8)
    scale = torch.from_numpy(rng.uniform(0.2, 1.0, (B, V)).astype(np.float32))
    plat = torch.from_numpy(rng.uniform(80.0, 400.0, V).astype(np.float32))
    llat = torch.tensor(88.9, dtype=torch.float32)
    shared = t_an._latency(pool64, vp, weight, valid, scale, plat, llat, P)
    rows = t_an._latency(pool64, vp, weight, valid, scale, plat.expand(B, V).clone(),
                         llat.expand(B).clone(), P)
    for a, b in zip(shared, rows):
        assert torch.equal(a, b)

    t_end = torch.from_numpy(np.sort(rng.uniform(0, 5e4, (B, N)), axis=1).astype(np.float32))
    nbytes = torch.from_numpy(rng.uniform(64, 4096, (B, N)).astype(np.float32))
    window = torch.from_numpy(rng.uniform(100.0, 4000.0, B).astype(np.float32))
    route = torch.from_numpy((rng.random((V, S)) < 0.5).astype(np.float32))
    bw = torch.tensor([32.0, 0.0, 8.0, 0.5])  # one unconstrained switch
    for hosts in (1, H):
        r = route if hosts == H else route[:P]
        v = vp if hosts == H else pool64
        shared = t_an._bandwidth(t_end, shared_lat := rows[0], v, nbytes, valid, window, r,
                                 bw, W, hosts)
        per_row = t_an._bandwidth(t_end, shared_lat, v, nbytes, valid, window, r,
                                  bw.expand(B, S).clone(), W, hosts)
        for a, b in zip(shared, per_row):
            assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# ScenarioSuite.run against the reference's
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("epoch_mode", ["step", "layer"])
def test_sweep_matches_the_reference_and_analyze_ref(epoch_mode):
    rm_r, ph_r = workload(R, seed=2, n_regions=14, n_phases=5)
    rm_t, ph_t = workload(T, seed=2, n_regions=14, n_phases=5)
    rs = suite(R, rm_r, ph_r, epoch_mode=epoch_mode)
    ts = suite(T, rm_t, ph_t, epoch_mode=epoch_mode)
    scens = grid(T, rm_t)
    want = rs.run(grid(R, rm_r))
    got = ts.run(scens)
    assert ts.dispatch_count == 1  # the whole grid: ONE stacked dispatch
    assert ts.last_unique_cascades == rs.last_unique_cascades == 16
    assert np.array_equal(got.feasible, want.feasible)
    assert np.array_equal(got.utilization, want.utilization)
    assert got.native_ns == want.native_ns and got.qos_classes == want.qos_classes == 1
    assert [s.label() for s in got.scenarios] == [s.label() for s in want.scenarios]
    for k, (g, w) in enumerate(zip(got.breakdowns, want.breakdowns)):
        assert_breakdowns_close(g, w, 1e-5, tag=f"{scens[k].label()} vs repro")
    # each scenario against the port's own f64 oracle, at
    # tests/test_scenario.py's bar
    stack = T.flatten_stack(ts.topology, [s.topology for s in scens])
    for k, s in enumerate(scens):
        ref = solo_ref(T, rm_t, ph_t, s, stack.member(k), epoch_mode)
        g = got.breakdowns[k]
        for f in ("latency_ns", "congestion_ns", "bandwidth_ns"):
            a, b = getattr(g, f), getattr(ref, f)
            assert abs(a - b) / max(abs(b), 1.0) <= 1e-4, f"{s.label()} {f}: {a} vs {b}"
        np.testing.assert_allclose(g.per_pool_latency_ns, ref.per_pool_latency_ns,
                                   rtol=1e-4, atol=1.0)
    # the frontier API reads the same
    assert got.order().tolist() == want.order().tolist()
    assert got.best() == want.best() and got.top(5) == want.top(5)
    assert [set(r) for r in got.table()] == [set(r) for r in want.table()]
    # a second run stages nothing anew and is one more dispatch
    again = ts.run(list(reversed(scens)))
    assert ts.dispatch_count == 2
    for g, w in zip(again.breakdowns, reversed(got.breakdowns)):
        assert g.total_ns == w.total_ns


def test_sweep_stats_split_and_observability():
    rm, ph = workload(T, seed=4)
    ts = suite(T, rm, ph)
    res = ts.run([T.Scenario(policy=T.ClassMapPolicy({"opt_state": "cxl_pool2"}))])
    st = ts.last_dispatch
    assert st.rows == 1 and st.devices_used == 1 and st.shard_rows == 0
    assert st.stage_s >= 0 and st.transfer_s >= 0 and st.compute_s > 0
    assert (res.stage_s, res.transfer_s, res.compute_s) == (st.stage_s, st.transfer_s,
                                                            st.compute_s)
    row = res.table()[0]
    assert row["devices_used"] == 1 and row["shard_rows"] == 0
    assert row["padded_fraction"] == 0.0 and len(row["qos_delay_shares"]) == 1


# --------------------------------------------------------------------------- #
# the qos axis
# --------------------------------------------------------------------------- #


def qos_workload(pkg):
    """``tests/test_qos_cascade.py``'s ``qos_suite`` workload."""
    rng = np.random.default_rng(0)
    rm = pkg.RegionMap()
    for i in range(6):
        r = rm.alloc(f"r{i}", 1 << 20, ("param", "opt_state", "kvcache")[i % 3])
        r.access_count = 10.0
    phases = [
        pkg.Phase(f"ph{p}", 1e12, tuple(
            pkg.Access(f"r{j}", float(rng.integers(1e5, 6e5)), False)
            for j in rng.choice(6, size=3, replace=False)
        ))
        for p in range(3)
    ]
    return rm, phases


def qos_specs(pkg):
    return [
        None,
        pkg.QosSpec(discipline="priority"),
        pkg.QosSpec(discipline="wfq", class_weights=(8.0, 2.0, 1.0)),
        pkg.QosSpec(discipline="wfq", class_weights=(8.0, 2.0, 1.0)),  # duplicate
        pkg.QosSpec(discipline="fifo"),
    ]


def test_sweep_qos_axis_matches_the_reference():
    runs = {}
    for pkg in (R, T):
        rm, ph = qos_workload(pkg)
        s = suite(pkg, rm, ph, region_qos={f"r{i}": i % C3 for i in range(6)})
        pol = pkg.ClassMapPolicy({"opt_state": "cxl_pool2", "kvcache": "cxl_pool1"})
        scens = [pkg.Scenario(policy=pol, name=f"s{i}", qos=q)
                 for i, q in enumerate(qos_specs(pkg))]
        runs[pkg] = (s, s.run(scens))
    (rs, want), (ts, got) = runs[R], runs[T]
    assert ts.dispatch_count == 1
    # duplicated (policy, qos) rows share one cascade, and so do the FIFO
    # spec and no spec on Figure 1's FIFO switches (the same rows)
    assert ts.last_unique_cascades == rs.last_unique_cascades == 3
    assert got.qos_classes == want.qos_classes == C3
    # times near 1.5e7 ns, where the f32 ulp is 1 ns: the reference's
    # max-plus QoS scan and the port's closed-form scans round a start apart
    # by an ulp, so congestion takes the reference's own abs slack of 4 ns
    # (tests/test_qos_cascade.py:470), bandwidth its 1 ns
    for k, (g, w) in enumerate(zip(got.breakdowns, want.breakdowns)):
        assert_breakdowns_close(g, w, 1e-5, tag=f"qos scenario {k}",
                                abs_ns={"congestion_ns": 4.0, "bandwidth_ns": 1.0})
        assert float(np.sum(g.per_class_congestion_ns)) == pytest.approx(
            g.congestion_ns, rel=1e-5, abs=1e-3)
    for gr, wr in zip(got.table(), want.table()):
        assert gr["qos_classes"] == wr["qos_classes"] == C3
        np.testing.assert_allclose(gr["qos_delay_shares"], wr["qos_delay_shares"],
                                   atol=4.0 / max(ms_to_ns(gr["congestion_ms"]), 4.0))
    assert got.breakdowns[2].congestion_ns == got.breakdowns[3].congestion_ns
    # priority moves congestion between the classes
    assert not np.allclose(got.breakdowns[1].per_class_congestion_ns,
                           got.breakdowns[0].per_class_congestion_ns)


def test_sweep_qos_fifo_equals_qos_off():
    """The port's counterpart of ``test_sweep_qos_fifo_matches_qos_off_totals``:
    a no-op and a FIFO ``QosSpec`` under ``region_qos`` reproduce the QoS-off
    totals at the reference's bars."""
    rm, ph = qos_workload(T)
    on_suite = suite(T, rm, ph, region_qos={f"r{i}": i % C3 for i in range(6)})
    pol = T.ClassMapPolicy({"opt_state": "cxl_pool2"})
    on = on_suite.run([T.Scenario(policy=pol, name="none"),
                       T.Scenario(policy=pol, name="fifo", qos=T.QosSpec(discipline="fifo"))])
    off = suite(T, on_suite.regions, on_suite.phases).run(
        [T.Scenario(policy=pol, name="off")]).breakdowns[0]
    for b in on.breakdowns:
        assert b.congestion_ns == pytest.approx(off.congestion_ns, rel=1e-5, abs=4.0)
        assert b.latency_ns == pytest.approx(off.latency_ns, rel=1e-5)
        assert b.bandwidth_ns == pytest.approx(off.bandwidth_ns, rel=1e-4, abs=1.0)


# --------------------------------------------------------------------------- #
# edge cases
# --------------------------------------------------------------------------- #


def test_sweep_zero_bandwidth_is_unconstrained_not_nan():
    res = {}
    for pkg in (R, T):
        rm, ph = workload(pkg, seed=6)
        pol = pkg.ClassMapPolicy({"opt_state": "cxl_pool2"})
        scens = [
            pkg.Scenario(policy=pol, name="base"),
            pkg.Scenario(policy=pol, name="bw0", topology=pkg.TopologyOverride(
                switches={"switch1": {"bandwidth_gbps": 0.0}})),
        ]
        s = suite(pkg, rm, ph)
        res[pkg] = (s, scens, s.run(scens), rm, ph)
    ts, scens, got, rm, ph = res[T]
    assert np.isfinite(got.totals_ns()).all()
    for g, w in zip(got.breakdowns, res[R][2].breakdowns):
        assert_breakdowns_close(g, w, 1e-5)
    stack = T.flatten_stack(ts.topology, [s.topology for s in scens])
    ref = solo_ref(T, rm, ph, scens[1], stack.member(1), "step")
    assert got.breakdowns[1].bandwidth_ns == pytest.approx(ref.bandwidth_ns, rel=1e-4,
                                                           abs=1e-3)
    assert got.best() is not None


def test_sweep_capacity_frontier_as_the_reference():
    out = {}
    for pkg in (R, T):
        flat = pkg.figure1_topology().flatten()
        rm = pkg.RegionMap()
        rm.alloc("huge", int(flat.pool_capacity[1]) + 1, "opt_state")
        rm.alloc("w", 1 << 20, "param")
        phases = [pkg.Phase("p", 1e10, (pkg.Access("huge", 1e6), pkg.Access("w", 1e5)))]
        s = suite(pkg, rm, phases)
        over = pkg.Scenario(policy=pkg.ClassMapPolicy({"opt_state": "cxl_pool1"}), name="over")
        ok = pkg.Scenario(policy=pkg.ClassMapPolicy({"opt_state": "cxl_pool2"}), name="ok")
        r = s.run([over, ok])
        with pytest.raises(ValueError, match="over capacity") as e:
            s.run([over], on_overflow="raise")
        with pytest.raises(ValueError):
            s.run([over], on_overflow="bogus")
        with pytest.raises(ValueError, match="empty"):
            s.run([])
        out[pkg] = (r, str(e.value))
    (want, msg_r), (got, msg_t) = out[R], out[T]
    assert msg_t == msg_r
    assert np.array_equal(got.feasible, want.feasible) and not got.feasible[0]
    assert got.best() == want.best() == 1
    assert got.best(require_feasible=False) == want.best(require_feasible=False) == 0
    assert got.best(max_slowdown=1.0 + 1e-12) is None is want.best(max_slowdown=1.0 + 1e-12)
    assert got.top(2) == want.top(2)
    np.testing.assert_allclose(got.slowdowns(), want.slowdowns(), rtol=1e-6)


def test_successive_halving_as_the_reference():
    out = {}
    for pkg in (R, T):
        rm, ph = workload(pkg, seed=5)
        s = suite(pkg, rm, ph, topology=pkg.two_tier_topology())
        pol = pkg.ClassMapPolicy({"opt_state": "cxl_pool"})

        def mk(bw, pkg=pkg, pol=pol):
            return pkg.Scenario(
                policy=pol,
                topology=pkg.TopologyOverride(
                    switches={"sw": {"bandwidth_gbps": float(bw)}},
                    pools={"cxl_pool": {"bandwidth_gbps": float(bw)}},
                ),
                name=f"bw{bw:.4g}",
            )

        def refine(sc, rnd, mk=mk):
            bw = float(sc.topology.switches["sw"]["bandwidth_gbps"])
            return [mk(bw * 1.3), mk(bw / 1.3)]

        seeds = [mk(b) for b in (4.0, 16.0, 64.0)]
        res0 = s.run(seeds)
        res, best = s.successive_halving(seeds, refine, rounds=2)
        out[pkg] = (s, res0, res, best)
    (rs, r0, rres, rbest), (ts, t0, tres, tbest) = out[R], out[T]
    assert [x.label() for x in tres.scenarios] == [x.label() for x in rres.scenarios]
    assert tbest == rbest
    assert tres.totals_ns()[tbest] <= t0.totals_ns().min() + 1e-6
    assert ts.dispatch_count == rs.dispatch_count == 4
    np.testing.assert_allclose(tres.totals_ns(), rres.totals_ns(), rtol=1e-5)


# --------------------------------------------------------------------------- #
# grouping and chunking in _analyze_sweep
# --------------------------------------------------------------------------- #


def test_one_stt_row_is_one_cascade_call():
    """A latency × policy × cache sweep shares one STT row: one cascade
    call (on the card one launch) for all its unique cascades."""
    rm, ph = workload(T, seed=4)
    ts = suite(T, rm, ph)
    pols = {"cm": T.ClassMapPolicy({"opt_state": "cxl_pool2"}),
            "il": T.InterleavePolicy(["cxl_pool2", "cxl_pool3"])}
    lats = {f"l{v}": T.TopologyOverride(pools={"cxl_pool2": {"latency_ns": float(v)}})
            for v in (150, 300, 450)}
    caches = {"nc": None, "c": T.DeviceCacheConfig(capacity_bytes=1 << 20, line_bytes=4096,
                                                   n_sets=16)}
    scens = T.ScenarioSuite.cartesian(pols, lats, caches, granularities=[64, 4096])
    before = t_ops.plain_launches
    ts.run(scens)
    assert t_ops.plain_launches - before == 1
    assert ts.last_unique_cascades == 4  # 2 policies x 2 granules


def test_each_stt_row_is_one_cascade_call():
    rm, ph = workload(T, seed=4)
    ts = suite(T, rm, ph)
    pol = T.ClassMapPolicy({"opt_state": "cxl_pool2"})
    scens = [
        T.Scenario(policy=pol, topology=T.TopologyOverride(
            switches={"switch1": {"stt_ns": float(s)}}))
        for s in (2.0, 4.0, 8.0)
    ]
    before = t_ops.plain_launches
    res = ts.run(scens)
    assert t_ops.plain_launches - before == 3
    assert ts.last_unique_cascades == 3
    cong = [b.congestion_ns for b in res.breakdowns]
    assert cong[0] <= cong[1] <= cong[2]


@pytest.mark.parametrize("qos", [False, True])
def test_chunking_changes_no_number(monkeypatch, qos):
    rm, ph = workload(T, seed=2, n_regions=14, n_phases=5)
    kw = {"region_qos": {f"r{i}": i % 2 for i in range(14)}} if qos else {}
    scens = grid(T, rm)
    if qos:
        scens = [dataclasses.replace(s, qos=T.QosSpec(discipline="wfq",
                                                      class_weights=(1.0 + k % 3, 1.0)))
                 for k, s in enumerate(scens)]
    whole = suite(T, rm, ph, epoch_mode="layer", **kw).run(scens)
    monkeypatch.setattr(t_an, "SWEEP_CHUNK_EVENTS", 1)  # one scenario a chunk
    chunked = suite(T, rm, ph, epoch_mode="layer", **kw).run(scens)
    for a, b in zip(whole.breakdowns, chunked.breakdowns):
        assert (a.latency_ns, a.congestion_ns, a.bandwidth_ns) == (
            b.latency_ns, b.congestion_ns, b.bandwidth_ns)
        for f in BREAKDOWN_ARRAYS:
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_multi_host_topology_sweep_matches_the_reference():
    """A sweep over a two-host topology stages every event on host 0 and
    runs the host-segmented cascade."""
    out = {}
    for pkg in (R, T):
        rm, ph = workload(pkg, seed=7)
        topo = pkg.pooled_topology(n_hosts=2)
        s = suite(pkg, rm, ph, topology=topo)
        scens = [
            pkg.Scenario(policy=pkg.ClassMapPolicy({c: "shared_pool"}), name=c,
                         topology=ov)
            for c in ("opt_state", "param")
            for ov in (None, pkg.TopologyOverride(switches={"fabric_sw": {"stt_ns": 6.0}}))
        ]
        out[pkg] = s.run(scens)
    for g, w in zip(out[T].breakdowns, out[R].breakdowns):
        assert_breakdowns_close(g, w, 1e-5)


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #


def test_mesh_raises():
    rm, ph = workload(T, seed=4)
    with pytest.raises(NotImplementedError, match="later slice"):
        suite(T, rm, ph, mesh=object())
    ts = suite(T, rm, ph)
    with pytest.raises(NotImplementedError, match="later slice"):
        ts.run([T.Scenario(policy=T.LocalOnlyPolicy())], mesh=object())


def test_cartesian_names_and_order_match_the_reference():
    rm_r, _ = workload(R, seed=2, n_regions=14)
    rm_t, _ = workload(T, seed=2, n_regions=14)
    a = [(s.name, s.label(), s.policy.granularity_bytes) for s in grid(T, rm_t)]
    b = [(s.name, s.label(), s.policy.granularity_bytes) for s in grid(R, rm_r)]
    assert a == b
    unnamed = T.Scenario(policy=T.ClassMapPolicy({"opt_state": "cxl_pool2"}),
                         topology=T.TopologyOverride(rc_stt_ns=1.0),
                         cache=T.DeviceCacheConfig(capacity_bytes=2 << 20),
                         qos=T.QosSpec(discipline="priority"))
    ref = R.Scenario(policy=R.ClassMapPolicy({"opt_state": "cxl_pool2"}),
                     topology=R.TopologyOverride(rc_stt_ns=1.0),
                     cache=R.DeviceCacheConfig(capacity_bytes=2 << 20),
                     qos=R.QosSpec(discipline="priority"))
    assert unnamed.label() == ref.label()
