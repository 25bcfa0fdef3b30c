"""Port parity for QoS switch arbitration (priority / WFQ / FIFO per
switch): the plain QoS cascades, the analyzer's QoS branch, QoS fabrics and
attach, and ``QosSpec``, each against the reference on the same inputs.

Bars are those of ``tests/test_qos_cascade.py``: slot indices exactly equal,
final times to rtol 1e-6, per-stage per-class delays to rtol 1e-5 / atol
1e-3.  On integer traces every product and sum is exact in f32, so the
port's closed-form per-class scans and the reference's max-plus scans agree
bitwise, tie-heavy traces included: the port keeps the reference's stable
tie rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import analyzer as r_an
from repro.core import topology as r_topo
from repro.kernels import ref as r_ref
from repro.kernels.congestion import qos_congestion_cascade as r_pallas
from repro_torch import core as T
from repro_torch.core import analyzer as t_an
from repro_torch.core import topology as t_topo
from repro_torch.core.units import ns_to_s
from repro_torch.interop import flat_topology_from_arrays, mem_events_from_arrays
from repro_torch.kernels import congestion as t_kernel
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(2)

C = 3
WEIGHTS = (4.0, 2.0, 1.0)
DISCIPLINES = {
    "mixed": ("wfq", "priority", "fifo"),
    "priority": ("priority",) * 3,
    "wfq": ("wfq",) * 3,
    "fifo": ("fifo",) * 3,
}


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _port_flat(flat):
    return flat_topology_from_arrays(_fields(flat))


def _port_events(tr):
    return mem_events_from_arrays(_fields(tr))


def _qos_chain(pkg, disciplines, weights=WEIGHTS):
    """Depth-3 switch chain with per-switch disciplines (the reference's QoS
    test topology), built in either package; the RC is a fourth stage."""
    switches = [
        pkg.Switch(
            f"sw{d}", 70.0, 64.0 - 8.0 * d, 2.0 + d,
            parent=f"sw{d - 1}" if d else None, discipline=disc,
            class_weights=weights if disc == "wfq" else None,
        )
        for d, disc in enumerate(disciplines)
    ]
    last = f"sw{len(switches) - 1}"
    return pkg.Topology(
        pools=[
            pkg.Pool("local", 88.9, 76.8, 1 << 36, is_local=True),
            pkg.Pool("far1", 180.0, 32.0, 1 << 38, parent=last),
            pkg.Pool("far2", 200.0, 32.0, 1 << 38, parent=last),
        ],
        switches=switches,
        n_qos_classes=len(weights),
    )


def _times(rng, n, ties):
    """Integer arrival times: unique below 4n (tie-free, still queueing) or
    drawn with replacement from a small span (tie-heavy)."""
    if ties:
        t = rng.integers(0, max(2, n // 8), n)
    else:
        t = rng.choice(np.arange(1, 4 * n), size=n, replace=False)
    return np.sort(t).astype(np.float32)


def _stage_tables(flat):
    order = list(r_an.plan_cascade(flat)[2])
    return (
        flat.switch_stt_ns[order].astype(np.float32),
        np.asarray(flat.discipline_codes())[order].astype(np.int32),
        flat.class_weight_table()[order].astype(np.float32),
    )


def _batch(flat, n, seed, ties):
    """Four rows of one batch whose fold decisions differ: route words from
    the topology (every remote event crosses every stage, so WFQ stages
    elide their folds), random route words (masks differ), a row padded at
    the tail as the stager pads, and a sparse row that never queues."""
    rng = np.random.default_rng(seed)
    bits_pool = r_an.plan_cascade(flat)[0]
    s = flat.n_switches
    big = np.float32(np.finfo(np.float32).max / 4)
    t = np.stack([_times(rng, n, ties) for _ in range(3)]
                 + [np.sort(rng.choice(np.arange(1, 1 << 22), n, replace=False))
                    .astype(np.float32)])
    bits = np.stack([
        bits_pool[rng.integers(0, flat.n_pools, n)],
        rng.integers(0, 1 << s, n),
        bits_pool[rng.integers(0, flat.n_pools, n)],
        bits_pool[rng.integers(0, flat.n_pools, n)],
    ]).astype(np.int32)
    qos = rng.integers(0, C, (4, n)).astype(np.int32)
    pad = n // 3  # row 2: its last third is padding
    t[2, -pad:], bits[2, -pad:], qos[2, -pad:] = big, 0, 0
    return t, bits, qos


def _torch_cascade(t, bits, stts, qos, disc, w, hosts=None, n_hosts=1):
    out = t_ref.qos_cascade_dyn(
        torch.from_numpy(t), torch.from_numpy(bits), torch.from_numpy(stts),
        torch.from_numpy(qos), torch.from_numpy(disc), torch.from_numpy(w),
        hosts=None if hosts is None else torch.from_numpy(hosts), n_hosts=n_hosts,
    )
    return tuple(x.numpy() for x in out)


_r_dyn = jax.jit(r_ref.qos_cascade_dyn, static_argnames=("n_hosts",))


def _reference_rows(t, bits, stts, qos, disc, w, hosts=None, n_hosts=1):
    """The reference's 1-D qos_cascade_dyn (jitted), row by row."""
    outs = [
        _r_dyn(
            jnp.asarray(t[r]), jnp.asarray(bits[r]), jnp.asarray(stts),
            jnp.asarray(qos[r]), jnp.asarray(disc), jnp.asarray(w),
            hosts=None if hosts is None else jnp.asarray(hosts[r]), n_hosts=n_hosts,
        )
        for r in range(t.shape[0])
    ]
    return tuple(np.stack([np.asarray(o[k]) for o in outs]) for k in range(3))


def _assert_qos_close(got, want):
    tf_g, idx_g, psd_g = got
    tf_w, idx_w, psd_w = want
    np.testing.assert_array_equal(idx_g, idx_w)
    np.testing.assert_allclose(tf_g, tf_w, rtol=1e-6)
    np.testing.assert_allclose(psd_g, psd_w, rtol=1e-5, atol=1e-3)


# --------------------------------------------------------------------------- #
# the plain QoS cascade against the reference
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("ties", [False, True], ids=["tie_free", "ties"])
@pytest.mark.parametrize("name", list(DISCIPLINES))
def test_plain_qos_cascade_matches_reference(name, ties):
    flat = _qos_chain(r_topo, DISCIPLINES[name]).flatten()
    stts, disc, w = _stage_tables(flat)
    t, bits, qos = _batch(flat, 1500, seed=5, ties=ties)
    got = _torch_cascade(t, bits, stts, qos, disc, w)
    assert got[2].shape == (4, len(stts), 1, C)
    _assert_qos_close(got, _reference_rows(t, bits, stts, qos, disc, w))
    assert got[2][:3].sum() > 0  # the dense rows queue


@pytest.mark.parametrize("ties", [False, True], ids=["tie_free", "ties"])
@pytest.mark.parametrize("zero_at", [1, 3], ids=["middle", "last"])
def test_zero_service_stage_is_an_identity(zero_at, ties):
    """A stage with zero service delays nothing (and, last, elides the
    fold before it)."""
    flat = _qos_chain(r_topo, ("wfq", "wfq", "priority")).flatten()
    stts, disc, w = _stage_tables(flat)
    stts = stts.copy()
    stts[zero_at] = 0.0
    t, bits, qos = _batch(flat, 1200, seed=6, ties=ties)
    got = _torch_cascade(t, bits, stts, qos, disc, w)
    assert not got[2][:, zero_at].any()
    _assert_qos_close(got, _reference_rows(t, bits, stts, qos, disc, w))


def _sparse_times(rng, n):
    """Unique integers below 2**20 (the reference's tie-free trace): sparse
    enough that the cascade itself creates no ties, on which the Pallas
    kernel's and the static spec's changed-run-first merges agree with the
    stable fold."""
    return np.sort(rng.choice(np.arange(1, 1 << 20), size=n, replace=False)).astype(np.float32)


def test_plain_qos_cascade_matches_pallas_interpret():
    flat = _qos_chain(r_topo, DISCIPLINES["mixed"]).flatten()
    stts, disc, w = _stage_tables(flat)
    rng = np.random.default_rng(9)
    n = 3000
    t = _sparse_times(rng, n)
    bits = r_an.plan_cascade(flat)[0][rng.integers(0, flat.n_pools, n)].astype(np.int32)
    qos = rng.integers(0, C, n).astype(np.int32)
    tf_k, idx_k, psd_k = r_pallas(
        jnp.asarray(t), jnp.asarray(bits), jnp.asarray(qos), jnp.asarray(stts),
        jnp.asarray(disc), jnp.asarray(w), block=1024, interpret=True,
    )
    got = _torch_cascade(t[None], bits[None], stts, qos[None], disc, w)
    want = (np.asarray(tf_k)[None], np.asarray(idx_k)[None], np.asarray(psd_k)[None, :, None])
    _assert_qos_close(got, want)


def test_all_fifo_static_spec_degenerates_bitwise():
    """With every stage FIFO the static spec takes the FIFO cascade's path:
    final times and slot indices bitwise equal to serial_queue_cascade's,
    and the reference's static spec's, delays split by class."""
    rng = np.random.default_rng(3)
    n, s = 4000, 3
    t = np.sort(rng.uniform(0, 1e5, (2, n)), axis=1).astype(np.float32)
    bits = rng.integers(0, 1 << s, (2, n)).astype(np.int32)
    qos = rng.integers(0, C, (2, n)).astype(np.int32)
    stts = np.asarray([4.0, 2.0, 0.5], np.float32)
    w = np.ones((s, C), np.float32)
    tq, iq, pq = (x.numpy() for x in t_ref.qos_serial_queue_cascade(
        torch.from_numpy(t), torch.from_numpy(bits), torch.from_numpy(stts),
        torch.from_numpy(qos), torch.from_numpy(w), ("fifo",) * s,
    ))
    tf, idf, pf = (x.numpy() for x in t_ref.serial_queue_cascade(
        torch.from_numpy(t), torch.from_numpy(bits), torch.from_numpy(stts),
    ))
    np.testing.assert_array_equal(tq, tf)
    np.testing.assert_array_equal(iq, idf)
    assert pq.shape == (2, s, C)
    np.testing.assert_allclose(pq.sum(-1), pf, rtol=1e-6)
    for r in range(2):
        tr, ir, pr = r_ref.qos_serial_queue_cascade(
            jnp.asarray(t[r]), jnp.asarray(bits[r]), jnp.asarray(stts),
            jnp.asarray(qos[r]), jnp.asarray(w), ("fifo",) * s,
        )
        np.testing.assert_array_equal(tq[r], np.asarray(tr))
        np.testing.assert_array_equal(iq[r], np.asarray(ir))
        np.testing.assert_allclose(pq[r], np.asarray(pr), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("name", ["mixed", "priority", "wfq"])
def test_static_spec_matches_reference_and_dyn(name):
    """The static-discipline spec against the reference's, with hosts, and
    against the data-driven cascade on a sparse tie-free trace."""
    flat = _qos_chain(r_topo, DISCIPLINES[name]).flatten()
    stts, disc, w = _stage_tables(flat)
    rng = np.random.default_rng(11)
    n = 2000
    t = _sparse_times(rng, n)
    bits = r_an.plan_cascade(flat)[0][rng.integers(0, flat.n_pools, n)].astype(np.int32)
    qos = rng.integers(0, C, n).astype(np.int32)
    hosts = rng.integers(0, 2, n).astype(np.int32)
    names = tuple(r_topo.DISCIPLINES[d] for d in disc)
    tg, ig, pg = (x.numpy() for x in t_ref.qos_serial_queue_cascade(
        torch.from_numpy(t), torch.from_numpy(bits), torch.from_numpy(stts),
        torch.from_numpy(qos), torch.from_numpy(w), names,
        hosts=torch.from_numpy(hosts), n_hosts=2,
    ))
    tw, iw, pw = r_ref.qos_serial_queue_cascade(
        jnp.asarray(t), jnp.asarray(bits), jnp.asarray(stts), jnp.asarray(qos),
        jnp.asarray(w), names, hosts=jnp.asarray(hosts), n_hosts=2,
    )
    np.testing.assert_array_equal(ig, np.asarray(iw))
    np.testing.assert_allclose(tg, np.asarray(tw), rtol=1e-6)
    np.testing.assert_allclose(pg, np.asarray(pw), rtol=1e-5, atol=1e-3)
    td, _, pd = _torch_cascade(t[None], bits[None], stts, qos[None], disc, w)
    np.testing.assert_allclose(td[0], tg, rtol=1e-6)
    np.testing.assert_allclose(pd[0, :, 0], pg.sum(1), rtol=1e-5, atol=1e-3)


def test_static_spec_rejects_unknown_disciplines():
    z = torch.zeros(1, 4)
    i32 = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown discipline"):
        t_ref.qos_serial_queue_cascade(z, i32, torch.ones(1), i32, torch.ones(1, 2), ("strict",))
    with pytest.raises(ValueError, match="disciplines for"):
        t_ref.qos_serial_queue_cascade(z, i32, torch.ones(2), i32, torch.ones(2, 2), ("fifo",))


def test_service_table_inflates_wfq_only():
    stts = torch.tensor([2.0, 3.0, 4.0])
    disc = torch.tensor([t_ref.DISC_WFQ, t_ref.DISC_PRIORITY, t_ref.DISC_FIFO], dtype=torch.int32)
    w = torch.tensor([WEIGHTS] * 3)
    table = t_ref.qos_service_table(stts, disc, w)
    np.testing.assert_array_equal(table.numpy(), [[3.5, 7.0, 14.0], [3.0] * 3, [4.0] * 3])


# --------------------------------------------------------------------------- #
# host-segmented attribution
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(8))
def test_host_segmented_sums_match_reference(seed):
    """Under tie-heavy traces the host-segmented delays sum to the
    unsegmented ones and match the reference's qos_cascade_dyn(hosts=)."""
    rng = np.random.default_rng(seed)
    n, tie_span = 500 + 300 * seed, 64 + 16 * seed
    t = np.sort(rng.integers(0, tie_span, (2, n)), axis=1).astype(np.float32)
    bits = rng.integers(0, 1 << 3, (2, n)).astype(np.int32)
    qos = rng.integers(0, C, (2, n)).astype(np.int32)
    hosts = rng.integers(0, 4, (2, n)).astype(np.int32)
    stts = np.asarray([4.0, 2.0, 1.0], np.float32)
    codes = r_topo.DISCIPLINE_CODES
    disc = np.asarray([codes["wfq"], codes["priority"], codes["fifo"]], np.int32)
    w = np.tile(np.asarray(WEIGHTS, np.float32), (3, 1))
    tf_u, idx_u, psd_u = _torch_cascade(t, bits, stts, qos, disc, w)
    got = _torch_cascade(t, bits, stts, qos, disc, w, hosts=hosts, n_hosts=4)
    np.testing.assert_array_equal(got[0], tf_u)
    np.testing.assert_array_equal(got[1], idx_u)
    np.testing.assert_allclose(got[2].sum(2), psd_u[:, :, 0], rtol=1e-5, atol=1e-2)
    want = _reference_rows(t, bits, stts, qos, disc, w, hosts=hosts, n_hosts=4)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-2)


# --------------------------------------------------------------------------- #
# the DES oracle
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["mixed", "priority", "wfq"])
def test_per_event_final_times_match_both_des(name):
    flat = _qos_chain(r_topo, DISCIPLINES[name]).flatten()
    rng = np.random.default_rng(7)
    n = 4000
    ev = R.MemEvents.build(
        t_ns=_times(rng, n, ties=False).astype(np.float64),
        pool=rng.integers(0, flat.n_pools, n), bytes_=np.full(n, 64.0),
        qos=rng.integers(0, C, n),
    )
    stts, disc, w = _stage_tables(flat)
    bits = r_an.plan_cascade(flat)[0][ev.pool].astype(np.int32)
    tf, idx, _ = _torch_cascade(
        ev.t_ns.astype(np.float32)[None], bits[None], stts,
        ev.qos.astype(np.int32)[None], disc, w,
    )
    out = np.empty(n, np.float64)
    out[idx[0]] = tf[0]
    port_des = t_an.FineGrainedSimulator(_port_flat(flat), bandwidth_mode="stt")
    ref_des = r_an.FineGrainedSimulator(flat, bandwidth_mode="stt")
    got_des = port_des.final_times(_port_events(ev), presorted=True)
    np.testing.assert_allclose(out, got_des, rtol=1e-5)
    np.testing.assert_allclose(got_des, ref_des.final_times(ev, presorted=True), rtol=1e-12)


# --------------------------------------------------------------------------- #
# the analyzer's QoS branch
# --------------------------------------------------------------------------- #


def _chain_trace(flat, n, seed):
    rng = np.random.default_rng(seed)
    return R.MemEvents.build(
        t_ns=_times(rng, n, ties=False).astype(np.float64),
        pool=rng.integers(0, flat.n_pools, n), bytes_=np.full(n, 64.0),
        qos=rng.integers(0, C, n),
    )


@pytest.mark.parametrize("name", ["mixed", "priority", "wfq"])
def test_analyzer_matches_reference_and_oracle_per_class(name):
    flat = _qos_chain(r_topo, DISCIPLINES[name]).flatten()
    traces = [_chain_trace(flat, 2000 + 500 * i, seed=13 + i) for i in range(2)]
    an = t_an.EpochAnalyzer(_port_flat(flat), device="cpu")
    assert an.qos_on
    got = an.analyze_batch([_port_events(tr) for tr in traces])
    want = r_an.EpochAnalyzer(flat).analyze_batch(traces)
    ref = r_an.analyze_ref(flat, traces[0]) + r_an.analyze_ref(flat, traces[1])
    assert got.per_class_congestion_ns.shape == (C,)
    assert got.congestion_ns > 0
    for other in (want, ref):
        assert got.congestion_ns == pytest.approx(other.congestion_ns, rel=1e-6)
        np.testing.assert_allclose(
            got.per_class_congestion_ns, other.per_class_congestion_ns, rtol=1e-6
        )
    assert got.latency_ns == pytest.approx(want.latency_ns, rel=1e-6)
    assert got.bandwidth_ns == pytest.approx(want.bandwidth_ns, rel=1e-5, abs=1e-2)
    np.testing.assert_allclose(
        got.per_switch_congestion_ns, want.per_switch_congestion_ns, rtol=1e-6
    )
    assert float(got.per_class_congestion_ns.sum()) == pytest.approx(
        got.congestion_ns, rel=1e-6
    )


def test_fabric_qos_analyzer_matches_reference_per_host_and_class():
    flat = r_topo.pooled_topology(
        n_hosts=3, discipline="priority", class_weights=(1.0, 1.0)
    ).flatten()
    rng = np.random.default_rng(21)
    traces = []
    for k in range(2):
        merged = R.merge_host_traces([
            R.synthetic_trace(600, flat.n_pools, epoch_ns=2e5, seed=30 + 3 * k + h,
                              burstiness=0.8)
            for h in range(3)
        ])
        traces.append(merged.with_qos(rng.integers(0, 2, merged.n)))
    got = t_an.EpochAnalyzer(_port_flat(flat), device="cpu").analyze_batch(
        [_port_events(tr) for tr in traces]
    )
    want = r_an.EpochAnalyzer(flat).analyze_batch(traces)
    for f in ("per_class_congestion_ns", "per_host_congestion_ns",
              "per_host_latency_ns", "per_switch_congestion_ns"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-5, atol=1e-2,
                                   err_msg=f)
    assert got.congestion_ns == pytest.approx(want.congestion_ns, rel=1e-5)
    assert got.congestion_ns > 0
    ref = r_an.analyze_ref(flat, traces[0]) + r_an.analyze_ref(flat, traces[1])
    np.testing.assert_allclose(got.per_class_congestion_ns, ref.per_class_congestion_ns,
                               rtol=5e-3)
    np.testing.assert_allclose(got.per_host_congestion_ns, ref.per_host_congestion_ns,
                               rtol=5e-3)


def test_analyzer_runs_the_plain_qos_cascade_on_cpu():
    flat = _port_flat(_qos_chain(r_topo, DISCIPLINES["mixed"]).flatten())
    tr = _port_events(_chain_trace(flat, 500, seed=2))
    before = (t_ops.plain_launches, t_kernel.qos_launches, t_kernel.qos_hosts_launches)
    t_an.EpochAnalyzer(flat, device="cpu").analyze_batch([tr, tr])
    after = (t_ops.plain_launches, t_kernel.qos_launches, t_kernel.qos_hosts_launches)
    assert after == (before[0] + 1, before[1], before[2])


def test_fifo_topology_keeps_the_fifo_path(monkeypatch):
    """A FIFO topology reports a per-class axis of length 1 and never
    reaches the QoS cascade."""
    def refuse(*args, **kwargs):
        raise AssertionError("the QoS cascade ran on a FIFO topology")

    monkeypatch.setattr(t_ref, "qos_cascade_dyn", refuse)
    flat = t_topo.figure1_topology().flatten()
    tr = T.synthetic_trace(1500, flat.n_pools, epoch_ns=1e5, seed=1, burstiness=0.6)
    an = t_an.EpochAnalyzer(flat, device="cpu")
    assert not an.qos_on
    bd = an.analyze(tr)
    assert bd.per_class_congestion_ns.shape == (1,)
    assert float(bd.per_class_congestion_ns[0]) == pytest.approx(bd.congestion_ns, rel=1e-6)


def test_qos_on_the_unfused_loop_raises_as_the_reference():
    for pkg, kw in ((r_topo, {}), (t_topo, {"device": "cpu"})):
        flat = pkg.pooled_topology(n_hosts=32, discipline="priority").flatten()
        an_mod = r_an if pkg is r_topo else t_an
        with pytest.raises(ValueError, match="require the fused cascade"):
            an_mod.EpochAnalyzer(flat, **kw)
    small = t_topo.pooled_topology(n_hosts=2, discipline="wfq",
                                   class_weights=(2.0, 1.0)).flatten()
    with pytest.raises(ValueError, match="require the fused cascade"):
        t_an.EpochAnalyzer(small, device="cpu", fused=False)


# --------------------------------------------------------------------------- #
# FabricSession and attach on QoS topologies
# --------------------------------------------------------------------------- #


def _wfq_tenant(pkg, name, seed, qos):
    """tests/test_qos_cascade.py's fabric tenant, built in either package,
    with 1e10 flops per phase instead of 1e12: the epoch then spans about
    1e5 ns, where every f32 time and service sum is exact.  (At 1e12 flops
    it spans 8.4e6 ns, where the f32 ulp is 1 ns and the reference's max-plus
    scan and the port's closed-form scans round an event's start apart by an
    ulp: 4789 against 4800 ns of congestion, analyze_ref's being 4800.)"""
    rng = np.random.default_rng(seed)
    rm = pkg.RegionMap()
    for i in range(3):
        rm.alloc(f"{name}/r{i}", 1 << 20, "param")
    phases = [
        pkg.Phase(f"{name}/p{p}", 1e10, tuple(
            pkg.Access(f"{name}/r{j}", float(rng.integers(1e5, 8e5)), False)
            for j in range(3)))
        for p in range(2)
    ]
    return pkg.Tenant(name=name, phases=phases, regions=rm,
                      policy=pkg.InterleavePolicy(["cxl1", "cxl2"]), qos_class=qos)


def _wfq_session(pkg, weights, **kw):
    topo = pkg.Topology(
        pools=[pkg.Pool("dram", 100.0, 100.0, 1 << 38, is_local=True),
               pkg.Pool("cxl1", 250.0, 64.0, 1 << 38, parent="sw0"),
               pkg.Pool("cxl2", 300.0, 48.0, 1 << 38, parent="sw0")],
        switches=[pkg.Switch("sw0", 70.0, 64.0, 2.0, discipline="wfq",
                             class_weights=weights)],
    )
    return pkg.FabricSession(
        topo, [_wfq_tenant(pkg, "lat_crit", 0, 0), _wfq_tenant(pkg, "batch", 1, 1)],
        hw=pkg.TPU_V5E, **kw,
    )


def test_wfq_fabric_session_matches_reference_and_weights_shift_shares():
    reports = {}
    for tag, w in (("protect0", (4.0, 1.0)), ("protect1", (1.0, 8.0))):
        want_s = _wfq_session(R, w)
        got_s = _wfq_session(T, w, device="cpu")
        want, got = want_s.run(1), got_s.run(1)
        want_s.close()
        got_s.close()
        assert got.summary()["qos_classes"] == want.summary()["qos_classes"] == 2
        assert got.congestion_s == pytest.approx(want.congestion_s, rel=1e-5)
        np.testing.assert_allclose(got.per_class_congestion_ns,
                                   want.per_class_congestion_ns, rtol=1e-5, atol=1e-2)
        np.testing.assert_allclose(got.qos_delay_shares(), want.qos_delay_shares(),
                                   rtol=1e-5, atol=1e-9)
        for g, r in zip(got.hosts, want.hosts):
            assert g.congestion_s == pytest.approx(r.congestion_s, rel=1e-5)
        merged = got_s._round_cache[0]
        ref = t_an.analyze_ref(got_s.flat, merged[0])
        for tr in merged[1:]:
            ref = ref + t_an.analyze_ref(got_s.flat, tr)
        np.testing.assert_allclose(got.per_class_congestion_ns, ref.per_class_congestion_ns,
                                   rtol=1e-6)
        assert ns_to_s(float(np.sum(got.per_class_congestion_ns))) == pytest.approx(
            got.congestion_s, rel=1e-9, abs=1e-15
        )
        reports[tag] = got
    # deprioritizing class 0 raises its share of the queueing delay
    assert reports["protect1"].qos_delay_shares()[0] > reports["protect0"].qos_delay_shares()[0]


def test_fabric_rejects_out_of_range_tenant_class():
    rm = T.RegionMap()
    rm.alloc("r0", 1 << 20, "param")
    t = T.Tenant(name="t", phases=[T.Phase("p", 1e12, ())], regions=rm,
                 policy=T.LocalOnlyPolicy(), qos_class=5)
    with pytest.raises(ValueError, match="qos_class=5"):
        T.FabricSession(T.pooled_topology(n_hosts=1), [t], device="cpu")


def _priority_figure1(pkg):
    fig = pkg.figure1_topology()
    return pkg.Topology(
        fig.pools, [dataclasses.replace(s, discipline="priority") for s in fig.switches],
        fig.rc_latency_ns, fig.rc_bandwidth_gbps, fig.rc_stt_ns, fig.local_dram_latency_ns,
        n_qos_classes=2,
    )


def test_attach_on_a_priority_topology_matches_reference_and_fifo():
    """CXLMemSim on Figure 1 with strict-priority switches: every traced
    event is class 0, so the report equals the reference's and the FIFO
    topology's, with class 1 carrying nothing."""
    from repro.configs import qwen3_0_6b as r_qwen
    from repro.models.phases import build_regions_and_phases as r_build
    from repro_torch.configs import qwen3_0_6b as t_qwen
    from repro_torch.models import build_regions_and_phases as t_build

    policy = {"opt_state": "cxl_pool2", "grad": "cxl_pool1"}
    kw = dict(max_events_per_access=256, check_capacity=False)
    regions, phases = r_build(r_qwen.SMOKE, "train", batch=2, seq=64)
    sim = R.CXLMemSim(_priority_figure1(R), R.ClassMapPolicy(policy),
                      epoch=R.EpochSchedule("layer"), hw=R.TPU_V5E, **kw)
    with sim.attach(lambda: None, phases, regions) as prog:
        want = prog.run(2)
    reports = []
    for topo in (_priority_figure1(T), T.figure1_topology()):
        regions, phases = t_build(t_qwen.SMOKE, "train", batch=2, seq=64)
        sim = T.CXLMemSim(topo, T.ClassMapPolicy(policy), epoch=T.EpochSchedule("layer"),
                          hw=T.TPU_V5E, device="cpu", **kw)
        with sim.attach(lambda: None, phases, regions) as prog:
            reports.append(prog.run(2))
    got, fifo = reports
    assert got.qos_classes == 2 and got.congestion_s > 0
    for f in ("latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-5), f
        assert getattr(got, f) == pytest.approx(getattr(fifo, f), rel=1e-6), f
    np.testing.assert_allclose(got.per_class_congestion_ns, want.per_class_congestion_ns,
                               rtol=1e-5, atol=1e-2)
    assert got.per_class_congestion_ns[1] == 0.0
    assert got.qos_delay_shares() == [1.0, 0.0]


# --------------------------------------------------------------------------- #
# QosSpec
# --------------------------------------------------------------------------- #


def test_qos_spec_validation_matches_reference():
    for pkg in (R, T):
        with pytest.raises(ValueError, match="unknown discipline"):
            pkg.QosSpec(discipline="strict")
        with pytest.raises(ValueError, match="positive"):
            pkg.QosSpec(discipline="wfq", class_weights=(1.0, -2.0))
        with pytest.raises(ValueError, match="unknown switch"):
            pkg.QosSpec(switch_disciplines=(("nope", "wfq"),)).apply(
                np.zeros(2, np.int32), np.ones((2, 2)), ["a", "b"]
            )
        assert pkg.QosSpec(discipline="wfq", class_weights=(2.0, 1.0)).n_classes() == 2
        assert "wfq" in pkg.QosSpec(discipline="wfq").describe()


@pytest.mark.parametrize("spec", [
    dict(switch_disciplines=(("sw", "priority"),), switch_weights=(("sw", (3.0, 1.0)),)),
    dict(discipline="wfq", class_weights=(8.0, 2.0)),
    dict(discipline="priority", switch_disciplines=(("other", "fifo"),),
         switch_weights=(("sw@1", (5.0, 1.0)),)),
    dict(),
], ids=["replicas", "blanket", "override", "base"])
def test_qos_spec_apply_and_describe_match_reference(spec):
    names = ["sw", "sw@1", "other"]
    outs = []
    for pkg in (R, T):
        disc = np.zeros(3, np.int32)
        w = np.ones((3, 2))
        q = pkg.QosSpec(**spec)
        q.apply(disc, w, names)
        outs.append((disc, w, q.describe(), q.n_classes(), hash(q) == hash(pkg.QosSpec(**spec))))
    (rd, rw, rs, rn, rh), (td, tw, ts, tn, th) = outs
    np.testing.assert_array_equal(td, rd)
    np.testing.assert_array_equal(tw, rw)
    assert (ts, tn, th) == (rs, rn, rh)
    if "switch_weights" in spec and spec["switch_weights"][0][0] == "sw":
        assert list(td) == [r_topo.DISCIPLINE_CODES["priority"]] * 2 + [0]
        np.testing.assert_allclose(tw[:2], [[3.0, 1.0]] * 2)


# --------------------------------------------------------------------------- #
# dispatch and the kernel wrappers' limits
# --------------------------------------------------------------------------- #


def test_cpu_tensors_take_the_plain_qos_path():
    t = torch.sort(torch.rand(2, 64) * 100.0).values
    bits = torch.randint(0, 4, (2, 64), dtype=torch.int32)
    qos = torch.randint(0, 2, (2, 64), dtype=torch.int32)
    stts = torch.tensor([2.0, 1.0])
    disc = torch.tensor([t_ref.DISC_PRIORITY, t_ref.DISC_WFQ], dtype=torch.int32)
    w = torch.ones(2, 2)
    before = (t_ops.plain_launches, t_kernel.qos_launches, t_kernel.qos_hosts_launches)
    tf, idx, psd = t_ops.qos_congestion_cascade(t, bits, stts, qos, disc, w)
    _, _, psd_h = t_ops.qos_congestion_cascade(
        t, bits, stts, qos, disc, w, hosts=torch.zeros_like(bits), n_hosts=3
    )
    assert (t_ops.plain_launches, t_kernel.qos_launches, t_kernel.qos_hosts_launches) == (
        before[0] + 2, before[1], before[2]
    )
    assert tf.shape == t.shape and psd.shape == (2, 2, 1, 2) and psd_h.shape == (2, 2, 3, 2)
    torch.testing.assert_close(psd_h.sum(2, keepdim=True), psd)


def test_qos_kernel_wrappers_refuse_cpu_tensors_and_their_limits():
    t = torch.zeros(1, 8)
    i32 = torch.zeros(1, 8, dtype=torch.int32)
    one = torch.ones(1)
    disc = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.qos_congestion_cascade(t, i32, i32, one, disc, torch.ones(1, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_kernel.qos_congestion_cascade_hosts(t, i32, i32, i32, one, disc, torch.ones(1, 2), 2)
    with pytest.raises(ValueError, match="kMaxClasses=8"):
        t_kernel.qos_congestion_cascade(t, i32, i32, one, disc, torch.ones(1, 9))
    with pytest.raises(ValueError, match="kMaxHosts=32"):
        t_kernel.qos_congestion_cascade_hosts(t, i32, i32, i32, one, disc, torch.ones(1, 2), 33)
    assert "qos_cascade" not in t_kernel._libs  # nothing was built or loaded
