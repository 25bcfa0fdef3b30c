"""Port parity: topology lowering, traces, staging buffers and cascade
planning — ``repro_torch`` against ``repro`` on the same inputs, bitwise."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import analyzer as r_an
from repro.core import events as r_ev
from repro.core import topology as r_topo
from repro_torch.core import analyzer as t_an
from repro_torch.core import events as t_ev
from repro_torch.core import topology as t_topo
from repro_torch.interop import flat_topology_from_arrays, mem_events_from_arrays

torch.set_num_threads(2)

TOPOLOGIES = {
    "figure1": lambda m: m.figure1_topology(),
    "two_tier": lambda m: m.two_tier_topology(),
    "chain3": lambda m: m.chained_topology(3),
    "chain8": lambda m: m.chained_topology(8),
    "local_only": lambda m: m.local_only_topology(),
}

FLAT_ARRAYS = (
    "route", "pool_latency_ns", "pool_bandwidth_gbps", "pool_capacity",
    "pool_media_latency_ns", "switch_stt_ns", "switch_bandwidth_gbps",
    "switch_depth", "host_reachable", "qos_class_weights",
)
EVENT_COLUMNS = ("t_ns", "pool", "bytes_", "is_write", "region", "weight", "host", "qos")


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _assert_flat_equal(r, t):
    for name in FLAT_ARRAYS:
        _assert_bitwise(getattr(r, name), getattr(t, name))
    for name in ("n_pools", "n_switches", "n_hosts", "n_qos_classes",
                 "local_latency_ns", "pool_names", "switch_names",
                 "switch_discipline"):
        assert getattr(r, name) == getattr(t, name), name
    _assert_bitwise(r.stage_order(), t.stage_order())
    _assert_bitwise(r.discipline_codes(), t.discipline_codes())
    _assert_bitwise(r.class_weight_table(), t.class_weight_table())
    assert r.has_qos == t.has_qos


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_flat_topology_bitwise(name):
    r = TOPOLOGIES[name](r_topo).flatten()
    t = TOPOLOGIES[name](t_topo).flatten()
    _assert_flat_equal(r, t)
    assert TOPOLOGIES[name](r_topo).describe() == TOPOLOGIES[name](t_topo).describe()


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_interop_topology_is_the_reference(name):
    r = TOPOLOGIES[name](r_topo).flatten()
    t = flat_topology_from_arrays(_fields(r))
    _assert_flat_equal(r, t)
    # copies, not views: mutating the port's arrays leaves the reference's
    t.route[...] = -1.0
    assert (r.route >= 0).all()


def test_interop_rejects_unknown_and_missing_fields():
    d = _fields(r_topo.figure1_topology().flatten())
    with pytest.raises(KeyError, match="no fields"):
        flat_topology_from_arrays({**d, "bogus": 1})
    d.pop("route")
    with pytest.raises(KeyError, match="needs fields"):
        flat_topology_from_arrays(d)


@pytest.mark.parametrize("kw", [
    dict(n_events=2000, n_pools=4, seed=3),
    dict(n_events=1500, n_pools=4, seed=4, burstiness=0.9, granule_bytes=4096),
    dict(n_events=800, n_pools=3, seed=5, n_qos_classes=3, write_frac=0.5),
])
def test_synthetic_trace_bitwise(kw):
    r = r_ev.synthetic_trace(**kw)
    t = t_ev.synthetic_trace(**kw)
    for c in EVENT_COLUMNS:
        _assert_bitwise(getattr(r, c), getattr(t, c))


def test_interop_events_and_sampling_bitwise():
    r = r_ev.synthetic_trace(3000, 4, seed=8, burstiness=0.5)
    t = mem_events_from_arrays(_fields(r))
    for c in EVENT_COLUMNS:
        _assert_bitwise(getattr(r, c), getattr(t, c))
    rs, ts = r.sample(0.3, seed=2), t.sample(0.3, seed=2)
    for c in EVENT_COLUMNS:
        _assert_bitwise(getattr(rs, c), getattr(ts, c))


def _trace_pair(n, seed, shuffle):
    r = r_ev.synthetic_trace(n, 4, seed=seed, burstiness=0.7)
    if shuffle:
        r = r.take(np.random.default_rng(seed).permutation(n))
    return r, mem_events_from_arrays(_fields(r))


@pytest.mark.parametrize("shuffle", [False, True], ids=["sorted", "unsorted"])
def test_event_stager_buffers_bitwise(shuffle):
    pairs = [_trace_pair(n, s, shuffle) for s, n in enumerate((700, 1000, 0, 33))]
    rs, ts = r_ev.EventStager(np.float32), t_ev.EventStager(np.float32)
    for b_bucket in (4, 8):  # with and without padded rows
        rb = rs.stage([p[0] for p in pairs], b_bucket, 1024)
        tb = ts.stage([p[1] for p in pairs], b_bucket, 1024)
        assert set(rb) == set(tb)
        for k in rb:
            _assert_bitwise(rb[k], tb[k])
    with pytest.raises(ValueError, match="exceed batch bucket"):
        ts.stage([p[1] for p in pairs], 2, 1024)


def test_concat_events_bitwise():
    r = [r_ev.synthetic_trace(n, 3, seed=n) for n in (5, 0, 9)]
    t = [mem_events_from_arrays(_fields(x)) for x in r]
    rc, tc = r_ev.concat_events(r), t_ev.concat_events(t)
    for c in EVENT_COLUMNS:
        _assert_bitwise(getattr(rc, c), getattr(tc, c))
    assert t_ev.concat_events([t[1]]).n == 0


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_plan_cascade_equal(name):
    rb, rplan, rorder = r_an.plan_cascade(TOPOLOGIES[name](r_topo).flatten())
    tb, tplan, torder = t_an.plan_cascade(TOPOLOGIES[name](t_topo).flatten())
    _assert_bitwise(rb, tb)
    assert rplan == tplan and rorder == torder


def test_region_map_and_buckets():
    for n in (0, 1, 15, 16, 17, 1000, 131072):
        assert t_an.bucket_pow2(n) == r_an.bucket_pow2(n)
        assert t_ev._bucket_pow2(n, 4) == r_ev._bucket_pow2(n, 4)
    rm, tm = r_ev.RegionMap(), t_ev.RegionMap()
    for m in (rm, tm):
        m.alloc("w", 1 << 20, "param", pool=1)
        m.alloc("a", 1 << 10, "activation")
        m.free("a")
    _assert_bitwise(rm.pool_vector(), tm.pool_vector())
    _assert_bitwise(rm.bytes_per_pool(3), tm.bytes_per_pool(3))
    with pytest.raises(KeyError):
        tm.alloc("w", 1)
