"""Port parity: the port's copy of the coherency model against the
reference's.  Both are numpy only, so every injected BI column, every miss
latency and every running total must be bitwise equal on the same traces."""

import dataclasses

import numpy as np
import pytest

from repro.core import coherency as r_coh
from repro.core import events as r_ev
from repro_torch.core import coherency as t_coh
from repro_torch.core import events as t_ev
from repro_torch.interop import mem_events_from_arrays

COLUMNS = ("t_ns", "pool", "bytes_", "is_write", "region", "weight", "host", "qos")


def _regions(ev, names=("kv", "w", "act"), classes=("kvcache", "param", "activation"),
             pools=(1, 1, 0)):
    rm = ev.RegionMap()
    for name, cls, pool in zip(names, classes, pools):
        rm.alloc(name, 1 << 20, cls, pool=pool)
    return rm


def _trace(seed, n=600, n_regions=3, weighted=False):
    """A host's epoch: random times, regions and read/write mix, with PEBS
    weights when ``weighted``."""
    rng = np.random.default_rng(seed)
    return r_ev.MemEvents(
        t_ns=np.sort(rng.uniform(0.0, 5e4, n)),
        pool=np.ones((n,), np.int32),
        bytes_=np.full((n,), 64.0),
        is_write=rng.random(n) < 0.3,
        region=rng.integers(0, n_regions, n).astype(np.int32),
        weight=rng.uniform(1.0, 4.0, n) if weighted else np.ones((n,)),
        host=np.zeros((n,), np.int32),
        qos=rng.integers(0, 2, n).astype(np.int32),
    )


def _port(tr):
    return mem_events_from_arrays({f.name: getattr(tr, f.name) for f in dataclasses.fields(tr)})


def _assert_events_equal(got, want):
    assert got.n == want.n
    for c in COLUMNS:
        np.testing.assert_array_equal(getattr(got, c), getattr(want, c), err_msg=c)
        assert getattr(got, c).dtype == getattr(want, c).dtype, c


def _assert_totals_equal(got, want):
    for f in ("bi_messages_total", "bi_bytes_total", "coherency_delay_total_ns"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("n_hosts, weighted, cap", [
    (2, False, 8192), (3, True, 8192), (3, False, 50),
], ids=["2hosts", "3hosts-weighted", "3hosts-capped"])
def test_fabric_traffic_matches_reference(n_hosts, weighted, cap):
    traces = [_trace(10 + h, weighted=weighted) for h in range(n_hosts)]
    kw = dict(shared_classes=("kvcache", "param"), max_bi_events=cap)
    want_model = r_coh.CoherencyModel(r_coh.CoherencyConfig(**kw))
    got_model = t_coh.CoherencyModel(t_coh.CoherencyConfig(**kw))
    r_maps = [_regions(r_ev) for _ in range(n_hosts)]
    t_maps = [_regions(t_ev) for _ in range(n_hosts)]
    for _ in range(2):  # running totals accumulate across epochs
        want_bi, want_miss = want_model.fabric_traffic(traces, r_maps)
        got_bi, got_miss = got_model.fabric_traffic([_port(t) for t in traces], t_maps)
        np.testing.assert_array_equal(got_miss, want_miss)
        assert len(got_bi) == len(want_bi) == n_hosts
        for g, w in zip(got_bi, want_bi):
            _assert_events_equal(g, w)
    _assert_totals_equal(got_model, want_model)
    assert got_model.bi_messages_total > 0 and got_miss.sum() > 0
    if cap < 8192:  # one capped stream per (writer, shared region) pair
        assert all(b.n == cap * (n_hosts - 1) * 2 for b in got_bi)


def test_fabric_traffic_needs_two_sharers():
    """A region one host alone touches, or a single host, injects nothing."""
    model = t_coh.CoherencyModel(t_coh.CoherencyConfig(shared_classes=("kvcache",)))
    tr = _port(_trace(1))
    bi, miss = model.fabric_traffic([tr], [_regions(t_ev)])
    assert [b.n for b in bi] == [0] and miss.tolist() == [0.0]
    quiet = dataclasses.replace(tr, region=np.full((tr.n,), 2, np.int32))
    bi, miss = model.fabric_traffic([tr, quiet], [_regions(t_ev), _regions(t_ev)])
    assert [b.n for b in bi] == [0, 0] and model.bi_messages_total == 0.0
    with pytest.raises(ValueError, match="one region map per host"):
        model.fabric_traffic([tr, tr], [_regions(t_ev)])


@pytest.mark.parametrize("n_hosts, cap", [(2, 8192), (4, 16)], ids=["2hosts", "4hosts-capped"])
def test_epoch_traffic_matches_reference(n_hosts, cap):
    tr = _trace(7, weighted=True)
    kw = dict(n_hosts=n_hosts, shared_classes=("kvcache",), max_bi_events=cap)
    want_model = r_coh.CoherencyModel(r_coh.CoherencyConfig(**kw), _regions(r_ev))
    got_model = t_coh.CoherencyModel(t_coh.CoherencyConfig(**kw), _regions(t_ev))
    want_bi, want_ns = want_model.epoch_traffic(tr)
    got_bi, got_ns = got_model.epoch_traffic(_port(tr))
    _assert_events_equal(got_bi, want_bi)
    assert got_ns == want_ns > 0
    _assert_totals_equal(got_model, want_model)
    if cap < 8192:
        assert got_bi.n == cap


def test_epoch_traffic_noops_and_errors():
    tr = _port(_trace(3))
    single = t_coh.CoherencyModel(t_coh.CoherencyConfig(n_hosts=1), _regions(t_ev))
    assert single.epoch_traffic(tr)[0].n == 0
    no_map = t_coh.CoherencyModel(t_coh.CoherencyConfig(n_hosts=2))
    with pytest.raises(ValueError, match="RegionMap"):
        no_map.epoch_traffic(tr)
    local = t_coh.CoherencyModel(
        t_coh.CoherencyConfig(n_hosts=2, shared_classes=("activation",)), _regions(t_ev)
    )
    bi, miss_ns = local.epoch_traffic(tr)  # activations live in local DRAM
    assert bi.n == 0 and miss_ns == 0.0
