"""Port parity for migration and the expander-side device cache: the port's
``MigrationSimulator`` and ``DeviceCacheModel`` (host numpy copies of the
reference's) against the reference on the same numpy inputs, and their
wiring through ``CXLMemSim`` and ``FabricSession``.

Bars: decisions, migrated traces, copy events, hit fractions and scale
vectors bitwise equal to the reference's; an attached step's and a fabric
round's pre-analysis (migration, coherency, the cache's scale rows) bitwise
the reference's; a zero-capacity cache bitwise the no-cache analysis;
attach and fabric totals against the reference's synchronous
``impl='inline'`` runs at rel 1e-5 (both sum f32 per-event delays, in
different orders), against the f64 oracle at ``tests/test_migration_cache.py``'s
bars.  Every case of ``tests/test_migration_cache.py`` and of
``tests/test_policy_migration.py``'s migration tests has its port case here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro_torch import core as T
from repro_torch.core.units import ns_to_s

torch.set_num_threads(2)

PAGE = 4096
COLUMNS = ("t_ns", "pool", "bytes_", "is_write", "region", "weight", "host", "qos")
PKGS = {"reference": R, "port": T}


def _flat(pkg):
    return pkg.figure1_topology().flatten()


def _events(pkg, **cols):
    """One trace in ``pkg`` from numpy columns (the same arrays for both)."""
    return pkg.MemEvents(**{k: np.array(v, copy=True) for k, v in cols.items()})


def _assert_events_equal(got, want):
    assert got.n == want.n
    for c in COLUMNS:
        a, b = getattr(got, c), getattr(want, c)
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(a, b, err_msg=c)


def _assert_scales_equal(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _random_regions(pkg, rng_state, n=40):
    """Two identical RegionMaps (decisions mutate Region.pool in place)."""
    rng = np.random.default_rng(rng_state)
    flat = _flat(pkg)
    sizes = (rng.integers(1, 600, size=n) * PAGE).tolist()
    pools = rng.integers(0, flat.n_pools, size=n).tolist()
    maps = []
    for _ in range(2):
        rm = pkg.RegionMap()
        for i, (s, p) in enumerate(zip(sizes, pools)):
            rm.alloc(f"r{i}", int(s), "kvcache", pool=int(p))
        maps.append(rm)
    return maps


def _trace_cols(rng, n_regions, n_events, pool_vec):
    # skewed: each epoch touches a random half of the regions, so the rest
    # decay cold — exercising demotions as well as budget-truncated promotions
    active = rng.choice(n_regions, size=max(n_regions // 2, 1), replace=False)
    reg = rng.choice(active, size=n_events).astype(np.int32)
    return dict(
        t_ns=np.sort(rng.uniform(0, 1e5, size=n_events)),
        pool=pool_vec[reg].astype(np.int32),
        bytes_=np.full((n_events,), 64.0),
        is_write=rng.random(n_events) < 0.3,
        region=reg,
    )


# --------------------------------------------------------------------------- #
# vectorized decisions == loop oracle == the reference's, bitwise
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_vector_matches_loop_and_reference_on_random_regions(seed):
    sims = {}
    for pkg in (R, T):
        rm_v, rm_l = _random_regions(pkg, seed)
        cfg = pkg.MigrationConfig(
            mode="software",
            promote_threshold=8.0,
            demote_threshold=3.0,
            # tight budget so the promotion prefix actually truncates
            local_budget_bytes=int(sum(r.nbytes for r in rm_v) // 3),
            demote_pool="cxl_pool2",
        )
        sims[pkg] = (
            pkg.MigrationSimulator(cfg, rm_v, _flat(pkg)),
            pkg.MigrationSimulator(cfg, rm_l, _flat(pkg), impl="loop"),
            rm_v, rm_l,
        )
    rng = np.random.default_rng(100 + seed)
    t_v, t_l, t_rm_v, t_rm_l = sims[T]
    r_v, r_l, r_rm_v, _ = sims[R]
    for _ in range(4):
        cols = _trace_cols(rng, len(t_rm_v), 3000, t_rm_l.pool_vector())
        out_tv, mig_tv = t_v.observe_and_migrate(_events(T, **cols))
        out_tl, mig_tl = t_l.observe_and_migrate(_events(T, **cols))
        out_rv, mig_rv = r_v.observe_and_migrate(_events(R, **cols))
        out_rl, mig_rl = r_l.observe_and_migrate(_events(R, **cols))
        # the port's vector pass is the reference's, bit for bit
        _assert_events_equal(out_tv, out_rv)
        _assert_events_equal(mig_tv, mig_rv)
        np.testing.assert_array_equal(t_rm_v.pool_vector(), r_rm_v.pool_vector())
        assert (t_v.promotions, t_v.demotions, t_v.moved_bytes_total) == (
            r_v.promotions, r_v.demotions, r_v.moved_bytes_total)
        assert t_v._budget.used == r_v._budget.used
        # and the port's loop oracle decides as its vector pass
        np.testing.assert_array_equal(t_rm_v.pool_vector(), t_rm_l.pool_vector())
        np.testing.assert_array_equal(t_v._pool, t_l._pool)
        assert (t_v.promotions, t_v.demotions) == (t_l.promotions, t_l.demotions)
        assert t_v.moved_bytes_total == t_l.moved_bytes_total
        assert mig_tv.n == mig_tl.n
        P = _flat(T).n_pools
        np.testing.assert_array_equal(
            np.bincount(mig_tv.pool, weights=mig_tv.bytes_, minlength=P),
            np.bincount(mig_tl.pool, weights=mig_tl.bytes_, minlength=P),
        )
        np.testing.assert_array_equal(out_tv.pool, out_tl.pool)
        # the loop oracle's remap and copy events are the reference loop's
        _assert_events_equal(out_tl, out_rl)
        _assert_events_equal(mig_tl, mig_rl)
    assert t_v.promotions > 0 and t_v.demotions > 0  # scenario is non-trivial


def test_hardware_vector_matches_loop_remap():
    outs = {}
    for pkg in (R, T):
        rm_v, rm_l = _random_regions(pkg, 7, n=12)
        cfg = pkg.MigrationConfig(
            mode="hardware", promote_threshold=4.0, reaction_ns=4e4,
            granularity_bytes=pkg.CACHELINE_BYTES, local_budget_bytes=1 << 32,
        )
        sim_v = pkg.MigrationSimulator(cfg, rm_v, _flat(pkg))
        sim_l = pkg.MigrationSimulator(cfg, rm_l, _flat(pkg), impl="loop")
        cols = _trace_cols(np.random.default_rng(7), len(rm_v), 500, rm_l.pool_vector())
        tr = _events(pkg, **cols)
        out_v, mig_v = sim_v.observe_and_migrate(tr)
        out_l, _ = sim_l.observe_and_migrate(tr)
        np.testing.assert_array_equal(out_v.pool, out_l.pool)
        # mid-epoch remap actually moved post-reaction events
        assert (out_v.pool != tr.pool).any()
        outs[pkg] = (out_v, mig_v)
    _assert_events_equal(outs[T][0], outs[R][0])
    _assert_events_equal(outs[T][1], outs[R][1])


def test_config_and_budget_validation():
    with pytest.raises(ValueError):
        T.MigrationConfig(mode="sometimes")
    with pytest.raises(ValueError, match="non-local"):
        T.MigrationSimulator(T.MigrationConfig(demote_pool="local_dram"), T.RegionMap(),
                             _flat(T))
    with pytest.raises(ValueError):
        T.MigrationSimulator(T.MigrationConfig(), T.RegionMap(), _flat(T), impl="batched")
    with pytest.raises(ValueError, match="capacity_bytes"):
        T.DeviceCacheConfig(capacity_bytes=-1)
    with pytest.raises(ValueError, match="positive"):
        T.DeviceCacheConfig(capacity_bytes=1 << 20, n_sets=0)
    with pytest.raises(ValueError, match="local DRAM"):
        T.DeviceCacheModel(T.DeviceCacheConfig(1 << 20, pools=("local_dram",)), _flat(T),
                           [T.RegionMap()])
    with pytest.raises(ValueError, match="region maps"):
        T.DeviceCacheModel(T.DeviceCacheConfig(1 << 20), _flat(T),
                           [T.RegionMap(), T.RegionMap()])
    assert T.DeviceCacheConfig(capacity_bytes=3 * 4096 * 64).ways == 3


# --------------------------------------------------------------------------- #
# weight / host threading, access counts, freed regions
# --------------------------------------------------------------------------- #


def test_remap_preserves_weight_and_host():
    n = 300
    cols = dict(
        t_ns=np.linspace(0, 1e5, n),
        pool=np.full((n,), 1, np.int32),
        bytes_=np.full((n,), 64.0),
        is_write=np.zeros((n,), bool),
        region=np.zeros((n,), np.int32),
        weight=np.full((n,), 4.0),  # PEBS 1/rate multiplicity
        host=np.full((n,), 2, np.int32),
    )
    migs = []
    for pkg in (R, T):
        rm = pkg.RegionMap()
        rm.alloc("hot", 1 << 20, "kvcache", pool=1)
        sim = pkg.MigrationSimulator(
            pkg.MigrationConfig(mode="hardware", promote_threshold=1, reaction_ns=3e4,
                                local_budget_bytes=1 << 30),
            rm, _flat(pkg), host=2,
        )
        tr = _events(pkg, **cols)
        remapped, mig = sim.observe_and_migrate(tr)
        np.testing.assert_array_equal(remapped.weight, tr.weight)
        np.testing.assert_array_equal(remapped.host, tr.host)
        np.testing.assert_array_equal(remapped.bytes_, tr.bytes_)
        assert mig.n > 0
        assert (mig.host == 2).all()  # copy traffic rides the simulator's host
        assert (mig.weight == 1.0).all()  # copies are exact traffic, not sampled
        migs.append(mig)
    _assert_events_equal(migs[1], migs[0])


def test_access_count_refreshed_for_small_maps():
    """Region.access_count (HotnessTieredPolicy's fallback input) keeps the
    every-epoch refresh for ordinarily-sized region maps."""
    got = {}
    for pkg in (R, T):
        rm, _ = _random_regions(pkg, 5, n=10)
        sim = pkg.MigrationSimulator(pkg.MigrationConfig(mode="software"), rm, _flat(pkg))
        cols = _trace_cols(np.random.default_rng(5), len(rm), 500, rm.pool_vector())
        sim.observe_and_migrate(_events(pkg, **cols))
        got[pkg] = np.array([r.access_count for r in rm])
        np.testing.assert_array_equal(got[pkg], sim._hot_ewma)
    assert got[T].sum() > 0
    np.testing.assert_array_equal(got[T], got[R])
    # large maps refresh on request only
    rm, _ = _random_regions(T, 5, n=10)
    sim = T.MigrationSimulator(T.MigrationConfig(mode="software"), rm, _flat(T))
    sim._SYNC_STATS_MAX = 4
    sim.observe_and_migrate(_events(T, **_trace_cols(np.random.default_rng(5), 10, 500,
                                                     rm.pool_vector())))
    assert all(r.access_count == 0.0 for r in rm)
    sim.sync_region_stats()
    np.testing.assert_array_equal([r.access_count for r in rm], sim._hot_ewma)


def test_freed_region_moves_no_bytes():
    """RegionMap.free() zeroes nbytes in place; the simulator must honor it
    (no phantom copy traffic or budget charge for dead regions)."""
    rm = T.RegionMap()
    reg = rm.alloc("dead", 8 << 20, "kvcache", pool=1)
    sim = T.MigrationSimulator(
        T.MigrationConfig(mode="software", promote_threshold=1,
                          local_budget_bytes=1 << 30),
        rm, _flat(T),
    )
    rm.free("dead")
    n = 100
    tr = T.MemEvents.build(
        np.linspace(0, 1e5, n), [1] * n, [64.0] * n, region=[reg.rid] * n
    )
    _, mig = sim.observe_and_migrate(tr)
    assert sim.moved_bytes_total == 0.0
    assert mig.total_bytes == 0.0
    assert sim._budget.used == 0.0


def test_hotness_ewma_is_weight_aware():
    """100 weight-1 events must decide like 50 weight-2 events (PEBS)."""
    outs = []
    for n, w in ((100, 1.0), (50, 2.0)):
        rm = T.RegionMap()
        reg = rm.alloc("kv", 1 << 20, "kvcache", pool=1)
        sim = T.MigrationSimulator(
            T.MigrationConfig(mode="software", promote_threshold=30,
                              local_budget_bytes=1 << 30),
            rm, _flat(T),
        )
        tr = T.MemEvents(
            t_ns=np.linspace(0, 1e5, n),
            pool=np.full((n,), 1, np.int32),
            bytes_=np.full((n,), 64.0),
            is_write=np.zeros((n,), bool),
            region=np.full((n,), reg.rid, np.int32),
            weight=np.full((n,), w),
        )
        sim.observe_and_migrate(tr)
        outs.append((sim.promotions, float(sim._hot_ewma[reg.rid])))
    assert outs[0] == outs[1]
    assert outs[0][0] == 1  # ewma 50 >= threshold 30


# --------------------------------------------------------------------------- #
# the demotion dead-end (local-born regions) and the demote_pool fix
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("demote_pool", [None, "cxl_pool3"])
def test_demote_pool_decides_local_born_cold_regions(demote_pool):
    """Without a demote pool the cold local-born region pins the one-region
    budget and the hot region never fits; with one it demotes and frees the
    budget for the promotion."""
    rm = T.RegionMap()
    rm.alloc("cold_local", 1 << 20, "param", pool=0)
    hot = rm.alloc("hot_remote", 1 << 20, "kvcache", pool=1)
    cfg = T.MigrationConfig(
        mode="software", promote_threshold=5, demote_threshold=5,
        local_budget_bytes=(1 << 20) + 1,  # room for exactly one region
        demote_pool=demote_pool,
    )
    sim = T.MigrationSimulator(cfg, rm, _flat(T))
    n = 200
    tr = T.MemEvents.build(
        np.linspace(0, 1e5, n), [1] * n, [64.0] * n, region=[hot.rid] * n
    )
    sim.observe_and_migrate(tr)
    if demote_pool is None:
        assert sim.demotions == 0 and sim.promotions == 0
        assert rm["hot_remote"].pool == 1
    else:
        assert rm["cold_local"].pool == _flat(T).pool_names.index("cxl_pool3")
        assert rm["hot_remote"].pool == 0  # freed budget admits the promotion
        assert sim.demotions == 1 and sim.promotions == 1


# --------------------------------------------------------------------------- #
# tests/test_policy_migration.py's migration cases
# --------------------------------------------------------------------------- #


def _trace_for(pkg, region_id, n, pool):
    return pkg.MemEvents.build(
        np.linspace(0, 1e5, n), [pool] * n, [64.0] * n, region=[region_id] * n
    )


def test_migration_promotes_hot_region():
    r = T.RegionMap()
    reg = r.alloc("hot", 1 << 20, "kvcache", pool=1)
    sim = T.MigrationSimulator(
        T.MigrationConfig(mode="software", promote_threshold=10, local_budget_bytes=1 << 30),
        r, _flat(T),
    )
    sim.observe_and_migrate(_trace_for(T, reg.rid, 200, pool=1))
    assert r["hot"].pool == 0
    assert sim.promotions == 1
    assert sim.moved_bytes_total == reg.nbytes


def test_migration_demotes_cold_region():
    r = T.RegionMap()
    reg = r.alloc("cold", 1 << 20, "kvcache", pool=1)
    reg.pool = 0  # currently resident local, home pool 1
    sim = T.MigrationSimulator(T.MigrationConfig(mode="software", demote_threshold=5.0),
                               r, _flat(T))
    sim._home_pool[reg.rid] = 1
    sim.observe_and_migrate(_trace_for(T, reg.rid, 1, pool=0))
    assert r["cold"].pool == 1
    assert sim.demotions == 1


def test_hardware_migration_remaps_within_epoch():
    r = T.RegionMap()
    reg = r.alloc("hot", 1 << 12, "kvcache", pool=1)
    sim = T.MigrationSimulator(
        T.MigrationConfig(mode="hardware", promote_threshold=1, reaction_ns=5e4,
                          local_budget_bytes=1 << 30, granularity_bytes=T.CACHELINE_BYTES),
        r, _flat(T),
    )
    remapped, mig = sim.observe_and_migrate(_trace_for(T, reg.rid, 100, pool=1))
    after = remapped.t_ns >= 5e4
    assert (remapped.pool[after] == 0).all()
    assert (remapped.pool[~after] == 1).all()
    assert mig.n > 0


def test_migration_off_is_identity():
    r = T.RegionMap()
    reg = r.alloc("x", 1 << 12, "kvcache", pool=1)
    sim = T.MigrationSimulator(T.MigrationConfig(mode="off"), r, _flat(T))
    tr = _trace_for(T, reg.rid, 10, pool=1)
    remapped, mig = sim.observe_and_migrate(tr)
    assert mig.n == 0 and remapped is tr
    np.testing.assert_array_equal(remapped.pool, tr.pool)


# --------------------------------------------------------------------------- #
# device cache: bitwise the reference's, exact at zero capacity, monotone
# --------------------------------------------------------------------------- #


def _reuse_setup(pkg, lines=32, events=600):
    """One hot region in pool 1 whose working set is ``lines`` cache lines."""
    rm = pkg.RegionMap()
    reg = rm.alloc("kv", lines * PAGE, "kvcache", pool=1)
    rng = np.random.default_rng(0)
    n = events
    tr = pkg.MemEvents(
        t_ns=np.sort(rng.uniform(0, 1e5, n)),
        pool=np.full((n,), 1, np.int32),
        bytes_=np.full((n,), float(PAGE)),
        is_write=np.zeros((n,), bool),
        region=np.full((n,), reg.rid, np.int32),
    )
    return rm, tr


def _multi_host_maps(pkg, rng_state, n_hosts=3, regions=6):
    rng = np.random.default_rng(rng_state)
    maps = []
    for h in range(n_hosts):
        rm = pkg.RegionMap()
        for i in range(regions):
            rm.alloc(f"r{i}", int(rng.integers(1, 96)) * PAGE, "kvcache",
                     pool=int(rng.integers(1, 3)))
        maps.append(rm)
    return maps


@pytest.mark.parametrize("pools", [None, ("shared_pool",)])
@pytest.mark.parametrize("capacity_pages", [0, 64, 256, 4096])
def test_cache_model_matches_reference_bitwise(capacity_pages, pools):
    """Multi-host streams over several epochs: the port's hit fractions,
    scale vectors, running hit rate and tag state are the reference's, bit
    for bit."""
    topo = {pkg: pkg.pooled_topology(n_hosts=3).flatten() for pkg in (R, T)}
    models = {
        pkg: pkg.DeviceCacheModel(
            pkg.DeviceCacheConfig(capacity_bytes=capacity_pages * PAGE, line_bytes=PAGE,
                                  n_sets=16, pools=pools),
            topo[pkg], _multi_host_maps(pkg, 3),
        )
        for pkg in (R, T)
    }
    rng = np.random.default_rng(11)
    for _ in range(4):
        n = 2000
        cols = dict(
            t_ns=np.sort(rng.uniform(0, 1e5, n)),
            pool=rng.integers(0, 2, n).astype(np.int32),
            bytes_=rng.choice([64.0, 4096.0, 16384.0], n),
            is_write=rng.random(n) < 0.3,
            region=rng.integers(0, 6, n).astype(np.int32),
            weight=rng.choice([1.0, 4.0], n),
            host=rng.integers(0, 3, n).astype(np.int32),
        )
        fr = models[R].observe(_events(R, **cols))
        ft = models[T].observe(_events(T, **cols))
        np.testing.assert_array_equal(ft, fr)
        np.testing.assert_array_equal(models[T].latency_scale(ft), models[R].latency_scale(fr))
        st = models[T].observe_scale(_events(T, **cols))
        sr = models[R].observe_scale(_events(R, **cols))
        assert (st is None) == (sr is None) == (capacity_pages == 0)
        if st is not None:
            np.testing.assert_array_equal(st, sr)
    for f in ("hit_weight_total", "access_weight_total"):
        assert getattr(models[T], f) == getattr(models[R], f)
    np.testing.assert_array_equal(models[T]._cursor, models[R]._cursor)
    for p in models[T]._resident:
        np.testing.assert_array_equal(models[T]._resident[p], models[R]._resident[p])
    if capacity_pages:
        assert 0.0 < models[T].hit_fraction <= 1.0


def test_analyze_batch_rejects_mismatched_scales():
    tr = _reuse_setup(T)[1]
    with pytest.raises(ValueError, match="lat_scales"):
        T.EpochAnalyzer(_flat(T), device="cpu").analyze_batch([tr, tr], [None])


def test_single_map_cache_on_multi_host_topology():
    """One attached program + cache on a Topology(n_hosts=2) must work."""
    flat2 = T.pooled_topology(n_hosts=2).flatten()
    rm = T.RegionMap()
    reg = rm.alloc("kv", 16 * PAGE, "kvcache", pool=1)
    model = T.DeviceCacheModel(
        T.DeviceCacheConfig(capacity_bytes=PAGE * 64, line_bytes=PAGE), flat2, [rm]
    )
    n = 200
    tr = T.MemEvents.build(
        np.linspace(0, 1e5, n), [1] * n, [float(PAGE)] * n, region=[reg.rid] * n
    )
    frac = model.observe(tr)
    assert frac.shape == (2, 2) and frac[0, 1] > 0 and frac[1].sum() == 0


def test_zero_capacity_cache_reproduces_no_cache_exactly():
    rm, tr = _reuse_setup(T)
    an = T.EpochAnalyzer(_flat(T), device="cpu")
    base = an.analyze(tr)
    model = T.DeviceCacheModel(T.DeviceCacheConfig(capacity_bytes=0), _flat(T), [rm])
    scale = model.latency_scale(model.observe(tr))
    np.testing.assert_array_equal(scale, np.ones_like(scale))
    assert model.observe_scale(tr) is None
    cached = an.analyze(tr, lat_scale=scale)
    assert cached.latency_ns == base.latency_ns
    assert cached.congestion_ns == base.congestion_ns
    assert cached.bandwidth_ns == base.bandwidth_ns
    np.testing.assert_array_equal(cached.per_pool_latency_ns, base.per_pool_latency_ns)


def test_cache_hit_rate_monotone_delay_monotone():
    cfgs = [
        T.DeviceCacheConfig(capacity_bytes=k * PAGE * 64, line_bytes=PAGE, n_sets=64)
        for k in range(4)
    ]
    an = T.EpochAnalyzer(_flat(T), device="cpu")
    fracs, delays = [], []
    for cfg in cfgs:
        rm, tr = _reuse_setup(T)
        model = T.DeviceCacheModel(cfg, _flat(T), [rm])
        total, frac_sum = 0.0, 0.0
        for _ in range(3):  # warm across epochs: tag state persists
            frac = model.observe(tr)
            frac_sum += frac[0, 1]
            total += an.analyze(tr, lat_scale=model.latency_scale(frac)).total_ns
        fracs.append(frac_sum)
        delays.append(total)
    assert all(b >= a for a, b in zip(fracs, fracs[1:]))  # hit rate up
    assert all(b <= a for a, b in zip(delays, delays[1:]))  # delay down
    assert fracs[1] > 0  # working set fits from one way up
    assert delays[1] < delays[0]  # and that strictly helps


def test_scaled_analysis_matches_oracle_and_reference():
    outs = {}
    for pkg in (R, T):
        rm, tr = _reuse_setup(pkg)
        model = pkg.DeviceCacheModel(
            pkg.DeviceCacheConfig(capacity_bytes=2 * PAGE * 64, line_bytes=PAGE),
            _flat(pkg), [rm],
        )
        scale = model.latency_scale(model.observe(tr))
        assert (scale < 1.0).any()  # non-trivial scaling under test
        an = (T.EpochAnalyzer(_flat(T), device="cpu") if pkg is T
              else R.EpochAnalyzer(_flat(R)))
        outs[pkg] = (an.analyze(tr, lat_scale=scale),
                     pkg.analyze_ref(_flat(pkg), tr, lat_scale=scale), scale)
    got, want, t_scale = outs[T]
    np.testing.assert_array_equal(t_scale, outs[R][2])
    assert got.latency_ns == pytest.approx(want.latency_ns, rel=1e-4)
    assert got.congestion_ns == pytest.approx(want.congestion_ns, rel=1e-3, abs=1e-6)
    r_got = outs[R][0]
    assert got.latency_ns == pytest.approx(r_got.latency_ns, rel=1e-5)
    assert got.congestion_ns == pytest.approx(r_got.congestion_ns, rel=1e-5)
    assert got.bandwidth_ns == pytest.approx(r_got.bandwidth_ns, rel=1e-5, abs=1e-6)


def test_scale_rows_change_latency_only():
    """A scaled row moves latency and nothing else: the cascade's final
    times, slot indices and per-stage delays are the unscaled row's."""
    rm, tr = _reuse_setup(T)
    model = T.DeviceCacheModel(
        T.DeviceCacheConfig(capacity_bytes=2 * PAGE * 64, line_bytes=PAGE), _flat(T), [rm])
    scale = model.latency_scale(model.observe(tr))
    an = T.EpochAnalyzer(_flat(T), device="cpu")
    base, cached = an.analyze(tr), an.analyze(tr, lat_scale=scale)
    assert cached.latency_ns < base.latency_ns
    assert cached.congestion_ns == base.congestion_ns
    np.testing.assert_array_equal(cached.per_switch_congestion_ns,
                                  base.per_switch_congestion_ns)


# --------------------------------------------------------------------------- #
# attach: the pre-analysis is the reference's; capacity 0 is bitwise no cache
# --------------------------------------------------------------------------- #


def _attach_program(pkg):
    rm = pkg.RegionMap()
    rm.alloc("w", 1 << 20, "param")
    rm.alloc("kv", 16 * PAGE, "kvcache")
    phases = [pkg.Phase("fwd", flops=5e8,
                        accesses=(pkg.Access("w", 1 << 20), pkg.Access("kv", 1 << 22, True)))]
    return rm, phases


def _mig_cfg(pkg):
    return pkg.MigrationConfig(mode="software", promote_threshold=1,
                               local_budget_bytes=1 << 30, demote_pool="cxl_pool")


def _attached(pkg, migration_cfg=None, **sim_kw):
    rm, phases = _attach_program(pkg)
    sim_kw.setdefault("async_analysis", False)  # both packages synchronous
    if pkg is R:
        step = jax.jit(lambda a: (a * 2).sum())
    else:
        step = lambda a: (a * 2).sum()  # noqa: E731
        sim_kw.setdefault("device", "cpu")
    topo = pkg.two_tier_topology()
    if migration_cfg is not None:
        sim_kw["migration"] = pkg.MigrationSimulator(migration_cfg(pkg), rm, topo.flatten())
    sim = pkg.CXLMemSim(topo, pkg.ClassMapPolicy({"kvcache": "cxl_pool"}),
                        hw=pkg.TPU_V5E, **sim_kw)
    return sim.attach(step, phases, rm)


def _run_attach(pkg, steps=2, **kw):
    x = jnp.ones((32,)) if pkg is R else torch.ones(32)
    with _attached(pkg, **kw) as prog:
        return prog.run(steps, x)


@pytest.mark.parametrize("variant", ["cache", "migration", "migration+cache"])
def test_attach_pre_analysis_is_the_reference_bitwise(variant):
    """Each step's batch after migration and the cache — remapped epochs,
    injected copy events and scale rows — is the reference's, bit for bit."""
    progs = {}
    for pkg in (R, T):
        kw = {}
        if "cache" in variant:
            kw["cache"] = pkg.DeviceCacheConfig(capacity_bytes=1 << 22, line_bytes=PAGE)
        if "migration" in variant:
            kw["migration_cfg"] = _mig_cfg
        progs[pkg] = _attached(pkg, **kw)
    for _ in range(3):
        got, want = progs[T]._epoch_batch(), progs[R]._epoch_batch()
        assert len(got[0]) == len(want[0])
        for a, b in zip(got[0], want[0]):
            _assert_events_equal(a, b)
        assert got[1] == want[1]
        _assert_scales_equal(got[2], want[2])
    if "migration" in variant:
        assert progs[T].sim.migration.moved_bytes_total > 0
    for pkg in (R, T):
        progs[pkg].close()


def test_promoted_region_moves_pool_in_the_next_step():
    """Migration reaches the tracer: a region promoted at the end of one
    step is read from local DRAM in the next step's epochs (the attached
    program re-synthesizes its traces when migration is on)."""
    prog = _attached(T, migration_cfg=_mig_cfg)
    kv = prog.regions["kv"]
    assert kv.pool == 1
    batches = []
    analyze = prog._analyzer.analyze_batch

    def recording(traces, lat_scales=None):
        batches.append(list(traces))
        return analyze(traces, lat_scales)

    prog._analyzer.analyze_batch = recording
    prog.run(2, torch.ones(32))
    assert prog.sim.migration.promotions >= 1 and kv.pool == 0
    (first,), (second,) = batches
    in_first = first.region == kv.rid
    # step 1: the structural events read pool 1, plus the copy traffic
    # (read from pool 1, written to local DRAM) at the epoch's end
    structural = in_first & (first.t_ns < first.t_ns.max())
    assert (first.pool[structural] == 1).all()
    # step 2: the same region's events are in local DRAM
    assert (second.pool[second.region == kv.rid] == 0).all()
    assert prog.report.migration_moved_bytes == kv.nbytes


def test_attach_with_device_cache_lowers_latency():
    reports = {
        cap: _run_attach(T, cache=T.DeviceCacheConfig(capacity_bytes=cap, line_bytes=PAGE))
        for cap in (0, 1 << 24)
    }
    assert reports[1 << 24].cache_hit_fraction > 0
    assert reports[1 << 24].latency_s < reports[0].latency_s


@pytest.mark.parametrize("other", ["cache0", "migration-off"])
def test_zero_capacity_and_migration_off_attach_are_bitwise_no_cache(other):
    base = _run_attach(T, steps=3)
    if other == "cache0":
        got = _run_attach(T, steps=3,
                          cache=T.DeviceCacheConfig(capacity_bytes=0, line_bytes=PAGE))
        assert got.cache_hit_fraction == 0.0 and np.isnan(base.cache_hit_fraction)
    else:
        got = _run_attach(
            T, steps=3,
            migration_cfg=lambda pkg: dataclasses.replace(_mig_cfg(pkg), mode="off"))
        assert got.migration_moved_bytes == 0.0
    for f in ("epochs", "latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(got, f) == getattr(base, f), f
    for f in ("per_pool_latency_ns", "per_switch_congestion_ns", "per_switch_bandwidth_ns"):
        np.testing.assert_array_equal(getattr(got, f), getattr(base, f))


@pytest.mark.parametrize("variant", ["cache", "migration", "migration+cache"])
def test_attach_matches_reference(variant):
    """The port's attach with migration and/or the cache against the
    reference's synchronous ``impl='inline'`` attach on the same program."""
    reps = {}
    for pkg in (R, T):
        kw = {}
        if "cache" in variant:
            kw["cache"] = pkg.DeviceCacheConfig(capacity_bytes=1 << 22, line_bytes=PAGE)
        if "migration" in variant:
            kw["migration_cfg"] = _mig_cfg
        reps[pkg] = _run_attach(pkg, steps=3, **kw)
    got, want = reps[T], reps[R]
    assert got.epochs == want.epochs == 3
    for f in ("latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-5), f
    np.testing.assert_allclose(got.per_pool_latency_ns, want.per_pool_latency_ns, rtol=1e-5)
    assert got.migration_moved_bytes == want.migration_moved_bytes
    if "cache" in variant:
        assert got.cache_hit_fraction == want.cache_hit_fraction > 0
    if "migration" in variant:
        assert got.migration_moved_bytes > 0


# --------------------------------------------------------------------------- #
# migration and the cache under the shared fabric
# --------------------------------------------------------------------------- #


def _fabric_tenant(pkg, name, kv_pages, hot=False):
    rm = pkg.RegionMap()
    rm.alloc("kv_" + name, kv_pages * PAGE, "kvcache")
    rm.alloc("act_" + name, 1 << 18, "activation")
    mult = 64 if hot else 1
    phases = [
        pkg.Phase("fwd", flops=5e8,
                  accesses=(pkg.Access("kv_" + name, mult * kv_pages * PAGE, True),
                            pkg.Access("act_" + name, 1 << 18)))
    ]
    return pkg.Tenant(name, phases, rm, pkg.ClassMapPolicy({"kvcache": "shared_pool"}))


def _session(pkg, tenants, **kw):
    kw.setdefault("async_analysis", False)  # both packages synchronous
    if pkg is T:
        kw.setdefault("device", "cpu")
    topo = kw.pop("topo", None) or pkg.pooled_topology(n_hosts=2, cxl_bandwidth_gbps=8.0)
    return pkg.FabricSession(topo, tenants(pkg), hw=pkg.TPU_V5E, **kw)


def _fabric(pkg, tenants, rounds=2, **kw):
    with _session(pkg, tenants, **kw) as sess:
        sess.run(rounds)
        return sess


def _mover_victim(pkg):
    return [_fabric_tenant(pkg, "mover", 1024, hot=True), _fabric_tenant(pkg, "victim", 64)]


def test_tenant_migration_raises_neighbor_congestion():
    base = _fabric(T, _mover_victim)
    mig = _fabric(T, _mover_victim, migration=T.MigrationConfig(
        mode="software", promote_threshold=2, local_budget_bytes=1 << 32))
    assert mig.report.migration_moved_bytes > 0
    # the mover's promotion copy traffic queued at the shared switch and
    # showed up in the *victim's* congestion share
    assert mig.report.hosts[1].congestion_s > base.report.hosts[1].congestion_s


def test_fabric_tenants_share_one_local_budget():
    sess = _fabric(
        T, lambda pkg: [_fabric_tenant(pkg, "a", 1024, hot=True),
                        _fabric_tenant(pkg, "b", 1024, hot=True)],
        topo=T.pooled_topology(n_hosts=2),
        migration=T.MigrationConfig(
            mode="software", promote_threshold=2,
            # room for one tenant's kv region (+ both activations), not two
            local_budget_bytes=1024 * PAGE + (1 << 20),
        ),
    )
    assert len({id(s._budget) for s in sess._migration}) == 1
    promoted = sum(s.promotions for s in sess._migration)
    assert promoted == 1  # the second promotion lost the shared budget race


def test_fabric_migration_off_builds_no_simulator():
    sess = _fabric(T, _mover_victim, migration=T.MigrationConfig(mode="off"))
    assert sess._migration == [None, None] and not sess._has_migration
    assert sess._round_cache is not None  # stateless: the round is replayed


def _fabric_kw(pkg, variant):
    kw = {}
    if "migration" in variant:
        kw["migration"] = pkg.MigrationConfig(
            mode="software", promote_threshold=2, local_budget_bytes=1 << 32)
    if "cache" in variant:
        kw["cache"] = pkg.DeviceCacheConfig(capacity_bytes=1 << 24, line_bytes=PAGE)
    if "coherency" in variant:
        kw["coherency"] = pkg.CoherencyConfig(shared_classes=("kvcache",))
    return kw


@pytest.mark.parametrize("variant", ["migration+cache", "migration+cache+coherency"])
def test_fabric_pre_analysis_is_the_reference_bitwise(variant):
    """Each round's merged epochs (remapped, copy traffic and BI injected),
    miss latencies and the shared cache's scale rows are the reference's,
    bit for bit, round after round."""
    sess = {pkg: _session(pkg, _mover_victim, **_fabric_kw(pkg, variant)) for pkg in (R, T)}
    for _ in range(3):
        got, want = sess[T]._merged_round(), sess[R]._merged_round()
        assert len(got[0]) == len(want[0])
        for a, b in zip(got[0], want[0]):
            _assert_events_equal(a, b)
        np.testing.assert_array_equal(got[1], want[1])
        _assert_scales_equal(got[2], want[2])
    assert sum(s.promotions for s in sess[T]._migration) >= 1
    for pkg in (R, T):
        sess[pkg].close()


@pytest.mark.parametrize("variant", ["migration", "cache", "migration+cache"])
def test_fabric_matches_reference(variant):
    """Per-host clocks and fabric totals of a stateful fabric (no round
    replay) against the reference's synchronous ``impl='inline'`` session."""
    sessions = {pkg: _fabric(pkg, _mover_victim, rounds=3, **_fabric_kw(pkg, variant))
                for pkg in (R, T)}
    got, want = sessions[T].report, sessions[R].report
    assert sessions[T]._round_cache is None  # stateful: never replayed
    assert got.rounds == want.rounds == 3 and got.epochs == want.epochs
    for f in ("latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-5), f
    assert got.migration_moved_bytes == want.migration_moved_bytes
    if "cache" in variant:
        assert got.cache_hit_fraction == want.cache_hit_fraction > 0
    for hg, hw in zip(got.hosts, want.hosts):
        assert hg.native_s == pytest.approx(hw.native_s, rel=1e-12)
        for f in ("latency_s", "congestion_s", "bandwidth_s"):
            assert getattr(hg, f) == pytest.approx(getattr(hw, f), rel=1e-5, abs=1e-12), f
    np.testing.assert_allclose(got.per_switch_congestion_ns, want.per_switch_congestion_ns,
                               rtol=1e-5, atol=1e-2)


def test_fabric_zero_capacity_cache_is_bitwise_no_cache():
    base = _fabric(T, _mover_victim, rounds=2).report
    zero = _fabric(T, _mover_victim, rounds=2,
                   cache=T.DeviceCacheConfig(capacity_bytes=0, line_bytes=PAGE)).report
    for f in ("latency_s", "congestion_s", "bandwidth_s"):
        assert getattr(zero, f) == getattr(base, f), f
    for hz, hb in zip(zero.hosts, base.hosts):
        assert (hz.latency_s, hz.congestion_s, hz.bandwidth_s) == (
            hb.latency_s, hb.congestion_s, hb.bandwidth_s)


def test_fabric_scales_reach_the_analyzer_in_epoch_order():
    """The cache's per-epoch scale rows travel with their merged epochs:
    the round's analysis equals the f64 oracle on the captured epochs and
    scales at the reference's bars."""
    sess = _session(T, _mover_victim,
                    cache=T.DeviceCacheConfig(capacity_bytes=1 << 24, line_bytes=PAGE))
    sess.round()  # warm the tags
    merged, _, scales = sess._merged_round()
    assert any(s is not None for s in scales)
    bd = sess._analyzer.analyze_batch(merged, scales)
    ref = None
    for tr, sc in zip(merged, scales):
        b = T.analyze_ref(sess.flat, tr, lat_scale=sc,
                          bw_window_ns=max(float(tr.t_ns.max()) + 1.0, 1e4) / 128,
                          n_windows=128)
        ref = b if ref is None else ref + b
    assert bd.latency_ns == pytest.approx(ref.latency_ns, rel=1e-4)
    assert bd.congestion_ns == pytest.approx(ref.congestion_ns, rel=1e-3, abs=1e-6)
    np.testing.assert_allclose(bd.per_host_latency_ns, ref.per_host_latency_ns, rtol=1e-4)
    assert ns_to_s(bd.latency_ns) > 0
