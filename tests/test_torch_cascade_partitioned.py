"""The cascade kernels' decomposition, rehearsed on the CPU: the partitioned
mirrors ``ref.serial_queue_cascade_partitioned`` and
``ref.qos_cascade_partitioned`` split each row between k CTAs as the kernels
do (pads cut off, count-then-max carries, merge-path splits, merges skipped
when they would be the identity, one merge flag per row and stage).  They
must equal the plain versions bitwise (slot indices and final times) for any
k, and the reference's plain versions at its own bars: per-stage delays to
rtol 1e-5, final times to rtol 1e-6, slot indices exactly equal.  A small
``tile`` puts several tiles in every CTA's slice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as r_topo
from repro.core.analyzer import plan_cascade as r_plan
from repro.kernels import ref as r_ref
from repro_torch.core import analyzer as t_an
from repro_torch.core import topology as t_topo
from repro_torch.kernels import congestion as t_kernel
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(2)

CTAS = [1, 2, 3, 4, 7]
TILE = 256
BIG = np.float32(np.finfo(np.float32).max / 4)
STTS = np.asarray([4.0, 2.0, 0.5], np.float32)
WEIGHTS = (4.0, 2.0, 1.0)


def _times(rng, rows, n, kind):
    """Sorted f32 arrival times: uniform, bursty (clusters: deep queues),
    or tie-heavy integers from a span of n/8."""
    out = np.empty((rows, n), np.float32)
    for r in range(rows):
        if kind == "ties":
            x = rng.integers(0, max(2, n // 8), n)
        elif kind == "bursty":
            centers = rng.uniform(0, 3.0 * n, max(1, n // 64))
            x = rng.choice(centers, size=n) + rng.exponential(20.0, size=n)
        else:
            x = rng.uniform(0, 3.0 * n, n)
        out[r] = np.sort(x)
    return out


def _pad(t, bits, *rest, count):
    """The stager's padding: the last ``count`` events of each row at
    finfo.max/4 with no route."""
    t[:, -count:] = BIG
    bits[:, -count:] = 0
    for x in rest:
        x[:, -count:] = 0


def _fifo_case(name):
    """(t [R, N], bits, stts, hosts or None, n_hosts) for a FIFO cascade."""
    rng = np.random.default_rng(sum(map(ord, name)))
    rows, n = 3, 5000
    if name in ("uniform", "bursty", "ties", "pads"):
        t = _times(rng, rows, n, "uniform" if name == "pads" else name)
        bits = rng.integers(0, 8, (rows, n)).astype(np.int32)
        if name == "pads":
            _pad(t, bits, count=1700)
        return t, bits, STTS, None, 1
    if name.startswith("pooled8"):
        flat = t_topo.pooled_topology(n_hosts=8).flatten()
    else:  # figure1 declared for 3 hosts
        fig = t_topo.figure1_topology()
        flat = t_topo.Topology(fig.pools, fig.switches, fig.rc_latency_ns, fig.rc_bandwidth_gbps,
                               fig.rc_stt_ns, fig.local_dram_latency_ns, n_hosts=3).flatten()
    bits_pool, _, order = t_an.plan_cascade(flat)
    vp = rng.integers(0, flat.route.shape[0], (rows, n))
    t = _times(rng, rows, n, "ties" if name.endswith("ties") else "bursty")
    bits = bits_pool[vp].astype(np.int32)
    hosts = (vp // flat.n_pools).astype(np.int32)
    _pad(t, bits, hosts, count=900)
    return t, bits, flat.switch_stt_ns[list(order)].astype(np.float32), hosts, flat.n_hosts


def _fifo(t, bits, stts, hosts, n_hosts, k=None):
    args = [torch.from_numpy(x) for x in (t, bits, stts)]
    h = None if hosts is None else torch.from_numpy(hosts)
    if k is None:
        return t_ref.serial_queue_cascade(*args, hosts=h, n_hosts=n_hosts)
    return t_ref.serial_queue_cascade_partitioned(*args, k, hosts=h, n_hosts=n_hosts, tile=TILE)


def _assert_mirror(got, want, rtol=1e-5, atol=0.0):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[2], want[2], rtol=rtol, atol=atol)


# --------------------------------------------------------------------------- #
# the CTAs-per-row rule
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("rows, n, sms, want", [
    (32, 1 << 20, 132, 4),  # fabric8's round batch: 128 CTAs
    (1, 1 << 20, 132, 8),  # one row: a whole portable cluster
    (256, 4096, 132, 1),  # more rows than SMs
    (132, 1 << 20, 132, 1),
    (16, 1 << 20, 132, 8),
    (32, 131072, 132, 4),  # main's batch
    (4, 3000, 132, 1),  # under one tile a row
    (2, 3 * 4096, 132, 3),  # one CTA per tile at most
    (8, 1 << 20, 114, 8),  # a card with fewer SMs
])
def test_ctas_per_row_rule(rows, n, sms, want):
    k = t_kernel.ctas_per_row(rows, n, sms)
    assert k == want
    assert 1 <= k <= t_kernel.MAX_CTAS
    assert rows * k <= max(sms, rows)


# --------------------------------------------------------------------------- #
# the FIFO mirror
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("k", CTAS)
@pytest.mark.parametrize("name", ["bursty", "ties", "pads", "pooled8", "pooled8_ties",
                                  "figure1x3"])
def test_fifo_mirror_equals_the_plain_cascade(name, k):
    case = _fifo_case(name)
    got = _fifo(*case, k=k)
    _assert_mirror(got[:3], _fifo(*case))
    flags = got[3]
    assert flags.shape == (case[0].shape[0], len(case[2])) and flags.dtype == torch.int8
    assert (flags[:, 0] == t_ref.MERGE_NONE).all()
    assert set(flags.unique().tolist()) <= {t_ref.MERGE_NONE, t_ref.MERGE_RAN, t_ref.MERGE_SKIPPED}


def test_pooled8_rows_skip_the_rc_merges():
    """On pooled_topology(n_hosts=8) a per-host RC never queues (its
    arrivals leave the shared switch >= 2 ns apart, its STT is 0.5 ns), so
    only the merge after the shared switch runs: 7 of 8 are skipped."""
    t, bits, stts, hosts, n_hosts = _fifo_case("pooled8")
    got = _fifo(t, bits, stts, hosts, n_hosts, k=4)
    want = torch.tensor([t_ref.MERGE_NONE, t_ref.MERGE_RAN] + [t_ref.MERGE_SKIPPED] * 7,
                        dtype=torch.int8)
    assert torch.equal(got[3], want.expand(t.shape[0], -1))


def test_zero_delay_stage_still_merges_its_ties():
    """A stage with zero service time delays nothing, yet the merge after it
    puts its events first among equal times: the skip must not fire there.
    Dropping that merge changes the slot order."""
    rng = np.random.default_rng(3)
    n = 2000
    t = np.sort(rng.integers(0, 300, n)).astype(np.float32)[None]
    bits = rng.integers(0, 8, (1, n)).astype(np.int32)
    stts = np.asarray([2.0, 0.0, 0.5], np.float32)
    got = _fifo(t, bits, stts, None, 1, k=3)
    want = _fifo(t, bits, stts, None, 1)
    _assert_mirror(got[:3], want)
    assert float(want[2][0, 1]) == 0.0  # stage 1 moved nothing
    assert got[3][0].tolist() == [t_ref.MERGE_NONE, t_ref.MERGE_RAN, t_ref.MERGE_RAN]
    skipped = t_ref.serial_queue_cascade(
        *[torch.from_numpy(x) for x in (t, bits, stts)], merge_plan=((), ((0, None),), ()))
    assert not torch.equal(skipped[1], want[1])


def test_rows_that_never_queue_run_no_merge():
    t, bits, stts, _, _ = _fifo_case("bursty")
    bits[1] = 0
    got = _fifo(t, bits, stts, None, 1, k=4)
    assert (got[3][1] == t_ref.MERGE_NONE).all()
    np.testing.assert_array_equal(got[1][1].numpy(), np.arange(t.shape[1]))


def test_a_routed_pad_keeps_the_whole_row_live():
    """A pad that carries a route bit queues like any event, so the cut at
    the first pad must not apply: the mirror then runs the whole row."""
    t, bits, stts, _, _ = _fifo_case("pads")
    bits[0, -5] = 1
    _assert_mirror(_fifo(t, bits, stts, None, 1, k=3)[:3], _fifo(t, bits, stts, None, 1))
    assert t_ref._live_length(torch.from_numpy(t[0]), torch.from_numpy(bits[0])) == t.shape[1]
    assert t_ref._live_length(torch.from_numpy(t[1]), torch.from_numpy(bits[1])) == t.shape[1] - 1700


@pytest.mark.parametrize("bursty", [False, True], ids=["uniform", "bursty"])
def test_fifo_mirror_matches_the_reference(bursty):
    """The reference's own cascade case (tests/test_torch_cascade.py's)."""
    rng = np.random.default_rng(5)
    n = 3000
    if bursty:
        centers = rng.uniform(0, 1e5, size=max(1, n // 64))
        x = rng.choice(centers, size=n) + rng.exponential(20.0, size=n)
    else:
        x = rng.uniform(0, 1e5, n)
    ts = np.sort(x).astype(np.float32)
    bits = rng.integers(0, 8, n).astype(np.int32)
    want = r_ref.serial_queue_cascade(jnp.asarray(ts), jnp.asarray(bits), jnp.asarray(STTS))
    got = _fifo(ts[None], bits[None], STTS, None, 1, k=3)
    np.testing.assert_allclose(got[2][0].numpy(), np.asarray(want[2]), rtol=1e-5)
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))


def test_fifo_hosts_mirror_matches_the_reference():
    """A pooled 3-host fabric's own route words, host-segmented."""
    flat = r_topo.pooled_topology(n_hosts=3).flatten()
    bits_pool, _, order = r_plan(flat)
    rng = np.random.default_rng(12)
    n = 3000
    ts = np.sort(rng.uniform(0, 2e4, n)).astype(np.float32)
    vp = rng.integers(0, flat.route.shape[0], n)
    bits = bits_pool[vp].astype(np.int32)
    hosts = (vp // flat.n_pools).astype(np.int32)
    stts = flat.switch_stt_ns[list(order)].astype(np.float32)
    want = r_ref.serial_queue_cascade(jnp.asarray(ts), jnp.asarray(bits), jnp.asarray(stts),
                                      hosts=jnp.asarray(hosts), n_hosts=3)
    got = _fifo(ts[None], bits[None], stts, hosts[None], 3, k=4)
    np.testing.assert_allclose(got[2][0].numpy(), np.asarray(want[2]), rtol=1e-5)
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))


def test_merge_path_places_like_the_plain_merge():
    """The merge-path placement over any tile and segment split equals the
    plain two-run merge, ties putting run a first."""
    rng = np.random.default_rng(21)
    n = 700
    x = np.sort(rng.integers(0, 200, n)).astype(np.float32)
    changed = rng.random(n) < 0.4
    x[changed] = np.sort(x[changed] + rng.integers(0, 30, changed.sum()))
    xt, ct = torch.from_numpy(x), torch.from_numpy(changed)
    want = t_ref.merge_sorted_runs(xt, ct, torch.arange(n))
    for k, tile in ((1, 4096), (3, 64), (7, 16)):
        pa, pb = t_ref._merge_path(xt[ct], xt[~ct], t_ref._segments(n, k), tile)
        got = t_ref._merge_into(pa, pb, (xt[ct], torch.arange(n)[ct]),
                                (xt[~ct], torch.arange(n)[~ct]))
        assert torch.equal(got[1], want[1])


# --------------------------------------------------------------------------- #
# the QoS mirror
# --------------------------------------------------------------------------- #


def _qos_chain(pkg, disciplines):
    switches = [
        pkg.Switch(f"sw{d}", 70.0, 64.0 - 8.0 * d, 2.0 + d,
                   parent=f"sw{d - 1}" if d else None, discipline=disc,
                   class_weights=WEIGHTS if disc == "wfq" else None)
        for d, disc in enumerate(disciplines)
    ]
    last = f"sw{len(switches) - 1}"
    return pkg.Topology(
        pools=[pkg.Pool("local", 88.9, 76.8, 1 << 36, is_local=True),
               pkg.Pool("far1", 180.0, 32.0, 1 << 38, parent=last),
               pkg.Pool("far2", 200.0, 32.0, 1 << 38, parent=last)],
        switches=switches, n_qos_classes=len(WEIGHTS),
    )


def _tables(flat, an):
    order = list(an.plan_cascade(flat)[2])
    return (flat.switch_stt_ns[order].astype(np.float32),
            np.asarray(flat.discipline_codes())[order].astype(np.int32),
            flat.class_weight_table()[order].astype(np.float32))


def _qos_case(name):
    """(t, bits, stts, qos, disc, w, hosts or None, n_hosts)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    rows, n = 3, 4000
    if name.startswith("pooled8"):
        flat = t_topo.pooled_topology(n_hosts=8, discipline="priority",
                                      class_weights=(1.0, 1.0)).flatten()
        stts, disc, w = _tables(flat, t_an)
        bits_pool = t_an.plan_cascade(flat)[0]
        vp = rng.integers(0, flat.route.shape[0], (rows, n))
        bits = bits_pool[vp].astype(np.int32)
        hosts = (vp // flat.n_pools).astype(np.int32)
        qos = rng.integers(0, 2, (rows, n)).astype(np.int32)
        t = _times(rng, rows, n, "ties" if name.endswith("ties") else "bursty")
        _pad(t, bits, hosts, qos, count=700)
        return t, bits, stts, qos, disc, w, hosts, flat.n_hosts
    discs = {"mixed": ("wfq", "priority", "fifo"), "priority": ("priority",) * 3,
             "wfq": ("wfq",) * 3, "zero_service": ("priority", "wfq", "wfq")}
    flat = _qos_chain(t_topo, discs[name.split("_ties")[0]]).flatten()
    stts, disc, w = _tables(flat, t_an)
    if name.startswith("zero_service"):
        stts = stts.copy()
        stts[1] = 0.0  # stages (wfq, wfq at zero service, priority, fifo)
    bits_pool = t_an.plan_cascade(flat)[0]
    bits = bits_pool[rng.integers(0, flat.n_pools, (rows, n))].astype(np.int32)
    bits[1] = rng.integers(0, 1 << len(stts), n)  # masks that differ between stages
    qos = rng.integers(0, 3, (rows, n)).astype(np.int32)
    t = _times(rng, rows, n, "ties" if "ties" in name else "uniform")
    _pad(t, bits, qos, count=1100)
    return t, bits, stts, qos, disc, w, None, 1


def _qos(t, bits, stts, qos, disc, w, hosts, n_hosts, k=None):
    args = [torch.from_numpy(x) for x in (t, bits, stts, qos, disc, w)]
    h = None if hosts is None else torch.from_numpy(hosts)
    if k is None:
        return t_ref.qos_cascade_dyn(*args, hosts=h, n_hosts=n_hosts)
    return t_ref.qos_cascade_partitioned(*args, k, hosts=h, n_hosts=n_hosts, tile=TILE)


@pytest.mark.parametrize("k", CTAS)
@pytest.mark.parametrize("name", ["mixed_ties", "priority", "wfq_ties", "zero_service_ties",
                                  "pooled8", "pooled8_ties"])
def test_qos_mirror_equals_the_plain_cascade(name, k):
    case = _qos_case(name)
    got = _qos(*case, k=k)
    _assert_mirror(got[:3], _qos(*case))
    assert got[3].shape == (case[0].shape[0], len(case[2]))
    assert (got[3][:, 0] == t_ref.MERGE_NONE).all()


def test_qos_zero_service_case_folds_at_the_unscanned_stage():
    """With stages (wfq, wfq at zero service, priority, fifo) on the chain's
    own route words the fold after stage 0 is elided (WFQ over the same
    events), so the row is still out of order at stage 1, which scans
    nothing: the fold before stage 2 must run."""
    got = _qos(*_qos_case("zero_service_ties"), k=3)
    assert got[3][0].tolist()[:3] == [t_ref.MERGE_NONE, t_ref.MERGE_NONE, t_ref.MERGE_RAN]


def test_qos_fold_orders_minus_zero_before_plus_zero():
    """The QoS key puts -0.0 before +0.0, while the FIFO merge ties them.
    Stage 0 queues an event at -0.0 (it starts at -0.0 + 0.0 = +0.0) ahead
    of an untouched -0.0: by float comparison the row is still in order, so
    the FIFO cascade skips its merge, but the stable QoS fold must run and
    put the untouched -0.0 first."""
    t = np.asarray([[-0.0, -0.0, 0.0, 10.0, 10.0, 50.0]], np.float32)
    bits = np.asarray([[1, 0, 2, 1, 1, 3]], np.int32)
    qos = np.zeros_like(bits)
    stts = np.asarray([2.0, 1.0], np.float32)
    disc = np.asarray([t_ref.DISC_PRIORITY, t_ref.DISC_FIFO], np.int32)
    w = np.ones((2, 2), np.float32)
    for k in (1, 2, 3):
        got = _qos(t, bits, stts, qos, disc, w, None, 1, k=k)
        want = _qos(t, bits, stts, qos, disc, w, None, 1)
        _assert_mirror(got[:3], want)
        assert got[3][0].tolist() == [t_ref.MERGE_NONE, t_ref.MERGE_RAN]
        fifo = _fifo(t, bits, stts, None, 1, k=k)
        _assert_mirror(fifo[:3], _fifo(t, bits, stts, None, 1))
        assert fifo[3][0].tolist() == [t_ref.MERGE_NONE, t_ref.MERGE_SKIPPED]
    assert want[1][0, :2].tolist() == [1, 0]  # the untouched -0.0 now first
    assert str(float(want[0][0, 0])) == "-0.0" and str(float(want[0][0, 1])) == "0.0"


_r_dyn = jax.jit(r_ref.qos_cascade_dyn, static_argnames=("n_hosts",))


@pytest.mark.parametrize("name", ["mixed_ties", "priority", "wfq_ties", "pooled8_ties"])
def test_qos_mirror_matches_the_reference(name):
    """The reference's own qos_cascade_dyn, row by row, at its bars."""
    t, bits, stts, qos, disc, w, hosts, n_hosts = _qos_case(name)
    got = _qos(t, bits, stts, qos, disc, w, hosts, n_hosts, k=4)
    for r in range(t.shape[0]):
        want = _r_dyn(jnp.asarray(t[r]), jnp.asarray(bits[r]), jnp.asarray(stts),
                      jnp.asarray(qos[r]), jnp.asarray(disc), jnp.asarray(w),
                      hosts=None if hosts is None else jnp.asarray(hosts[r]), n_hosts=n_hosts)
        np.testing.assert_array_equal(got[1][r].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0][r].numpy(), np.asarray(want[0]), rtol=1e-6)
        np.testing.assert_allclose(got[2][r].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-3)


def test_all_fifo_qos_mirror_equals_the_fifo_mirror():
    """Every switch FIFO: the QoS fold degenerates to the FIFO merge, and
    both mirrors give the same final times and flags."""
    flat = _qos_chain(t_topo, ("fifo",) * 3).flatten()
    stts, disc, w = _tables(flat, t_an)
    rng = np.random.default_rng(8)
    t = _times(rng, 2, 3000, "bursty")
    bits = t_an.plan_cascade(flat)[0][rng.integers(0, flat.n_pools, (2, 3000))].astype(np.int32)
    qos = rng.integers(0, 3, (2, 3000)).astype(np.int32)
    q = _qos(t, bits, stts, qos, disc, w, None, 1, k=3)
    f = _fifo(t, bits, stts, None, 1, k=3)
    assert torch.equal(q[0], f[0]) and torch.equal(q[1], f[1]) and torch.equal(q[3], f[3])
