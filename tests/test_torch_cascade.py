"""Port parity: the plain PyTorch congestion cascade (single-host and
host-segmented) and the single-switch scan against the reference's jnp
oracles and its Pallas kernels (interpret mode), at the bar of
``tests/test_fused_cascade.py``: per-stage delay to rtol 1e-5, final times
to rtol 1e-6, slot indices exactly equal; the scan to rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.analyzer import plan_cascade as r_plan
from repro.core.topology import chained_topology, figure1_topology, pooled_topology
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels.congestion import congestion_cascade as r_pallas
from repro.kernels.congestion import congestion_cascade_hosts as r_pallas_hosts
from repro_torch.kernels import congestion as t_kernel
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(2)

STTS = np.asarray([4.0, 2.0, 0.5], np.float32)


def _inputs(seed, n=3000, s=3, bursty=False):
    rng = np.random.default_rng(seed)
    if bursty:  # clustered arrivals: deep queues at every stage
        centers = rng.uniform(0, 1e5, size=max(1, n // 64))
        t = rng.choice(centers, size=n) + rng.exponential(20.0, size=n)
    else:
        t = rng.uniform(0, 1e5, n)
    ts = np.sort(t).astype(np.float32)
    bits = rng.integers(0, 1 << s, n).astype(np.int32)
    return ts, bits


def _torch_row(ts, bits, stts, plan=None):
    tf, idx, psd = t_ref.serial_queue_cascade(
        torch.from_numpy(ts)[None], torch.from_numpy(bits)[None],
        torch.from_numpy(stts), plan,
    )
    return tf[0].numpy(), idx[0].numpy(), psd[0].numpy()


def _assert_cascade_close(got, want):
    tf_g, idx_g, psd_g = (np.asarray(x) for x in got)
    tf_w, idx_w, psd_w = (np.asarray(x) for x in want)
    np.testing.assert_allclose(psd_g, psd_w, rtol=1e-5)
    np.testing.assert_allclose(tf_g, tf_w, rtol=1e-6)
    np.testing.assert_array_equal(idx_g, idx_w)


@pytest.mark.parametrize("bursty", [False, True], ids=["uniform", "bursty"])
def test_plain_cascade_matches_jnp_reference(bursty):
    ts, bits = _inputs(5, bursty=bursty)
    want = r_ref.serial_queue_cascade(jnp.asarray(ts), jnp.asarray(bits), jnp.asarray(STTS))
    _assert_cascade_close(_torch_row(ts, bits, STTS), want)


def test_plain_cascade_matches_pallas_interpret():
    ts, bits = _inputs(5)
    want = r_pallas(
        jnp.asarray(ts), jnp.asarray(bits), jnp.asarray(STTS), block=1024, interpret=True
    )
    _assert_cascade_close(_torch_row(ts, bits, STTS), want)


@pytest.mark.parametrize("topo", ["figure1", "chain3"])
def test_plain_cascade_with_merge_plan(topo):
    """Route words from the topology's own bit table, so the pruned plan's
    extra set bits (``within`` masks) mean what the plan says."""
    flat = (figure1_topology() if topo == "figure1" else chained_topology(3)).flatten()
    bits_pool, plan, order = r_plan(flat)
    rng = np.random.default_rng(11)
    n = 3000
    ts = np.sort(rng.uniform(0, 5e4, n)).astype(np.float32)
    bits = bits_pool[rng.integers(0, flat.n_pools, n)].astype(np.int32)
    stts = flat.switch_stt_ns[list(order)].astype(np.float32)
    want = r_ref.serial_queue_cascade(
        jnp.asarray(ts), jnp.asarray(bits), jnp.asarray(stts), merge_plan=plan
    )
    _assert_cascade_close(_torch_row(ts, bits, stts, plan), want)
    # the conservative schedule agrees on totals and final times per event
    tf_c, idx_c, psd_c = _torch_row(ts, bits, stts)
    tf_p, idx_p, psd_p = _torch_row(ts, bits, stts, plan)
    np.testing.assert_allclose(psd_c, psd_p, rtol=1e-5)
    by_event_c = np.empty_like(tf_c)
    by_event_c[idx_c] = tf_c
    by_event_p = np.empty_like(tf_p)
    by_event_p[idx_p] = tf_p
    np.testing.assert_allclose(by_event_c, by_event_p, rtol=1e-6)


def test_batched_rows_equal_row_by_row():
    rows = [_inputs(seed, bursty=seed % 2 == 1) for seed in range(4)]
    ts = np.stack([r[0] for r in rows])
    bits = np.stack([r[1] for r in rows])
    # one row that never queues: its merges must stay skipped
    bits[2] = 0
    tf, idx, psd = t_ops.congestion_cascade(
        torch.from_numpy(ts), torch.from_numpy(bits), torch.from_numpy(STTS)
    )
    assert tf.shape == (4, 3000) and idx.dtype == torch.int32 and psd.shape == (4, 3)
    for b in range(4):
        want = r_ref.serial_queue_cascade(
            jnp.asarray(ts[b]), jnp.asarray(bits[b]), jnp.asarray(STTS)
        )
        _assert_cascade_close((tf[b], idx[b], psd[b]), want)
    np.testing.assert_array_equal(idx[2].numpy(), np.arange(3000))


def test_tied_times_keep_the_reference_order():
    """Integer arrival times tie often; a stage with zero service time moves
    nothing, so the cumulative-delay guard must decide the merges exactly as
    the reference does."""
    rng = np.random.default_rng(3)
    n = 2000
    ts = np.sort(rng.integers(0, 300, n)).astype(np.float32)
    bits = rng.integers(0, 8, n).astype(np.int32)
    for stts in ([0.0, 3.0, 1.0], [2.0, 0.0, 0.5], [1.0, 1.0, 1.0]):
        stts = np.asarray(stts, np.float32)
        want = r_ref.serial_queue_cascade(jnp.asarray(ts), jnp.asarray(bits), jnp.asarray(stts))
        _assert_cascade_close(_torch_row(ts, bits, stts), want)


def test_padded_events_sort_last():
    ts, bits = _inputs(9, n=1000)
    big = np.float32(np.finfo(np.float32).max / 4)
    ts = np.concatenate([ts, np.full(24, big, np.float32)])
    bits = np.concatenate([bits, np.zeros(24, np.int32)])
    want = r_ref.serial_queue_cascade(jnp.asarray(ts), jnp.asarray(bits), jnp.asarray(STTS))
    got = _torch_row(ts, bits, STTS)
    _assert_cascade_close(got, want)
    assert (got[1][-24:] >= 1000).all()


def test_merge_sorted_runs_within_mask():
    """Piecewise merge: only the ``within`` subsequence is permuted."""
    x = torch.tensor([1.0, 5.0, 2.0, 9.0, 3.0, 7.0])
    changed = torch.tensor([False, True, False, True, False, False])
    within = torch.tensor([False, True, True, True, True, False])
    xm, pm = t_ref.merge_sorted_runs(x, changed, torch.arange(6), within=within)
    assert xm.tolist() == [1.0, 2.0, 3.0, 5.0, 9.0, 7.0]
    assert pm.tolist() == [0, 2, 4, 1, 3, 5]


@pytest.mark.parametrize("use_within", [False, True])
def test_merge_sorted_runs_matches_reference(use_within):
    rng = np.random.default_rng(21)
    n = 500
    x = np.sort(rng.integers(0, 200, n)).astype(np.float32)
    changed = rng.random(n) < 0.4
    # the changed run gets later times (as a queue would), still sorted
    x[changed] = np.sort(x[changed] + rng.integers(0, 30, changed.sum()))
    within = changed | (rng.random(n) < 0.5) if use_within else None
    payload = np.arange(n, dtype=np.int32)
    want = r_ref.merge_sorted_runs(
        jnp.asarray(x), jnp.asarray(changed), jnp.asarray(payload),
        within=None if within is None else jnp.asarray(within),
    )
    got = t_ref.merge_sorted_runs(
        torch.from_numpy(x), torch.from_numpy(changed), torch.from_numpy(payload),
        within=None if within is None else torch.from_numpy(within),
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_serial_queue_matches_reference():
    ts, _ = _inputs(2, n=1500, bursty=True)
    mask = np.random.default_rng(2).random(1500) < 0.6
    want = r_ref.serial_queue(jnp.asarray(ts), jnp.asarray(mask), 3.0)
    got = t_ref.serial_queue(torch.from_numpy(ts), torch.from_numpy(mask), 3.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_zero_stages_and_hosts():
    ts, bits = _inputs(1, n=64)
    tf, idx, psd = _torch_row(ts, bits, np.zeros((0,), np.float32))
    np.testing.assert_array_equal(tf, ts)
    np.testing.assert_array_equal(idx, np.arange(64))
    assert psd.shape == (0,)
    tf, idx, psd = t_ref.serial_queue_cascade(
        torch.from_numpy(ts), torch.from_numpy(bits), torch.zeros(0),
        hosts=torch.zeros(64, dtype=torch.int32), n_hosts=2,
    )
    np.testing.assert_array_equal(tf.numpy(), ts)
    assert psd.shape == (0, 2)


# --------------------------------------------------------------------------- #
# host-segmented cascade (the shared fabric's kernel)
# --------------------------------------------------------------------------- #


def _hosts(seed, n, n_hosts):
    return np.random.default_rng(seed + 100).integers(0, n_hosts, n).astype(np.int32)


def _torch_hosts_row(ts, bits, hosts, stts, n_hosts, plan=None):
    tf, idx, psd = t_ref.serial_queue_cascade(
        torch.from_numpy(ts)[None], torch.from_numpy(bits)[None],
        torch.from_numpy(stts), plan,
        hosts=torch.from_numpy(hosts)[None], n_hosts=n_hosts,
    )
    return tf[0].numpy(), idx[0].numpy(), psd[0].numpy()


@pytest.mark.parametrize("bursty", [False, True], ids=["uniform", "bursty"])
def test_plain_hosts_cascade_matches_jnp_reference(bursty):
    ts, bits = _inputs(6, bursty=bursty)
    hosts = _hosts(6, ts.size, 3)
    want = r_ref.serial_queue_cascade(
        jnp.asarray(ts), jnp.asarray(bits), jnp.asarray(STTS),
        hosts=jnp.asarray(hosts), n_hosts=3,
    )
    got = _torch_hosts_row(ts, bits, hosts, STTS, 3)
    assert got[2].shape == (3, 3)
    _assert_cascade_close(got, want)
    # the host axis decomposes the single-host per-stage delays
    _, idx1, psd1 = _torch_row(ts, bits, STTS)
    np.testing.assert_array_equal(got[1], idx1)
    np.testing.assert_allclose(got[2].sum(axis=1), psd1, rtol=1e-6)


def test_plain_hosts_cascade_matches_pallas_interpret():
    """Untied uniform times, so the Pallas kernel's per-stage merge guard
    and the plain version's cumulative one decide alike."""
    ts, bits = _inputs(8, n=2500)
    hosts = _hosts(8, ts.size, 4)
    want = r_pallas_hosts(
        jnp.asarray(ts), jnp.asarray(bits), jnp.asarray(hosts), jnp.asarray(STTS),
        n_hosts=4, block=1024, interpret=True,
    )
    _assert_cascade_close(_torch_hosts_row(ts, bits, hosts, STTS, 4), want)


def test_plain_hosts_cascade_with_merge_plan():
    """A pooled 3-host fabric's own bit table and pruned plan."""
    flat = pooled_topology(n_hosts=3).flatten()
    bits_pool, plan, order = r_plan(flat)
    rng = np.random.default_rng(12)
    n = 3000
    ts = np.sort(rng.uniform(0, 2e4, n)).astype(np.float32)
    vp = rng.integers(0, flat.route.shape[0], n)
    bits = bits_pool[vp].astype(np.int32)
    hosts = (vp // flat.n_pools).astype(np.int32)
    stts = flat.switch_stt_ns[list(order)].astype(np.float32)
    want = r_ref.serial_queue_cascade(
        jnp.asarray(ts), jnp.asarray(bits), jnp.asarray(stts), merge_plan=plan,
        hosts=jnp.asarray(hosts), n_hosts=3,
    )
    got = _torch_hosts_row(ts, bits, hosts, stts, 3, plan)
    _assert_cascade_close(got, want)
    assert (got[2][0] > 0).all()  # every host queues at the shared switch


def test_batched_hosts_rows_equal_row_by_row():
    rows = [_inputs(seed, bursty=seed % 2 == 0) for seed in range(3)]
    ts = np.stack([r[0] for r in rows])
    bits = np.stack([r[1] for r in rows])
    hosts = np.stack([_hosts(seed, ts.shape[1], 2) for seed in range(3)])
    tf, idx, psd = t_ops.congestion_cascade(
        torch.from_numpy(ts), torch.from_numpy(bits), torch.from_numpy(STTS),
        hosts=torch.from_numpy(hosts), n_hosts=2,
    )
    assert psd.shape == (3, 3, 2)
    for b in range(3):
        want = r_ref.serial_queue_cascade(
            jnp.asarray(ts[b]), jnp.asarray(bits[b]), jnp.asarray(STTS),
            hosts=jnp.asarray(hosts[b]), n_hosts=2,
        )
        _assert_cascade_close((tf[b], idx[b], psd[b]), want)


# --------------------------------------------------------------------------- #
# single-switch scan (the unfused per-stage loop's kernel)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
def test_plain_scan_matches_reference(impl):
    rows = [_inputs(seed, n=3000, bursty=seed == 1)[0] for seed in (1, 2)]
    masks = [np.random.default_rng(30 + i).random(3000) < 0.5 for i in range(2)]
    start, delay = t_ops.congestion_queue(
        torch.from_numpy(np.stack(rows)), torch.from_numpy(np.stack(masks)), 2.0
    )
    assert start.shape == delay.shape == (2, 3000)
    for b in range(2):
        w_start, w_delay = r_ops.congestion_queue(
            jnp.asarray(rows[b]), jnp.asarray(masks[b]), 2.0, impl=impl, block=1024
        )
        np.testing.assert_allclose(start[b].numpy(), np.asarray(w_start), rtol=1e-6)
        np.testing.assert_allclose(delay[b].numpy(), np.asarray(w_delay), rtol=1e-6)
    unmasked = ~torch.from_numpy(np.stack(masks))
    assert (delay[unmasked] == 0).all()
    assert torch.equal(start[unmasked], torch.from_numpy(np.stack(rows))[unmasked])
    assert float(delay.sum()) > 0


def test_cpu_hosts_cascade_and_queue_take_the_plain_path():
    ts, bits = _inputs(4, n=256)
    t, b = torch.from_numpy(ts)[None], torch.from_numpy(bits)[None]
    counts0 = (t_ops.plain_launches, t_kernel.launches, t_kernel.hosts_launches,
               t_kernel.scan_launches)
    t_ops.congestion_cascade(t, b, torch.from_numpy(STTS),
                             hosts=torch.zeros_like(b), n_hosts=2)
    t_ops.congestion_queue(t, b > 3, 1.0)
    assert t_ops.plain_launches == counts0[0] + 2
    assert (t_kernel.launches, t_kernel.hosts_launches, t_kernel.scan_launches) == counts0[1:]
