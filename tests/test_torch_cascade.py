"""Port parity: the plain PyTorch congestion cascade against the reference's
jnp oracle and its Pallas kernel (interpret mode), at the bar of
``tests/test_fused_cascade.py``: per-stage delay to rtol 1e-5, final times
to rtol 1e-6, slot indices exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.analyzer import plan_cascade as r_plan
from repro.core.topology import chained_topology, figure1_topology
from repro.kernels import ref as r_ref
from repro.kernels.congestion import congestion_cascade as r_pallas
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
    with pytest.raises(NotImplementedError, match="slice 2"):
        t_ref.serial_queue_cascade(
            torch.from_numpy(ts), torch.from_numpy(bits), torch.from_numpy(STTS),
            hosts=torch.zeros(64, dtype=torch.int32), n_hosts=2,
        )
