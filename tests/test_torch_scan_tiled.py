"""The scan kernel's decomposition, rehearsed on the CPU: the tiled mirror
``ref.congestion_scan_tiled`` cuts each row into tiles as
``csrc/congestion_scan.cu`` does, counts first and takes the max second,
and finds each tile's prefixes by look-back (a seeded generator draws the
predecessor whose inclusive prefix counts as already published).  It must
equal the plain ``ref.congestion_scan`` bitwise for every tile, every
arrival pattern and every look-back schedule, and the reference's Pallas
scan (interpret mode) at its bar, rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.congestion import congestion_scan as r_pallas_scan
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(2)

N = 3001  # ragged: no tile of 7 or 256 divides it
BIG = np.float32(np.finfo(np.float32).max / 4)  # the stager's pad time
STT = 2.0
TILES = [1, 7, 256, N, N + 1000]
SEEDS = [None, 0, 1, 2]


def _times(rng, rows, n, kind):
    """Sorted f32 arrival times: uniform, bursty (clusters: deep queues), or
    tie-heavy integers from a span of n/8."""
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


def _case(kind, mask, n=N, rows=2):
    rng = np.random.default_rng(sum(map(ord, kind + mask)) + n)
    t = _times(rng, rows, n, kind)
    if mask == "all":
        m = np.ones((rows, n), bool)
    elif mask == "none":
        m = np.zeros((rows, n), bool)
    else:
        m = rng.random((rows, n)) < 0.5
    return torch.from_numpy(t), torch.from_numpy(m)


def _generator(seed):
    return None if seed is None else torch.Generator().manual_seed(seed)


def _assert_tiled_equal(t, m, tile, seed):
    want = t_ref.congestion_scan(t, m, STT)
    got = t_ref.congestion_scan_tiled(t, m, STT, tile=tile, generator=_generator(seed))
    assert got[0].shape == got[1].shape == t.shape
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    return want


@pytest.mark.parametrize("seed", SEEDS, ids=lambda s: f"seed{s}")
@pytest.mark.parametrize("tile", TILES, ids=lambda x: f"tile{x}")
@pytest.mark.parametrize("kind", ["uniform", "bursty", "ties"])
def test_tiled_mirror_equals_the_plain_scan(kind, tile, seed):
    t, m = _case(kind, "random")
    want = _assert_tiled_equal(t, m, tile, seed)
    assert float(want[1].sum()) > 0  # the case queues


@pytest.mark.parametrize("seed", SEEDS, ids=lambda s: f"seed{s}")
@pytest.mark.parametrize("tile", TILES, ids=lambda x: f"tile{x}")
@pytest.mark.parametrize("kind,mask", [("ties", "all"), ("bursty", "all"),
                                       ("uniform", "none")])
def test_tiled_mirror_on_full_and_empty_masks(kind, mask, tile, seed):
    t, m = _case(kind, mask)
    start, delay = _assert_tiled_equal(t, m, tile, seed)
    if mask == "none":
        assert torch.equal(start, t) and not delay.any()
    else:  # the queue is deep and serves in order
        assert bool((start[:, 1:] >= start[:, :-1]).all()) and bool((delay >= 0).all())
        assert bool((delay.amax(-1) > 100 * STT).all())


@pytest.mark.parametrize("seed", SEEDS, ids=lambda s: f"seed{s}")
@pytest.mark.parametrize("tile", [7, 256, 1024])
def test_tiled_mirror_on_a_padded_tail(tile, seed):
    t, m = _case("bursty", "random")
    t[:, -900:] = float(BIG)
    m[:, -1100:-900] = True  # masked events just before the pads
    m[0, -900:] = True  # row 0: the pads masked too; row 1: not
    start, delay = _assert_tiled_equal(t, m, tile, seed)
    assert bool((start[:, -900:] == float(BIG)).all())
    assert torch.isfinite(delay).all()


@pytest.mark.parametrize("seed", SEEDS, ids=lambda s: f"seed{s}")
@pytest.mark.parametrize("tile", [1, 256, t_ref.SCAN_TILE])
@pytest.mark.parametrize("mask", ["all", "none"])
def test_tiled_mirror_on_one_event_rows(mask, tile, seed):
    t, m = _case("uniform", mask, n=1, rows=3)
    start, delay = _assert_tiled_equal(t, m, tile, seed)
    assert torch.equal(start, t) and not delay.any()


@pytest.mark.parametrize("tile", [256, 1024, t_ref.SCAN_TILE])
@pytest.mark.parametrize("kind", ["uniform", "bursty"])
def test_tiled_mirror_matches_the_pallas_scan(kind, tile):
    n = 3000
    t, m = _case(kind, "random", n=n)
    start, delay = t_ref.congestion_scan_tiled(t, m, STT, tile=tile,
                                               generator=_generator(tile))
    for b in range(t.shape[0]):
        w_start, w_delay = r_pallas_scan(jnp.asarray(t[b].numpy()), jnp.asarray(m[b].numpy()),
                                         STT, interpret=True, block=1024)
        np.testing.assert_allclose(start[b].numpy(), np.asarray(w_start), rtol=1e-6)
        np.testing.assert_allclose(delay[b].numpy(), np.asarray(w_delay), rtol=1e-6)


def test_look_back_schedules_differ_but_agree():
    """The seeded look-back really stops early: with a generator, some tile
    takes an inclusive prefix short of the row's first tile; without one,
    every tile walks back to it.  The prefixes agree either way."""
    agg = torch.arange(1, 41, dtype=torch.int32).reshape(2, 20)
    stops = []

    def reduce(w):
        stops.append(w.shape[-1])
        return w.sum(-1, dtype=torch.int32)

    plain = t_ref._look_back(agg, torch.add, reduce, 0, None)
    walks = list(stops)
    stops.clear()
    drawn = t_ref._look_back(agg, torch.add, reduce, 0, torch.Generator().manual_seed(3))
    want = torch.cumsum(agg, -1, dtype=torch.int32) - agg
    assert torch.equal(plain, want) and torch.equal(drawn, want)
    assert walks == list(range(1, 19))  # tiles 2..19 sum aggregates back to tile 1
    assert sum(stops) < sum(walks)
