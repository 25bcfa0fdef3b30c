"""The three delays of the CXLMemSim paper, priced with plain numpy over
one epoch's events: the plain reference the benchmark holds the program to.

* latency: each remote event pays its virtual pool's added latency over
  local DRAM, times its weight;
* congestion: every switch (deepest first, each host's root complex last)
  is a FIFO serial queue of constant service time ``stt``; an event's start
  is ``max(arrival, previous start + stt)``, and the shift carries to the
  next stage;
* bandwidth: after those shifts (plus each event's latency), the bytes a
  switch carries in each of ``n_windows`` windows of ``span / n_windows``
  stretch that window by whatever exceeds its length at the switch's
  bandwidth; a window's stretch goes to the hosts by their byte share.

``price`` computes in float64.  ``control=True`` computes the same one
precision below what the simulator states (float32 event times, float64
sums): event times held in bfloat16, the arithmetic in float32 and each
sum accumulated one event at a time in float32, as f32 atomics would.
Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 (to nearest, ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _serial_queue(arrival: np.ndarray, stt, dtype) -> np.ndarray:
    idx = np.arange(len(arrival), dtype=dtype)
    stt = dtype(stt)
    return np.maximum.accumulate(arrival - idx * stt) + idx * stt


def _sums(values: np.ndarray, keys: np.ndarray, n: int, control: bool) -> np.ndarray:
    if not control:
        return np.bincount(keys, weights=values, minlength=n)[:n]
    out = np.zeros((n,), np.float32)
    np.add.at(out, keys, values.astype(np.float32))
    return out.astype(np.float64)


def price(flat: dict, ev: dict, n_windows: int = 128, min_window_span_ns: float = 10_000.0,
          control: bool = False) -> Dict[str, object]:
    """Delays (ns) of one epoch: ``latency``, ``congestion``, ``bandwidth``
    and per host ``host_latency``, ``host_congestion``, ``host_bandwidth``."""
    dt = np.float32 if control else np.float64
    P, H, S = flat["n_pools"], flat["n_hosts"], flat["n_switches"]
    zero = np.zeros((H,), np.float64)
    n = len(ev["t"])
    if n == 0:
        return {"latency": 0.0, "congestion": 0.0, "bandwidth": 0.0, "host_latency": zero,
                "host_congestion": zero.copy(), "host_bandwidth": zero.copy()}
    host = ev["host"].astype(np.int64)
    vp = host * P + ev["pool"].astype(np.int64)
    t = bf16(ev["t"]) if control else ev["t"].astype(dt)
    span = max(float(ev["t"].max()) + 1.0, min_window_span_ns)
    window = dt(max(span / n_windows, 1.0))

    lat = np.maximum(flat["pool_latency_ns"].astype(dt)[vp] - dt(flat["local_latency_ns"]), 0)
    lat = (lat * ev["weight"].astype(dt)).astype(dt)
    host_lat = _sums(lat, host, H, control)

    host_cong = np.zeros((H,), np.float64)
    for s in flat["stage_order"]:
        stt = float(flat["stt_ns"][s])
        sub = np.nonzero(flat["route"][vp, s] > 0)[0]
        if stt <= 0 or not len(sub):
            continue
        sub = sub[np.argsort(t[sub], kind="stable")]
        start = _serial_queue(t[sub], stt, dt)
        delay = start - t[sub]
        t[sub] = start
        host_cong += _sums(delay, host[sub], H, control)

    t_obs = t + lat
    win = np.minimum((t_obs / window).astype(np.int64), n_windows - 1)
    nbytes = ev["bytes"].astype(dt)
    host_bw = np.zeros((H,), np.float64)
    for s in range(S):
        bw = float(flat["bandwidth_gbps"][s])
        mask = flat["route"][vp, s] > 0
        if bw <= 0 or not mask.any():
            continue
        key = win[mask] * H + host[mask]
        wb_h = _sums(nbytes[mask], key, n_windows * H, control).reshape(n_windows, H)
        wbytes = wb_h.sum(axis=1)
        stretch = np.maximum(wbytes / bw - float(window), 0.0)
        share = np.divide(wb_h, wbytes[:, None], out=np.zeros_like(wb_h),
                          where=wbytes[:, None] > 0)
        host_bw += (stretch[:, None] * share).sum(axis=0)
    return {"latency": float(host_lat.sum()), "congestion": float(host_cong.sum()),
            "bandwidth": float(host_bw.sum()), "host_latency": host_lat,
            "host_congestion": host_cong, "host_bandwidth": host_bw}


def price_epochs(flat: dict, epochs, n_windows: int = 128, control: bool = False) -> dict:
    """The delays of a list of epochs, summed."""
    tot = None
    for ev in epochs:
        one = price(flat, ev, n_windows=n_windows, control=control)
        tot = one if tot is None else {k: tot[k] + one[k] for k in tot}
    return tot
