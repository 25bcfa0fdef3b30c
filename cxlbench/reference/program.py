"""The simulated program, rebuilt from a configuration's description with
plain numpy: the topology and its flattening, a model's memory program
(regions and phases), the paced event skeleton, the placement policies, the
fabric's coherency traffic and the merged shared timeline.

These are frozen copies of the simulator's own rules (the CXLMemSim paper's
Tracer, Timer and placement, as the port implements them), kept here so that
the benchmark's yardstick does not move when the program does.  Nothing here
imports the program.  Events are dicts of numpy columns: ``t`` (f64 ns),
``pool``, ``bytes``, ``write``, ``region``, ``weight``, ``host``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

# --------------------------------------------------------------------------- #
# Topology
# --------------------------------------------------------------------------- #


def _switch_by_name(topo: dict) -> Dict[str, dict]:
    return {s["name"]: s for s in topo.get("switches", [])}


def _switch_path(topo: dict, pool: dict) -> List[dict]:
    by_name = _switch_by_name(topo)
    path, cur = [], pool.get("parent")
    while cur is not None:
        sw = by_name[cur]
        path.append(sw)
        cur = sw.get("parent")
    return path


def with_override(topo: dict, override: dict) -> dict:
    """A copy of ``topo`` with numeric fields replaced: ``override`` maps
    ``pools`` / ``switches`` to {name: {field: value}} and may set the
    scalar ``rc_latency_ns``, ``rc_bandwidth_gbps``, ``rc_stt_ns`` and
    ``local_dram_latency_ns``."""
    out = dict(topo)
    out["pools"] = [dict(p, **override.get("pools", {}).get(p["name"], {}))
                    for p in topo["pools"]]
    out["switches"] = [dict(s, **override.get("switches", {}).get(s["name"], {}))
                       for s in topo.get("switches", [])]
    for key in ("rc_latency_ns", "rc_bandwidth_gbps", "rc_stt_ns", "local_dram_latency_ns"):
        if override.get(key) is not None:
            out[key] = override[key]
    return out


def flatten(topo: dict) -> dict:
    """Virtual-pool lowering: one row per (host, pool) pair, the shared
    switches' columns then one private root-complex column per host.  A
    remote pool costs its media latency, the root complex's and every
    switch's on its path; local DRAM its own media latency only."""
    pools, switches = topo["pools"], topo.get("switches", [])
    H, P, n_sw = int(topo.get("n_hosts", 1)), len(pools), len(switches)
    S = n_sw + H
    col = {s["name"]: i for i, s in enumerate(switches)}
    lat = np.zeros((H * P,), np.float64)
    route = np.zeros((H * P, S), np.float64)
    rc_lat = float(topo.get("rc_latency_ns", 10.0))
    for i, p in enumerate(pools):
        path = _switch_path(topo, p)
        if p.get("is_local"):
            one = float(p["latency_ns"])
        else:
            one = float(p["latency_ns"]) + rc_lat + sum(float(s["latency_ns"]) for s in path)
        for h in range(H):
            vp = h * P + i
            lat[vp] = one
            if p.get("is_local"):
                continue
            route[vp, n_sw + h] = 1.0
            for s in path:
                route[vp, col[s["name"]]] = 1.0
    by_name = _switch_by_name(topo)

    def depth(s: dict) -> int:
        d, cur = 1, s.get("parent")
        while cur is not None:
            d, cur = d + 1, by_name[cur].get("parent")
        return d

    stt = np.array([float(s["stt_ns"]) for s in switches]
                   + [float(topo.get("rc_stt_ns", 0.5))] * H, np.float64)
    bw = np.array([float(s["bandwidth_gbps"]) for s in switches]
                  + [float(topo.get("rc_bandwidth_gbps", 256.0))] * H, np.float64)
    depths = np.array([depth(s) for s in switches] + [0] * H, np.int64)
    return {
        "n_pools": P, "n_hosts": H, "n_switches": S,
        "pool_names": tuple(p["name"] for p in pools),
        "capacity": np.array([float(p["capacity_bytes"]) for p in pools], np.float64),
        "pool_latency_ns": lat,
        "local_latency_ns": float(topo.get("local_dram_latency_ns", 88.9)),
        "route": route, "stt_ns": stt, "bandwidth_gbps": bw,
        # deepest switch first, root complexes last (stable among equals)
        "stage_order": np.argsort(-depths, kind="stable"),
    }


# --------------------------------------------------------------------------- #
# A model's memory program
# --------------------------------------------------------------------------- #


def param_counts(m: dict) -> Dict[str, float]:
    """Parameters of a dense (GELU or gated MLP) or MoE (every layer)
    transformer with RMS norms (a gain) or layer norms (a gain and a bias):
    ``total`` and ``active`` (the experts a token does not visit taken
    away)."""
    d, hd = m["d_model"], m["d_head"]
    ln = m.get("norm", "rms") == "ln"
    nrm = 2 * d if ln else d
    attn = d * m["n_heads"] * hd + 2 * d * m["n_kv_heads"] * hd + m["n_heads"] * hd * d
    group, expert = nrm + attn, 0.0
    if m["family"] == "moe":
        e, f = m["n_experts"], m["moe_d_ff"]
        experts = 3 * e * d * f
        group += nrm + d * e + experts
        expert = m["n_layers"] * experts
    else:
        gated = m.get("mlp_gated", True) and not ln
        group += nrm + (3 if gated else 2) * d * m["d_ff"]
    total = m["n_layers"] * group + nrm + m["vocab_size"] * d
    if not m.get("tie_embeddings", True):
        total += d * m["vocab_size"]
    active = total
    if m.get("n_experts") and m.get("top_k"):
        active = total - expert * (1.0 - m["top_k"] / m["n_experts"])
    return {"total": float(total), "active": float(active)}


def memory_program(m: dict, kind: str, batch: int, seq: int, cache_len: int = 0):
    """Regions ``[(name, nbytes, class)]`` and phases ``[(name, flops,
    [(region, bytes, is_write)])]`` of one prefill or decode step, f32
    parameters and activations: an ``embed`` phase, then one phase a
    layer that reads its weights and writes its activations; a prefill
    writes each layer's K/V, a decode reads the cache and writes one
    token's."""
    if kind not in ("prefill", "decode"):
        raise ValueError(kind)
    L, D, f4 = m["n_layers"], m["d_model"], 4
    tokens = batch * (seq if kind != "decode" else 1)
    counts = param_counts(m)
    embed_params = m["vocab_size"] * D * (1 if m.get("tie_embeddings", True) else 2)
    pg = max((counts["total"] - embed_params - D) / L, 0.0) * f4
    embed_bytes = m["vocab_size"] * D * f4
    act_bytes = tokens * D * f4
    kv_per_tok = 2 * m["n_kv_heads"] * m["d_head"] * f4
    regions = [("embed", int(embed_bytes), "param")]
    for g in range(L):
        regions += [(f"block{g}.w", int(pg), "param"),
                    (f"block{g}.act", int(act_bytes), "activation"),
                    (f"block{g}.kv", int(batch * max(seq, cache_len) * kv_per_tok), "kvcache")]
    flops_g = 2.0 * (counts["active"] / L) * tokens
    phases = [("embed", 2.0 * tokens * D, [("embed", embed_bytes, False)])]
    for g in range(L):
        acc = [(f"block{g}.w", pg, False), (f"block{g}.act", act_bytes, True)]
        if kind == "prefill":
            acc.append((f"block{g}.kv", tokens * kv_per_tok, True))
        else:
            acc += [(f"block{g}.kv", batch * max(cache_len, seq) * kv_per_tok, False),
                    (f"block{g}.kv", batch * kv_per_tok, True)]
        phases.append((f"block{g}", flops_g, acc))
    return regions, phases


def skeleton(regions, phases, pacing: dict, granularity: float, max_events: int) -> dict:
    """Layer epochs: each access of ``bytes`` becomes ``min(ceil(bytes /
    granularity), max_events)`` events of equal byte shares, spread evenly
    over its phase's roofline-paced duration (the larger of its FLOPs at
    ``peak_flops`` and its bytes at ``hbm_gbps``, at least 1 ns); times
    are epoch-relative."""
    rid = {name: i for i, (name, _, _) in enumerate(regions)}
    t, share, write, region, ptr = [], [], [], [], [0]
    for _, flops, acc in phases:
        total = sum(b for _, b, _ in acc)
        dur = max(flops / pacing["peak_flops"] * 1e9, total / pacing["hbm_gbps"], 1.0)
        for name, b, is_w in acc:
            n = int(min(max(math.ceil(b / granularity), 1), max_events))
            t.append((np.arange(n, dtype=np.float64) + 0.5) / n * dur)
            share.append(np.full((n,), b / n))
            write.append(np.full((n,), is_w))
            region.append(np.full((n,), rid[name], np.int64))
        ptr.append(ptr[-1] + sum(len(x) for x in t[len(t) - len(acc):]))
    return {"t": np.concatenate(t), "bytes": np.concatenate(share),
            "write": np.concatenate(write), "region": np.concatenate(region),
            "ptr": np.asarray(ptr, np.int64)}


def epochs(skel: dict, pool_of_region: np.ndarray, host: int = 0) -> List[dict]:
    """The skeleton's epochs with each event's pool, tagged as ``host``'s."""
    out = []
    for e in range(len(skel["ptr"]) - 1):
        lo, hi = int(skel["ptr"][e]), int(skel["ptr"][e + 1])
        reg = skel["region"][lo:hi]
        out.append({"t": skel["t"][lo:hi], "pool": pool_of_region[reg], "bytes": skel["bytes"][lo:hi],
                    "write": skel["write"][lo:hi], "region": reg,
                    "weight": np.ones((hi - lo,), np.float64),
                    "host": np.full((hi - lo,), host, np.int64)})
    return out


# --------------------------------------------------------------------------- #
# Placement
# --------------------------------------------------------------------------- #


def place(policy: dict, regions, flat: dict) -> np.ndarray:
    """``[R]`` pool of each region under ``policy``: ``local_only``;
    ``class_map`` ({class: pool}, others local); ``interleave`` (regions in
    order to the pool of the largest byte-share deficit, ties to the first
    listed); ``hotness_tiered`` (first fit into a local budget of
    ``budget_share`` of the program's bytes, in order of declaration since
    no access counts are known, the rest to ``fallback``)."""
    idx = {n: i for i, n in enumerate(flat["pool_names"])}
    kind, out = policy["kind"], np.zeros((len(regions),), np.int64)
    if kind == "local_only":
        return out
    if kind == "class_map":
        for i, (_, _, cls) in enumerate(regions):
            target = policy["map"].get(cls)
            out[i] = idx[target] if target is not None else 0
        return out
    if kind == "interleave":
        pools = [idx[p] for p in policy["pools"]]
        w = np.asarray(policy["weights"], np.float64)
        w = w / w.sum()
        placed = np.zeros((len(pools),), np.float64)
        for i, (_, nbytes, _) in enumerate(regions):
            k = int(np.argmax(w - placed / (placed.sum() + 1e-9)))
            out[i] = pools[k]
            placed[k] += nbytes
        return out
    if kind == "hotness_tiered":
        budget = int(policy["budget_share"] * sum(int(b) for _, b, _ in regions))
        used = 0
        for i, (_, nbytes, _) in enumerate(regions):
            if used + nbytes <= budget:
                used += nbytes
            else:
                out[i] = idx[policy["fallback"]]
        return out
    raise ValueError(f"unknown policy {kind!r}")


# --------------------------------------------------------------------------- #
# The shared fabric: coherency traffic and the merged timeline
# --------------------------------------------------------------------------- #


def _take(ev: dict, idx) -> dict:
    return {k: v[idx] for k, v in ev.items()}


def _concat(parts: Sequence[dict]) -> dict:
    parts = [p for p in parts if len(p["t"])]
    keys = ("t", "pool", "bytes", "write", "region", "weight", "host")
    if not parts:
        return {k: np.zeros((0,)) for k in keys}
    return {k: np.concatenate([p[k] for p in parts]) for k in keys}


def coherency(group: Sequence[dict], region_maps, pools_of, cfg: dict, dt=np.float64):
    """Back-invalidation events and coherency-miss ns of one co-scheduled
    epoch.  A region of a shared class, matched by name across the hosts'
    maps and placed off local DRAM, is shared by the hosts whose epoch
    touches it.  Each of a sharer's writes sends one BI packet to every
    other sharer, on that sharer's own route (its events subsampled evenly
    to ``max_bi_events``, bytes and weight kept); each sharer's reads pay
    ``coherency_miss_ns`` times the others' share of the written weight.
    The miss sums are taken in ``dt``."""
    H = len(group)
    bi: List[List[dict]] = [[] for _ in range(H)]
    miss = np.zeros((H,), np.float64)
    shared = set(cfg["shared_classes"])
    cand: Dict[str, Dict[int, int]] = {}
    for h, regions in enumerate(region_maps):
        for rid, (name, _, cls) in enumerate(regions):
            if cls in shared and pools_of[h][rid] != 0:
                cand.setdefault(name, {})[h] = rid
    for _, by_host in cand.items():
        if len(by_host) < 2:
            continue
        touch = {h: group[h]["region"] == rid for h, rid in by_host.items()
                 if len(group[h]["t"]) and (group[h]["region"] == rid).any()}
        sharers = sorted(touch)
        if len(sharers) < 2:
            continue
        w_write = {h: dt(group[h]["weight"][touch[h] & group[h]["write"]].astype(dt).sum())
                   for h in sharers}
        w_all = sum(dt(group[h]["weight"][touch[h]].astype(dt).sum()) for h in sharers)
        for h in sharers:
            ev = group[h]
            src = np.nonzero(touch[h] & ev["write"])[0]
            if len(src):
                w_tot = float(ev["weight"][src].sum())
                emit = int(min(len(src), cfg["max_bi_events"]))
                pick = src[np.linspace(0, len(src) - 1, emit).astype(np.int64)]
                for g in sharers:
                    if g == h:
                        continue
                    rid = by_host[g]
                    bi[g].append({
                        "t": ev["t"][pick], "pool": np.full((emit,), pools_of[g][rid]),
                        "bytes": np.full((emit,), cfg["bi_message_bytes"] * w_tot / emit),
                        "write": np.ones((emit,), bool), "region": np.full((emit,), rid),
                        "weight": np.full((emit,), w_tot / emit), "host": np.full((emit,), g),
                    })
            remote = sum(w_write[g] for g in sharers if g != h)
            if remote > 0:
                reads = dt(ev["weight"][touch[h] & ~ev["write"]].astype(dt).sum())
                miss[h] = dt(miss[h]) + reads * (remote / max(w_all, dt(1.0))) * dt(
                    cfg["coherency_miss_ns"])
    return [_concat(parts) for parts in bi], miss


def merged_round(per_host: Sequence[List[dict]], region_maps, pools_of, coh: dict,
                 dt=np.float64):
    """Epoch k of every host merged onto one timeline (their BI traffic
    appended to each host's stream first), stably sorted by time; and the
    round's coherency-miss ns per host, summed in ``dt``."""
    H = len(per_host)
    miss = np.zeros((H,), np.float64)
    merged = []
    for k in range(max(len(e) for e in per_host)):
        group = [e[k] for e in per_host]
        if coh is not None:
            bi, m = coherency(group, region_maps, pools_of, coh, dt)
            group = [_concat([g, b]) for g, b in zip(group, bi)]
            miss += m
        ev = _concat(group)
        merged.append(_take(ev, np.argsort(ev["t"], kind="stable")))
    return merged, miss
