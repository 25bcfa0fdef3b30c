"""Everything a run feeds the program, made from ``--seed``: a dense
model's weights (on the device, in a few large draws), each step's tokens,
the fabric tenants' cache lengths, each sweep's topology overrides, and the
sample of answers the reference checks.  The program and the reference are
handed the same inputs; neither makes its own."""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np
import torch

_CHUNK = 1 << 28  # elements a draw: a few large calls, never one a leaf


def _rng(*key: int) -> np.random.Generator:
    """numpy's generator of a key of whole numbers (negatives too)."""
    return np.random.default_rng([k % (1 << 64) for k in key])


def _gen(device, *key: int) -> torch.Generator:
    """A torch generator on ``device`` seeded from the same key."""
    seed = int(_rng(*key).integers(0, 1 << 63))
    return torch.Generator(device=device).manual_seed(seed)


def dense_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights of a dense transformer with a plain GELU MLP, named as
    the port's ``Model`` state dict (matrices ``[d_in, d_out]``): standard
    normals drawn on ``device`` in chunks of ``_CHUNK``, scaled by
    1/sqrt(fan-in) (the embedding, tied to the head, by 0.02).  RMS norm
    gains are ones; under ``norm: "ln"`` each norm is a gain ``1 + 0.1 z``
    and a bias ``0.1 z``, so that the bias is part of what is compared."""
    D, L, hd = m["d_model"], m["n_layers"], m["n_heads"] * m["d_head"]
    kv = m["n_kv_heads"] * m["d_head"]
    shapes = {"embed": ((m["vocab_size"], D), 0.02)}
    for g in range(L):
        p = f"blocks.{g}.sub0."
        shapes.update({
            p + "attn.wq": ((D, hd), D ** -0.5), p + "attn.wk": ((D, kv), D ** -0.5),
            p + "attn.wv": ((D, kv), D ** -0.5), p + "attn.wo": ((hd, D), hd ** -0.5),
            p + "mlp.wi": ((D, m["d_ff"]), D ** -0.5), p + "mlp.wo": ((m["d_ff"], D), m["d_ff"] ** -0.5),
        })
    total = sum(int(np.prod(s)) for s, _ in shapes.values())
    flat = torch.empty((total,), dtype=torch.float32, device=device)
    gen = _gen(device, seed, 1)
    for lo in range(0, total, _CHUNK):
        flat[lo:lo + _CHUNK].normal_(generator=gen)
    out, off = {}, 0
    for name, (shape, scale) in shapes.items():
        n = int(np.prod(shape))
        out[name] = flat[off:off + n].view(shape).mul_(scale)
        off += n
    norms = ["final_norm"] + [f"blocks.{g}.sub0.{n}" for g in range(L) for n in ("norm1", "norm2")]
    if m.get("norm", "rms") == "ln":
        z = torch.empty((len(norms), 2, D), dtype=torch.float32, device=device)
        z.normal_(generator=_gen(device, seed, 6)).mul_(0.1)
        z[:, 0] += 1.0
        for i, name in enumerate(norms):
            out[f"{name}.g"], out[f"{name}.b"] = z[i, 0], z[i, 1]
    else:
        for name in norms:
            out[name] = torch.ones((D,), dtype=torch.float32, device=device)
    return out


def step_tokens(seed: int, step: int, batch: int, seq: int, vocab: int, device) -> torch.Tensor:
    """Step ``step``'s ``[batch, seq]`` token ids, uniform over the
    vocabulary; any step's can be drawn again on its own."""
    return torch.randint(0, vocab, (batch, seq), generator=_gen(device, seed, 2, step),
                         device=device)


def cache_lens(seed: int, hosts: int, low: int, high: int, step: int) -> List[int]:
    """Each tenant's KV-cache length, uniform over ``low..high`` by ``step``."""
    grid = np.arange(low, high + 1, step)
    return [int(x) for x in _rng(seed, 3).choice(grid, size=hosts)]


def sweep_overrides(seed: int, sweep: int, traffic: dict) -> List[dict]:
    """The ``stt_rows x variants_per_row`` topology overrides of sweep
    ``sweep``: distinct switch service-time rows drawn from the traffic's
    grids, each crossed with the same variants, whose pool latencies and
    switch bandwidths are drawn from the traffic's ranges."""
    rng = _rng(seed, 4, sweep)
    grid = list(itertools.product(*traffic["stt_ns"].values()))
    rows = [grid[i] for i in rng.choice(len(grid), size=traffic["stt_rows"], replace=False)]
    variants = []
    for _ in range(traffic["variants_per_row"]):
        v = {"pools": {p: {"latency_ns": float(np.round(rng.uniform(*r)))}
                       for p, r in traffic["latency_ns"].items()},
             "switches": {s: {"bandwidth_gbps": float(np.round(rng.uniform(*r) * 2) / 2)}
                          for s, r in traffic["bandwidth_gbps"].items()}}
        variants.append(v)
    out = []
    for row in rows:
        for v in variants:
            o = {"pools": v["pools"], "switches": {s: dict(f) for s, f in v["switches"].items()}}
            for name, stt in zip(traffic["stt_ns"], row):
                if name == "rc":
                    o["rc_stt_ns"] = float(stt)
                else:
                    o["switches"].setdefault(name, {})["stt_ns"] = float(stt)
            out.append(o)
    return out


def sample(seed: int, population: int, k: int, salt: int) -> List[int]:
    """``k`` distinct indices of ``range(population)`` (all when fewer),
    sorted."""
    k = min(k, population)
    return sorted(int(i) for i in _rng(seed, 5, salt).choice(
        population, size=k, replace=False))
