"""Mixture-of-Experts layer: a top-k router and three dispatches (port of
``repro/models/moe.py``).

Tokens are cut into groups of ``group_tokens`` (the last one padded) and
routed by an f32 softmax router to their top ``k`` experts, with the gates
renormalised over the chosen ``k``.  Capacity is per group, ``C =
max(int(gs·k·cf / E), 1)``, and a route past its expert's ``C`` slots is
dropped.  The dispatches compute the same function where no route drops:

- ``'einsum'``: GShard's one-hot dispatch and combine tensors ``[g, gs, E,
  C]`` and their products (the reference's default);
- ``'scatter'``: token vectors scattered straight into the expert buffers
  ``[g, E, C, D]`` and gathered back, O(T·k·D) data movement;
- ``'dense'``: every expert for every token, combined by the gates; no
  capacity, so nothing drops.

The load-balance auxiliary loss (Switch §2.2), ``E · Σ_e f_e · P_e`` over
the real tokens, is returned beside the output so that the trainer can add
``aux_weight * aux``.

The expert products are plain matrix products in both packages (no Pallas
kernel in the reference).  :func:`route` is the routing alone, so that a
test can hold it to the reference's on identical probabilities.  Top-k is
a stable descending sort: among equal probabilities the lower expert index
comes first, as ``jax.lax.top_k`` puts it (``torch.topk`` promises no
order for ties).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import init_linear, truncated_normal

__all__ = ["DISPATCHES", "Routing", "capacity", "init_moe", "moe_block", "route",
           "router_probs"]

Params = Mapping[str, torch.Tensor]

DISPATCHES = ("einsum", "scatter", "dense")


def init_moe(
    gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
    shared_expert: bool = False, device=None,
) -> Dict[str, torch.Tensor]:
    """The reference's initial distributions, drawn from ``gen`` on
    ``device`` (default: its own), f32: ``router [D, E]``, the stacked
    experts ``wi``, ``wu [E, D, F]`` and ``wo [E, F, D]``, and with
    ``shared_expert`` a gated MLP's ``shared_wi``, ``shared_wu``,
    ``shared_wo``."""
    dev = device or gen.device
    p = {
        "router": init_linear(gen, d_model, n_experts, device=dev),
        "wi": truncated_normal(gen, (n_experts, d_model, d_ff), dev) * d_model ** -0.5,
        "wu": truncated_normal(gen, (n_experts, d_model, d_ff), dev) * d_model ** -0.5,
        "wo": truncated_normal(gen, (n_experts, d_ff, d_model), dev) * d_ff ** -0.5,
    }
    if shared_expert:
        p["shared_wi"] = init_linear(gen, d_model, d_ff, device=dev)
        p["shared_wu"] = init_linear(gen, d_model, d_ff, device=dev)
        p["shared_wo"] = init_linear(gen, d_ff, d_model, scale=d_ff ** -0.5, device=dev)
    return p


class Routing(NamedTuple):
    """One routing of ``[g, gs]`` grouped tokens to ``k`` experts each."""

    idx: torch.Tensor  # [g, gs, k] int64, the experts, best first
    gates: torch.Tensor  # [g, gs, k] f32, renormalised over the k
    pos: torch.Tensor  # [g, gs, k] int64, the slot in its expert's buffer
    keep: torch.Tensor  # [g, gs, k] bool, pos < capacity


def capacity(group_size: int, top_k: int, capacity_factor: float, n_experts: int) -> int:
    """Slots per expert and group, in the reference's Python float
    arithmetic."""
    return max(int(group_size * top_k * capacity_factor / n_experts), 1)


def router_probs(router: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """The router's f32 softmax over experts: logits in ``xg``'s dtype (as
    the reference's ``xg @ router``), then f32."""
    logits = (xg @ router.to(xg.dtype)).float()
    return torch.softmax(logits, dim=-1)


def route(probs: torch.Tensor, top_k: int, cap: int) -> Routing:
    """Top ``k`` experts of each token of ``probs [g, gs, E]``, their gates
    and their slots.

    Ties go to the lower expert index (a stable descending sort), and the
    gates are gathered from ``probs`` at the chosen indices, so that
    gradients reach the same elements as the reference's.  A slot is the
    count of the group's earlier routes to the same expert over the
    flattened ``[gs·k]`` axis, token-major (token s's k-th choice before
    token s+1's first); padding tokens route too, after the real ones."""
    g, gs, n_exp = probs.shape
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :top_k]
    gate_vals = probs.gather(-1, idx)
    gates = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = F.one_hot(idx, n_exp).reshape(g, gs * top_k, n_exp)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1).reshape(g, gs, top_k)
    return Routing(idx, gates, pos, pos < cap)


def _one_hot(i: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``i``'s one-hot rows over ``n`` classes in ``dtype``; an index ``>=
    n`` gives a zero row (the reference's ``one_hot(.., n + 1)[..., :n]``)."""
    return (i[..., None] == torch.arange(n, device=i.device)).to(dtype)


def _experts(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """The stacked SwiGLU experts on their buffers ``[g, E, C, D]``."""
    dt = xe.dtype
    h = torch.einsum("gecd,edf->gecf", xe, p["wi"].to(dt))
    u = torch.einsum("gecd,edf->gecf", xe, p["wu"].to(dt))
    return torch.einsum("gecf,efd->gecd", F.silu(h) * u, p["wo"].to(dt))


def moe_block(
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    top_k: int,
    capacity_factor: float = 1.25,
    dispatch: str = "einsum",
    group_tokens: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output ``[B, S, D]`` in x's dtype, aux loss f32 scalar):
    the reference's ``moe_block`` step for step."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}; one of {DISPATCHES}")
    B, S, D = x.shape
    E = p["router"].shape[1]
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, D)

    # ---- grouping: the last group padded with zero tokens ---------------- #
    gs = min(group_tokens, T)
    Gm = -(-T // gs)
    if Gm * gs > T:
        xt = F.pad(xt, (0, 0, 0, Gm * gs - T))
    xg = xt.reshape(Gm, gs, D)

    probs = router_probs(p["router"], xg)  # [g, gs, E] f32
    C = capacity(gs, top_k, capacity_factor, E)
    r = route(probs, top_k, C)
    # load-balance aux loss over the real tokens: E · Σ_e f_e · P_e
    me = probs.reshape(-1, E)[:T].mean(dim=0)
    ce = torch.bincount(r.idx.reshape(-1)[: T * top_k], minlength=E).float() / (T * top_k)
    aux = E * torch.sum(me * ce)

    if dispatch == "scatter":
        cidx = torch.where(r.keep, r.pos, C)  # C: the overflow slot, sliced away
        gi = torch.arange(Gm, device=x.device)[:, None, None]
        # every kept slot takes exactly one write; only the overflow slot
        # takes many (in any order), so the sum is deterministic where kept
        xe = torch.zeros((Gm, E, C + 1, D), dtype=dt, device=x.device).index_put(
            (gi, r.idx, cidx), xg[:, :, None, :].expand(Gm, gs, top_k, D),
            accumulate=True)
        eo = F.pad(_experts(p, xe[:, :, :C]), (0, 0, 0, 1))  # the overflow row = 0
        gathered = eo[gi, r.idx, cidx]  # [g, gs, k, D]
        gates = torch.where(r.keep, r.gates, 0.0).to(dt)
        out = (gathered * gates[..., None]).sum(dim=2)
    elif dispatch == "dense":
        # every expert for every token (the upper-bound baseline)
        h = torch.einsum("gsd,edf->gsef", xg, p["wi"].to(dt))
        u = torch.einsum("gsd,edf->gsef", xg, p["wu"].to(dt))
        eo = torch.einsum("gsef,efd->gsed", F.silu(h) * u, p["wo"].to(dt))
        comb = (_one_hot(r.idx, E, dt) * r.gates.to(dt)[..., None]).sum(dim=2)  # [g, gs, E]
        out = torch.einsum("gsed,gse->gsd", eo, comb)
    else:
        # GShard capacity dispatch, per group
        slot = _one_hot(torch.where(r.keep, r.pos, C), C, dt)  # [g, gs, k, C]
        ek = _one_hot(r.idx, E, dt)  # [g, gs, k, E]
        disp = torch.einsum("gske,gskc->gsec", ek, slot)  # [g, gs, E, C]
        xe = torch.einsum("gsec,gsd->gecd", disp, xg)  # [g, E, C, D]
        eo = _experts(p, xe)
        gated = ek * torch.where(r.keep, r.gates, 0.0).to(dt)[..., None]
        cw = torch.einsum("gske,gskc->gsec", gated, slot)
        out = torch.einsum("gsec,gecd->gsd", cw, eo)

    if "shared_wi" in p:
        h = F.silu(xg @ p["shared_wi"].to(dt)) * (xg @ p["shared_wu"].to(dt))
        out = out + h @ p["shared_wo"].to(dt)

    out = out.reshape(Gm * gs, D)[:T]
    return out.reshape(B, S, D), aux
