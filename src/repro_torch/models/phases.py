"""Memory-program synthesis: ModelConfig -> (RegionMap, [Phase]).  A copy
of ``repro/models/phases.py`` over the port's own data model.

This is the allocation half of the Tracer: every logical tensor class of a
step is registered as a region (the eBPF range-map analogue), and each layer
group becomes a Phase with its byte-accurate access list.  The CXLMemSim
attach path then prices any placement policy / topology against the step.

Accounting (per group, per step):
  train:   fwd reads W, writes A; bwd reads W + A, writes G(=W bytes);
           optimizer reads G + M (2 moments) + P, writes M + P.
  prefill: reads W, writes A + KV.
  decode:  reads W + KV(cache_len·kv_bytes_per_tok) + states, writes 1 token KV.

One repair against the reference: a model without attention (the ssm
family) allocates no ``block{g}.kv`` region, and the reference still lists
zero-byte accesses to it, which its trace synthesis refuses ("unknown
region"); here the KV accesses exist only where the KV region does.
"""

from __future__ import annotations

from typing import List, Tuple

from ..core.events import RegionMap
from ..core.tracer import Access, Phase

__all__ = ["build_regions_and_phases", "group_param_bytes"]


def _bytes_of(n_params: float, dtype_bytes: int = 4) -> float:
    return n_params * dtype_bytes


def group_param_bytes(cfg) -> float:
    """Parameters of one group (from the analytic counts)."""
    counts = cfg.param_counts()
    # embed (+head) params
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.embed_inputs else 0)
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        embed += cfg.d_model * cfg.vocab_size
    per_group = (counts["total"] - embed - cfg.d_model) / max(cfg.n_groups, 1)
    return max(per_group, 0.0)


def build_regions_and_phases(
    cfg,
    kind: str,  # 'train' | 'prefill' | 'decode'
    batch: int,
    seq: int,
    param_dtype_bytes: int = 4,
    act_dtype_bytes: int = 4,
    cache_len: int = 0,
) -> Tuple[RegionMap, List[Phase]]:
    regions = RegionMap()
    G = cfg.n_groups
    D = cfg.d_model
    tokens = batch * (seq if kind != "decode" else 1)

    pg = group_param_bytes(cfg) * param_dtype_bytes
    embed_bytes = cfg.vocab_size * D * param_dtype_bytes
    act_bytes = tokens * D * act_dtype_bytes  # residual stream per group
    kv_per_tok = (
        2 * cfg.n_kv_heads * cfg.d_head * cfg.attn_layers_per_group * act_dtype_bytes
    )

    if cfg.embed_inputs:
        regions.alloc("embed", int(embed_bytes), "param")
    for g in range(G):
        regions.alloc(f"block{g}.w", int(pg), "param")
        regions.alloc(f"block{g}.act", int(act_bytes), "activation")
        if kind == "train":
            regions.alloc(f"block{g}.grad", int(pg), "grad")
            regions.alloc(f"block{g}.opt", int(2 * pg), "opt_state")
        if kind in ("prefill", "decode") and kv_per_tok:
            cache_tokens = batch * max(seq, cache_len)
            regions.alloc(
                f"block{g}.kv", int(cache_tokens * kv_per_tok), "kvcache"
            )
    if kind == "train":
        regions.alloc("logits", int(tokens * cfg.vocab_size * act_dtype_bytes), "activation")

    # per-group model FLOPs (6·n·tokens train, 2·n·tokens inference)
    n_active_group = cfg.param_counts()["active"] / max(G, 1)
    mult = 6.0 if kind == "train" else 2.0
    flops_g = mult * n_active_group * tokens

    phases: List[Phase] = []
    if cfg.embed_inputs:
        phases.append(
            Phase(
                "embed",
                flops=2.0 * tokens * D,
                accesses=(
                    Access("embed", embed_bytes),
                    *(() if kind == "decode" else ()),
                ),
            )
        )
    for g in range(G):
        acc = [Access(f"block{g}.w", pg)]
        if kind == "train":
            acc += [
                Access(f"block{g}.act", act_bytes, is_write=True),
                Access(f"block{g}.act", act_bytes),  # bwd re-read
                Access(f"block{g}.grad", pg, is_write=True),
            ]
        elif kind == "prefill":
            acc += [Access(f"block{g}.act", act_bytes, is_write=True)]
            if kv_per_tok:
                acc += [Access(f"block{g}.kv", tokens * kv_per_tok, is_write=True)]
        else:  # decode
            acc += [Access(f"block{g}.act", act_bytes, is_write=True)]
            if kv_per_tok:
                acc += [
                    Access(f"block{g}.kv", batch * max(cache_len, seq) * kv_per_tok),
                    Access(f"block{g}.kv", batch * kv_per_tok, is_write=True),
                ]
        phases.append(Phase(f"block{g}", flops=flops_g, accesses=tuple(acc)))

    if kind == "train":
        lb = tokens * cfg.vocab_size * act_dtype_bytes
        phases.append(
            Phase(
                "loss",
                flops=2.0 * tokens * D * cfg.vocab_size,
                accesses=(Access("logits", lb, is_write=True), Access("logits", lb)),
            )
        )
        opt_acc = []
        for g in range(G):
            opt_acc += [
                Access(f"block{g}.grad", pg),
                Access(f"block{g}.opt", 2 * pg),
                Access(f"block{g}.opt", 2 * pg, is_write=True),
                Access(f"block{g}.w", pg, is_write=True),
            ]
        phases.append(Phase("optimizer", flops=0.0, accesses=tuple(opt_acc)))
    return regions, phases
