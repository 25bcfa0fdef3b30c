"""Serving with KV-cache offload on the PyTorch port: prefill + decode under
CXLMemSim (the counterpart of ``examples/serve_offload.py``).

The canonical CXL.mem serving question (paper §1: "comparison of cache-line
and page memory management"): long-context decode with the KV cache in a
pooled CXL expander — what does each management granularity cost?

The port's decode writes each token's K/V into the prefill's cache in
place, where ``repro``'s returns a new array, so every decode loop here
starts from its own copy of the prefill's caches.

    PYTHONPATH=src python examples/serve_offload_torch.py [--device cpu]
"""

import argparse
import dataclasses

import torch

import repro_torch.configs as cfgs
from repro_torch.core import (
    CACHELINE_BYTES,
    H100_SXM,
    PAGE_BYTES,
    CXLMemSim,
    ClassMapPolicy,
    LocalOnlyPolicy,
    two_tier_topology,
)
from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import Model
from repro_torch.models.phases import build_regions_and_phases

B, PROMPT, DECODE, SMAX = 4, 96, 16, 160

CFG = dataclasses.replace(
    cfgs.get_smoke("mistral-large-123b"), dtype=torch.float32, cache_dtype=torch.float32
)


def copy_caches(caches):
    """A copy of a cache tree (dicts of tensors) that a decode may write into."""
    if isinstance(caches, dict):
        return {k: copy_caches(v) for k, v in caches.items()}
    return caches.clone()


def run(device="cuda", hw=H100_SXM, decodes=DECODE, params=None, prompt=None):
    """Prefill, then ``decodes`` attached greedy decode steps under each
    policy; returns each policy's ``SimReport`` and the logits of its first
    decode.  ``params`` (a :class:`Model` on ``device``) and ``prompt``
    (``[B, PROMPT]`` tokens) default to weights from seed 0 and tokens from
    a seeded ``torch.Generator``."""
    device = resolve_device(device)  # raises without a card, unless "cpu"
    model = params if params is not None else Model(CFG, device=device, seed=0)
    if prompt is None:
        gen = torch.Generator(device=device).manual_seed(1)
        prompt = torch.randint(0, CFG.vocab_size, (B, PROMPT), generator=gen, device=device)

    # --- real serving path: prefill then token-by-token decode -------------- #
    prefill = make_prefill_step(CFG, pad_to=SMAX)
    decode = make_decode_step(CFG)
    logits, caches, clen = prefill(model, {"tokens": prompt})
    tok = logits.argmax(-1)[:, None]

    def decode_step_fn(c, t, n):
        lg, new_c, _ = decode(model, {"token": t, "caches": c, "cache_len": n})
        return lg, new_c

    decode_step_fn(copy_caches(caches), tok, clen)  # the first call's set-up, up front

    topo = two_tier_topology(cxl_latency_ns=170.0, cxl_bandwidth_gbps=32.0)
    reports, first_logits = {}, {}
    for name, policy in {
        "local": LocalOnlyPolicy(),
        "kv_offload_cacheline": ClassMapPolicy({"kvcache": "cxl_pool"}, CACHELINE_BYTES),
        "kv_offload_page": ClassMapPolicy({"kvcache": "cxl_pool"}, PAGE_BYTES),
    }.items():
        regions, phases = build_regions_and_phases(
            CFG, "decode", batch=B, seq=1, cache_len=SMAX
        )
        sim = CXLMemSim(topo, policy, hw=hw, check_capacity=False, device=device)
        with sim.attach(decode_step_fn, phases, regions) as prog:
            c, t, n = copy_caches(caches), tok, clen
            for i in range(decodes):
                lg, c = prog.step(c, t, n)
                if i == 0:
                    first_logits[name] = lg
                t = lg.argmax(-1)[:, None]
                n = n + 1
            reports[name] = prog.report
    return {"reports": reports, "first_logits": first_logits, "decodes": decodes}


def report_lines(out):
    """The lines ``examples/serve_offload.py`` prints, for ``run``'s result."""
    results, decodes = out["reports"], out["decodes"]
    lines = []
    for name, r in results.items():
        lines.append(
            f"{name:22s} native {r.native_s*1e3:7.1f} ms   "
            f"simulated {r.simulated_s*1e3:7.1f} ms   "
            f"slowdown {r.slowdown:.3f}x   "
            f"(lat {r.latency_s*1e3:.2f} ms, bw {r.bandwidth_s*1e3:.2f} ms)"
        )
    for name in ("kv_offload_cacheline", "kv_offload_page"):
        extra = results[name].simulated_s - results[name].native_s
        lines.append(f"{name}: +{extra / decodes * 1e3:.3f} ms per decoded token vs all-local")
    lines.append("\n(cacheline management touches only the lines the step reads;"
                 "\n page management rounds every access up to 4 KiB pages — the paper's"
                 "\n cache-line vs page comparison, priced on one topology)")
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    print("\n".join(report_lines(run(device=args.device))))


if __name__ == "__main__":
    main()
