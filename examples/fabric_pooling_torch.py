"""Two-tenant memory pooling on a shared CXL fabric, on the PyTorch port
(the counterpart of ``examples/fabric_pooling.py``).

The paper's headline scenario: two servers offload their KV caches onto one
shared CXL expander to fix memory stranding.  A quiet serving tenant and a
bulk-traffic tenant co-attach on the same fabric; the session reports each
host's native vs simulated clock plus the fabric-wide contention
decomposition, including what the noisy neighbor costs the quiet one.  On
the card the round's analysis runs the host-segmented congestion cascade.

Run:  PYTHONPATH=src python examples/fabric_pooling_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core import (
    H100_SXM,
    Access,
    ClassMapPolicy,
    CoherencyConfig,
    FabricSession,
    Phase,
    RegionMap,
    Tenant,
    pooled_topology,
)
from repro_torch.core.units import s_to_ms
from repro_torch.launch.mesh import resolve_device

ROUNDS = 5


def toy_step(x):
    return torch.tanh(x @ x.T).sum()


def make_tenant(name: str, kv_bytes: int, batch: int, device="cuda") -> Tenant:
    """A toy serving step on ``device``: weights in local DRAM, KV cache on
    the shared pool."""
    regions = RegionMap()
    regions.alloc("weights", 1 << 28, "param")
    regions.alloc("kv", max(kv_bytes, 1 << 22), "kvcache")
    regions.alloc("activations", 1 << 22, "activation")
    phases = [
        Phase(
            "decode",
            flops=2e10,
            accesses=(
                Access("weights", 1 << 28),
                Access("kv", kv_bytes),  # read the cache...
                Access("kv", kv_bytes // 8, is_write=True),  # ...append to it
                Access("activations", 1 << 22, is_write=True),
            ),
        )
    ]
    x = torch.ones((batch, 256), device=device)
    return Tenant(
        name, phases, regions,
        ClassMapPolicy({"kvcache": "shared_pool"}),
        step_fn=toy_step, step_args=(x,),
    )


def run(device="cuda", hw=H100_SXM):
    """``ROUNDS`` fabric rounds of the two tenants; returns the topology and
    the ``FabricReport``."""
    device = resolve_device(device)  # raises without a card, unless "cpu"
    topo = pooled_topology(n_hosts=2, cxl_bandwidth_gbps=16.0)
    session = FabricSession(
        topo,
        [
            make_tenant("quiet-serving", kv_bytes=1 << 24, batch=64, device=device),
            make_tenant("bulk-tenant", kv_bytes=1 << 28, batch=256, device=device),
        ],
        # shared kv-cache class => trace-driven back-invalidation traffic
        coherency=CoherencyConfig(shared_classes=("kvcache",)),
        hw=hw,
        device=device,
    )
    with session:
        report = session.run(ROUNDS)
    return {"topology": topo, "report": report}


def report_lines(out):
    """The lines ``examples/fabric_pooling.py`` prints, for ``run``'s result."""
    report = out["report"]
    lines = [
        out["topology"].describe(),
        "",
        f"fabric: {report.rounds} rounds, {report.epochs} epochs, "
        f"BI messages {report.bi_messages:.0f}",
        f"  latency    {s_to_ms(report.latency_s):9.3f} ms",
        f"  congestion {s_to_ms(report.congestion_s):9.3f} ms",
        f"  bandwidth  {s_to_ms(report.bandwidth_s):9.3f} ms",
        f"  coherency  {s_to_ms(report.coherency_s):9.3f} ms",
    ]
    for hc in report.hosts:
        lines.append(
            f"host {hc.host} ({hc.name}): native {s_to_ms(hc.native_s):.2f} ms, "
            f"simulated {s_to_ms(hc.simulated_s):.2f} ms, "
            f"slowdown {hc.slowdown:.2f}x "
            f"(delay share: lat {s_to_ms(hc.latency_s):.3f} / "
            f"cong {s_to_ms(hc.congestion_s):.3f} / "
            f"bw {s_to_ms(hc.bandwidth_s):.3f} / coh {s_to_ms(hc.coherency_s):.3f} ms)"
        )
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    print("\n".join(report_lines(run(device=args.device))))


if __name__ == "__main__":
    main()
