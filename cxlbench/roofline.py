"""The yardstick's arithmetic: NVIDIA's published H100 SXM peaks, the
FLOPs a prefill needs from a model's published sizes, and the least time a
congestion cascade can take on the inputs it is given (bytes moved once,
or its queueing operations, over the card's peaks).  Only the work the
inputs need is counted: valid events, not padding; causal attention's
visible pairs, not the blocks a kernel visits."""

from __future__ import annotations

BF16_FLOPS = 989e12  # H100 SXM data sheet: bf16 dense tensor cores
F32_FLOPS = 67e12  # H100 SXM data sheet: f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet: HBM3

CASCADE_BYTES_PER_EVENT = 16  # FIFO cascade: read t + route bits, write t + slot index
HOSTS_CASCADE_BYTES_PER_EVENT = 20  # host-segmented cascade: + read the host id
OPS_PER_QUEUED_EVENT = 6  # stt*rank, t - p, max, f + p, start - t, sum


def prefill_flops(m: dict, batch: int, seq: int) -> float:
    """FLOPs of one prefill of a dense transformer: every weight product
    at every position (2 a multiply-add), causal attention's scores and
    weighted values over the visible pairs, and the tied head at the last
    position only (the prefill's output)."""
    d, hd, kv = m["d_model"], m["n_heads"] * m["d_head"], m["n_kv_heads"] * m["d_head"]
    mlp = (3 if m.get("mlp_gated", True) else 2) * d * m["d_ff"]
    per_token_layer = 2 * (d * hd + 2 * d * kv + hd * d + mlp)
    pairs = seq * (seq + 1) // 2  # query-key pairs a causal row sees
    attn_layer = 2 * 2 * m["n_heads"] * m["d_head"] * pairs  # q.k and p.v
    head = 2 * d * m["vocab_size"]
    return float(m["n_layers"] * batch * (seq * per_token_layer + attn_layer) + batch * head)


def cascade_bound_s(valid_events: int, queued_events: int, n_stages: int, rows: int,
                    out_per_row: int, bytes_per_event: int) -> float:
    """Least seconds of cascade launches over ``rows`` epoch rows holding
    ``valid_events`` events, ``queued_events`` of them queued at a stage
    (an event counts once a stage it passes): each event's bytes once plus
    the stage service times in and each row's ``out_per_row`` f32 sums
    out, over the HBM rate, or the queueing operations over the f32 rate,
    whichever is longer."""
    nbytes = bytes_per_event * valid_events + 4 * (n_stages + rows * out_per_row)
    return max(nbytes / HBM_BYTES_PER_S, OPS_PER_QUEUED_EVENT * queued_events / F32_FLOPS)
