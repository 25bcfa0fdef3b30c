"""The yardstick's arithmetic against hand-worked shapes."""

import pytest

from cxlbench import roofline


def test_prefill_flops_of_a_hand_worked_shape():
    # d 4, 2 heads of 2 (kv 1 head of 2), GELU MLP 8, vocab 10, 3 layers;
    # batch 2 of 5 tokens
    m = {"d_model": 4, "n_heads": 2, "d_head": 2, "n_kv_heads": 1, "d_ff": 8,
         "vocab_size": 10, "n_layers": 3, "mlp_gated": False}
    # a token's products in a layer: q 4x4, k and v 4x2 each, o 4x4, MLP 2 x 4x8
    per_token = 2 * (16 + 8 + 8 + 16 + 64)
    # causal pairs of 5 tokens: 15; scores and values: 2 x 2 x heads 2 x d_head 2
    attn = 15 * 2 * 2 * 2 * 2
    head = 2 * 4 * 10  # the last position of each row
    want = 3 * 2 * (5 * per_token + attn) + 2 * head
    assert roofline.prefill_flops(m, 2, 5) == want == 3 * 2 * (5 * 224 + 240) + 160


def test_gated_mlp_counts_three_products():
    m = {"d_model": 4, "n_heads": 2, "d_head": 2, "n_kv_heads": 1, "d_ff": 8,
         "vocab_size": 10, "n_layers": 1, "mlp_gated": True}
    dense = dict(m, mlp_gated=False)
    assert roofline.prefill_flops(m, 1, 1) - roofline.prefill_flops(dense, 1, 1) == 2 * 4 * 8


def test_cascade_bound_counts_valid_events_once():
    # 1000 valid events in 2 rows, 3 stages, 1200 queued passes: bytes rule
    b = roofline.cascade_bound_s(1000, 1200, 3, 2, 3, roofline.CASCADE_BYTES_PER_EVENT)
    assert b == pytest.approx((16 * 1000 + 4 * (3 + 2 * 3)) / 3.35e12)
    hosts = roofline.cascade_bound_s(1000, 1200, 9, 2, 72, roofline.HOSTS_CASCADE_BYTES_PER_EVENT)
    assert hosts == pytest.approx((20 * 1000 + 4 * (9 + 2 * 72)) / 3.35e12)


def test_cascade_bound_takes_operations_when_they_are_longer():
    b = roofline.cascade_bound_s(10, 10**9, 1, 1, 1, 16)
    assert b == pytest.approx(6 * 10**9 / 67e12)


def test_published_peaks():
    assert roofline.BF16_FLOPS == 989e12
    assert roofline.HBM_BYTES_PER_S == 3.35e12
