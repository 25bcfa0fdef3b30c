"""The attached prefill step's share of the card's bf16 dense peak: the
FLOPs a prefill needs from the model's published sizes
(``roofline.prefill_flops``), times the steps, over the window."""

from cxlbench import roofline


def read(ctx):
    if ctx["traffic"]["kind"] != "attached_prefill" or not ctx["counters"]["units"]:
        return None
    t = ctx["traffic"]
    flops = roofline.prefill_flops(ctx["config"]["model"], t["batch"], t["seq"])
    return 100.0 * flops * ctx["counters"]["units"] / ctx["window_s"] / roofline.BF16_FLOPS
