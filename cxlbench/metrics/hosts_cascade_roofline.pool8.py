"""The host-segmented cascade kernel's share of its bound: the least time
of a round's cascade on its real events (``roofline.cascade_bound_s``,
20 bytes an event), times the rounds, over the kernel's seconds in the
profiler's trace."""


def read(ctx):
    tr, w = ctx["trace"], ctx["work"]
    if tr is None or "cascade_kernel" not in w or ctx["traffic"]["kind"] != "fabric_rounds":
        return None
    kernel_s = tr.kernel_seconds(w["cascade_kernel"])
    if kernel_s <= 0:
        return None
    return 100.0 * w["cascade_bound_s_per_unit"] * ctx["counters"]["units"] / kernel_s
