"""Seconds from process start to the first measured unit: inputs, the
program, the kernels' builds and one warm-up unit."""


def read(ctx):
    return ctx.get("setup_s")
