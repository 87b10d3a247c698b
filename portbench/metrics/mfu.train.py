"""The train step's share of the card's bf16 peak: the frozen matmul count
of a step times the steps of the unprofiled timed stretch, over its wall
time and 989.4 TFLOP/s."""


def read(ctx):
    t = ctx.timed
    return 100.0 * ctx.step_flops * t["steps"] / (t["wall_s"] * ctx.peak_flops)
