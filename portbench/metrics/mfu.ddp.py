"""The train step's share of the cards' bf16 peak over the mesh: the frozen
matmul count of a global step times the steps of rank 0's unprofiled timed
stretch, over its wall time and the peak of every card."""


def read(ctx):
    t = ctx.timed
    return 100.0 * ctx.step_flops * t["steps"] / (t["wall_s"] * ctx.world * ctx.peak_flops)
