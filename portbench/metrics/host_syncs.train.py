"""Copies from host memory to the card a step, each of which blocks the host
until the stream drains: the program's ``sync:h2d`` spans (the
augmentation's gates, parameters and hole corners) over the profiled steps."""

from portbench import spans


def read(ctx):
    if not spans.recorded(ctx.profile):
        return None
    return spans.count(ctx.profile, spans.SYNC) / ctx.profile.steps
