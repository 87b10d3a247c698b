"""Device-idle ms a step between operations inside the train step's
``step:backward`` spans (each microbatch's backward, and the gradients'
finish), read by ``portbench/spans.py``."""

from portbench import spans


def read(ctx):
    return spans.phase_idle_ms(ctx.profile, "step:backward")
