"""Device-idle ms a step between operations inside the train step's
``step:forward`` spans (each microbatch's dropout generator and forward),
read by ``portbench/spans.py``."""

from portbench import spans


def read(ctx):
    return spans.phase_idle_ms(ctx.profile, "step:forward")
