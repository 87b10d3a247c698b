"""Device-idle ms a step between operations inside the train step's
``step:augment`` spans (the input's copy and the augmentation), read by
``portbench/spans.py``."""

from portbench import spans


def read(ctx):
    return spans.phase_idle_ms(ctx.profile, "step:augment")
