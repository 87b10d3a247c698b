"""Device ms a step of the LayerNorm kernels: the frozen class of
``trace.KERNEL_CLASSES`` ("layer_norm" in their names), which holds
PyTorch's LayerNorm kernels and the port's own alike.  Nothing where the
program launches none."""


def read(ctx):
    seconds = ctx.profile.seconds_by_class().get("LayerNorm")
    return None if seconds is None else 1e3 * seconds / ctx.profile.steps
