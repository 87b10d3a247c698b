"""Device ms a step of the pooling-attention kernels (``mvit_attention`` in
their names: the forward and the two backward kernels).  Nothing where the
program launches none."""


def read(ctx):
    seconds, kernels = ctx.profile.seconds_of("mvit_attention")
    return 1e3 * seconds / ctx.profile.steps if kernels else None
