"""Device ms a step of the linear epilogue's kernels (``linear_epilogue``
in their names: the forward, the backward's elementwise pass and its bias
column sums), inside the frozen class of copies, casts and elementwise
kernels.  Nothing where the program launches none."""


def read(ctx):
    seconds, kernels = ctx.profile.seconds_of("linear_epilogue")
    return 1e3 * seconds / ctx.profile.steps if kernels else None
