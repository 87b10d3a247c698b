"""Device ms a step of the copy, cast and elementwise kernels (the frozen
name marks of ``trace.KERNEL_CLASSES``)."""


def read(ctx):
    seconds = ctx.profile.seconds_by_class().get("copies, casts, elementwise")
    return None if seconds is None else 1e3 * seconds / ctx.profile.steps
