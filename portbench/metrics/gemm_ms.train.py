"""Device ms a step of the cuBLAS GEMMs (the frozen name marks of
``trace.KERNEL_CLASSES``)."""


def read(ctx):
    seconds = ctx.profile.seconds_by_class().get("GEMM (cuBLAS)")
    return None if seconds is None else 1e3 * seconds / ctx.profile.steps
