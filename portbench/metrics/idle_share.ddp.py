"""Share of rank 0's profiled stretch in which no operation ran on its
card (NCCL kernels count as busy): 1 − the union of the device operations'
intervals over the stretch's wall time."""


def read(ctx):
    return 100.0 * (1.0 - ctx.profile.busy_s() / ctx.profile.wall_s)
