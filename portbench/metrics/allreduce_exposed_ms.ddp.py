"""ms a step on rank 0 in which an NCCL kernel runs and no other device
operation does: the gradient all-reduce not hidden behind compute."""


def read(ctx):
    seconds, kernels = ctx.profile.seconds_of("nccl")
    if not kernels:
        return None
    return 1e3 * ctx.profile.exposed_s("NCCL collectives") / ctx.profile.steps
