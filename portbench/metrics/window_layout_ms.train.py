"""Device ms a step of Swin's window layout where it runs in kernels of its
own: PyTorch's ``roll_cuda_kernel`` (the cyclic roll of shifted blocks and
its backward, while the layout was PyTorch's chain) and the port's
``window_layout`` gathers.  The chain's padding, permute and crop copies
run in PyTorch's ``direct_copy`` kernels, which the frozen copies class
counts: that share shows in ``cast_copy_ms.train``, not here.  Nothing
where neither kernel ran."""


def read(ctx):
    roll, rolls = ctx.profile.seconds_of("roll_cuda_kernel")
    gathers, launches = ctx.profile.seconds_of("window_layout")
    if not (rolls or launches):
        return None
    return 1e3 * (roll + gathers) / ctx.profile.steps
