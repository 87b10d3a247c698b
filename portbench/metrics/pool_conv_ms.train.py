"""Device ms a step of MViTv2's depthwise 3³ pools, forward and backward.
The pools run ``F.conv3d`` with groups equal to the channels on contiguous
tensors, which PyTorch sends to its own depthwise kernels
(``conv_depthwise3d_cuda_kernel`` and its ``backward_input`` and
``backward_weight`` kernels); nothing else in the step is a depthwise
convolution, and the stem's dense convolution runs in cuDNN under other
names.  ``trace.Profile`` keeps no link from a kernel to the host operation
that launched it, so the reader matches those names; a hand-written pool
kernel that takes their place keeps the metric by carrying ``mvit_pool`` in
its name.  Nothing where no such kernel ran."""

MARKS = ("conv_depthwise3d", "mvit_pool")


def read(ctx):
    prof = ctx.profile
    hit = [float(e - s) for n, s, e in zip(prof.names, prof.starts, prof.ends)
           if any(m in n for m in MARKS)]
    return 1e3 * sum(hit) / prof.steps if hit else None
